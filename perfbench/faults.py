#!/usr/bin/env python3
"""Faults planted under a serving cell's timed path: a run with any of them
has to come out not ``correct``.  The program is not edited; the fault
wraps the model entry the server calls for every decode step.

    python3 perfbench/faults.py --fault half_batch --workload <cell> --seed <n> --seconds <s> --trace 0

runs one cell as ``perfbench/run.py`` does, with the fault in place.

* ``state_unchanged``: the step returns the cache as it was given
* ``half_batch``: every odd row gets the logits of the even row before it
  (half the batch's own logits left out)
* ``token_altered``: every 4th step, every row's token is its least likely one
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

FAULTS = ("state_unchanged", "half_batch", "token_altered")


def _copy(cache):
    if isinstance(cache, dict):
        return {k: _copy(v) for k, v in cache.items()}
    return cache.clone()


def broken_decode(dec, how: str):
    """``dec`` (``models.decode_step``) with the fault ``how`` planted."""
    import torch

    if how not in FAULTS:
        raise ValueError(f"no fault {how!r}; one of {FAULTS}")
    calls = {"n": 0}

    def broken(params, arch, tokens, positions, cache):
        calls["n"] += 1
        if how == "state_unchanged":
            logits, _ = dec(params, arch, tokens, positions, _copy(cache))
            return logits, cache
        logits, cache = dec(params, arch, tokens, positions, cache)
        if how == "half_batch":
            logits = logits[torch.arange(logits.shape[0], device=logits.device) // 2 * 2]
        elif calls["n"] % 4 == 0:
            logits = logits.clone()
            rows = torch.arange(logits.shape[0], device=logits.device)
            logits[rows, 0, logits[:, 0].argmin(-1)] = 1e9
        return logits, cache

    return broken


def install(how: str) -> None:
    """Plant the fault ``how`` in the server's decode step."""
    from repro_torch.serve import server as server_mod

    server_mod.decode_step = broken_decode(server_mod.decode_step, how)


if __name__ == "__main__":
    T_START = time.perf_counter()
    sys.path[0:1] = [str(Path(__file__).resolve().parents[1])]
    from perfbench import run as entry  # the caches' directories and the port's path, as a run sets them

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--fault", choices=FAULTS, required=True)
    args, rest = ap.parse_known_args()
    install(args.fault)
    print(f"perfbench: the fault {args.fault} is planted in the server's decode step", file=sys.stderr)
    sys.exit(entry.main(rest, T_START))
