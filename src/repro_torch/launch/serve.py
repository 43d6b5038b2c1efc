"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id>``.

Port of ``repro/launch/serve.py``: runs the continuous-batching engine on
a (smoke) model with a synthetic request stream submitted from several
client threads, and prints latency/throughput stats.  The request/response
hand-off rides the comm layer (``--transport collective``, the default)
driven by the shared ``ProgressEngine``; ``--transport shmem`` rides the
one-sided put backend; ``--transport inline`` runs the direct path.

``--workers N`` (N > 1) scales the model tier out into the fleet: one
router, N workers each with a shard of the slots, per-worker channels over
one shared group — same math, same request stream.  ``--prefill-chunk C``
turns on chunked prefill (prompts cross the wire as C-token pieces
interleaved with decode).

Runs on ``cuda`` unless ``--device cpu`` is given; without a card it
raises.  Weights are random, from a ``torch.Generator`` seeded with 0.
An encoder-decoder (``whisper-large-v3``) is refused: a request carries
tokens only, as in the reference.
"""
from __future__ import annotations

import argparse
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from ..configs import get_smoke_config
from ..device import resolve_device
from ..models import init_params
from ..serve import Fleet, FleetConfig, InferenceServer, ServeConfig


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--requests", type=int, default=12)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--transport", choices=("collective", "shmem", "inline"), default="collective")
    ap.add_argument(
        "--workers", type=int, default=1,
        help="model workers; >1 runs the router+fleet tier (slots shard across workers)",
    )
    ap.add_argument(
        "--prefill-chunk", type=int, default=0,
        help="chunked prefill: prompt piece size in tokens (0 = single-shot prefill)",
    )
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    arch = get_smoke_config(args.arch)
    params = init_params(torch.Generator(device=device).manual_seed(0), arch)
    if args.workers > 1:
        server = Fleet(
            arch, params,
            FleetConfig(
                workers=args.workers, slots=args.slots, context=256,
                transport=args.transport, prefill_chunk=args.prefill_chunk,
            ),
        )
    else:
        server = InferenceServer(
            arch, params,
            ServeConfig(slots=args.slots, context=256, transport=args.transport, prefill_chunk=args.prefill_chunk),
        )
    rng = np.random.default_rng(0)
    rng_lock = threading.Lock()
    reqs = []
    lock = threading.Lock()

    def client(n: int) -> None:
        for _ in range(n):
            with rng_lock:
                prompt = rng.integers(0, arch.vocab_size, size=args.prompt_len).tolist()
            r = server.submit(prompt, max_new=args.max_new)
            with lock:
                reqs.append(r)
            time.sleep(0.001)

    per = args.requests // args.clients
    threads = [threading.Thread(target=client, args=(per,)) for _ in range(args.clients)]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    # engine loop = the shared progress engine (paper §3.3.4, explicit
    # driving): each step pumps the comm hand-off and the batched decode
    while any(t.is_alive() for t in threads) or not server.idle():
        if not server.step():
            time.sleep(1e-3)
    for t in threads:
        t.join()
    server.run_until_idle()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.monotonic() - t0
    done = [r for r in reqs if r.done_event.is_set()]
    ttft = [r.first_token_at - r.submitted_at for r in done if r.first_token_at]
    tier = f"fleet(workers={args.workers})" if args.workers > 1 else "single-host"
    extra = ""
    if args.workers > 1:
        extra = f" eagain={server.eagain_events}"
        server.close()
    print(
        f"requests={len(done)}/{len(reqs)} engine_steps={server.steps} "
        f"tokens={server.tokens_out} throughput={server.tokens_out/dt:.1f} tok/s "
        f"ttft_p50={np.median(ttft)*1e3:.1f}ms transport={args.transport} "
        f"tier={tier}{extra} device={device}"
    )
    return 0 if len(done) == len(reqs) else 1


if __name__ == "__main__":
    raise SystemExit(main())
