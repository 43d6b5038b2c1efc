"""Serving: the cell's traffic through ``repro_torch.serve.InferenceServer``.

The benchmark's client and the engine loop share one thread: before each
``server.step()`` the client submits every request that is due (open
loop: its arrival time has come; closed loop: its client's last request
finished), and after it reads how many tokens each request holds, which
timestamps every token at step granularity (the server hands tokens over
once a step).  Counters of ``DecodeCore`` (``prefill_seconds``,
``decode_seconds``, ``steps``) are read around every step; the prompt
tokens prefilled and the positions decoded are read from wrappers around
the model entries the server calls (``prefill``, ``decode_step``).

After the window the engine runs on, with no new requests, until every
request due in the window has its first token, for at most ``GRACE_S``.  Then the peak memory is read, the
server is freed, and a sample of finished requests drawn from the seed
(the longest among them) is held against the plain reference.
"""
from __future__ import annotations

import gc
import time
from typing import Any, Dict, List

from perfbench import flops as fl
from perfbench.cells import family, load_module
from perfbench.readings import PREFILL_CALLS, PROMPT_TOKENS, STEPS
from perfbench.seeds import derive, rng
from perfbench.weights import make_params

GRACE_S = 60.0


class Probe:
    """Wrappers around the server's model entries: prompt tokens and
    positions decoded, and the benchmark's ranges in a traced run."""

    def __init__(self, server_mod, core, cfg: Dict[str, Any], entries=None):
        import torch

        self.mod, self.core, self.cfg, self.entries = server_mod, core, cfg, entries
        self.prompt_tokens = 0
        self.prefill_flops = 0.0
        self.decode_tokens = 0
        self.decode_flops = 0.0
        self._orig = (server_mod.prefill, server_mod.decode_step)
        pre, dec = self._orig
        prefill_flops, decode_flops = fl.counters(cfg)

        def prefill(params, arch, batch, cache):
            s = batch["tokens"].shape[1]
            self.prompt_tokens += s
            self.prefill_flops += prefill_flops(s)
            if self.entries is None or not self.entries.recording:
                return pre(params, arch, batch, cache)
            self.entries.phase = "prefill"
            with torch.profiler.record_function("perfbench::prefill"):
                return pre(params, arch, batch, cache)

        def decode_step(params, arch, tokens, positions, cache):
            for i in self.core.active_slots():
                self.decode_tokens += 1
                self.decode_flops += decode_flops(int(self.core._positions[i]))
            if self.entries is None or not self.entries.recording:
                return dec(params, arch, tokens, positions, cache)
            self.entries.phase = "decode"
            with torch.profiler.record_function("perfbench::decode_step"):
                return dec(params, arch, tokens, positions, cache)

        server_mod.prefill, server_mod.decode_step = prefill, decode_step

    def uninstall(self) -> None:
        self.mod.prefill, self.mod.decode_step = self._orig

    def snapshot(self) -> tuple:
        c = self.core
        return (c.prefill_seconds, c.decode_seconds, c.steps, c.prefill_calls, self.prompt_tokens,
                self.decode_tokens, self.prefill_flops, self.decode_flops)


def run(ctx) -> Dict[str, Any]:
    import torch
    from repro_torch.serve import InferenceServer, ServeConfig
    from repro_torch.serve import server as server_mod

    cell, cfg, arch, device = ctx.cell, ctx.cfg, ctx.arch, ctx.device
    sv = cell["serve"]
    params = make_params(cfg, derive(ctx.seed, "weights"), device)
    traffic = load_module("traffic", cell["mix"]["kind"]).Traffic(
        cell["mix"], cell, rng(ctx.seed, "traffic"), ctx.seconds, cfg["vocab_size"])
    prompts, outputs = traffic.lengths()
    if max(prompts) > sv["max_prefill"] or max(prompts) + max(outputs) > sv["context"]:
        raise ValueError(f"{cell['name']}: traffic up to {max(prompts)} + {max(outputs)} tokens does not fit "
                         f"max_prefill {sv['max_prefill']} and context {sv['context']}")
    server = InferenceServer(arch, params, ServeConfig(slots=sv["slots"], context=sv["context"],
                                                       max_prefill=sv["max_prefill"], transport=sv["transport"]))
    entries = sessions = None
    if ctx.trace:
        from perfbench.trace import Entries, Sessions

        entries = Entries()
        entries.install()
        sessions = Sessions(entries, **cell["trace"])
    probe = Probe(server_mod, server.core, cfg, entries)
    gen = rng(ctx.seed, "sample")

    # warm-up: a prefill at the shortest and at the longest prompt, decode steps of the full tile
    for plen in (min(prompts), max(prompts)):
        server.submit(gen.integers(0, cfg["vocab_size"], plen).tolist(), 3)
    server.run_until_idle()
    ctx.sync()

    tracked: Dict[int, Dict[str, Any]] = {}  # rid -> request record
    open_reqs: List[int] = []

    def submit(specs, t_open):
        for client, due, prompt, max_new in specs:
            req = server.submit(prompt, max_new)
            tracked[req.rid] = {"req": req, "client": client, "due": t_open + due, "times": [], "prompt": prompt,
                                "max_new": max_new}
            open_reqs.append(req.rid)

    freed: List[int] = []

    def collect(now):
        for rid in list(open_reqs):
            rec = tracked[rid]
            n = len(rec["req"].out_tokens)
            if n > len(rec["times"]):
                rec["times"].extend([now] * (n - len(rec["times"])))
            if rec["req"].finished_at is not None:
                open_reqs.remove(rid)
                if rec["client"] is not None:
                    freed.append(rec["client"])

    # before the window: a closed loop fills its slots
    primed = traffic.prime()
    if primed:
        submit(primed, time.perf_counter())
        while server.core.free_slots() or server.pending_requests():
            server.step()
            collect(time.perf_counter())
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ctx.sync()
    t_open = time.perf_counter()
    setup_s = t_open - ctx.t_start
    close = t_open + ctx.seconds
    steps: List[tuple] = []  # (wall, traced, counters before, counters after)
    backlog: List[tuple] = []  # (time, requests sent and waiting for their first token)
    work_steps = 0
    work_walls: List[tuple] = []  # (host wall, prompt tokens prefilled) of the unprofiled steps with work

    def engine_step():
        nonlocal work_steps
        has_work = not server.idle()  # a slot active, a request pending or in flight on the hand-off
        if sessions is not None and has_work:
            sessions.before_step(work_steps, any(not tracked[rid]["times"] for rid in open_reqs))
        traced = sessions is not None and sessions.active
        before = probe.snapshot()
        t0 = time.perf_counter()
        if traced and sessions.ranges:
            with torch.profiler.record_function("perfbench::step"):
                server.step()
        else:
            server.step()
        t1 = time.perf_counter()
        collect(t1)
        backlog.append((t1, sum(1 for rid in open_reqs if not tracked[rid]["times"])))
        after = probe.snapshot()
        did = after[STEPS] != before[STEPS] or after[PREFILL_CALLS] != before[PREFILL_CALLS]
        if has_work:
            work_steps += 1
            tokens = after[PROMPT_TOKENS] - before[PROMPT_TOKENS]
            if not traced:
                work_walls.append((t1 - t0, tokens))
            if did:
                steps.append((t1 - t0, traced, before, after))
            if sessions is not None:
                sessions.after_step(t1 - t0, tokens)
        return has_work

    while True:
        now = time.perf_counter()
        if now >= close:
            break
        submit(traffic.due(now - t_open, freed), t_open)
        freed.clear()
        if not engine_step():
            nxt = min(traffic.next_due() + t_open, close)
            time.sleep(max(0.0, min(nxt - time.perf_counter(), 0.01)))
    t_close = time.perf_counter()
    # every request due in the window gets its first token (late is late, not lost)
    due_in = [r for r in tracked.values() if r["due"] < close]
    while any(not r["times"] for r in due_in) and time.perf_counter() < t_close + GRACE_S:
        engine_step()
    if sessions is not None:
        sessions.stop()
    ctx.sync()
    t_end = time.perf_counter()
    memory_peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
    probe.uninstall()
    if entries is not None:
        entries.uninstall()

    # free the program's state before the reference runs
    del server
    gc.collect()
    if device == "cuda":
        torch.cuda.empty_cache()
    trace = sessions.summarize(ctx.peaks) if sessions is not None else None
    check = judge(ctx, params, cfg, tracked, gen)
    return {
        "kind": "serve", "setup_s": setup_s, "open": t_open, "close": close, "t_end": t_end,
        "requests": list(tracked.values()), "open_loop": traffic.open_loop, "steps": steps, "work_walls": work_walls,
        "memory_peak_bytes": memory_peak, "trace": trace, "check": check,
        "grace_s": t_end - t_close, "notes": [backlog_note(backlog, t_open, close)],
    }


def backlog_note(backlog: List[tuple], t_open: float, close: float) -> str:
    """Requests waiting for their first token over the window: the mean of
    each quarter and the least-squares growth a second."""
    pts = [(t - t_open, n) for t, n in backlog if t_open <= t <= close]
    if len(pts) < 2:
        return "backlog: no samples"
    span = close - t_open
    quarters = []
    for q in range(4):
        ns = [n for t, n in pts if q * span / 4 <= t < (q + 1) * span / 4]
        quarters.append(round(sum(ns) / len(ns), 3) if ns else None)
    mt = sum(t for t, _ in pts) / len(pts)
    mn = sum(n for _, n in pts) / len(pts)
    var = sum((t - mt) ** 2 for t, _ in pts)
    slope = sum((t - mt) * (n - mn) for t, n in pts) / var if var else 0.0
    return f"backlog: mean by quarter {quarters}, growth {slope} requests/s"


def gap_stats(logits, chosen, name: str) -> Dict[str, float]:
    """Over every position: the gap by which the chosen token's reference
    logit lies below the reference's best.  The widest gap, the mean gap,
    and the share of positions whose chosen token is not the reference's best."""
    import torch

    gaps = torch.cat([lg.max(-1).values - lg.gather(1, c[:, None])[:, 0] for lg, c in zip(logits, chosen)])
    return {f"{name}_gap": float(gaps.max()), f"{name}_mean_gap": float(gaps.mean()),
            f"{name}_miss_share": float((gaps > 0).float().mean())}


def judge(ctx, params, cfg, tracked, gen) -> Dict[str, Any]:
    """The served tokens of a sample of finished requests against the plain
    reference: the gaps by which a served token's reference logit lies below
    the reference's best at its position; and every finished request's
    token count against its ``max_new``.  With ``ctx.control`` the control
    takes the served tokens' place (the program's own readings are kept
    under ``program_*``), so the cell's limits judge the control."""
    import torch

    chk = ctx.cell["check"]
    done = [r for r in tracked.values() if r["req"].finished_at is not None]
    wrong_len = sum(1 for r in done if len(r["req"].out_tokens) != r["max_new"])
    if not done:
        return {"served_gap": None, "wrong_length": wrong_len, "sampled": 0, "sampled_tokens": 0}
    longest = max(done, key=lambda r: len(r["prompt"]) + len(r["req"].out_tokens))
    rest = [r for r in done if r is not longest]
    pick = [longest] + [rest[i] for i in gen.permutation(len(rest))[: chk["sample"] - 1]]
    reqs = [(r["prompt"], list(r["req"].out_tokens)) for r in pick]
    served_logits = family(cfg, "served_logits")
    from perfbench.reference.common import strict_f32

    strict_f32()
    t0 = time.perf_counter()
    with torch.no_grad():
        logits = served_logits(params, cfg, reqs, "f32")
        served = [torch.tensor(toks, device=lg.device) for lg, (_, toks) in zip(logits, reqs)]
        out = {"wrong_length": wrong_len, "sampled": len(pick), "sampled_tokens": sum(len(t) for t in served)}
        if ctx.control:
            # the control in the program's place: at every position, the token the float8 reference puts first
            out.update(gap_stats(logits, served, "program"))
            ctl = served_logits(params, cfg, reqs, "fp8")
            served = [c.argmax(-1) for c in ctl]
        out.update(gap_stats(logits, served, "served"))
    out["reference_s"] = time.perf_counter() - t0
    return out
