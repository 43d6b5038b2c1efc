"""Card time inside the port's ``repro::shared_block`` ranges in prefill
(the hybrid's shared attention+MLP block with its per-invocation linear
layer) per 1,000 prompt tokens prefilled, in ms, over the complete
``ranges`` sessions of a cell run by ``drivers/serve_ranges.py``; None
where nothing was read."""


def read(run, ctx):
    tr = run.get("trace") or {}
    got = tr.get("repro_ranges")
    if not got or not got["tokens"] or "shared_block" not in got["ranges"]:
        return None
    return 1e3 * got["ranges"]["shared_block"] / (got["tokens"] / 1e3)
