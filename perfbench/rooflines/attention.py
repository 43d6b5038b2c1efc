"""``ops.attention(q, k, v, causal, window, chunk)``: q, k, v read once, the
output written once; 2 products of 2 operations per visible (query, key)
pair per head dim (the flash kernel's arithmetic in ``chip_smoke.py``)."""
from __future__ import annotations

ENTRY = "attention"
KERNEL = "flash_attention"


def visible_pairs(s: int, causal: bool, window: int, chunk: int) -> int:
    """The (query, key) pairs the mask lets through: query i sees keys from
    max(0, i - window + 1, its chunk's start) to i, or every key when not causal."""
    if not causal:
        return s * s
    total = 0
    for i in range(s):
        lo = 0
        if window:
            lo = max(lo, i - window + 1)
        if chunk:
            lo = max(lo, i // chunk * chunk)
        total += i - lo + 1
    return total


def capture(args, kwargs):
    q, k = args[0], args[1]
    return {"q": tuple(q.shape), "kv": k.shape[2], "dtype": str(q.dtype).replace("torch.", ""),
            "causal": kwargs.get("causal", True), "window": kwargs.get("window", 0), "chunk": kwargs.get("chunk", 0)}


def work(rec):
    b, s, h, d = rec["q"]
    item = 2 if rec["dtype"] in ("bfloat16", "float16") else 4
    nbytes = item * b * s * d * (2 * h + 2 * rec["kv"])
    flops = 4 * b * h * d * visible_pairs(s, rec["causal"], rec["window"], rec["chunk"])
    return flops, nbytes, rec["dtype"]
