"""``ops.ssd_chunk(a_dt, x, b, c)``: the SSD scan's intra-chunk block, a_dt
(B, H, nc, Q), x (B, H, nc, Q, P), b and c (B, G, nc, Q, N).  a_dt, x, b, c
read once, y and the float32 chunk states written once; operations on the
causal half (j <= i) that the data needs: C.B^T (2N a pair), the decay (1 a
pair), the product with X (2P a pair), the decay-weighted B (Q N) and the
state product (2 Q P N), a (batch, head, chunk) (``chip_smoke.py``
``ssd_bound_ms``)."""
from __future__ import annotations

ENTRY = "ssd_chunk"
KERNEL = "ssd_scan"


def capture(args, kwargs):
    a, x, b = args[0], args[1], args[2]
    bsz, h, nc, q = a.shape
    return {"bsz": bsz, "h": h, "g": b.shape[1], "nc": nc, "q": q, "p": x.shape[-1], "n": b.shape[-1],
            "dtype": str(x.dtype).replace("torch.", "")}


def work(rec):
    bsz, h, g, nc, q, p, n = (rec[k] for k in ("bsz", "h", "g", "nc", "q", "p", "n"))
    item = 2 if rec["dtype"] in ("bfloat16", "float16") else 4
    nbytes = 4 * bsz * h * nc * q + item * bsz * nc * q * (2 * h * p + 2 * g * n) + 4 * bsz * h * nc * p * n
    pairs = q * (q + 1) // 2
    flops = bsz * h * nc * (pairs * (2 * n + 1 + 2 * p) + q * n + 2 * q * p * n)
    return flops, nbytes, rec["dtype"]
