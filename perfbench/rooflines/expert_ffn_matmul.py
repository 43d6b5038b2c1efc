"""``ops.expert_ffn_matmul(x, w)``, x (E, R, D) x w (E, D, F): one product of
the experts' FFN.  Only the weights of experts that received a token are
read, and only the routed rows of x read and of the output written: a row
of the capacity queues that no token filled is all zeros (the dispatch
writes a token's hidden state, never zeros), so the routed rows are the
rows of x that are not all zero.  2 operations per multiply-add over the
routed rows.  The count of routed rows per expert is taken on the device
outside the timed range, once for the gate and up products (the same x)
and reused by the down product that follows them (its rows are theirs)."""
from __future__ import annotations

ENTRY = "expert_ffn_matmul"
KERNEL = "moe_gmm"

_last = {}


def capture(args, kwargs):
    import torch

    x, w = args[0], args[1]
    e, r, d = x.shape
    prev = _last.get("rec")
    # after a gate or up product: the up product reads the same x; the down
    # product reads their output's width
    same = prev is not None and not prev["down"]
    down = same and x.data_ptr() != prev["x_ptr"] and (prev["e"], prev["r"], prev["f"]) == (e, r, d)
    if same and (down or x.data_ptr() == prev["x_ptr"]):
        rows = prev["rows"]
    else:
        rows = torch.count_nonzero(x.abs().amax(dim=-1), dim=-1)
    rec = {"e": e, "r": r, "d": d, "f": w.shape[2], "rows": rows, "x_ptr": x.data_ptr(), "down": down,
           "dtype": str(x.dtype).replace("torch.", "")}
    _last["rec"] = rec
    return rec


def work(rec):
    rows = rec["rows"]
    rows = rows.tolist() if hasattr(rows, "tolist") else list(rows)
    used = sum(1 for n in rows if n)
    routed = sum(rows)
    d, f = rec["d"], rec["f"]
    item = 2 if rec["dtype"] in ("bfloat16", "float16") else 4
    nbytes = item * (used * d * f + routed * (d + f))
    return 2 * routed * d * f, nbytes, rec["dtype"]
