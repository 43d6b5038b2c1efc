"""The operations and bytes each kernel entry of ``repro_torch.kernels.ops``
needs for one call, from the call's arguments (one module an entry).

Each module names its ``ENTRY`` (the attribute of ``kernels/ops.py`` the
models look up at call time), ``capture(args, kwargs)`` (what of a call the
count needs; a device tensor may be in it, read after the session) and
``work(record) -> (flops, bytes, dtype)``.  Input bytes are counted once
read, output bytes once written; where the work depends on the data, the
count is of what these inputs need, not of the kernel's padded capacity.
"""
