#!/usr/bin/env python3
"""List the aten ops this PyTorch's DTensor can propagate a sharding for.

DTensor runs an op on sharded tensors only where a sharding strategy or
rule is registered for it (``torch.distributed.tensor._ops``), or where
its dispatcher handles it itself (``as_strided``, ``convolution``, the
random ops, ...).  Which ops those are changes from one PyTorch release
to the next, so a model that runs on DTensors under one release can stop
at an op with "does not have a sharding strategy registered" under
another.  This prints the release and writes one JSON object:

    {"torch": "<torch.__version__>",
     "strategies": [...],       # op_strategy_funcs
     "single_dim_strategies": [...],   # op_single_dim_strategy_funcs, where the release has them
     "rules": [...],            # op_to_rules
     "handlers": [...],         # the dispatcher's own handlers and random ops
     "ops": [...],              # the union, sorted
     "refused_on_2d_mesh": [...]}   # registered, but refused on a 2-D mesh

The last list comes from probes: each op of ``PROBES`` runs on a meta
DTensor placed on a 2×2 mesh over a ``fake`` process group of world 4,
and an op that raises there, or gives an output whose placements do not
cover the mesh's two dims, is listed (a strategy written for 1-D meshes:
the next op on its output then fails).

Each op is named as ``str(op)`` names it (``aten.view.default``).
``tests/test_torch_sharded_families.py`` holds the ops the sharded
families dispatch on DTensors against the list made with the release
that runs on the card (``tools/torch_dtensor_ops.json``):

    python3 tools/torch_dtensor_ops.py --out tools/torch_dtensor_ops.json
"""
from __future__ import annotations

import argparse
import json
import sys

import torch


def registered_ops() -> dict:
    from torch.distributed.tensor import DTensor

    disp = DTensor._op_dispatcher
    prop = disp.sharding_propagator
    names = lambda reg: sorted({str(op) for op in reg})  # noqa: E731
    rec = {
        "torch": torch.__version__,
        "strategies": names(prop.op_strategy_funcs),
        "single_dim_strategies": names(getattr(prop, "op_single_dim_strategy_funcs", {})),
        "rules": names(prop.op_to_rules),
        "handlers": names(set(getattr(disp, "_custom_op_handlers", {})) | set(getattr(disp, "_random_ops", ()))),
    }
    rec["ops"] = sorted(set().union(*(rec[k] for k in ("strategies", "single_dim_strategies", "rules", "handlers"))))
    return rec


# name → a call on x, a (4, 8, 6) f32 meta DTensor sharded over its dim 0
# on the 2×2 mesh's first dim: the shape-changing and indexing ops the
# port's models reach on DTensors, or reached before they ran them on
# local shards
PROBES = {
    "constant_pad_nd": lambda x: torch.nn.functional.pad(x, (0, 0, 3, 0)),
    "roll": lambda x: torch.roll(x, 1, dims=1),
    "flip": lambda x: torch.flip(x, dims=(1,)),
    "cumsum": lambda x: torch.cumsum(x, dim=1),
    "topk": lambda x: torch.topk(x, 2, dim=-1),
    "tril": lambda x: torch.tril(x),
    "logaddexp": lambda x: torch.logaddexp(x, x),
    "repeat": lambda x: x.repeat(1, 2, 1),
    "unbind": lambda x: torch.unbind(x, dim=1),
}

def refused_on_2d_mesh() -> list:
    """The ops of :data:`PROBES` that a 2×2 mesh refuses (see the module
    docstring): the op that raised, or whose output is misplaced."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_leaves

    class Blame(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.last, self.bad = None, set()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if any(isinstance(a, DTensor) for a in tree_leaves((args, kwargs or {}))):
                self.last = str(func)
            out = func(*args, **(kwargs or {}))
            if any(isinstance(o, DTensor) and len(o.placements) != o.device_mesh.ndim for o in tree_leaves(out)):
                self.bad.add(str(func))
            return out

    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    mesh = init_device_mesh("cuda", (2, 2), mesh_dim_names=("data", "model"))
    local = torch.empty((2, 8, 6), device="meta")
    x = DTensor.from_local(local, mesh, (Shard(0), Replicate()), run_check=False)
    refused = set()
    for name, fn in PROBES.items():
        with Blame() as blame:
            try:
                fn(x)
            except Exception as exc:  # noqa: BLE001 - the refusal is the reading
                refused.add(blame.last or f"aten.{name}")
                print(f"probe {name}: {type(exc).__name__}: {str(exc)[:200]}", file=sys.stderr)
        refused |= blame.bad
    dist.destroy_process_group()
    return sorted(refused)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default=None, help="write the JSON here (default: standard output)")
    args = ap.parse_args(argv)
    rec = registered_ops()
    rec["refused_on_2d_mesh"] = refused_on_2d_mesh()
    text = json.dumps(rec, indent=1) + "\n"
    print(f"torch {rec['torch']}: {len(rec['ops'])} ops ({len(rec['strategies'])} strategies, "
          f"{len(rec['single_dim_strategies'])} single-dim strategies, {len(rec['rules'])} rules, "
          f"{len(rec['handlers'])} handlers); refused on a 2-D mesh: {rec['refused_on_2d_mesh']}", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            f.write(text)
    else:
        sys.stdout.write(text)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
