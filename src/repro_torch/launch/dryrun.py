"""Multi-pod dry-run: run every (arch × shape × mesh) cell's step on meta
tensors, placed on a fake mesh, and count what one device does.

Port of ``repro/launch/dryrun.py``.  Where the reference lowers and
compiles each cell for 512 placeholder CPU devices, this runs it: the
``fake`` process group of the mesh's world (256, or 512 for two pods)
stands in for the cluster, and the abstract state, batch and cache
(:mod:`repro_torch.launch.specs`) are meta DTensors placed by the spec
trees (:mod:`repro_torch.sharding.params`).  Meta is this module's device
by design, as 512 placeholder devices are the reference's: no data, no
allocation, no card.  The appropriate step (the train step, ``prefill``
or ``decode_step``) runs under the per-device op counter
(:mod:`repro_torch.roofline.op_count`), and its counts go to
``experiments/dryrun/<arch>__<shape>__<pod1|pod2>.json`` with the
reference's keys; the roofline (:mod:`repro_torch.roofline`) reads them.

* ``memory.argument_size_in_bytes`` is the local bytes of the placed
  arguments on one rank, exactly; ``temp_size_in_bytes`` the peak of live
  op outputs; ``lower_s`` the time to build and place the arguments,
  ``compile_s`` the time of the counted step (eager: nothing compiles).
* ``cost`` and ``hlo_lines`` carry the counter's totals (``flops`` =
  matrix-product FLOPs, ``bytes accessed`` = ``hbm_bytes``; the number of
  local ops), there being no HLO.
* ``--save-hlo`` has nothing to save and raises.
* A cell whose step reaches an op DTensor has no sharding rule for
  reports ``status: "error"`` with the op's name, as the reference
  reports per-cell errors.

The fake group is process-global (the reference sets ``XLA_FLAGS`` at
import for the same reason): run the dry-run in its own process.
DTensor propagates shardings op by op, so each cell prints its wall time.

CLI::

    python -m repro_torch.launch.dryrun --arch qwen2-7b --shape train_4k
    python -m repro_torch.launch.dryrun --all [--multi-pod|--both-meshes] [--cells a:s,b:s2]
    python -m repro_torch.launch.dryrun --cells tinyllama-1.1b:train_4k --mesh 4x4
"""
from __future__ import annotations

import argparse
import json
import math
import re
import time
import traceback
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import SHAPES, cell_is_applicable, get_config, list_archs
from ..optim import OptHParams
from ..roofline.op_count import count_ops
from ..sharding.logical import PartitionSpec, is_dtensor, use_rules
from ..sharding.params import batch_specs, cache_specs, distribute_tree, opt_specs, param_specs
from ..train import TrainConfig, make_train_step
from ..tree import leaves
from .mesh import PRODUCTION_SHAPES, make_production_mesh, make_rules, make_test_mesh
from .specs import abstract_cache, abstract_params, abstract_train_state, input_specs

__all__ = ["dryrun_cell", "fake_world", "local_bytes", "main"]

_OP_RE = re.compile(r"\b(?:aten|_c10d_functional|c10d|_dtensor)\.[\w]+(?:\.[\w]+)?")


def fake_world(n: int) -> None:
    """Make the default process group the ``fake`` one of world ``n``
    (rank 0), replacing any fake group of another world."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() == n:
            return
        if dist.get_backend() != "fake":
            raise RuntimeError(f"the dry-run makes its own fake group; a {dist.get_backend()} group exists")
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def local_bytes(tree: Any) -> int:
    """Bytes of the tensors of ``tree`` on this rank (a DTensor's local
    shard)."""
    total = 0
    for t in leaves(tree):
        if isinstance(t, torch.Tensor):
            loc = t.to_local() if is_dtensor(t) else t
            total += loc.numel() * loc.element_size()
    return total


def _mesh_for(multi_pod: bool, mesh_shape: Optional[Tuple[int, int]]):
    """The production mesh, or a (data, model) mesh of ``mesh_shape``, over
    a fake group of its world."""
    shape = tuple(mesh_shape) if mesh_shape is not None else PRODUCTION_SHAPES[multi_pod][0]
    fake_world(math.prod(shape))
    if mesh_shape is not None:
        return make_test_mesh(shape, ("data", "model"))
    return make_production_mesh(multi_pod=multi_pod)


def dryrun_cell(
    arch_name: str,
    shape_name: str,
    *,
    multi_pod: bool = False,
    tcfg: Optional[TrainConfig] = None,
    rules_overrides: Optional[dict] = None,
    mesh_shape: Optional[Tuple[int, int]] = None,
) -> Dict[str, Any]:
    """One cell on the production mesh (``multi_pod`` for 2×16×16), or on a
    ``mesh_shape`` (data, model) mesh."""
    arch = get_config(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = cell_is_applicable(arch, shape)
    if not ok:
        return {"cell": f"{arch_name}×{shape_name}", "status": "skipped", "reason": reason}
    t0 = time.time()
    mesh = _mesh_for(multi_pod, mesh_shape)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    n_dev = mesh.size()
    # serving cells shard the KV-cache sequence: over "model" for 32k
    # shapes, over every axis for the single-request 500k cell
    overrides = dict(rules_overrides or {})
    if shape.kind != "train" and "seq_kv" not in overrides:
        if shape.name == "long_500k":
            overrides["seq_kv"] = ("data", "model") if "pod" not in sizes else ("pod", "data", "model")
        else:
            overrides["seq_kv"] = "model"
    # head counts that don't divide the model axis would replicate all
    # attention compute/score traffic — switch those cells to
    # sequence-parallel attention (seq_act) instead
    model_size = sizes.get("model", 1)
    if (
        "seq_act" not in overrides
        and shape.kind in ("train", "prefill")
        and arch.n_heads
        and arch.n_heads % model_size != 0
    ):
        overrides.setdefault("seq_act", "model")
        overrides.setdefault("heads", None)
        overrides.setdefault("kv_heads", None)
    rules = make_rules(mesh, long_context=False, overrides=overrides)
    tcfg = tcfg or TrainConfig()
    result: Dict[str, Any] = {
        "cell": f"{arch_name}×{shape_name}",
        "arch": arch_name,
        "shape": shape_name,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "n_devices": int(n_dev),
        "kind": shape.kind,
        "rules_overrides": {k: str(v) for k, v in overrides.items()},
        "tcfg": {"microbatches": tcfg.microbatches, "remat": tcfg.remat},
    }
    with use_rules(rules), torch.no_grad():
        batch = input_specs(arch, shape)
        batch = distribute_tree(batch, mesh, batch_specs(batch, rules))
        if shape.kind == "train":
            state = abstract_train_state(arch, tcfg)
            p_spec = param_specs(state["params"], rules)
            s_spec: Dict[str, Any] = {
                "params": p_spec,
                "opt": opt_specs(state["opt"], state["params"], rules, zero=True, mesh=mesh),
                "step": PartitionSpec(),
            }
            if "ef" in state:
                s_spec["ef"] = p_spec
            state = distribute_tree(state, mesh, s_spec)
            step = make_train_step(arch, OptHParams(), tcfg)
            args: Tuple[Any, ...] = (state, batch)
            run = lambda: step(state, batch)  # noqa: E731
            donated = state
        else:
            from ..models import decode_step, prefill

            params = abstract_params(arch)
            params = distribute_tree(params, mesh, param_specs(params, rules))
            cache = abstract_cache(arch, shape.global_batch, shape.seq_len)
            cache = distribute_tree(cache, mesh, cache_specs(cache, rules))
            donated = cache
            if shape.kind == "prefill":
                args = (params, batch, cache)
                run = lambda: prefill(params, arch, batch, cache)  # noqa: E731
            else:
                args = (params, batch["tokens"], batch["positions"], cache)
                run = lambda: decode_step(params, arch, batch["tokens"], batch["positions"], cache)  # noqa: E731
        result["lower_s"] = round(time.time() - t0, 1)
        t1 = time.time()
        with count_ops() as counted:
            try:
                out = run()
            except Exception as exc:
                exc.dtensor_op = counted.last_dtensor_op  # for error_record, when the message names no op
                raise
        result["compile_s"] = round(time.time() - t1, 1)
    result["cost"] = {"flops": counted.dot_flops, "bytes accessed": counted.hbm_bytes}
    arg_bytes = local_bytes(args)
    result["memory"] = {
        "generated_code_size_in_bytes": 0.0,
        "argument_size_in_bytes": float(arg_bytes),
        "output_size_in_bytes": float(local_bytes(out)),
        "temp_size_in_bytes": float(counted.peak_bytes),
        "alias_size_in_bytes": float(local_bytes(donated)),  # updated in place, where jit donates
    }
    result["collective_bytes"] = dict(counted.collective_bytes)
    result["dot_flops"] = counted.dot_flops
    result["dot_bytes"] = counted.dot_bytes
    result["hbm_bytes"] = counted.hbm_bytes
    result["while_trip_counts"] = dict(counted.while_trip_counts)
    result["hlo_lines"] = counted.n_ops
    result["status"] = "ok"
    return result


def error_record(arch_name: str, shape_name: str, mesh: str, exc: BaseException) -> Dict[str, Any]:
    """A cell that raised: the error, the op it names (DTensor's "no
    sharding strategy" messages name one; else the DTensor op the step
    dispatched last, the one that raised), and the traceback's tail."""
    msg = f"{type(exc).__name__}: {exc}"
    m = _OP_RE.search(msg) or _OP_RE.search(getattr(exc, "dtensor_op", ""))
    return {
        "cell": f"{arch_name}×{shape_name}",
        "arch": arch_name,
        "shape": shape_name,
        "mesh": mesh,
        "status": "error",
        "error": msg,
        "op": m.group(0) if m else None,
        "traceback": traceback.format_exc()[-2000:],
    }


def _parse_mesh(text: Optional[str]) -> Optional[Tuple[int, int]]:
    if not text:
        return None
    d, m = text.lower().split("x")
    return int(d), int(m)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--cells", default=None, help="comma list arch:shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--mesh", default=None, help="a (data)x(model) mesh instead of the production one, e.g. 4x4 or 1x1")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="dots")
    ap.add_argument(
        "--override",
        action="append",
        default=[],
        help="sharding-rule override key=axis (repeatable), e.g. seq_act=model",
    )
    ap.add_argument("--save-hlo", action="store_true", help="(the port has no HLO: raises)")
    ap.add_argument("--out", default="experiments/dryrun")
    args = ap.parse_args(argv)
    if args.save_hlo:
        raise SystemExit("--save-hlo: the port runs eager PyTorch and has no HLO to save")

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    tcfg = TrainConfig(microbatches=args.microbatches, remat=args.remat)
    cli_overrides = {}
    for ov in args.override:
        k, _, v = ov.partition("=")
        cli_overrides[k] = None if v in ("", "none", "None") else (tuple(v.split("+")) if "+" in v else v)

    cells = []
    if args.cells:
        for c in args.cells.split(","):
            a, s = c.split(":")
            cells.append((a, s))
    elif args.all:
        for a in list_archs():
            for s in SHAPES:
                cells.append((a, s))
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all or --cells")
        cells.append((args.arch, args.shape))

    mesh_shape = _parse_mesh(args.mesh)
    meshes = [args.multi_pod] if mesh_shape is None and not args.both_meshes else ([False, True] if mesh_shape is None else [False])

    n_fail = 0
    for arch_name, shape_name in cells:
        for mp in meshes:
            pod = args.mesh if mesh_shape is not None else ("pod2" if mp else "pod1")
            tag = f"{arch_name}__{shape_name}__{pod}"
            mesh_name = args.mesh or ("2x16x16" if mp else "16x16")
            t0 = time.time()
            try:
                res = dryrun_cell(arch_name, shape_name, multi_pod=mp, tcfg=tcfg,
                                  rules_overrides=cli_overrides or None, mesh_shape=mesh_shape)
            except Exception as e:  # noqa: BLE001 - reported per cell
                res = error_record(arch_name, shape_name, mesh_name, e)
                n_fail += 1
            wall = time.time() - t0
            (out_dir / f"{tag}.json").write_text(json.dumps(res, indent=1))
            status = res["status"]
            extra = ""
            if status == "ok":
                cb = sum(res["collective_bytes"].values())
                extra = (f" args={res['memory']['argument_size_in_bytes'] / 1e9:.3f}GB"
                         f" temp={res['memory']['temp_size_in_bytes'] / 1e9:.3f}GB"
                         f" flops={res['dot_flops']:.4g} coll={cb / 1e9:.3f}GB")
            elif status == "error":
                extra = f" op={res['op']} " + res["error"][:160]
            print(f"[{status:7s}] {tag} wall={wall:.1f}s{extra}", flush=True)
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
