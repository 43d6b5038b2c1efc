"""Training launcher: ``python -m repro_torch.launch.train --arch <id> [...]``.

Port of ``repro/launch/train.py``: runs a (smoke, or with ``--full`` the
published) config end to end through the trainer — executor-prefetched
data, the train step, AdamW.  Runs on ``cuda`` unless ``--device cpu`` is
given; without a card it raises.  Weights are random, from a
``torch.Generator`` seeded with 0.  ``--ckpt-dir`` saves the train state
every ``--ckpt-every`` steps and at the end, and a run started on a
directory that holds a checkpoint resumes from its latest step (the
reference's format: a JAX run's checkpoint resumes here, and back).
``--production`` binds the 16×16 production mesh and its sharding rules
around the trainer (``--multi-pod`` the 2×16×16 one), as the reference
does: the process group of that world (256 or 512 ranks, one card each,
``torchrun`` or the like) must exist before ``main`` runs, else the mesh
raises and names the world it needs.
"""
from __future__ import annotations

import argparse
from typing import List, Optional

from ..configs import get_config, get_smoke_config
from ..optim import OptHParams
from ..sharding.logical import use_rules
from ..train import TrainConfig
from ..train.trainer import Trainer, TrainerConfig
from .mesh import make_production_mesh, make_rules


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--remat", default="none")
    ap.add_argument("--grad-sync", default="auto", choices=["auto", "int8_ef"])
    ap.add_argument("--grad-pack", default="host", choices=["host", "device"],
                    help="explicit-DP wire packer: host reference loop or the "
                         "fused device kernel (bit-identical wire bytes)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--production", action="store_true", help="bind the 16x16 production mesh")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)

    arch = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    hp = OptHParams(lr_peak=args.lr, warmup_steps=max(args.steps // 10, 1), total_steps=args.steps)
    tcfg = TrainConfig(microbatches=args.microbatches, remat=args.remat,
                       grad_sync=args.grad_sync, grad_pack=args.grad_pack)
    run = TrainerConfig(
        batch=args.batch,
        seq=args.seq,
        steps=args.steps,
        ckpt_dir=args.ckpt_dir,
        ckpt_every=args.ckpt_every,
    )
    def go() -> int:
        trainer = Trainer(arch, hp, tcfg, run, device=args.device)
        summary = trainer.train()
        print("summary:", summary)
        return 0

    if args.production or args.multi_pod:
        mesh = make_production_mesh(multi_pod=args.multi_pod)
        with use_rules(make_rules(mesh)):
            return go()
    return go()


if __name__ == "__main__":
    raise SystemExit(main())
