"""Trainer: the host-side orchestration loop.

Port of ``repro/train/trainer.py``:

* the **AMT executor** (paper runtime) builds the data batches ahead of
  the step and writes the checkpoint leaves; the loop pumps
  ``executor.progress()`` once per step — the parcelport
  ``background_work`` contract (paper Listing 2);
* **checkpoint/restart** (``ckpt_dir``): the latest step on disk is
  restored into the freshly built state, in place, and the data stream
  resumes at that step (batch ``i`` is a pure function of the seed and
  ``i``); the state is saved every ``ckpt_every`` steps (asynchronously:
  the host copy is taken before ``save`` returns) and once more at the end,
  waited for.  The format is the reference's, so a run of either package
  resumes in the other;
* **step-time watchdog**: flags straggler steps and records them;
* **sharding**: inside a rules context with a mesh
  (:func:`repro_torch.sharding.use_rules`, bound by the launcher's
  ``--production``), the state is placed as DTensors by ``param_specs`` and
  ``opt_specs(zero=True)`` and each batch by ``batch_specs``; the step
  keeps every leaf on its placement.

The train step updates the state in place (see
:mod:`repro_torch.train.step`), where the reference's ``jit`` donates it,
so a full-width run holds one copy of the optimizer state.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Union

import numpy as np
import torch

from ..checkpoint import CheckpointManager
from ..configs.base import ArchConfig
from ..core.executor import AMTExecutor
from ..data import PrefetchingLoader, SyntheticLM
from ..device import resolve_device
from ..optim import OptHParams
from ..sharding.logical import PartitionSpec, current_rules
from ..sharding.params import batch_specs, distribute_tree, opt_specs, param_specs
from .step import TrainConfig, TrainState, init_train_state, make_train_step

__all__ = ["Trainer", "TrainerConfig"]


@dataclass
class TrainerConfig:
    batch: int = 8
    seq: int = 128
    steps: int = 100
    ckpt_every: int = 50
    ckpt_dir: Optional[str] = None
    log_every: int = 10
    straggler_factor: float = 3.0  # step slower than 3× median → flagged
    seed: int = 0


class Trainer:
    def __init__(
        self,
        arch: ArchConfig,
        hp: OptHParams,
        tcfg: TrainConfig = TrainConfig(microbatches=1, remat="none"),
        run: TrainerConfig = TrainerConfig(),
        executor: Optional[AMTExecutor] = None,
        device: Union[str, torch.device, None] = "cuda",
    ):
        self.arch = arch
        self.hp = hp
        self.tcfg = tcfg
        self.run_cfg = run
        self.device = resolve_device(device)
        self.executor = executor or AMTExecutor(n_workers=2)
        self._own_executor = executor is None
        self.step_fn = make_train_step(arch, hp, tcfg)
        self.ckpt = CheckpointManager(run.ckpt_dir, executor=self.executor) if run.ckpt_dir else None
        self.start_step = 0
        self.state: Optional[TrainState] = None
        self.metrics_log: List[Dict[str, float]] = []
        self.straggler_steps: List[int] = []

    def _to_device(self, batch_np: Dict[str, np.ndarray]) -> Dict[str, torch.Tensor]:
        batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch_np.items()}
        for k in ("tokens", "labels"):
            batch[k] = batch[k].long()
        for k in ("prefix", "frames"):  # the frontends' stubs arrive in f32
            if k in batch:
                batch[k] = batch[k].to(getattr(torch, self.arch.dtype))
        rules = current_rules()
        if rules is not None and rules.mesh is not None:
            batch = distribute_tree(batch, rules.mesh, batch_specs(batch, rules))
        return batch

    def _place(self, state: TrainState) -> TrainState:
        """The state as DTensors on the active rules' mesh (params by
        ``param_specs``, moments by ``opt_specs(zero=True)``, EF as the
        params); unchanged without a mesh."""
        rules = current_rules()
        if rules is None or rules.mesh is None:
            return state
        p_spec = param_specs(state["params"], rules)
        spec = {"params": p_spec, "opt": opt_specs(state["opt"], state["params"], rules, zero=True, mesh=rules.mesh),
                "step": PartitionSpec()}
        if "ef" in state:
            spec["ef"] = p_spec
        return distribute_tree(state, rules.mesh, spec)

    # ------------------------------------------------------------------ run
    def train(self) -> Dict[str, Any]:
        try:
            return self._train()
        finally:
            if self._own_executor:
                self.executor.shutdown()

    def _train(self) -> Dict[str, Any]:
        rc = self.run_cfg
        gen = torch.Generator(device=self.device).manual_seed(rc.seed)
        state = self.state = init_train_state(gen, self.arch, self.tcfg)
        start_step = 0
        if self.ckpt is not None and self.ckpt.latest_step() is not None:
            state, start_step = self.ckpt.restore(state)  # the latest step, into the built state in place
            print(f"restored step {start_step} from {self.ckpt.dir}", flush=True)
        state = self.state = self._place(state)
        self.start_step = start_step
        source = SyntheticLM(self.arch, rc.batch, rc.seq, seed=rc.seed)
        loader = PrefetchingLoader(source, self.executor, depth=4, start_index=start_step)
        times: List[float] = []
        for step in range(start_step, rc.steps):
            batch = self._to_device(loader.next())
            t0 = time.monotonic()
            state, metrics = self.step_fn(state, batch)
            rec_metrics = {k: float(v) for k, v in metrics.items()}  # waits for the device
            dt = time.monotonic() - t0
            times.append(dt)
            med = float(np.median(times[-32:]))
            if len(times) > 8 and dt > rc.straggler_factor * med:
                self.straggler_steps.append(step)
            rec = {"step": step, "time_s": dt, **rec_metrics}
            self.metrics_log.append(rec)
            if step % rc.log_every == 0:
                print(
                    f"step {step:5d} loss={rec.get('loss', float('nan')):.4f} "
                    f"lr={rec.get('lr', 0):.2e} {dt*1e3:.0f}ms",
                    flush=True,
                )
            if self.ckpt is not None and (step + 1) % rc.ckpt_every == 0:
                self.ckpt.save(state, step + 1)
            # paper Listing 2 contract: pump host-side background work
            self.executor.progress()
        if self.ckpt is not None:
            self.ckpt.save(state, rc.steps, wait=True)
        return {
            "final_loss": self.metrics_log[-1].get("loss") if self.metrics_log else None,
            "steps": len(self.metrics_log),
            "stragglers": self.straggler_steps,
            "median_step_s": float(np.median(times)) if times else None,
        }
