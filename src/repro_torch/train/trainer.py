"""Fault-tolerant training loop (``repro/train/trainer.py``), single
device:

* checkpoint every N steps (async), resume from the latest on start;
* a per-step deadline: a step that runs over raises, is retried from the
  last checkpoint, and after ``max_retries`` the job exits with the error
  for the scheduler to reschedule;
* a failure hook for tests (a simulated preemption mid-run).

Checkpoints are the reference's format, so a run resumes from one the JAX
trainer wrote and the other way round.  The mesh argument of the reference
comes with the distributed slice.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import torch

from ..configs.base import ModelConfig, ShapeConfig
from ..data.pipeline import TokenPipeline
from ..distributed.optimizer import AdamWConfig, OptState, init_opt_state
from ..distributed.steps import make_train_step
from ..kernels.common import DeviceLike, resolve_device
from ..models import init_params
from .checkpoint import (AsyncCheckpointer, latest_checkpoint,
                         restore_checkpoint)

Tree = Any


@dataclass
class TrainerConfig:
    total_steps: int = 100
    checkpoint_every: int = 20
    checkpoint_dir: str = "checkpoints"
    keep_checkpoints: int = 3
    step_deadline_s: float = 0.0        # 0 = no watchdog
    max_retries: int = 2
    log_every: int = 10
    seed: int = 0


class StepDeadlineExceeded(RuntimeError):
    pass


class Trainer:
    """Trains ``cfg`` on ``TokenPipeline`` batches of ``shape`` on
    ``device`` (None: the card), float32 master weights and AdamW state.
    ``history`` holds (step, loss) per completed step and ``step_s`` its
    seconds (host clock around the step, which ends reading the loss
    back); ``restore_s`` the seconds of the last resume."""

    def __init__(self, cfg: ModelConfig, shape: ShapeConfig,
                 tcfg: Optional[TrainerConfig] = None,
                 opt_cfg: Optional[AdamWConfig] = None,
                 failure_hook: Optional[Callable[[int], None]] = None, *,
                 device: DeviceLike = None, remat: bool = True):
        self.cfg = cfg
        self.shape = shape
        self.tcfg = tcfg or TrainerConfig()
        self.failure_hook = failure_hook
        self.device = resolve_device(device)
        self.step_fn = make_train_step(cfg, opt_cfg, remat=remat,
                                       device=self.device)
        self.pipeline = TokenPipeline(cfg, shape, seed=self.tcfg.seed)
        self.ckpt = AsyncCheckpointer(self.tcfg.checkpoint_dir, cfg,
                                      keep=self.tcfg.keep_checkpoints)
        self.step = 0
        self.params: Optional[Tree] = None
        self.opt_state: Optional[OptState] = None
        self.history: list = []
        self.step_s: list = []
        self.restore_s = 0.0

    # ------------------------------------------------------------ setup
    def init(self) -> None:
        """Fresh float32 weights drawn from ``seed`` on the device (the
        reference's distributions; torch's generator draws other numbers
        than JAX's keys)."""
        gen = torch.Generator(device=self.device).manual_seed(self.tcfg.seed)
        self.params = init_params(self.cfg, gen, device=self.device,
                                  dtype=torch.float32)
        self.opt_state = init_opt_state(self.params)
        self.step = 0

    def resume(self) -> bool:
        """Restore the latest checkpoint, if there is one."""
        path = latest_checkpoint(self.tcfg.checkpoint_dir)
        if path is None:
            return False
        t0 = time.perf_counter()
        step, params, opt, extra = restore_checkpoint(path, self.cfg,
                                                      device=self.device)
        self.restore_s = time.perf_counter() - t0
        self.params = params
        self.opt_state = opt if opt is not None else init_opt_state(params)
        self.step = step
        self.pipeline.load_state_dict(extra.get("pipeline", {"step": step}))
        return True

    # ------------------------------------------------------------- loop
    def _one_step(self) -> Dict[str, float]:
        if self.failure_hook is not None:
            self.failure_hook(self.step)
        batch = next(self.pipeline)
        t0 = time.perf_counter()
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        metrics = {k: float(v) for k, v in metrics.items()}
        dt = time.perf_counter() - t0
        if self.tcfg.step_deadline_s and dt > self.tcfg.step_deadline_s:
            raise StepDeadlineExceeded(
                f"step {self.step} took {dt:.2f}s "
                f"(deadline {self.tcfg.step_deadline_s}s)")
        metrics["step_s"] = dt
        return metrics

    def run(self) -> Dict[str, float]:
        if self.params is None and not self.resume():
            self.init()
        metrics: Dict[str, float] = {}
        while self.step < self.tcfg.total_steps:
            retries = 0
            while True:
                try:
                    metrics = self._one_step()
                    break
                except StepDeadlineExceeded:
                    retries += 1
                    if retries > self.tcfg.max_retries:
                        raise
                    # The step updated the weights in place: replay it
                    # from the last checkpoint (its input is deterministic
                    # at this step index).
                    if not self.resume():
                        self.init()
            self.step += 1
            self.pipeline.state.step = self.step
            self.history.append((self.step, metrics.get("loss", 0.0)))
            self.step_s.append(metrics["step_s"])
            if self.step % self.tcfg.log_every == 0:
                print(f"[train] step={self.step} "
                      f"loss={metrics.get('loss', float('nan')):.4f} "
                      f"({metrics.get('step_s', 0):.2f}s)", flush=True)
            if self.step % self.tcfg.checkpoint_every == 0:
                self.ckpt.save(self.step, self.params, self.opt_state,
                               extra={"pipeline":
                                      self.pipeline.state_dict()})
        self.ckpt.wait()
        return metrics
