"""Fault-tolerant training loop.

  * periodic async checkpoints (params + optimizer state + data offset)
  * bounded-retry step execution: a failed step is re-run from the live
    state (the train step writes nothing in place, so a step that failed
    half way left that state whole); past ``max_retries`` the last
    checkpoint is restored, or the error re-raised where there is none
  * resume: ``resume_or_init`` restores the latest checkpoint onto a fresh
    train state on the trainer's device; with no ``ckpt_dir`` a run writes
    to a new directory of its own under the temp dir, so it never resumes
    another run's state
  * gradient accumulation for global batches beyond per-step memory:
    ``grad_accum`` > 1 runs the step once per slice of the batch's leading
    axis, each slice an optimizer update (the reference's scan), and logs
    the mean of their metrics
  * a mesh: the train state lives on it, each leaf placed by its spec
    (``sharding.train_state_pspecs``); ``resume_or_init`` and the rollback
    restore onto it, and a checkpoint holds global arrays (the elastic
    restore, onto any mesh or none). A step gathers the state onto the
    trainer's device, runs the step without a mesh and places the new
    state back: the reference's jit with in/out shardings keeps the
    program's math and only places its state, and so does this. (A loss
    per data shard with its gradients summed would be another function
    wherever the loss does not decompose over examples: the embedder's
    in-batch negatives, the MoE's balance loss and per-group capacity,
    MIND's negatives drawn once a batch.)
"""
from __future__ import annotations

import dataclasses
import logging
import tempfile
import time
from typing import Callable, Iterator

import torch

from repro_torch.distributed.sharding import (place, shardings_from_pspecs,
                                              train_state_pspecs, unshard)
from repro_torch.kernels.common import resolve_device
from repro_torch.models.api import Arch, TrainState
from repro_torch.train.checkpoint import CheckpointManager

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 1000
    ckpt_dir: str | None = None  # None: a fresh directory under the temp dir
    ckpt_interval: int = 200
    keep_n: int = 3
    log_interval: int = 20
    max_retries: int = 2        # per-step transient-failure retries
    grad_accum: int = 1


class Trainer:
    def __init__(self, arch: Arch, cfg: TrainerConfig, mesh=None, device=None):
        """``device`` (``cuda`` unless given) runs the step; ``mesh`` (see
        ``launch.mesh``), whose devices must be of the same type, holds
        the state."""
        self.arch = arch
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh = mesh
        self.state_shardings = None
        if mesh is not None:
            kinds = {d.type for d in mesh.devices.ravel()}
            if kinds != {self.device.type}:
                raise ValueError(f"a mesh on {sorted(kinds)} for a trainer on "
                                 f"{self.device}: the state and the step share a device type")
            self.state_shardings = shardings_from_pspecs(
                train_state_pspecs(arch, mesh), mesh)
        if cfg.ckpt_dir is None:
            cfg = dataclasses.replace(cfg, ckpt_dir=tempfile.mkdtemp(prefix="repro_ckpt_"))
            self.cfg = cfg
        self.ckpt = CheckpointManager(cfg.ckpt_dir, cfg.keep_n)
        step_fn = arch.make_train_step()

        if cfg.grad_accum > 1:
            base = step_fn

            def accum_fn(state, batches):
                # one update per slice of the leading axis, metrics averaged
                ms = []
                for i in range(cfg.grad_accum):
                    state, m = base(state, {k: v[i] for k, v in batches.items()})
                    ms.append(m)
                return state, {k: torch.mean(torch.stack([m[k] for m in ms]).float())
                               for k in ms[0]}

            step_fn = accum_fn
        if mesh is not None:
            local = step_fn

            def mesh_fn(state, batch):
                new, metrics = local(unshard(state, self.device),
                                     unshard(batch, self.device))
                return place(new, self.state_shardings), metrics

            step_fn = mesh_fn
        self.step_fn = step_fn

    # ------------------------------------------------------------------ state
    def init_state(self, seed: int = 0) -> TrainState:
        state = self.arch.init_train_state(seed, self.device)
        return state if self.mesh is None else place(state, self.state_shardings)

    def _restore(self) -> tuple[TrainState, dict]:
        return self.ckpt.restore(self.arch.abstract_train_state(self.device),
                                 shardings=self.state_shardings)

    def resume_or_init(self, seed: int = 0) -> tuple[TrainState, dict]:
        latest = self.ckpt.latest_step()
        if latest is None:
            return self.init_state(seed), {"step": 0}
        state, meta = self._restore()
        log.info("resumed from step %s", meta["step"])
        return state, meta

    # ------------------------------------------------------------------- loop
    def fit(self, data: Iterator[dict], state: TrainState | None = None,
            start_step: int = 0,
            on_metrics: Callable[[int, dict], None] | None = None):
        cfg = self.cfg
        if state is None:
            state, meta = self.resume_or_init()
            start_step = int(meta.get("step", 0))
        history = []
        t0 = time.time()
        step = start_step
        while step < cfg.total_steps:
            batch = next(data)
            attempt = 0
            while True:
                try:
                    state, metrics = self.step_fn(state, batch)
                    break
                except Exception as e:  # transient failure path
                    attempt += 1
                    log.warning("step %d failed (attempt %d): %s", step, attempt, e)
                    if attempt > cfg.max_retries:
                        # fatal: restore the last checkpoint, re-raise if none;
                        # a save still being written counts, so wait for it first
                        self.ckpt.wait()
                        if self.ckpt.latest_step() is None:
                            raise
                        state, meta = self._restore()
                        step = int(meta["step"])
                        log.warning("rolled back to checkpoint step %d", step)
                        attempt = 0
            step += 1

            if step % cfg.log_interval == 0 or step == cfg.total_steps:
                m = {k: float(v) for k, v in metrics.items()}
                m["steps_per_sec"] = cfg.log_interval / max(time.time() - t0, 1e-9)
                t0 = time.time()
                history.append((step, m))
                if on_metrics:
                    on_metrics(step, m)
                else:
                    log.info("step %d %s", step, m)
            if step % cfg.ckpt_interval == 0:
                # global arrays, gathered to the host
                self.ckpt.save_async(step, unshard(state, torch.device("cpu")), metadata={
                    "step": step,
                    "data_offset": int(getattr(data, "offset", 0) or 0),
                })
        self.ckpt.wait()
        return state, history
