"""Trainer: checkpoint/restart, fault tolerance, straggler guard (port of
``repro.train.trainer`` on one device; the mesh branch and the elastic
re-lay are ``ROADMAP.md`` A3b).

* ``fault_hook`` — tests inject exceptions at chosen steps; the trainer
  restores the latest checkpoint (or starts over at step 0 when there is
  none) and replays: the data pipeline is a pure function of the step.
  The train step updates the params and moments in place, so a failed
  step may have left them half-written: the fault path always reloads.
* straggler guard — steps slower than ``straggler_factor x`` the running
  median are counted and logged.
"""
from __future__ import annotations

import json
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.data.pipeline import DataConfig, DataIterator
from repro_torch.models import lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.train import checkpoint as ckpt
from repro_torch.utils import DeviceLike, resolve_device


@dataclass
class TrainerConfig:
    ckpt_dir: str = "runs/ckpt"
    ckpt_every: int = 50
    keep_ckpts: int = 3
    log_every: int = 10
    base_lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 1000
    straggler_factor: float = 3.0
    grad_clip: float = 1.0
    metrics_path: Optional[str] = None


def _skeleton(tree):
    """The tree with each tensor replaced by an empty one of its dtype and
    device: a template for :func:`checkpoint.load` that holds no memory."""
    if isinstance(tree, dict):
        return {k: _skeleton(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_skeleton(v) for v in tree)
    return torch.empty(0, dtype=tree.dtype, device=tree.device)


class Trainer:
    def __init__(self, cfg: ModelConfig, data_cfg: DataConfig,
                 tcfg: TrainerConfig,
                 fault_hook: Optional[Callable[[int], None]] = None,
                 device: DeviceLike = None):
        """Trains on ``device`` (default: the CUDA card; raises without
        one)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.data_cfg = data_cfg
        self.tcfg = tcfg
        self.fault_hook = fault_hook
        self.metrics: list[dict] = []
        self.straggler_events = 0
        self.restarts = 0
        self.step_fn = lm.make_train_step(
            cfg, AdamWConfig(grad_clip_norm=tcfg.grad_clip),
            base_lr=tcfg.base_lr, warmup=tcfg.warmup,
            total_steps=tcfg.total_steps)

    # ------------------------------------------------------------------
    def init_state(self, seed: int = 0):
        params = lm.init_params(
            self.cfg, torch.Generator(device=self.device).manual_seed(seed),
            device=self.device)
        return params, adamw_init(params)

    def _load(self, template: dict):
        """(params, opt, meta) of the latest checkpoint, new tensors in
        ``template``'s dtypes and devices."""
        loaded, meta = ckpt.load(self.tcfg.ckpt_dir, template)
        return loaded["params"], loaded["opt"], meta

    def restore(self, params_tmpl, opt_tmpl):
        if ckpt.latest_step(self.tcfg.ckpt_dir) is None:
            return None
        params, opt, meta = self._load({"params": params_tmpl,
                                        "opt": opt_tmpl})
        return params, opt, meta["step"], meta.get("data_step", meta["step"])

    # ------------------------------------------------------------------
    def run(self, steps: int, resume: bool = True, seed: int = 0
            ) -> Dict[str, Any]:
        params, opt = self.init_state(seed)
        start = 0
        data = DataIterator(self.data_cfg)
        if resume:
            restored = self.restore(params, opt)
            if restored is not None:
                params, opt, start, data_step = restored
                data.restore(data_step)

        step = start
        durations: list[float] = []
        losses = []
        while step < start + steps:
            batch = {k: torch.from_numpy(v).to(self.device)
                     for k, v in next(data).items()}
            t0 = time.time()
            try:
                if self.fault_hook is not None:
                    self.fault_hook(step)
                params, opt, metrics = self.step_fn(params, opt, batch, step)
                loss = float(metrics["loss"])
            except Exception as e:  # fault-tolerance path
                self.restarts += 1
                # never reuse a failed step's tensors: free them, reload
                template = _skeleton({"params": params, "opt": opt})
                params = opt = None
                if ckpt.latest_step(self.tcfg.ckpt_dir) is None:
                    params, opt = self.init_state(seed)
                    step = 0
                    data.restore(0)
                else:
                    params, opt, meta = self._load(template)
                    step = meta["step"]
                    data.restore(meta.get("data_step", step))
                self._log({"event": "restart", "step": step,
                           "error": repr(e)[:200]})
                continue

            dt = time.time() - t0
            durations.append(dt)
            med = float(np.median(durations[-50:]))
            if len(durations) > 5 and dt > self.tcfg.straggler_factor * med:
                self.straggler_events += 1
                self._log({"event": "straggler", "step": step, "dt": dt,
                           "median": med})
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self._log({"step": step, "loss": loss, "dt": dt})
            step += 1
            if step % self.tcfg.ckpt_every == 0:
                self._save(step, params, opt, data)
        self._save(step, params, opt, data)
        return {"params": params, "opt": opt, "losses": losses,
                "final_step": step, "restarts": self.restarts,
                "straggler_events": self.straggler_events}

    def _save(self, step: int, params, opt, data: DataIterator) -> None:
        ckpt.save(self.tcfg.ckpt_dir, step, {"params": params, "opt": opt},
                  meta={"data_step": data.state(), "arch": self.cfg.name},
                  keep=self.tcfg.keep_ckpts)

    def _log(self, rec: dict) -> None:
        self.metrics.append(rec)
        if self.tcfg.metrics_path:
            with open(self.tcfg.metrics_path, "a") as f:
                f.write(json.dumps(rec) + "\n")
