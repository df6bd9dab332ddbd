"""What the modes share on the program's side: the port's configuration
and optimizer objects built from the cell's files, its kernels loaded, and
the readings of its first steps that ``check.readings`` compares."""
from __future__ import annotations

import dataclasses
import time

from portbench import weights


def arch_config(model: dict):
    """The port's ``ArchConfig`` of a configuration file's ``model``."""
    from repro_torch.configs.base import ArchConfig, LayerSpec
    names = {f.name for f in dataclasses.fields(ArchConfig)}
    kw = {k: v for k, v in model.items() if k in names}
    kw["layer_pattern"] = (LayerSpec("attn"),)
    return ArchConfig(**kw)


def opt_config(spec: dict):
    from repro_torch.train.optimizer import AdamWConfig
    return AdamWConfig(**spec["optimizer"])


def load_kernels(cfg, device) -> None:
    """Build (a checkout's first run) or load the kernels the model
    launches, so that no step waits on nvcc."""
    if device.type == "cuda":
        from repro_torch.kernels import _build
        _build.preload(cfg)


class StepReadings:
    """The program's readings of its first ``steps`` steps: each step's
    loss, the first step's gradient norm per leaf as the optimizer got it
    (before clipping: its first moment after one step over (1 - b1) and
    the clip scale), and the master weights' change per leaf after the
    last, against the harness's weights made again from the seed."""

    def __init__(self, model, seed, device, opt_cfg, steps):
        self.model, self.seed, self.device = model, seed, device
        self.cfg, self.steps = opt_cfg, steps
        self.loss, self.grad, self.change = [], {}, {}
        self.seconds = 0.0

    def step_loss(self, loss_sum: float, w_sum: float) -> None:
        if len(self.loss) < self.steps:
            self.loss.append(loss_sum / max(w_sum, 1.0))

    def after_update(self, opt, grad_norm: float) -> None:
        import torch
        step = opt["step"]
        if step not in (1, self.steps):
            return
        t0 = time.perf_counter()
        with torch.no_grad():
            if step == 1:
                scale = min(self.cfg.clip_norm / max(grad_norm, 1e-12), 1.0)
                self.grad = {k: float(torch.linalg.vector_norm(m))
                             / ((1 - self.cfg.b1) * scale)
                             for k, m in weights.leaf_items(opt["m"])}
            if step == self.steps:
                init = dict(weights.leaf_items(
                    weights.make_params(self.model, self.seed, self.device)))
                self.change = {k: float(torch.linalg.vector_norm(
                    ma - init[k].float()))
                    for k, ma in weights.leaf_items(opt["master"])}
                del init
        self.seconds += time.perf_counter() - t0

    def as_dict(self) -> dict:
        return {"loss": list(self.loss), "grad": dict(self.grad),
                "change": dict(self.change)}
