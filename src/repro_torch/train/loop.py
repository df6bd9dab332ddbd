"""Deprecated training-loop entry point — thin shim over the runner.

Counterpart of ``repro.train.loop``: ``LoopConfig`` is a deprecated
subclass of :class:`~repro_torch.train.runner.RunnerConfig` that warns on
construction, and :func:`train` feeds a ``MultiTaskDataset`` through a
``DatasetStream`` to :class:`~repro_torch.train.runner.PlanAheadRunner`.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.core.cost_model import CostModel
from repro_torch.core.planner import PlannerConfig
from repro_torch.data.synthetic import MultiTaskDataset
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import DatasetStream, PlanAheadRunner, RunnerConfig


@dataclass
class LoopConfig(RunnerConfig):
    """Deprecated alias for :class:`repro_torch.train.runner.RunnerConfig`."""

    def __post_init__(self):
        warnings.warn(
            "LoopConfig is deprecated; use repro_torch.train.runner."
            "RunnerConfig (identical fields)", DeprecationWarning, stacklevel=3)


def train(cfg: ArchConfig, cost: CostModel, pcfg: PlannerConfig,
          lcfg: RunnerConfig, opt_cfg: AdamWConfig = AdamWConfig(lr=3e-4),
          dataset: Optional[MultiTaskDataset] = None, monitor=None):
    """Returns (params, history). ``monitor`` (a ``StragglerMonitor``) goes
    to the runner, which feeds it each replica's iteration time. With
    ``lcfg.ckpt_dir`` the run resumes from the newest valid checkpoint
    there and trains ``lcfg.n_iters`` iterations from it. For an
    encoder-decoder config the default dataset gives every sample a
    decoder target (the reference's leaves it without one, which its
    runner refuses)."""
    ds = dataset or MultiTaskDataset(n_tasks=16, max_len=pcfg.palette.seq_buckets[-1]
                                     if pcfg.palette else 512,
                                     seed=lcfg.seed,
                                     encdec=cfg.family == "encdec")
    stream = DatasetStream(ds, max(2, lcfg.global_tokens // 256), cfg.vocab)
    runner = PlanAheadRunner(cfg, cost, pcfg, lcfg, stream,
                             opt_cfg=opt_cfg, monitor=monitor)
    params, history, _stats = runner.run()
    return params, history
