"""Training launcher: DynaPipe-planned multi-task training in PyTorch.

Counterpart of ``repro.launch.train``, with the same flags plus
``--device`` (default ``cuda``; ``cpu`` only when asked for). By default
it trains on the threaded 2-stage pipeline; ``--no-executor`` takes the
sequential path. ``--arch t5-paper`` trains the encoder-decoder on 2-D
micro-batches. Examples:

  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --iters 20 --tokens 1024 --max-seq 128
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --reduced \\
      --arch t5-paper --iters 5 --tokens 512 --max-seq 64
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --stages 4
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs.base import get_arch, reduced
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.planner import PlannerConfig
from repro_torch.core.shapes import ShapePalette
from repro_torch.train.loop import train
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.runner import RunnerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gpt-paper")
    ap.add_argument("--reduced", action="store_true",
                    help="tiny same-family config (CPU-runnable)")
    ap.add_argument("--iters", type=int, default=50)
    ap.add_argument("--tokens", type=int, default=4096,
                    help="global batch token budget per iteration")
    ap.add_argument("--stages", type=int, default=2)
    ap.add_argument("--dp", type=int, default=1)
    ap.add_argument("--schedule", default="adaptive", choices=["adaptive", "1f1b"])
    ap.add_argument("--ordering", default="sort", choices=["sort", "tsp"])
    ap.add_argument("--no-executor", action="store_true",
                    help="sequential micro-batch accumulation instead of the "
                         "threaded pipeline executor")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--max-seq", type=int, default=512)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="where the model trains; cpu only when asked for")
    args = ap.parse_args(argv)

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
        if cfg.n_periods % args.stages:
            cfg = dataclasses.replace(
                cfg, n_layers=args.stages * len(cfg.layer_pattern))

    palette = ShapePalette.build(min_seq=32, max_seq=args.max_seq,
                                 seq_align=32, max_mbs=64)
    cost = AnalyticCostModel(cfg, n_stages=args.stages)
    pcfg = PlannerConfig(
        n_stages=args.stages, dp_size=args.dp, device_mem=16e9,
        schedule=args.schedule, ordering=args.ordering,
        palette=palette, d_model=cfg.d_model)
    lcfg = RunnerConfig(
        n_iters=args.iters, global_tokens=args.tokens,
        ckpt_every=args.ckpt_every, ckpt_dir=args.ckpt_dir,
        use_executor=not args.no_executor, seed=args.seed,
        device=args.device)

    params, history = train(cfg, cost, pcfg, lcfg,
                            opt_cfg=AdamWConfig(lr=args.lr))
    first = sum(h["loss"] for h in history[:5]) / max(len(history[:5]), 1)
    last = sum(h["loss"] for h in history[-5:]) / max(len(history[-5:]), 1)
    print(f"\nloss: first5={first:.4f} last5={last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return history


if __name__ == "__main__":
    main()
