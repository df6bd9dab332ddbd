"""Static plan verification CLI.

Verify serialized plans::

    python -m repro_torch.analysis plan.json [plan2.json ...]

Verify the golden plans of the bench scenarios (gpt / t5 / mesh — the
same tiny-model + MultiTaskStream setups benchmarks/bench_e2e.py runs),
demonstrate the naive-baseline deadlock counterexample (paper Fig. 8b),
and run the chaos mutation corpus::

    python -m repro_torch.analysis --scenario all --naive-demo --mutations 42 \
        --out BENCH_verifier_smoke.json

Exit status: 0 = no finding at/above ``--fail-level`` (and, when
mutations are requested, a 100% kill rate), 1 otherwise. The JSON report
written by ``--out`` is consumed by benchmarks/check_regression.py.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path
from typing import Optional

import numpy as np

from repro_torch.analysis import Severity, verify_plan
from repro_torch.configs.base import get_arch, reduced
from repro_torch.core import comm_plan
from repro_torch.core.cost_model import AnalyticCostModel
from repro_torch.core.instructions import (
    ExecutionPlan,
    MicroBatchSpec,
    RecomputePolicy,
)
from repro_torch.core.planner import PlannerConfig, plan_iteration
from repro_torch.core.schedule import schedule_adaptive
from repro_torch.core.shapes import ShapePalette
from repro_torch.core.simulator import simulate
from repro_torch.dist.chaos import PLAN_MUTATIONS, mutate_plan

# mirrors benchmarks/bench_e2e.py's smoke setup: tiny models over the
# deterministic skewed MultiTaskStream, planner palette 64..512/64
_MAX_LEN = 512
_SCENARIOS = ("gpt", "t5", "mesh")


def _scenario_setup(name: str):
    from repro_torch.data.streams import MultiTaskStream, StreamConfig
    if name == "t5":
        cfg = dataclasses.replace(reduced(get_arch("t5-paper")), n_layers=2,
                                  vocab=2048, d_model=128, n_heads=4,
                                  d_head=32, d_ff=256)
        n_stages = 2
    else:
        cfg = dataclasses.replace(reduced(get_arch("gpt-paper")), vocab=2048,
                                  d_model=128, n_heads=4, d_head=32,
                                  d_ff=256)
        # mesh smoke compiles 4-stage ring plans over 4 virtual devices
        n_stages = 4 if name == "mesh" else 2
    stream = MultiTaskStream(StreamConfig(
        n_tasks=32, global_tokens=4096, max_len=_MAX_LEN, vocab=2048,
        tail_fraction=0.1, tail_alpha=1.2,
        encdec_fraction=1.0 if name == "t5" else 0.0, seed=0))
    cost = AnalyticCostModel(cfg, n_stages=n_stages)
    pal = ShapePalette.build(min_seq=64, max_seq=_MAX_LEN, seq_align=64,
                             max_mbs=16)
    pcfg = PlannerConfig(n_stages=n_stages, d_model=cfg.d_model, palette=pal)
    return stream, cost, pcfg, pal


def _golden_plans(name: str, n_batches: int) -> tuple[list[ExecutionPlan],
                                                      ShapePalette, float]:
    stream, cost, pcfg, pal = _scenario_setup(name)
    plans = []
    for it in range(n_batches):
        itp = plan_iteration(stream.batch(it).lengths, cost, pcfg)
        for p in itp.replica_plans:
            # verify the serialized form — what executors actually fetch
            # from the instruction store
            plans.append(ExecutionPlan.from_json(p.to_json()))
    return plans, pal, pcfg.device_mem


def _verify_scenario(name: str, n_batches: int,
                     verbose: bool) -> tuple[dict, int]:
    plans, pal, mem = _golden_plans(name, n_batches)
    counts = {"ERROR": 0, "WARNING": 0, "INFO": 0}
    n_instr = 0
    worst_level = 0
    for k, p in enumerate(plans):
        rep = verify_plan(p, palette=pal, mem_limit=mem)
        n_instr += rep.meta["n_instructions"]
        for f in rep.findings:
            counts[f.severity.label] += 1
            if verbose:
                print(f"  {name} plan {k}: {f}")
        worst_level = max(worst_level, int(rep.worst() or 0))
    rec = {
        "name": name,
        "n_plans": len(plans),
        "n_instructions": n_instr,
        "findings": sum(counts.values()),
        **{k.lower() + "s": v for k, v in counts.items()},
    }
    return rec, worst_level


def _naive_counterexample(max_seeds: int = 64) -> dict:
    """Reproduce the paper's Fig. 8b deadlock: the naive comm plan
    (send at production, recv just-before-use) over random adaptive
    schedules, statically convicted by the HB cycle."""
    for seed in range(max_seeds):
        rng = np.random.default_rng(seed)
        m = int(rng.integers(4, 10))
        c = int(rng.integers(3, 6))
        tf = rng.uniform(0.5, 2.0, size=(m, c))
        tb = tf * 2.0
        am = rng.uniform(0.5, 1.5, size=(m, c))
        order = schedule_adaptive(m, c, am, 1e9)
        sim = simulate(order, tf, tb, act_mem=am)
        specs = [MicroBatchSpec(i, [i], 1, 64, float(tf[i, 0]),
                                float(tb[i, 0]), float(am[i, 0]))
                 for i in range(m)]
        naive = comm_plan.build_instructions(order, specs, sim, d_model=8,
                                             naive=True)
        if not comm_plan.check_order_consistency(naive):
            continue
        plan = ExecutionPlan(n_stages=c, micro_batches=specs,
                             per_stage=naive,
                             recompute=RecomputePolicy.FULL)
        rep = verify_plan(plan)
        cycle = rep.meta.get("hb_cycle")
        return {
            "seed": seed,
            "n_stages": c,
            "n_micro_batches": m,
            "cycle_found": cycle is not None,
            "cycle_len": len(cycle) if cycle else 0,
            "cycle": cycle or [],
            "errors": len(rep.errors),
        }
    return {"cycle_found": False, "cycle": [],
            "note": f"no inconsistent naive plan in {max_seeds} seeds"}


def _mutation_corpus(n_mutants: int, seed: int, n_batches: int,
                     verbose: bool) -> dict:
    """Seed ``n_mutants`` plan defects (cycling operators × scenarios) and
    count how many the verifier flags with an ERROR."""
    base: list[tuple[str, ExecutionPlan, ShapePalette, float]] = []
    for name in _SCENARIOS:
        plans, pal, mem = _golden_plans(name, n_batches)
        for p in plans:
            if p.micro_batches:
                base.append((name, p, pal, mem))
    ops = sorted(PLAN_MUTATIONS)
    per_op = {op: {"total": 0, "killed": 0} for op in ops}
    survivors = []
    k = 0
    trial = 0
    while k < n_mutants and trial < n_mutants * 4:
        op = ops[trial % len(ops)]
        name, plan, pal, mem = base[(trial // len(ops)) % len(base)]
        r = mutate_plan(plan, op, seed=seed + trial)
        trial += 1
        if r is None:
            continue
        mutant, desc = r
        rep = verify_plan(mutant, palette=pal, mem_limit=mem)
        per_op[op]["total"] += 1
        k += 1
        if rep.errors:
            per_op[op]["killed"] += 1
            if verbose:
                rules = sorted({f.rule for f in rep.errors})
                print(f"  killed [{name}] {desc} -> {rules}")
        else:
            survivors.append(f"[{name}] {desc}")
            print(f"  SURVIVED [{name}] {desc}", file=sys.stderr)
    total = sum(v["total"] for v in per_op.values())
    killed = sum(v["killed"] for v in per_op.values())
    return {
        "total": total,
        "killed": killed,
        "kill_rate": round(killed / total, 4) if total else 0.0,
        "operators": per_op,
        "survivors": survivors,
    }


def run(argv: Optional[list[str]] = None) -> tuple[dict, int]:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static ExecutionPlan verifier (HB deadlock analysis, "
                    "IR lint, memory liveness)")
    ap.add_argument("plans", nargs="*", help="serialized ExecutionPlan "
                    "JSON files to verify")
    ap.add_argument("--scenario", choices=_SCENARIOS + ("all",),
                    help="verify golden planner plans for a bench scenario")
    ap.add_argument("--batches", type=int, default=3,
                    help="stream batches per scenario (default 3)")
    ap.add_argument("--naive-demo", action="store_true",
                    help="emit the naive-baseline deadlock counterexample")
    ap.add_argument("--mutations", type=int, default=0, metavar="N",
                    help="run N seeded plan mutants through the verifier")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mem-limit", type=float, default=None,
                    help="memory limit for file verification")
    ap.add_argument("--fail-level", choices=("error", "warning"),
                    default="error")
    ap.add_argument("--out", type=Path, default=None,
                    help="write the aggregate JSON report here")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    fail_at = (Severity.ERROR if args.fail_level == "error"
               else Severity.WARNING)
    report: dict = {}
    failed = False

    if args.plans:
        recs = []
        for path in args.plans:
            plan = ExecutionPlan.from_json(Path(path).read_text())
            rep = verify_plan(plan, mem_limit=args.mem_limit)
            rec = rep.to_dict()
            rec["file"] = str(path)
            recs.append(rec)
            ok = rep.ok(fail_at)
            failed |= not ok
            print(f"{path}: {rep.summary()}")
        report["files"] = recs

    scenarios = []
    if args.scenario:
        names = _SCENARIOS if args.scenario == "all" else (args.scenario,)
        for name in names:
            rec, worst = _verify_scenario(name, args.batches, args.verbose)
            scenarios.append(rec)
            failed |= worst >= fail_at
            print(f"scenario {name}: {rec['n_plans']} plans, "
                  f"{rec['n_instructions']} instructions, "
                  f"{rec['findings']} finding(s)")
    if scenarios:
        report["scenarios"] = scenarios

    if args.naive_demo:
        naive = _naive_counterexample()
        report["naive"] = naive
        failed |= not naive["cycle_found"]
        print(f"naive baseline: cycle_found={naive['cycle_found']} "
              f"(len {naive.get('cycle_len', 0)})")
        for ln in naive["cycle"]:
            print(f"  {ln}")

    if args.mutations > 0:
        mut = _mutation_corpus(args.mutations, args.seed, args.batches,
                               args.verbose)
        report["mutations"] = mut
        failed |= mut["killed"] != mut["total"] or mut["total"] == 0
        print(f"mutation corpus: {mut['killed']}/{mut['total']} killed "
              f"(kill_rate={mut['kill_rate']})")

    if args.out is not None:
        args.out.write_text(json.dumps(report, indent=2) + "\n")
        print(f"wrote {args.out}")
    return report, 1 if failed else 0


def main(argv: Optional[list[str]] = None) -> int:
    return run(argv)[1]


if __name__ == "__main__":
    raise SystemExit(main())
