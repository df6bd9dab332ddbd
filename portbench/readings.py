"""The readings a cell's limits are set from, on the card.

    python3 portbench/readings.py --workload <cell> --first-seed <n> \\
        --seeds 12 --control 3 --out <file>

For each of ``--seeds`` seeds, the program's first steps on the cell's
own path (the mode stopped after them) against the fp32 reference: the
lower readings. For the first ``--control`` seeds also the control, the
reference computed in fp8 (``reference.py``), and the fault "half of each
global batch left out, the mean taken over the rest" planted in the
reference, each against the fp32 reference: the upper readings. One JSON
line a reading to standard output and to ``--out``.
"""
import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path

_ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(_ROOT), str(_ROOT / "src")]

from portbench import bench, check, reference, weights  # noqa: E402
from portbench.traffic import CellTraffic  # noqa: E402


def _worst(got, ref, key, n=3):
    """The ``n`` leaves with the largest gap of ``key``'s norms, each with
    its gap over the reference's norm and that norm."""
    gaps = {k: abs(got[key][k] - ref[key][k]) / max(ref[key][k], 1e-30)
            for k in ref[key]}
    return [[k, gaps[k], ref[key][k]] for k in sorted(gaps, key=gaps.get,
                                                       reverse=True)[:n]]


def _half(gb):
    n = max(1, gb.n_samples // 2)
    return dataclasses.replace(gb, lengths=gb.lengths[:n],
                               task_ids=gb.task_ids[:n], tokens=gb.tokens[:n])


def main(argv) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--first-seed", type=int, required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--out", required=True)
    args = p.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    cell = bench.load_cell(args.workload)
    cell = dataclasses.replace(cell, spec={**cell.spec, "check_only": True})
    mode = __import__(f"portbench.modes.{cell.spec['mode']}",
                      fromlist=["run"])
    m, opt = cell.model, cell.spec["optimizer"]
    out = open(args.out, "a")

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        out.write(line + "\n")
        out.flush()

    def ref_steps(seed, precision="fp32", half=False):
        traffic = CellTraffic(cell.spec, m["vocab"], seed)
        gbs = [traffic.batch(i) for i in range(bench.CHECK_STEPS)]
        return reference.train_steps(
            m, weights.make_params(m, seed, device),
            [_half(g) for g in gbs] if half else gbs, opt,
            precision=precision, chunk_tokens=m["reference_chunk_tokens"])

    for k in range(args.seeds):
        seed = args.first_seed + k
        t0 = time.perf_counter()
        run = mode.run(cell, seed, 0.0, False, device, t0)
        bench.free_device(device)
        t1 = time.perf_counter()
        ref = ref_steps(seed)
        t2 = time.perf_counter()
        nums = check.readings(run.program, ref)
        emit({"cell": cell.name, "seed": seed, "kind": "program",
              "layout": run.layout_errors, "program_s": t1 - t0,
              "reference_s": t2 - t1, "loss": run.program["loss"],
              "ref_loss": ref["loss"], "grad_norm": ref["grad_norm"],
              "numbers": nums, "worst_grad": _worst(run.program, ref, "grad"),
              "worst_change": _worst(run.program, ref, "change")})
        if k < args.control:
            for kind, kw in (("control_fp8", {"precision": "fp8"}),
                             ("fault_half_batch", {"half": True})):
                got = ref_steps(seed, **kw)
                emit({"cell": cell.name, "seed": seed, "kind": kind,
                      "numbers": check.readings(got, ref),
                      "loss": got["loss"]})
        bench.free_device(device)
    bad = bench.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
