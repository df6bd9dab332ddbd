"""The paper's MLM+DS packing baseline (§2.2): each global batch packed
first-fit into rows of fixed length, a fixed number of rows a micro-batch,
the last micro-batch filled with empty rows; each micro-batch's grad step,
the gradients summed in micro-batch order and scaled by the loss weights'
sum, then AdamW.

The loop is ``benchmarks/bench_e2e.py``'s ``run_baseline`` at commit
6c281531521ac131e36dd31e0d5322d0dc64508a (packing mode), rewritten in
PyTorch over the port's functions as ``chip_smoke.py``'s
``_packed_batches`` and ``_packed_iteration`` run it: ``core/packing``'s
``pack_first_fit`` or ``pack_encdec_first_fit``, ``data/dataset``'s
``materialize_packed_rows`` or ``materialize_packed_encdec_rows``,
``train/pipeline_adapter``'s ``build_grad_step`` or
``build_encdec_grad_step``, ``train/optimizer``'s ``adamw_update``. It
bypasses the planner, the dynamic shapes and the plan-ahead pool.
"""
from __future__ import annotations

import numpy as np

from portbench import bench, flops, layout, port, weights
from portbench.traffic import CellTraffic


def _pad_rows(b, pad):
    """``pad`` fully masked rows appended (segment ids -1, everything
    else 0), as bench_e2e's ``_pad_rows``."""
    return {k: np.concatenate(
        [v, np.repeat(v[-1:] * 0 + (-1 if k.endswith("segment_ids") else 0),
                      pad, axis=0)])
        for k, v in b.items()}


def pack(gb, spec, encdec):
    """``(micro-batches, rows)``: numpy dicts of ``rows_per_micro_batch``
    packed rows each, the last padded with empty rows; each row's sample
    indices in the order they were packed, an empty row none."""
    from repro_torch.core.packing import pack_encdec_first_fit, pack_first_fit
    from repro_torch.data.dataset import (materialize_packed_encdec_rows,
                                          materialize_packed_rows)
    per = int(spec["rows_per_micro_batch"])
    if encdec:
        enc, dec = spec["row_len"]
        rows = pack_encdec_first_fit(gb.lengths, enc, dec)

        def make(chunk):
            return materialize_packed_encdec_rows(chunk, gb.tokens,
                                                  gb.lengths, enc, dec)
        samples = [list(r) for r in rows]
    else:
        rows = pack_first_fit(gb.lengths, int(spec["row_len"]))

        def make(chunk):
            return materialize_packed_rows(chunk, gb.tokens,
                                           int(spec["row_len"]))
        samples = [list(r.sample_indices) for r in rows]
    batches, mb_rows = [], []
    for i in range(0, len(rows), per):
        b = make(rows[i:i + per])
        got = samples[i:i + per]
        if len(got) < per:
            b = _pad_rows(b, per - len(got))
            got = got + [[] for _ in range(per - len(got))]
        batches.append(b)
        mb_rows.append(got)
    return batches, mb_rows


def run(cell, seed, seconds, trace, device, t0) -> bench.Run:
    import torch

    from repro_torch.train.optimizer import adamw_update, init_opt_state
    from repro_torch.train.pipeline_adapter import (build_encdec_grad_step,
                                                    build_grad_step)
    from repro_torch.train.runner import scale_
    from repro_torch.tree import add_into
    spec, model = cell.spec, cell.model
    encdec = model["family"] == "encdec"
    cfg = port.arch_config(model)
    port.load_kernels(cfg, device)
    traffic = CellTraffic(spec, model["vocab"], seed)
    opt_cfg = port.opt_config(spec)
    readings = port.StepReadings(model, seed, device, opt_cfg,
                                 bench.CHECK_STEPS)
    params = weights.make_params(model, seed, device)
    opt = init_opt_state(params, opt_cfg)
    step = (build_encdec_grad_step if encdec else build_grad_step)(cfg)
    row_len = (sum(spec["row_len"]) if encdec else int(spec["row_len"]))
    per = int(spec["rows_per_micro_batch"])
    window = bench.Window(traffic.cycle, seconds, trace, device,
                          check_only=spec.get("check_only", False))
    done = {}                     # it -> (gb, micro-batches, rows)
    it = 0
    while window.at_iteration(it):
        gb = traffic.batch(it)
        with bench.span("pack"):
            batches, mb_rows = pack(gb, spec, encdec)
        grads, loss_sum, w_sum = None, 0.0, 0.0
        for b in batches:
            with bench.span("step"):
                ls, ws, g = step(params, {k: torch.as_tensor(v).to(device)
                                          for k, v in b.items()})
                loss_sum += float(ls)
                w_sum += float(ws)
                grads = g if grads is None else add_into(grads, g)
            del g
        readings.step_loss(loss_sum, w_sum)
        scale_(grads, 1.0 / max(w_sum, 1.0))
        with bench.span("optimizer"):
            _, _, met = adamw_update(params, grads, opt, opt_cfg)
            gn = float(met["grad_norm"])
        del grads
        readings.after_update(opt, gn)
        done[it] = (gb, batches, mb_rows)
        it += 1
    del params, opt, step
    bench.free_device(device)
    errors = {i: layout.sample_errors(*done[i]) for i in done}
    if window.t_open is None:
        return bench.Run(model=model, program=readings.as_dict(),
                         layout_errors=sum(errors.values()))
    timed = range(window.it_open, window.it_close)
    return bench.Run(
        model=model,
        setup_s=window.t_open - t0 - readings.seconds,
        window_s=window.t_close - window.t_open, cycle=traffic.cycle,
        iters=len(timed),
        real_tokens=sum(done[i][0].total_tokens for i in timed),
        positions=sum(len(done[i][1]) * per * row_len for i in timed),
        model_flops=sum(flops.model_flops(model, done[i][0].lengths)
                        for i in timed),
        peak_bytes=window.peak_bytes, trace=window.summary,
        traced_mbs=[[tuple(int(x) for x in done[i][0].lengths[s])
                     for row in rows for s in row]
                    for i in window.traced for rows in done[i][2]],
        program=readings.as_dict(), layout_errors=sum(errors.values()),
        failed_iters=sum(errors[i] > 0 for i in timed))
