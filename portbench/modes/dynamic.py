"""DynaPipe's own path: ``PlanAheadRunner.run`` on the threads backend's
sequential path (``use_executor=False``), one device, plan-ahead planning
with the traffic's lookahead, the card's memory as ``device_mem``.

The runner has no per-iteration hook, so a subclass reads its iterations
where they pass through the runner's own methods: ``_obtain`` starts each
iteration (the window's decisions; a stop ends ``run`` by an exception,
outside any update), ``_execute_replica`` sees each plan and global batch,
and wrappers on the backend's ``execute_plan`` and ``optimizer_step``
read the micro-batches as materialised, the loss sums and the optimizer
state. The window's counters are the runner's own ``RunnerStats``
(real and padded tokens, plan wait).
"""
from __future__ import annotations

from portbench import bench, flops, layout, port, weights
from portbench.traffic import CellTraffic


# the planner's memory budget where a test runs the mode on the CPU
CPU_DEVICE_MEM = 80e9


class _Stop(Exception):
    """The window's end: raised from the start of an iteration."""


class _Probe:
    def __init__(self, window, readings):
        self.window, self.readings = window, readings
        self.stats = None
        self.iters = {}           # it -> [plan, gb, [numpy micro-batches]]
        self.snaps = {}

    def attach(self, backend) -> None:
        execute, optimize = backend.execute_plan, backend.optimizer_step

        def execute_plan(plan, **kw):
            with bench.span("execute"):
                res = execute(plan, **kw)
            it = max(self.iters)
            self.iters[it][2] = [kw["batches"][m.mb_id]
                                 for m in sorted(plan.micro_batches,
                                                 key=lambda m: m.mb_id)]
            self.readings.step_loss(res.loss_sum, res.weight_sum)
            return res

        def optimizer_step(params, grads, opt, cfg):
            with bench.span("optimizer"):
                out = optimize(params, grads, opt, cfg)
            if opt["step"] in (1, self.readings.steps):
                self.readings.after_update(opt, float(out[2]["grad_norm"]))
            return out
        backend.execute_plan = execute_plan
        backend.optimizer_step = optimizer_step

    def snapshot(self, it):
        s = self.stats
        self.snaps[it] = (s.real_tokens, s.padded_tokens, s.plan_wait_s,
                          s.iters)


def _runner_class():
    from repro_torch.train.runner import PlanAheadRunner

    class Runner(PlanAheadRunner):
        probe: _Probe

        def _obtain(self, it, stats=None):
            if self.probe.stats is None:
                self.probe.attach(self.backend)
            self.probe.stats = stats
            if not self.probe.window.at_iteration(it):
                raise _Stop
            with bench.span("plan_wait"):
                return super()._obtain(it, stats)

        def _execute_replica(self, it, rep, plan, gb, params):
            self.probe.iters[it] = [plan, gb, None]
            with bench.span("replica"):
                return super()._execute_replica(it, rep, plan, gb, params)
    return Runner


def _samples(plan, gb):
    return [[tuple(int(x) for x in gb.lengths[i]) for i in m.sample_indices]
            for m in plan.micro_batches]


def run(cell, seed, seconds, trace, device, t0) -> bench.Run:
    import torch

    from repro_torch.core.cost_model import AnalyticCostModel
    from repro_torch.core.planner import PlannerConfig
    from repro_torch.core.shapes import ShapePalette
    from repro_torch.train.runner import RunnerConfig
    spec, model = cell.spec, cell.model
    cfg = port.arch_config(model)
    port.load_kernels(cfg, device)
    traffic = CellTraffic(spec, model["vocab"], seed)
    opt_cfg = port.opt_config(spec)
    readings = port.StepReadings(model, seed, device, opt_cfg,
                                 bench.CHECK_STEPS)
    mem = (torch.cuda.get_device_properties(device).total_memory
           if device.type == "cuda" else CPU_DEVICE_MEM)
    pcfg = PlannerConfig(n_stages=1, d_model=cfg.d_model,
                         palette=ShapePalette.build(**spec["palette"]),
                         device_mem=float(mem))
    rcfg = RunnerConfig(n_iters=1 << 30, use_executor=False,
                        lookahead=int(spec["lookahead"]), log_every=0,
                        seed=int(seed) % (1 << 63), device=str(device))
    window = bench.Window(traffic.cycle, seconds, trace, device,
                          check_only=spec.get("check_only", False))
    probe = _Probe(window, readings)
    window.on_open = window.on_close = probe.snapshot
    runner = _runner_class()(cfg, AnalyticCostModel(cfg, n_stages=1), pcfg,
                             rcfg, traffic, opt_cfg=opt_cfg,
                             params=weights.make_params(model, seed, device))
    runner.probe = probe
    try:
        runner.run()
    except _Stop:
        pass
    del runner
    bench.free_device(device)
    errors = {it: layout.sample_errors(
        gb, mbs, [[[s] for s in m.sample_indices]
                  for m in sorted(plan.micro_batches, key=lambda m: m.mb_id)])
        for it, (plan, gb, mbs) in probe.iters.items() if mbs is not None}
    if window.t_open is None:
        return bench.Run(model=model, program=readings.as_dict(),
                         layout_errors=sum(errors.values()))
    r0, p0, w0, i0 = probe.snaps[window.it_open]
    r1, p1, w1, i1 = probe.snaps[window.it_close]
    timed = range(window.it_open, window.it_close)
    return bench.Run(
        model=model,
        setup_s=window.t_open - t0 - readings.seconds,
        window_s=window.t_close - window.t_open, cycle=traffic.cycle,
        iters=i1 - i0,
        real_tokens=r1 - r0, positions=p1 - p0, plan_wait_s=w1 - w0,
        model_flops=sum(flops.model_flops(model, probe.iters[it][1].lengths)
                        for it in timed),
        peak_bytes=window.peak_bytes, trace=window.summary,
        traced_mbs=[mb for it in window.traced
                    for mb in _samples(*probe.iters[it][:2])],
        program=readings.as_dict(), layout_errors=sum(errors.values()),
        failed_iters=sum(errors.get(it, 1) > 0 for it in timed))
