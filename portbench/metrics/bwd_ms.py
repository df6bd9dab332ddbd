"""Milliseconds an iteration of the traced cycle spent in the backward
pass: the program's ``backward`` spans (``repro_torch.tracing``, around
``torch.autograd.grad`` in ``train/pipeline_adapter._value_and_grad``, the
per-period recompute inside), each the extent of its work on the device's
clock, summed over the cycle and divided by its iterations. Nothing where
the program has no such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("backward")
    if t is None or t.device_s <= 0 or not run.cycle:
        return None
    return 1e3 * t.device_s / run.cycle
