"""Milliseconds an iteration of the traced cycle spent in AdamW: the
program's ``optimizer`` spans (``repro_torch.tracing``, around
``train/optimizer.adamw_update``, the global norm included), each the
extent of its work on the device's clock, summed over the cycle and divided
by its iterations. Nothing where the program has no such span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    t = tracing.totals().get("optimizer")
    if t is None or t.device_s <= 0 or not run.cycle:
        return None
    return 1e3 * t.device_s / run.cycle
