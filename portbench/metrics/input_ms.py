"""Host milliseconds an iteration of the traced cycle spent making its
input: the program's ``materialise`` spans (``data/dataset.py``, numpy
micro-batches from the samples) and ``h2d`` spans (the sequential path's
blocking host-to-device copies in ``dist/backend.py``), summed over the
cycle and divided by its iterations. Nothing where the program has no such
span."""


def read(run):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    totals = tracing.totals()
    host_s = sum(totals[n].host_s for n in ("materialise", "h2d")
                 if n in totals)
    if host_s <= 0 or not run.cycle:
        return None
    return 1e3 * host_s / run.cycle
