"""The share of a cycle's wall time in which no operation ran on the
device: one less the device's busy time in the traced cycle (the union of
the trace's device intervals) over the mean wall time of a cycle of the
timed window, which trains the same global batches untraced. The traced
cycle's own wall time is longer by the profiler's host overhead, which a
host-bound cell would read as idle."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or not run.iters:
        return None
    cycle_s = run.window_s * run.cycle / run.iters
    return 100.0 * (1.0 - t.busy_s / cycle_s)
