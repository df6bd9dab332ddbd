"""Real tokens over the positions the steps computed in the window: the
planner's padded micro-batches (``RunnerStats``), or the packed rows,
empty rows included."""


def read(run):
    return run.real_tokens / run.positions if run.positions else None
