"""The comparison that decides ``correct`` for a training cell.

The program's readings of its first steps, against the plain reference
run over the same weights and global batches (``reference.train_steps``):

- ``loss``: the largest relative gap of a step's loss; ``loss_step1``
  the first step's alone, for a cell whose later steps' losses swing
  from seed to seed by the nature of its model (the cell's limits file
  names the one it is held to);
- ``grad``: the first step's gradient as the optimizer gets it (before
  clipping), the worst leaf's gap of norms, |‖g‖ - ‖g_ref‖|, over the
  larger of the reference's norm of that leaf and of the median leaf;
- ``change``: the same of the master weights' change after the last
  step, over the leaves whose reference gradient is at least
  ``MOVING_LEAF`` of the median leaf's (a leaf whose gradient is nought
  to rounding moves under Adam by round-off alone);
- ``layout``: samples of the timed iterations that did not reach the step
  exactly once with their tokens intact, counted by the modes (exact).

Each number is held to its limit from ``limits/<cell>.json``; the run is
correct where every number is at or under its limit.
"""
from __future__ import annotations

import statistics

MOVING_LEAF = 1e-3


def _worst_leaf(got: dict, ref: dict, leaves) -> float:
    med = statistics.median(ref[k] for k in leaves)
    return max(abs(got[k] - ref[k]) / max(ref[k], med, 1e-30)
               for k in leaves)


def readings(prog: dict, ref: dict) -> dict:
    """The compared numbers of one run: ``prog`` and ``ref`` hold
    ``loss``, ``grad`` and ``change`` as ``reference.train_steps`` returns
    them."""
    gaps = [abs(a - b) / abs(b) for a, b in zip(prog["loss"], ref["loss"])]
    if not gaps or len(prog["loss"]) != len(ref["loss"]):
        gaps = [float("inf")]
    grads = sorted(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moving = [k for k in grads if ref["grad"][k] >= MOVING_LEAF * med]
    return {"loss": max(gaps), "loss_step1": gaps[0],
            "grad": _worst_leaf(prog["grad"], ref["grad"], grads),
            "change": _worst_leaf(prog["change"], ref["change"], moving)}


def judge(numbers: dict, limits: dict) -> tuple[bool, list]:
    """``(correct, [[name, number, limit]])``, every limit's number, in the
    limits file's order."""
    rows = [[k, float(numbers.get(k, float("inf"))), float(v)]
            for k, v in limits.items()]
    return all(n <= lim for _, n, lim in rows), rows
