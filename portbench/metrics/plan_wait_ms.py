"""Milliseconds an iteration of the window waited for its plan
(``RunnerStats.plan_wait_s`` over the window's iterations); only where a
planner runs."""


def read(run):
    if run.plan_wait_s is None or not run.iters:
        return None
    return 1e3 * run.plan_wait_s / run.iters
