"""Every real token of every global batch trained in the window, over the
window's wall time (whole iterations, ending in a device synchronise)."""


def read(run):
    return run.real_tokens / run.window_s if run.window_s > 0 else None
