"""The whole step's share of the card's bf16 peak: the model FLOPs of the
window's real samples (``flops.model_flops``: no padding, no recompute)
over the window's wall time."""
from portbench import flops


def read(run):
    if run.window_s <= 0 or run.model_flops <= 0:
        return None
    return 100.0 * run.model_flops / run.window_s / flops.PEAK_BF16_FLOPS
