"""K1's share of its roofline in the traced cycle (``flops.fwd_bound_s``
over each call's live pairs and real tokens, every pass the trace saw)."""
from portbench import flops


def read(run):
    return flops.roofline_pct(run, "K1", flops.fwd_bound_s)
