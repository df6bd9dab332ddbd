"""The fused attention backward's share of its roofline in the traced
cycle (``flops.bwd_bound_s``), counted as ``k1_roofline`` counts K1's."""
from portbench import flops


def read(run):
    return flops.roofline_pct(run, "K2/K3", flops.bwd_bound_s)
