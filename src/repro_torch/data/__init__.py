"""Data copied from ``repro.data``: the synthetic multi-task requests, the
deterministic training streams and micro-batch materialisation."""
