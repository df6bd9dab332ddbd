"""Planning copied from ``repro.core``: shape palette, cost model, DP splitter."""
