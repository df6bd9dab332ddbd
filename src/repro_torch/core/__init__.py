"""Planning copied from ``repro.core``: shape palette, cost model, DP
splitter, schedules, simulator, comm plan, recompute, planner, the
threaded pipeline executor, and the baselines the paper compares against
(``packing``: MLM+DS packing, token-based and fixed-size micro-batching)."""
