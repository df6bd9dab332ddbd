"""Planning copied from ``repro.core``: shape palette, cost model, DP
splitter, schedules, simulator, comm plan, recompute, planner and the
threaded pipeline executor."""
