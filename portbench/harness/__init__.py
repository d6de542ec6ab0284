"""The benchmark's harness: cells resolved by name (spec), the run
(run_cell), the profiled slice (trace) and the check (correct)."""
