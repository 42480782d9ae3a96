"""The harness of perfbench/run.py: the traffic generator (gen), the
window and the result (cell), the spans around the port's layers
(spans), the trace's reduction (trace), the roofline yardstick (cost),
the check against the plain reference (check, reference/) and the
benchmark's files found by name (spec)."""
