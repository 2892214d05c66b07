"""The harness behind benchmark/run.py: clouds, weights, the closed loop,
the trace, the check."""
