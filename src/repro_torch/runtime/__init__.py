"""Serving runtime of the port (fixed-batch prefill + greedy decode)."""
