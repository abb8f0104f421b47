"""Roofline inputs and synthesis of the port (``op_stats``, ``analysis``)."""
