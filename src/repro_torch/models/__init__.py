"""Model assembly of the port (dense family)."""
