"""Model assembly of the port (dense and griffin families)."""
