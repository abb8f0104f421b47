"""MiCS core of the port: flat pools, topology, CommEngine, MiCSConfig."""
