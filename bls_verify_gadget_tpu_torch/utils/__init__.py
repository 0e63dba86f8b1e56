"""Runtime configuration of the port (config.py)."""
