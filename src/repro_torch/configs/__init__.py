"""Configurations of the port (the paper's §5 setup)."""
