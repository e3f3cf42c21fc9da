"""Synthetic request data for the port (numpy, on the host)."""
