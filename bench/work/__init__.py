"""Frozen operation and byte counts of the kernels' work and of the models,
and the card's published peaks (``peaks.json``)."""
