from repro_torch.roofline import analysis  # noqa: F401
