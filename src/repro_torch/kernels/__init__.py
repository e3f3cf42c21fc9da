"""Hand-written CUDA kernels (sources in ``../csrc``), their ctypes
bindings, their plain PyTorch versions (``ref``) and the public wrappers
(``ops``)."""
