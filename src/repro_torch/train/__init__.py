"""Training: optimisers, microbatching, checkpoints, the loop and gradient
compression, over the port's parameter trees."""
from repro_torch.train import checkpoint, grad_compress, loop, optim  # noqa: F401
