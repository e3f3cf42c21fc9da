"""Plain PyTorch references of the benchmark's models, float32 with TF32 off
unless the caller turns it on (the control).  They import nothing of the
port and take nothing the port made."""
