"""Kernel K3 (csrc/cin.cu), the CIN layers' forward, in the bulk cell: 100 x
its least time over the traced work (bench/work/counts.py k3: 2·M·K·N FLOPs
at the dense TF32 peak, a weight read once a unit of work) / the device
time of its kernels (the layer, its weight pre-pass and the sum of a split
reduction) in the trace."""

KERNELS = ("cin_layer_kernel", "cin_split_w_kernel", "cin_reduce_kernel")


def read(run):
    return run.roofline_share("k3_bound_s", KERNELS)
