"""Kernel K3-bwd (csrc/cin_backward.cu), the CIN layers' gradient: 100 x its
least time over the traced steps (bench/work/counts.py k3_bwd: 4·M·K·N +
5·M·K FLOPs at the dense TF32 peak) / the device time of its kernels (its
pre-passes, data and weight products and their sums) in the trace."""

KERNELS = ("bwd_split_w_kernel", "bwd_split_g_kernel", "bwd_split_x_kernel",
           "bwd_data_kernel", "bwd_weight_kernel", "bwd_reduce_kernel")


def read(run):
    return run.roofline_share("k3bwd_bound_s", KERNELS)
