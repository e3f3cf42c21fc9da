"""Kernel K1 (csrc/embedding_bag.cu), forward: 100 x its least time over the
traced passes (bench/work/counts.py k1: each distinct (table, row) of a
pass read once, the ids read and the pooled rows written) / its device
time in the trace."""

KERNELS = ("embedding_bag_kernel",)


def read(run):
    return run.roofline_share("k1_bound_s", KERNELS)
