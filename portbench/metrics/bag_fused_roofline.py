"""The CN-side fused bag (``fused_flat_kernel``, DDR MNs' shards) against
its bytes bound at the HBM peak."""
from portbench.metrics._bag import roofline


def read(ctx):
    return roofline(ctx, "ddr", "fused_flat_kernel")
