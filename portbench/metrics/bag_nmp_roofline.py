"""The near-memory bag (``nmp_flat_kernel``, NMP MNs' shards) against its
bytes bound at the HBM peak."""
from portbench.metrics._bag import roofline


def read(ctx):
    return roofline(ctx, "nmp", "nmp_flat_kernel")
