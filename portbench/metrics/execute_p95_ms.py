"""95th percentile of the host wall of each batch's
``ClusterEngine._execute`` (index upload, the MNs' pools, the byte
accounting, the tower and the scores' readback, which synchronises)."""
import numpy as np


def read(ctx):
    t = ctx.counters["execute_s"]
    if not t:
        return None
    return 1e3 * float(np.percentile(t, 95))
