"""Shared by the bag kernels' rooflines: the bytes bound of the window's
launches of one kernel over their device time, in %."""
from portbench import counts


def roofline(ctx, pool_kind: str, kernel: str):
    k = ctx.counters["bag"].get(pool_kind)
    if ctx.trace is None or ctx.peak is None or not k or not k["calls"]:
        return None
    t = ctx.trace.device_s(lambda name: kernel in name)
    if t <= 0:
        return None
    b = counts.bag_bytes(k["valid"], k["index_slots"], k["bags"],
                         k["tables"], ctx.cfg["embed_dim"])
    return 100.0 * b / ctx.peak["hbm_bytes_per_s"] / t
