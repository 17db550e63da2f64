"""The dense tower against its roofline: max(FLOPs / fp32 peak, bytes /
HBM peak) of the window's ``dense_forward`` calls over the device time of
the operations launched inside their spans, in %."""
from portbench import counts


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or ctx.peak is None or not c["dense_calls"]:
        return None
    t = ctx.trace.launched_in_s("portbench.dense_forward")
    if t <= 0:
        return None
    B = c["batch_size"]
    flops = c["dense_calls"] * B * counts.tower_flops_per_sample(ctx.cfg)
    nbytes = c["dense_calls"] * counts.tower_bytes(ctx.cfg, B)
    bound = max(flops / ctx.peak["fp32_flops"],
                nbytes / ctx.peak["hbm_bytes_per_s"])
    return 100.0 * bound / t
