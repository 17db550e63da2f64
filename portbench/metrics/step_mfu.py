"""The whole step's share of the fp32 peak: the samples scored times the
tower's FLOPs a sample, over the traced window, in %."""
from portbench import counts


def read(ctx):
    if ctx.trace is None or ctx.peak is None or not ctx.counters["samples"]:
        return None
    flops = ctx.counters["samples"] * counts.tower_flops_per_sample(ctx.cfg)
    return 100.0 * flops / ctx.trace.window_s / ctx.peak["fp32_flops"]
