"""Device milliseconds of host-to-device copies a batch, from the trace."""


def read(ctx):
    c = ctx.counters
    if ctx.trace is None or not c["batches"]:
        return None
    t = ctx.trace.device_s(lambda name: "HtoD" in name)
    return 1e3 * t / c["batches"] if t > 0 else None
