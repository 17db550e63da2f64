"""Host milliseconds a batch outside ``ClusterEngine._execute``: the
dispatcher's batching, assembly, routing and clock work, and the serve
calls' own set-up, over the window's batches."""


def read(ctx):
    c = ctx.counters
    if not c["batches"] or not c["execute_s"]:
        return None
    return 1e3 * (c["window_s"] - sum(c["execute_s"])) / c["batches"]
