"""Samples scored over the batches' slots (batches as the engine counts
them, ``ClusterEngine.batches_seen``, times the batch size), in %."""


def read(ctx):
    c = ctx.counters
    if not c["batches"]:
        return None
    return 100.0 * c["samples"] / (c["batches"] * c["batch_size"])
