"""Share of the traced window with no kernel, copy or set on the device."""


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.ops:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)
