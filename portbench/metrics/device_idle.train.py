"""device_idle.train: share of the profiled slice of whole steps that no
device operation covers, in percent."""


def read(ctx):
    trace = ctx.get("trace") if ctx else None
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
