"""device_idle.serve: share of the profiled slice's wall time that no
device operation covers (the union of kernel, copy and set intervals on the
device timeline), in percent."""


def read(ctx):
    trace = ctx.get("trace") if ctx else None
    if trace is None or trace.window_s <= 0 or not trace.kernels:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
