"""data_wait_ms_per_step.train: host milliseconds a step waited for its
batch (the benchmark's wrapper around the DataLoader's iterator), over the
steps of the untraced part of the window."""


def read(ctx):
    waits = ctx.get("data_wait_ms") if ctx else None
    if not waits:
        return None
    return sum(waits) / len(waits)
