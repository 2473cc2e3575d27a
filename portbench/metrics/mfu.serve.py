"""mfu.serve: model FLOPs of the files completed in the untraced part of
a `--trace 1` window, over that part's seconds times the bf16 dense peak,
in percent. The FLOPs are counted from the configuration's shapes
(portbench/flops.py), whatever implements them."""


def read(ctx):
    if not ctx or ctx.get("untraced_seconds", 0) <= 0 or not ctx.get("untraced_flops"):
        return None
    peak = ctx["peaks"]["bf16_flop_per_s"]
    return 100.0 * ctx["untraced_flops"] / (ctx["untraced_seconds"] * peak)
