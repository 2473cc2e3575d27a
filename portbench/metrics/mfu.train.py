"""mfu.train: model FLOPs of the steps of the untraced part of a
`--trace 1` window (the forward of the layers each step computed, and twice
that for the backward, every part trained; portbench/flops.py) over that
part's seconds times the bf16 dense peak, in percent."""


def read(ctx):
    if not ctx or ctx.get("untraced_seconds", 0) <= 0 or not ctx.get("untraced_flops"):
        return None
    return 100.0 * ctx["untraced_flops"] / (ctx["untraced_seconds"] * ctx["peaks"]["bf16_flop_per_s"])
