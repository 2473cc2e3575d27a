"""k1_roofline.serve: K1's least time over its device time in the profiled
slice, in percent. K1's launches are found by the name patterns of
portbench/kernels/k1.json. A launch's grid holds (query tiles, batch x
heads); the heads of each launch follow the configuration's attention
layers in order, one launch a layer a batch, which fixes the batch of every
launch. The least time of a launch is the larger of its bytes over the HBM
rate and its operations over the bf16 peak (portbench/flops.py)."""

from portbench import core, flops


def layer_heads(arch):
    w = arch["wavlm"]
    return [len(h) for h, on in zip(w["remaining_heads"], w["use_attention"]) if on and h]


def batches(products, heads):
    """The batch of each launch, from the launches' batch x heads in order
    and the heads of the layers in order; None where no phase fits."""
    n = len(heads)
    for phase in range(n):
        found, ok = [], True
        for i, p in enumerate(products):
            h = heads[(i + phase) % n]
            if p % h:
                ok = False
                break
            found.append(p // h)
        if not ok:
            continue
        groups = {}
        for i, b in enumerate(found):
            groups.setdefault((i + phase) // n, set()).add(b)
        if all(len(g) == 1 for g in groups.values()):
            return [(b, heads[(i + phase) % n]) for i, b in enumerate(found)]
    return None


def read(ctx):
    trace = ctx.get("trace") if ctx else None
    if trace is None:
        return None
    spec = core.kernel_spec("k1")
    launches = trace.matching(spec["patterns"])
    if not launches or any(k[3] is None for k in launches):
        return None
    shapes = batches([k[3][spec["grid_rows_axis"]] for k in launches],
                     layer_heads(ctx["config"]["architecture"]))
    if shapes is None:
        return None
    t = ctx["layout"].frames
    bound = getattr(flops, spec["bound"])
    least = sum(bound(b, h, t, spec["head_dim"], spec["itemsize"], ctx["peaks"])
                for b, h in shapes)
    spent = sum(end - start for _, start, end, _ in launches)
    return 100.0 * least / spent if spent > 0 else None
