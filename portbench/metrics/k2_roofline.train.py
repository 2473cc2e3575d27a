"""k2_roofline.train: K2's least time over its device time in the profiled
slice, in percent. K2's launches (pass A, the sum of its slices, pass B)
are found by the name patterns of portbench/kernels/k2.json; each pass-B
launch is one backward, whose grid's first axis holds batch x heads; the
heads are the configuration's (every attention layer of the trained model
has the same count here, checked). The least time of a backward is the
larger of its bytes over the HBM rate and its operations over the bf16
peak (portbench/flops.py)."""

from portbench import core, flops


def read(ctx):
    trace = ctx.get("trace") if ctx else None
    if trace is None:
        return None
    spec = core.kernel_spec("k2")
    launches = trace.matching(spec["patterns"])
    calls = [k for k in launches if spec["calls"] in k[0]]
    if not calls or any(k[3] is None for k in calls):
        return None
    w = ctx["config"]["architecture"]["wavlm"]
    heads = {len(h) for h, on in zip(w["remaining_heads"], w["use_attention"]) if on}
    if len(heads) != 1:
        return None
    h = heads.pop()
    bound = getattr(flops, spec["bound"])
    least = sum(bound(k[3][spec["grid_rows_axis"]] // h, h, ctx["frames"], spec["head_dim"],
                      spec["itemsize"], ctx["peaks"]) for k in calls)
    spent = sum(end - start for _, start, end, _ in launches)
    return 100.0 * least / spent if spent > 0 else None
