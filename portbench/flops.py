"""Operations and bytes of the work, from the configuration's shapes alone:
the model FLOPs of a served file (what `mfu.serve` divides) and the least
time of a kernel launch (what a `<kernel>_roofline` divides). A
multiply-add is two operations. The count is the same whatever implements
the work; padding rows of a partial batch are not useful work and are not
counted.
"""

from __future__ import annotations

from portbench.reference.segmentation import powerset_mapping


def conv_stack_frames(arch: dict, samples: int) -> list:
    """Output length of each layer of WavLM's conv stack."""
    out, n = [], samples
    for _, kernel, stride in arch["wavlm"]["conv_layers"]:
        n = (n - kernel) // stride + 1
        out.append(n)
    return out


def segmentation_flops(arch: dict, samples: int, layers_run=None) -> int:
    """One window through WavLM, the weighted sum, the projection, the
    Conformer and the classifier; `layers_run`, where given, the WavLM
    layers computed (layer drop in training skips the others)."""
    w, e = arch["wavlm"], arch["eend"]
    macs, c_in = 0, 1
    lengths = conv_stack_frames(arch, samples)
    for (c, k, _), t_out in zip(w["conv_layers"], lengths):
        macs += t_out * k * c_in * c
        c_in = c
    t, d = lengths[-1], w["embed_dim"]
    hd = d // w["total_num_heads"][0]
    macs += t * c_in * d  # feature projection
    macs += t * w["pos_conv_kernel"] * d * (d // w["pos_conv_groups"])  # positional conv
    for i in range(w["num_layers"]):
        if layers_run is not None and i not in layers_run:
            continue
        if w["use_attention"][i]:
            inner = len(w["remaining_heads"][i]) * hd
            macs += 4 * t * d * inner  # q, k, v, out projections
            macs += t * w["total_num_heads"][i] * hd * 8  # the GRU gate's linear
            macs += 2 * t * t * inner  # scores and weights times values
        if w["use_feed_forward"][i]:
            macs += 2 * t * d * w["ff_interm_features"][i]
    a, ffn = e["attention_in"], e["conformer_ffn_hidden"]
    macs += e["wavlm_layer_num"] * t * d  # the weighted sum
    macs += t * e["wavlm_feat_dim"] * a  # projection to the Conformer
    per_block = (4 * t * a * ffn  # two macaron feed-forwards
                 + 4 * t * a * a + 2 * t * t * a  # self-attention
                 + t * a * 2 * a + t * a * e["conformer_kernel"] + t * a * a)  # conv module
    macs += e["conformer_layers"] * per_block
    classes = len(powerset_mapping(e["max_speakers_per_chunk"], e["max_speakers_per_frame"]))
    macs += t * a * classes
    return 2 * macs


def fbank_flops(samples: int) -> int:
    """Kaldi fbank of `samples`: the 512-point DFT of 400 samples as two
    (400, 257) products, the power and the (257, 80) mel product."""
    frames = 0 if samples < 400 else 1 + (samples - 400) // 160
    return 2 * frames * (2 * 400 * 257 + 257 * 80)


def resnet_flops(arch: dict, fbank_frames: int, speakers: int) -> int:
    """One window's fbank through the ResNet34, pooled for `speakers`
    weight rows, and the linear head for each."""
    r = arch["resnet"]
    m, h, t = r["m_channels"], r["feat_dim"], fbank_frames
    macs, c_in = h * t * 9 * m, m  # conv1
    for li, blocks in enumerate(r["num_blocks"], start=1):
        c = m * 2 ** (li - 1)
        for bi in range(blocks):
            if li > 1 and bi == 0:
                h, t = (h - 1) // 2 + 1, (t - 1) // 2 + 1
                macs += h * t * c_in * c  # the 1x1 shortcut
            macs += h * t * 9 * c_in * c + h * t * 9 * c * c
            c_in = c
    stats = c_in * h
    macs += speakers * 2 * stats * t  # weighted mean and variance
    macs += speakers * 2 * stats * r["embed_dim"]
    return 2 * macs


def file_flops(arch: dict, chunks: int, samples: int, window: int, speakers: int) -> int:
    """A served file of `samples` in `chunks` windows of `window` samples:
    segmentation and embedding of every window, and the file's fbank."""
    fb_frames = 0 if window < 400 else 1 + (window - 400) // 160
    return (chunks * (segmentation_flops(arch, window) + resnet_flops(arch, fb_frames, speakers))
            + fbank_flops(samples))


def train_step_flops(arch: dict, batch: int, samples: int, layers_run) -> int:
    """One training step: the forward of `batch` windows and twice that for
    the backward, every part being trained."""
    return 3 * batch * segmentation_flops(arch, samples, layers_run)


def attention_bound_s(b: int, h: int, t: int, d: int, itemsize: int, peaks: dict) -> float:
    """K1's least time for one launch: q, k, v read and o written once, the
    (H, T, T) bias read once, the float32 gate read once; two T x T x D
    products. The larger of bytes over the HBM rate and operations over the
    bf16 dense peak."""
    moved = 4 * b * h * t * d * itemsize + h * t * t * itemsize + b * h * t * 4
    ops = 4 * b * h * t * t * d
    return max(moved / peaks["hbm_bytes_per_s"], ops / peaks["bf16_flop_per_s"])


def attention_backward_bound_s(b: int, h: int, t: int, d: int, itemsize: int,
                               peaks: dict) -> float:
    """K2's least time for one backward of the attention: q, k, v and dO read
    (not o), dq, dk, dv written, the bias read, d pos_bias written in
    float32, the gate and the log-sum-exp read and dgate written (float32);
    five T x T x D products. The larger of the two bounds."""
    act, bias, row = b * h * t * d * itemsize, h * t * t, b * h * t * 4
    moved = 7 * act + bias * itemsize + bias * 4 + 3 * row
    ops = 10 * b * h * t * t * d
    return max(moved / peaks["hbm_bytes_per_s"], ops / peaks["bf16_flop_per_s"])
