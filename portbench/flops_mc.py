"""Model FLOPs of a multi-channel served file (what `mfu.serve` divides in
the multi-channel cell), from the configuration's shapes alone, counted as
`flops.py` counts the single-channel model: a multiply-add is two
operations, padding rows are not work.

A window of C channels and N fusions: every channel's stream through the
extractor, the feature projection, the positional convolution and WavLM
layers 0..N-1; the N cross-channel attentions at every frame; one stream
through the remaining layers, the weighted sum, the Conformer and the head;
the ResNet34 on every (window, channel) and the channels' embeddings summed
under their weights; each channel's fbank over the file.
"""

from __future__ import annotations

from portbench.flops import conv_stack_frames, fbank_flops, resnet_flops, segmentation_flops


def stream_front_flops(arch: dict, samples: int) -> int:
    """One stream of a window through the extractor, the feature projection
    and the positional convolution."""
    w = arch["wavlm"]
    macs, c_in = 0, 1
    lengths = conv_stack_frames(arch, samples)
    for (c, k, _), t_out in zip(w["conv_layers"], lengths):
        macs += t_out * k * c_in * c
        c_in = c
    t, d = lengths[-1], w["embed_dim"]
    macs += t * c_in * d  # feature projection
    macs += t * w["pos_conv_kernel"] * d * (d // w["pos_conv_groups"])  # positional conv
    return 2 * macs


def layers_flops(arch: dict, samples: int, layers) -> int:
    """One stream of a window through the WavLM layers `layers`."""
    return (segmentation_flops(arch, samples, layers_run=list(layers))
            - segmentation_flops(arch, samples, layers_run=[]))


def fusion_flops(arch: dict, samples: int, channels: int) -> int:
    """One cross-channel attention over a window's C streams: q, k, v and
    out products at every (frame, channel), scores and weights times values
    across the channels in each head."""
    d, fusion = arch["wavlm"]["embed_dim"], arch["fusion"]
    hidden = fusion["hidden"]
    t = conv_stack_frames(arch, samples)[-1]
    macs = t * channels * 4 * d * hidden  # linearQ, linearK, linearV, linearO
    macs += t * 2 * channels * channels * hidden  # scores, weights x values (all heads)
    return 2 * macs


def mc_segmentation_flops(arch: dict, samples: int, channels: int) -> int:
    """One window of `channels` channels through the multi-channel model."""
    fusions = arch["fusion"]["num_fusion_layers"]
    layers = arch["wavlm"]["num_layers"]
    front = stream_front_flops(arch, samples)
    # the single-stream model without its layers is the front and the back end
    back = segmentation_flops(arch, samples, layers_run=[]) - front
    return (channels * (front + layers_flops(arch, samples, range(fusions)))
            + fusions * fusion_flops(arch, samples, channels)
            + layers_flops(arch, samples, range(fusions, layers)) + back)


def mc_file_flops(arch: dict, chunks: int, samples: int, window: int, speakers: int,
                  channels: int) -> int:
    """A served (channels, samples) file in `chunks` windows of `window`
    samples: the segmentation of every window, the ResNet34 of every
    (window, channel) with the weighted sum of the channels' embeddings,
    and each channel's fbank of the file."""
    fb_frames = 0 if window < 400 else 1 + (window - 400) // 160
    fuse_embeddings = 2 * channels * speakers * arch["resnet"]["embed_dim"]
    return (chunks * (mc_segmentation_flops(arch, window, channels)
                      + channels * resnet_flops(arch, fb_frames, speakers) + fuse_embeddings)
            + channels * fbank_flops(samples))
