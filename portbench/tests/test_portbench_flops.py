"""The operation and byte counts against values worked by hand at one
small shape."""

import pytest

from portbench import core, flops

ARCH = {
    "wavlm": {"conv_layers": [[4, 10, 5], [4, 3, 2]], "embed_dim": 8, "total_num_heads": [2],
              "remaining_heads": [[0]], "use_attention": [True], "use_feed_forward": [True],
              "ff_interm_features": [16], "pos_conv_kernel": 4, "pos_conv_groups": 2,
              "num_layers": 1},
    "eend": {"wavlm_layer_num": 2, "wavlm_feat_dim": 8, "attention_in": 4,
             "conformer_ffn_hidden": 8, "conformer_layers": 1, "conformer_kernel": 3,
             "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2},
    "resnet": {"m_channels": 2, "num_blocks": [1, 1, 1, 1], "feat_dim": 16, "embed_dim": 4},
}
PEAKS = {"hbm_bytes_per_s": 3.35e12, "bf16_flop_per_s": 989e12}


def test_segmentation_flops_by_hand():
    # 100 samples -> 19 -> 9 frames; multiply-adds: convs 760 + 432, projection 288,
    # pos-conv 1152, q k v o 1152, gate 576, scores and values 648, feed-forward 2304,
    # weighted sum 144, projection 288, Conformer block 2916, classifier 396
    assert flops.segmentation_flops(ARCH, 100) == 2 * 11056


def test_resnet_and_fbank_flops_by_hand():
    # 16 mels x 10 frames: conv1 2880, stage 1 11520, stage 2 8960, stage 3 10752,
    # stage 4 14336, pooling for 2 speakers 256, head 512 multiply-adds
    assert flops.resnet_flops(ARCH, 10, 2) == 2 * 49216
    assert flops.fbank_flops(800) == 2 * 3 * (2 * 400 * 257 + 257 * 80)
    assert flops.fbank_flops(399) == 0


def test_attention_bound_by_hand():
    # B 2, H 3, T 10, D 8, bf16: 3840 bytes of q k v o, 600 of bias, 240 of gate
    assert flops.attention_bound_s(2, 3, 10, 8, 2, PEAKS) == pytest.approx(4680 / 3.35e12)
    # a compute-bound shape: T 4096, D 128
    ops = 4 * 1 * 1 * 4096 * 4096 * 128
    moved = 4 * 4096 * 128 * 2 + 4096 * 4096 * 2 + 4096 * 4
    assert flops.attention_bound_s(1, 1, 4096, 128, 2, PEAKS) == pytest.approx(
        max(ops / 989e12, moved / 3.35e12))


def test_k1_launch_shapes_from_grid():
    batches = core.load_module(core.BENCH / "metrics" / "k1_roofline.serve.py", "k1_reader").batches
    heads = [2, 3, 1]
    # a slice that starts at the second layer of a batch of 4, then a batch of 8
    products = [12, 4, 16, 24, 8]
    assert batches(products, heads) == [(4, 3), (4, 1), (8, 2), (8, 3), (8, 1)]
    assert batches([5, 7], heads) is None
