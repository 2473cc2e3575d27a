"""The plain reference of the fine-tuning step against the port's own step
on the CPU in float32 (its plain attention with the hashed dropout mask): at
a tiny size with every dropout and layer drop on, three steps give the same
losses, first gradients and parameters. This holds the reference's order of
random draws to the program's."""

import dataclasses

import numpy as np
import torch

from portbench.reference.training import reference_steps
from portbench.weights import make_weights

WAVLM = {"extractor_mode": "group_norm", "conv_layers": [[16, 10, 5], [16, 3, 2], [16, 2, 2]],
         "conv_bias": False, "embed_dim": 32, "pos_conv_kernel": 8, "pos_conv_groups": 4,
         "num_layers": 3, "use_attention": [True] * 3, "use_feed_forward": [True] * 3,
         "total_num_heads": [4] * 3, "remaining_heads": [[0, 1, 2, 3]] * 3,
         "num_buckets": 32, "max_distance": 64, "ff_interm_features": [24] * 3,
         "layer_norm_first": False, "normalize_waveform": False}
EEND = {"wavlm_layer_num": 4, "wavlm_feat_dim": 32, "attention_in": 16,
        "conformer_ffn_hidden": 24, "conformer_heads": 2, "conformer_layers": 2,
        "conformer_kernel": 5, "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2,
        "sample_rate": 16000}
TRAIN = {"seed": 3407, "lr_wavlm": 2e-3, "lr_other": 1e-2, "weight_decay": 0.01,
         "clip_percentile": 90.0, "projection_dropout": 0.1, "dropout": 0.1,
         "attention_dropout": 0.1, "layer_drop": 0.3, "feature_grad_mult": 0.1,
         "conformer_dropout": 0.1}
CFG = {"architecture": {"wavlm": WAVLM, "eend": EEND}, "weights": {"classifier_scale": 1.0},
       "train": TRAIN}


def test_three_steps_match_the_port():
    from diarizen_tpu_torch.models.conformer import ConformerConfig
    from diarizen_tpu_torch.models.eend import EendConfig, EendModel
    from diarizen_tpu_torch.models.wavlm import WavLMConfig
    from diarizen_tpu_torch.train import dual_lr_optimizer, train_step
    from diarizen_tpu_torch.train.step import create_train_state

    wavlm = dataclasses.replace(
        WavLMConfig.base(), embed_dim=32, conv_layers=tuple(map(tuple, WAVLM["conv_layers"])),
        pos_conv_kernel=8, pos_conv_groups=4, num_layers=3, use_attention=(True,) * 3,
        use_feed_forward=(True,) * 3, total_num_heads=(4,) * 3,
        remaining_heads=((0, 1, 2, 3),) * 3, num_buckets=32, max_distance=64,
        ff_interm_features=(24,) * 3, layer_drop=0.3)
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=16, ffn_hidden=24, num_heads=2,
                                                            num_layers=2, kernel_size=5),
                     wavlm_layer_num=4, wavlm_feat_dim=32, attention_in=16)
    model = EendModel(cfg)
    weights = make_weights(CFG, 2**31 + 9, "cpu")["segmentation"]
    model.load_state_dict(weights, strict=True)
    state = create_train_state(model, dual_lr_optimizer(model.param_groups(), lr_small=2e-3,
                                                        lr_big=1e-2), "cpu")
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    rng = np.random.default_rng(4)
    frames = cfg.num_frames(8000)
    batches = [{"xs": (0.1 * rng.standard_normal((3, 1, 8000))).astype(np.float32),
                "target": (rng.uniform(size=(3, frames, 4)) > 0.6).astype(np.uint8)}
               for _ in range(3)]
    losses, grads = [], None
    for batch in batches:
        losses.append(train_step(state, batch, 3407, torch.float32)["loss"])
        if grads is None:
            grads = {n: mu / 0.1 for n, mu in state.optimizer.state["mu"].items()}
    ref = reference_steps(CFG["architecture"], TRAIN, before, batches, 3407, "cpu")
    assert np.allclose(losses, ref["losses"], rtol=1e-5), (losses, ref["losses"])
    for n, g in ref["first_grads"].items():
        assert torch.allclose(grads[n], g, rtol=1e-3, atol=1e-6), n
    # Adam moves a leaf whose gradient is nought to rounding (a key bias under
    # softmax) by the rounding's sign alone: the rule on the reference's gradient
    norms = {n: g.norm().item() for n, g in ref["first_grads"].items()}
    median = float(np.median(list(norms.values())))
    counted = [n for n, v in norms.items() if v >= 1e-3 * median]
    assert not [n for n in counted if n.endswith(("k_proj.bias", "linearK.bias"))]
    for n in counted:
        assert torch.allclose(model.state_dict()[n], ref["params"][n], rtol=1e-4, atol=1e-6), n
