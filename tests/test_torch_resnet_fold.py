"""The ResNet's folded, channels-last trunk (`models/resnet.py`) on the CPU:
against the unfolded formula written out here, the fold's cache and its
count in the launch registry, the stem's plain version (`ops/resnet_stem.py`),
and `stats_pool` on (B, D, T) features as `models/xvector.py` calls it.
Imports nothing of JAX."""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig, stats_pool
from diarizen_tpu_torch.ops import cuda_build
from diarizen_tpu_torch.ops.resnet_stem import stem_conv
from diarizen_tpu_torch.utils import state_stamp

TOL = dict(rtol=1e-4, atol=1e-5)  # float32: the fold reassociates w * s


def seeded_resnet(cfg: ResNetConfig, seed: int = 1) -> ResNet:
    """Seeded weights, every BatchNorm's statistics and affine parameters
    off the identity."""
    model = ResNet(cfg)
    sd = random_state_dict(model, seed)
    rng = np.random.default_rng(seed + 100)
    for key in sd:
        n = sd[key].shape[0] if sd[key].dim() else 0
        if key.endswith("running_var"):
            sd[key] = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
        elif key.endswith("running_mean"):
            sd[key] = torch.tensor(0.1 * rng.standard_normal(n), dtype=torch.float32)
        elif ("bn" in key or "shortcut.1" in key) and key.endswith("weight"):
            sd[key] = torch.tensor(rng.uniform(0.5, 1.5, n), dtype=torch.float32)
        elif ("bn" in key or "shortcut.1" in key or key.startswith("seg_")) and key.endswith("bias"):
            sd[key] = torch.tensor(0.1 * rng.standard_normal(n), dtype=torch.float32)
    model.load_state_dict(sd)
    return model.eval()


def batch_norm(bn, x):
    return ((x - bn.running_mean[:, None, None]) / torch.sqrt(bn.running_var[:, None, None] + bn.eps)
            * bn.weight[:, None, None] + bn.bias[:, None, None])


def unfolded_forward(model: ResNet, fbank: torch.Tensor, weights) -> torch.Tensor:
    """WeSpeaker's ResNet as written: channels first, each convolution then
    its BatchNorm on the running statistics, the ReLUs and residual adds on
    their own."""
    def conv(c, x):
        return F.conv2d(x, c.weight, stride=c.stride, padding=c.padding)

    x = torch.relu(batch_norm(model.bn1, conv(model.conv1, fbank.transpose(1, 2)[:, None])))
    for block in model.blocks():
        out = torch.relu(batch_norm(block.bn1, conv(block.conv1, x)))
        out = batch_norm(block.bn2, conv(block.conv2, out))
        if len(block.shortcut):
            x = batch_norm(block.shortcut[1], conv(block.shortcut[0], x))
        x = torch.relu(out + x)
    b, c, h, w = x.shape
    emb = F.linear(stats_pool(x.reshape(b, c * h, w), weights), model.seg_1.weight,
                   model.seg_1.bias)
    if not model.cfg.two_emb_layer:
        return emb
    bn = model.seg_bn_1
    out = (torch.relu(emb) - bn.running_mean) / torch.sqrt(bn.running_var + bn.eps)
    return F.linear(out, model.seg_2.weight, model.seg_2.bias)


def fbank_and_weights(model: ResNet, rows: int = 3, frames: int = 101, seed: int = 0):
    gen = torch.Generator().manual_seed(seed)
    fbank = torch.randn((rows, frames, model.cfg.feat_dim), generator=gen)
    t_out = model.cfg.num_frames(160 * (frames - 1) + 400)
    weights = (torch.rand((rows, 2, t_out), generator=gen) < 0.6).float()
    return fbank, weights


@pytest.mark.parametrize("num_blocks", [(1, 1, 1, 1), (2, 1, 2, 1)],
                         ids=["projection-shortcuts", "identity-shortcuts-too"])
@pytest.mark.parametrize("two_emb_layer", [False, True])
@pytest.mark.parametrize("with_weights", [True, False])
def test_folded_trunk_matches_the_unfolded_formula(num_blocks, two_emb_layer, with_weights):
    model = seeded_resnet(ResNetConfig(m_channels=4, num_blocks=num_blocks, embed_dim=16,
                                       two_emb_layer=two_emb_layer))
    fbank, weights = fbank_and_weights(model)
    weights = weights if with_weights else None
    with torch.inference_mode():
        got = model(fbank, weights)
        want = unfolded_forward(model, fbank, weights)
    assert got.shape == want.shape == ((3, 2, 16) if with_weights else (3, 16))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


def test_the_fold_is_cached_and_outside_the_stamp():
    """One fold a parameter state and compute type: the same tensors come
    back, the registry counts it once, and the stamp the inference objects
    read (`state_stamp`) does not see the cache."""
    model = seeded_resnet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1), embed_dim=8))
    stamp = state_stamp(model)
    assert len(stamp) == len(list(model.parameters()) + list(model.buffers()))
    before = cuda_build.launches["resnet_fold"]
    first = model.folded(torch.float32)
    assert model.folded(torch.float32) is first
    assert cuda_build.launches["resnet_fold"] == before + 1
    model(*fbank_and_weights(model))
    assert cuda_build.launches["resnet_fold"] == before + 1
    assert state_stamp(model) == stamp
    stem, blocks = first
    assert len(blocks) == 4 and stem.weight.dtype == torch.float32
    assert all(w.is_contiguous(memory_format=torch.channels_last)
               for conv in [stem, *(c for block in blocks for c in block if c is not None)]
               for w in [conv.weight])
    # the projection's bias rides on conv2's: it runs with none
    assert all(block[2] is not None and block[2].bias is None for block in blocks[1:])
    bf16 = model.folded(torch.bfloat16)
    assert bf16[0].weight.dtype == torch.bfloat16
    assert cuda_build.launches["resnet_fold"] == before + 2
    assert model.folded(torch.float32) is first


@pytest.mark.parametrize("change", ["running_var in place", "load_state_dict"])
def test_a_new_parameter_state_refolds(change):
    """A statistic changed in place and a new state dict each change the
    next call's output, with one more fold each."""
    model = seeded_resnet(ResNetConfig(m_channels=4, num_blocks=(1, 2, 1, 1), embed_dim=8))
    fbank, weights = fbank_and_weights(model)
    with torch.inference_mode():
        old = model(fbank, weights)
    folds = cuda_build.launches["resnet_fold"]
    with torch.no_grad():
        if change == "load_state_dict":
            model.load_state_dict(seeded_resnet(model.cfg, seed=7).state_dict())
        else:
            model.layer2[0].bn1.running_var.mul_(3.0)
    with torch.inference_mode():
        new = model(fbank, weights)
        again = model(fbank, weights)
        want = unfolded_forward(model, fbank, weights)
    assert cuda_build.launches["resnet_fold"] == folds + 1
    assert not torch.allclose(new, old, rtol=1e-3, atol=1e-4)
    assert torch.equal(new, again)
    np.testing.assert_allclose(new.numpy(), want.numpy(), **TOL)


def test_a_resnet_converted_in_inference_mode_folds_once():
    """Parameters made inside `torch.inference_mode` (a model moved or
    converted there) have no version counter: the stamp reads their
    addresses, the forward runs, and it folds once for the new tensors."""
    model = seeded_resnet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1), embed_dim=8))
    fbank, weights = fbank_and_weights(model)
    with torch.inference_mode():
        want = model(fbank, weights)
        model = model.double().float()
        assert model.conv1.weight.is_inference()
        folds = cuda_build.launches["resnet_fold"]
        got = model(fbank, weights)
        assert torch.equal(model(fbank, weights), got)
    assert cuda_build.launches["resnet_fold"] == folds + 1
    assert torch.equal(got, want)


@pytest.mark.parametrize("channels", [4, 32])
def test_stem_plain_version_is_the_transposed_image_convolution(channels):
    """The stem off CUDA: the (B, T, F) fbank as the one-channel image
    (B, 1, F, T), channels-last out."""
    gen = torch.Generator().manual_seed(channels)
    fbank = torch.randn((2, 37, 80), generator=gen)
    weight = torch.randn((channels, 1, 3, 3), generator=gen)
    bias = torch.randn((channels,), generator=gen)
    got = stem_conv(fbank, weight, bias)
    want = torch.relu(F.conv2d(fbank.transpose(1, 2)[:, None], weight, bias, padding=1))
    assert got.shape == (2, channels, 80, 37)
    assert got.is_contiguous(memory_format=torch.channels_last)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5, atol=1e-5)


def plain_stats(features: np.ndarray, weights) -> np.ndarray:
    """Weighted mean and unbiased std over the last axis, in float64."""
    f = features.astype(np.float64)
    if weights is None:
        return np.concatenate([f.mean(-1), f.std(-1, ddof=1)], -1)
    w = weights.astype(np.float64)
    if w.shape[-1] != f.shape[-1]:  # nearest, as F.interpolate
        w = w[..., np.floor(np.arange(f.shape[-1]) * (w.shape[-1] / f.shape[-1])).astype(int)]
    squeeze = w.ndim == 2
    w = w[:, None] if squeeze else w
    out = []
    for b in range(f.shape[0]):
        rows = []
        for ws in w[b]:
            v1 = ws.sum() + 1e-8
            mean = (f[b] * ws).sum(-1) / v1
            var = ((f[b] - mean[:, None]) ** 2 * ws).sum(-1) / (v1 - (ws ** 2).sum() / v1 + 1e-8)
            rows.append(np.concatenate([mean, np.sqrt(np.maximum(var, 0.0))]))
        out.append(rows)
    out = np.asarray(out)
    return out[:, 0] if squeeze else out


@pytest.mark.parametrize("weights_shape", [None, (3, 40), (3, 2, 40), (3, 2, 17)],
                         ids=["unweighted", "one-row", "speaker-rows", "interpolated"])
def test_stats_pool_on_channel_first_features(weights_shape):
    """(B, D, T) features, as the x-vector head passes them: the plain
    formula's means and unbiased standard deviations."""
    rng = np.random.default_rng(5)
    features = rng.standard_normal((3, 6, 40)).astype(np.float32)
    weights = None if weights_shape is None else (
        rng.uniform(size=weights_shape) > 0.4).astype(np.float32)
    if weights is not None:
        weights[0, ..., :3] = 1.0  # every row weighs something
    got = stats_pool(torch.from_numpy(features),
                     None if weights is None else torch.from_numpy(weights))
    np.testing.assert_allclose(got.numpy(), plain_stats(features, weights), rtol=1e-5, atol=1e-5)
