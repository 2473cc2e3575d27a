"""The port's other model families against the JAX package on the CPU, in
float32 on the same seeded inputs, with the JAX parameters carried across by
`models/convert.py`: the Fbank + Conformer EEND and its fbank, the
SincNet-BiLSTM baseline, SSeRiouSS (the eval-time weighted sum in WavLM's
layer loop, also through K4's plain version, and one chosen layer), the x-vector with its MFCC and SincNet
front ends, with and without pooling weights; every JAX leaf lands in the
port by a strict load; the frame grid of each family; the train step's
loss and gradients of the two EEND families at dropout 0 against the JAX
package's `make_train_step`; SSeRiouSS's frozen trunk (no gradient reaches
WavLM, the layer weights and the head get JAX's); and `adamw_torch_args`
against optax's AdamW."""

import dataclasses

import numpy as np
import optax
import pytest
import torch
import torch.nn.functional as F

import jax
import jax.numpy as jnp

from diarizen_tpu.infer.sliding import receptive_field_window as jax_receptive_field_window
from diarizen_tpu.models import fbank_eend as jax_fbank
from diarizen_tpu.models import sincnet_eend as jax_sincnet
from diarizen_tpu.models import sserious as jax_sserious
from diarizen_tpu.models import xvector as jax_xvector
from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.train.loss import segmentation_loss as jax_segmentation_loss
from diarizen_tpu.train.step import create_train_state as jax_create_train_state
from diarizen_tpu.train.step import make_train_step
from diarizen_tpu_torch import config
from diarizen_tpu_torch.infer.sliding import receptive_field_window
from diarizen_tpu_torch.models import convert
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models import sincnet_eend
from diarizen_tpu_torch.models.fbank_eend import FbankEendConfig, FbankEendModel, speechbrain_fbank
from diarizen_tpu_torch.models.forward import segmentation_forward
from diarizen_tpu_torch.models.sincnet_eend import SincNetEendConfig, SincNetEendModel
from diarizen_tpu_torch.models.sserious import SSeRiouSSConfig, SSeRiouSSModel
from diarizen_tpu_torch.models import wavlm as wavlm_module
from diarizen_tpu_torch.models.wavlm import WavLMConfig, set_fused_ln
from diarizen_tpu_torch.models.xvector import XVectorConfig, XVectorModel, mfcc
from diarizen_tpu_torch.train import TrainState, train_step
from diarizen_tpu_torch.ops.fused_ln import residual_ln_acc
from diarizen_tpu_torch.train.optim import adamw_torch_args

from test_torch_mc_training import CaptureGrads, capture_transform

SR = 16000
# gradients that are zero in exact arithmetic, rounding noise on both sides:
# attention key biases (softmax ignores a per-row shift), the depthwise-conv
# bias before a BatchNorm on batch statistics, and SincNet's conv biases
# (a per-channel shift through the max-pool, taken out by the instance norm)
NULL_GRADIENT = ("linearK.bias", "depthwise_conv.bias", "sincnet.conv1d.1.bias",
                 "sincnet.conv1d.2.bias")


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def tiny_wavlm(n=2):
    return JaxWavLMConfig(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), embed_dim=64, num_layers=n,
        use_attention=(True,) * n, use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=(tuple(range(4)),) * n, ff_interm_features=(48,) * n, num_buckets=40,
        max_distance=100, layer_drop=0.0, dropout=0.0, attention_dropout=0.0,
        projection_dropout=0.0)


def perturbed(params, seed):
    """The params with every vector moved off its init (norms off 1, biases
    off 0), so that no term vanishes."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(np.shape(x)).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), params)


def port_cfg(jax_cfg, cls):
    """The port's config of the same fields (nested configs converted)."""
    fields = {f.name: getattr(jax_cfg, f.name) for f in dataclasses.fields(jax_cfg)}
    if "conformer" in fields:
        fields["conformer"] = ConformerConfig(**dataclasses.asdict(jax_cfg.conformer))
    if "wavlm" in fields:
        fields["wavlm"] = WavLMConfig(**dataclasses.asdict(jax_cfg.wavlm))
    return cls(**fields)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """Two torch threads for this module: the suite runs several workers on
    the same cores, where more threads contend and run far slower."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def families():
    """{name: (JAX config, params, state, port model, JAX scores of
    `waves(0)`)}: Fbank + Conformer (1 x 32), SincNet-BiLSTM (2 x 16),
    SSeRiouSS (tiny WavLM, 2 x 16) with the weighted sum and with layer 1,
    all at dropout 0. The JAX functions run jitted, once each."""
    out = {}
    wave = jnp.asarray(waves(0))
    jcfg = jax_fbank.FbankEendConfig(
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1,
                                     dropout=0.0), attention_in=32, chunk_size=1.0)
    params, state = jax.jit(lambda k: jax_fbank.init_fbank_eend_params(k, jcfg))(
        jax.random.PRNGKey(0))
    params, state = perturbed(params, 1), np_tree(state)
    model = FbankEendModel(port_cfg(jcfg, FbankEendConfig))
    model.load_state_dict(convert.fbank_eend_state_dict_from_jax(params, state, jcfg), strict=True)
    want = jax.jit(lambda p, s, x: jax_fbank.fbank_eend_forward(p, s, jcfg, x)[0])(
        params, state, wave)
    out["fbank"] = (jcfg, params, state, model, np.asarray(want))

    jcfg = jax_sincnet.SincNetEendConfig(hidden_size=16, num_lstm_layers=2, lstm_dropout=0.0,
                                         chunk_size=1.0)
    params = perturbed(jax.jit(lambda k: jax_sincnet.init_sincnet_eend_params(k, jcfg))(
        jax.random.PRNGKey(2)), 3)
    model = SincNetEendModel(port_cfg(jcfg, SincNetEendConfig))
    model.load_state_dict(convert.sincnet_eend_state_dict_from_jax(params, jcfg), strict=True)
    want = jax.jit(lambda p, x: jax_sincnet.sincnet_eend_forward(p, jcfg, x))(params, wave)
    out["sincnet"] = (jcfg, params, {}, model, np.asarray(want))

    jcfg = jax_sserious.SSeRiouSSConfig(wavlm=tiny_wavlm(), lstm_layers=2, lstm_hidden=16,
                                        linear_hidden=16, chunk_size=1.0)
    params = perturbed(jax.jit(lambda k: jax_sserious.init_sserious_params(k, jcfg))(
        jax.random.PRNGKey(4)), 5)
    # the extractor's output scale, which the port always has, as a parameter
    params["wavlm"]["feature_extractor"]["output_scale"] = np.random.default_rng(6).uniform(
        0.5, 1.5, 32).astype(np.float32)
    for name, layer in (("sserious", -1), ("sserious_layer1", 1)):
        lcfg = dataclasses.replace(jcfg, wav2vec_layer=layer)
        cfg = port_cfg(lcfg, SSeRiouSSConfig)
        model = SSeRiouSSModel(cfg)
        model.load_state_dict(convert.sserious_state_dict_from_jax(params, cfg), strict=True)
        want = jax.jit(lambda p, x, c=lcfg: jax_sserious.sserious_forward(p, c, x))(params, wave)
        out[name] = (lcfg, params, {}, model, np.asarray(want))
    return out


def waves(seed, b=2, n=SR):
    """(b, 1, n) noise with a tone, the second item 60 dB quieter: the
    fbank's top-dB clamp then differs per item."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / SR
    x = 0.1 * rng.standard_normal((b, 1, n)) + 0.3 * np.sin(2 * np.pi * 440 * t)
    x[1] *= 1e-3
    return x.astype(np.float32)


@pytest.mark.parametrize("name", ["fbank", "sincnet", "sserious", "sserious_layer1"])
def test_scores_match_jax(families, name):
    jcfg, _, _, model, want = families[name]
    wave = waves(0)
    with torch.no_grad():
        got = model(torch.from_numpy(wave)).numpy()
    assert got.shape == want.shape == (2, jcfg.num_frames(SR), jcfg.num_powerset_classes)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # the SincNet family runs float32 whatever compute type it is given
    if name == "sincnet":
        with torch.no_grad():
            again = segmentation_forward(model)(torch.from_numpy(wave), torch.bfloat16)
        assert again.dtype == torch.float32 and torch.equal(again, torch.from_numpy(got))


def test_sserious_fused_ln_route_matches_jax(families, monkeypatch):
    """With the fused residual-LayerNorm route on, SSeRiouSS's eval weighted
    sum is accumulated by K4 (its plain version on the CPU) in WavLM's layer
    loop, once a layer, and the scores stay JAX's."""
    jcfg, _, _, model, want = families["sserious"]
    wave = waves(0)
    calls = []

    def counted(*args):
        calls.append(args[-2])
        return residual_ln_acc(*args)

    monkeypatch.setattr(wavlm_module, "residual_ln_acc", counted)
    set_fused_ln(True)
    try:
        with torch.no_grad():
            got = model(torch.from_numpy(wave)).numpy()
    finally:
        set_fused_ln(None)
    assert len(calls) == jcfg.wavlm.num_layers
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_features_match_jax():
    wave = waves(1, b=3, n=24000)[:, 0]
    for port_fn, jax_fn in ((speechbrain_fbank, jax_fbank.speechbrain_fbank),
                            (mfcc, jax_xvector.mfcc)):
        want = np.asarray(jax.jit(jax_fn)(jnp.asarray(wave)))
        got = port_fn(torch.from_numpy(wave)).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))
    # the top-dB clamp is per item: the quiet item reads as it does alone,
    # with values below the loud item's clamp floor
    fb = speechbrain_fbank(torch.from_numpy(wave)).numpy()
    alone = speechbrain_fbank(torch.from_numpy(wave[1:2])).numpy()[0]
    np.testing.assert_allclose(fb[1], alone, rtol=0, atol=1e-4)
    assert (fb[1] < fb[0].max() - 80.0).any()


@pytest.fixture(scope="module")
def xvectors():
    out = {}
    for frontend in ("mfcc", "sincnet"):
        jcfg = jax_xvector.XVectorConfig(frontend=frontend, dimension=64)
        params = jax.jit(lambda k, c=jcfg: jax_xvector.init_xvector_params(k, c))(
            jax.random.PRNGKey(6))
        rng = np.random.default_rng(7)
        params = perturbed(params, 8)
        for layer in params["tdnn"]:  # running statistics of a trained model
            layer["bn"]["var"] = rng.uniform(0.5, 2.0, layer["bn"]["var"].shape).astype(np.float32)
        model = XVectorModel(XVectorConfig(**dataclasses.asdict(jcfg)))
        model.load_state_dict(convert.xvector_state_dict_from_jax(params, jcfg), strict=True)
        out[frontend] = (jcfg, params, model.eval())
    return out


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("frontend", ["mfcc", "sincnet"])
def test_xvector_matches_jax(xvectors, frontend, weighted):
    jcfg, params, model = xvectors[frontend]
    wave = waves(2, n=24000)
    weights = None
    if weighted:  # per-speaker frame weights on the segmentation grid, interpolated
        weights = np.random.default_rng(3).uniform(size=(2, 3, 57)).astype(np.float32)
    want = np.asarray(jax.jit(lambda p, x, w: jax_xvector.xvector_forward(p, jcfg, x, w))(
        params, jnp.asarray(wave), None if weights is None else jnp.asarray(weights)))
    with torch.no_grad():
        got = model(torch.from_numpy(wave),
                    None if weights is None else torch.from_numpy(weights)).numpy()
    assert got.shape == want.shape == ((2, 3, 64) if weighted else (2, 64))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * float(np.abs(want).max()))


def test_every_jax_leaf_lands_in_the_port(families, xvectors):
    """Strict loads above; here the element counts: the JAX leaves against
    the port's trainable parameters (plus the BatchNorm statistics of the
    JAX state), the zero `bias_hh` of each LSTM direction aside."""
    cases = [(p, s, m) for _, p, s, m, _ in families.values()]
    cases += [(p, {}, m) for _, p, m in xvectors.values()]
    for params, state, model in cases:
        want = sum(np.size(x) for x in jax.tree_util.tree_leaves((params, state)))
        got = sum(p.numel() for p in model.parameters() if p.requires_grad)
        got += sum(b.numel() for n, b in model.named_buffers() if n.endswith(("_mean", "_var")))
        frozen = [n for n, p in model.named_parameters() if not p.requires_grad]
        assert all(".bias_hh_l0" in n for n in frozen)
        assert got == want, type(model).__name__


@pytest.mark.parametrize("name", ["fbank", "sincnet", "sserious"])
def test_frame_grid_matches_jax(families, name):
    jcfg, _, _, model, _ = families[name]
    want = jax_receptive_field_window(jcfg)
    got = receptive_field_window(model.cfg)
    assert (got.start, got.duration, got.step) == pytest.approx(
        (want.start, want.duration, want.step), rel=1e-12, abs=1e-15)
    assert model.cfg.num_frames(8 * SR) == jcfg.num_frames(8 * SR)
    assert model.cfg.rf_info() == jcfg.rf_info()


@pytest.mark.parametrize("name", ["fbank", "sincnet"])
def test_train_step_gradients_match_jax(families, name, monkeypatch):
    """One float32 train step at dropout 0: the loss and every gradient
    (before clipping) of the JAX package's `make_train_step`."""
    jcfg, params, state, model, _ = families[name]
    rng = np.random.default_rng(9)
    nf = jcfg.num_frames(SR)
    batch = {"xs": waves(13, b=3), "target": (rng.uniform(size=(3, nf, 4)) > 0.5
                                               ).astype(np.float32)}
    # a leaky ReLU's slope jumps 100x at 0: an input within float32 rounding
    # of the kink takes either slope, in either package, and the gradients
    # behind it differ by that factor. The batch keeps every input of the
    # SincNet model's leaky ReLUs at least 1e-6 away from it
    margins = []

    def recorded(x):
        margins.append(float(x.detach().abs().min()))
        return F.leaky_relu(x, 0.01)

    monkeypatch.setattr(sincnet_eend, "leaky_relu", recorded)
    optimizer = capture_transform()
    step = jax.jit(make_train_step(jcfg, optimizer, compute_dtype=jnp.float32))
    new_state, metrics = step(jax_create_train_state(params, state, optimizer),
                              jax.tree_util.tree_map(jnp.asarray, batch), jax.random.PRNGKey(2))
    grads = np_tree(new_state.opt_state)
    if name == "fbank":
        want = convert.fbank_eend_state_dict_from_jax(grads, np_tree(new_state.model_state))
    else:
        want = convert.sincnet_eend_state_dict_from_jax(grads)

    port = type(model)(model.cfg)
    port.load_state_dict(model.state_dict())
    capture = CaptureGrads(port)
    m = train_step(TrainState(port, capture), batch, seed=0, compute_dtype=torch.float32)
    assert not m["skipped"] and m["attention_layers"] == 0
    assert len(margins) == (5 if name == "sincnet" else 0) and min(margins, default=1.0) > 1e-6
    np.testing.assert_allclose(m["loss"], float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(m["grad_norm"], float(metrics["grad_norm"]), rtol=1e-4)
    assert set(capture.captured) <= set(want)
    for key, got in capture.captured.items():
        w = want[key].numpy()
        if key.endswith(NULL_GRADIENT):
            assert max(float(got.abs().max()), float(np.abs(w).max())) <= 1e-5 * m["grad_norm"]
            continue
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"grad of {key}")
    # the Conformer's BatchNorm statistics moved as in JAX; the sinc band
    # edges got JAX's gradient through abs and clip above
    for key, buf in port.named_buffers():
        if key.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(buf.numpy(), want[key].numpy(), rtol=1e-5, atol=1e-6)


def test_sserious_frozen_trunk_gradients_match_jax(families):
    """A float32 train step of SSeRiouSS: WavLM gets no gradient; the layer
    weights and the head get JAX's gradient of the same loss."""
    jcfg, params, _, model, _ = families["sserious"]
    rng = np.random.default_rng(11)
    wave = waves(12, b=2)
    target = (rng.uniform(size=(2, jcfg.num_frames(SR), 4)) > 0.5).astype(np.float32)

    def loss_fn(p):
        scores = jax_sserious.sserious_forward(p, jcfg, jnp.asarray(wave), train=True,
                                               rng=jax.random.PRNGKey(1))
        return jax_segmentation_loss(jcfg.powerset, scores, jnp.asarray(target))

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    grads = np_tree(grads)
    assert all(not np.any(g) for g in jax.tree_util.tree_leaves(grads["wavlm"]))
    want = convert.sserious_state_dict_from_jax(grads, model.cfg)

    port = SSeRiouSSModel(model.cfg)
    port.load_state_dict(model.state_dict())
    capture = CaptureGrads(port)
    m = train_step(TrainState(port, capture), {"xs": wave, "target": target}, seed=0,
                   compute_dtype=torch.float32)
    assert not m["skipped"] and m["attention_layers"] == 2
    np.testing.assert_allclose(m["loss"], float(loss), rtol=1e-5)
    for key, p in port.named_parameters():
        if key.startswith("wav2vec."):
            assert p.grad is None and not capture.captured[key].any(), key
            continue
        w = want[key].numpy()
        assert np.abs(w).max() > 0.0 or key.startswith("lstm.") and "bias_hh" in key, key
        np.testing.assert_allclose(capture.captured[key].numpy(), w, rtol=1e-4,
                                   atol=1e-4 * max(float(np.abs(w).max()), 1e-30),
                                   err_msg=f"grad of {key}")


def test_adamw_torch_args_matches_optax():
    """`torch.optim.AdamW` resolves to the port's `adamw_torch_args`: torch's
    defaults and surface, optax's AdamW update."""
    assert config.resolve("torch.optim.AdamW") is adamw_torch_args
    rng = np.random.default_rng(13)
    w0 = rng.standard_normal((3, 4)).astype(np.float32)
    grads = [rng.standard_normal((3, 4)).astype(np.float32) for _ in range(3)]
    kwargs = dict(lr=1e-2, betas=(0.8, 0.99), eps=1e-6, weight_decay=0.05)
    tx = optax.adamw(kwargs["lr"], b1=0.8, b2=0.99, eps=1e-6, weight_decay=0.05)
    params, opt_state = jnp.asarray(w0), None
    opt_state = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    opt = adamw_torch_args({"w": p}, amsgrad=False, **kwargs)
    for g in grads:
        updates, opt_state = tx.update(jnp.asarray(g), opt_state, params)
        params = optax.apply_updates(params, updates)
        opt.step([torch.from_numpy(g)])
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params), rtol=1e-6, atol=1e-7)
    defaults = adamw_torch_args({"w": p})
    assert (defaults.betas, defaults.eps, defaults.weight_decay) == ((0.9, 0.999), 1e-8, 1e-2)
