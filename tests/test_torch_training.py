"""The port's training pieces against the JAX package on the CPU: the loss
and its permutation search, the DER counts, the optimizer (against optax on
identical gradients), the EEND training forward and its gradients, and the
NaN-batch skip of the train step."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.eend import EendConfig as JaxEendConfig
from diarizen_tpu.models.eend import eend_forward, init_eend_params, non_wavlm_param_labels
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.models.wavlm import set_flash_attention
from diarizen_tpu.ops.losses import nll_loss as jax_nll_loss
from diarizen_tpu.ops.permutation import permutate_enumerate as jax_permutate
from diarizen_tpu.ops.powerset import Powerset as JaxPowerset
from diarizen_tpu.train.loss import der_metrics as jax_der_metrics
from diarizen_tpu.train.loss import segmentation_loss as jax_segmentation_loss
from diarizen_tpu.train.optim import dual_lr_optimizer as jax_dual_lr_optimizer
from diarizen_tpu.train.optim import with_gradient_accumulation as jax_accumulation
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import eend_state_dict_from_jax
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.ops.losses import binary_cross_entropy, mse_loss, nll_loss
from diarizen_tpu_torch.ops.permutation import permutate_enumerate, permutate_hungarian
from diarizen_tpu_torch.ops.powerset import Powerset
from diarizen_tpu_torch.train import (
    TrainState,
    dual_lr_optimizer,
    segmentation_loss,
    train_step,
    with_gradient_accumulation,
)
from diarizen_tpu_torch.train.loss import der_metrics


def _scores_and_target(seed, b=3, f=50, k=4, p=11):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((b, f, p)).astype(np.float32)
    scores = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    target = (rng.uniform(size=(b, f, k)) > 0.6).astype(np.float32)
    target[:, :, 3] = 0.0  # an absent speaker, as padding leaves
    return scores.astype(np.float32), target


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_loss_permutation_and_der_match_jax(seed):
    scores, target = _scores_and_target(seed)
    jps, ps = JaxPowerset(4, 2), Powerset(4, 2)
    s_t, y_t = torch.from_numpy(scores), torch.from_numpy(target)

    idx = np.random.default_rng(seed).integers(0, 11, scores.shape[:2])
    np.testing.assert_allclose(nll_loss(s_t, torch.from_numpy(idx)).item(),
                               float(jax_nll_loss(jnp.asarray(scores), jnp.asarray(idx))),
                               rtol=1e-6)
    hyp = np.asarray(jps.to_multilabel(jnp.asarray(scores)))
    want_perm, want_idx = jax_permutate(jnp.asarray(hyp), jnp.asarray(target))
    got_perm, got_idx = permutate_enumerate(torch.tensor(hyp), y_t)
    np.testing.assert_array_equal(got_idx.numpy(), np.asarray(want_idx))
    np.testing.assert_array_equal(got_perm.numpy(), np.asarray(want_perm))
    host, host_idx = permutate_hungarian(hyp, target)
    np.testing.assert_array_equal(host, np.asarray(want_perm))  # unique optimum here
    np.testing.assert_array_equal(
        ps.to_powerset_index(got_perm).numpy(),
        np.asarray(jps.to_powerset_index(jnp.asarray(want_perm))))
    np.testing.assert_array_equal(ps.to_powerset(got_perm).numpy(),
                                  np.asarray(jps.to_powerset(want_perm)))

    np.testing.assert_allclose(segmentation_loss(ps, s_t, y_t).item(),
                               float(jax_segmentation_loss(jps, jnp.asarray(scores),
                                                           jnp.asarray(target))), rtol=1e-6)
    want = jax_der_metrics(jps, jnp.asarray(scores), jnp.asarray(target))
    got = der_metrics(ps, s_t, y_t)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in want.items()}

    probs = np.clip(np.exp(scores[..., :4]), 0, 1)
    w = np.random.default_rng(seed).uniform(size=scores.shape[:2]).astype(np.float32)
    from diarizen_tpu.ops.losses import binary_cross_entropy as jax_bce, mse_loss as jax_mse
    for port_fn, jax_fn in ((binary_cross_entropy, jax_bce), (mse_loss, jax_mse)):
        for weight in (None, w):
            got = port_fn(torch.from_numpy(probs), y_t,
                          None if weight is None else torch.from_numpy(weight)).item()
            want = float(jax_fn(jnp.asarray(probs), jnp.asarray(target),
                                None if weight is None else jnp.asarray(weight)))
            np.testing.assert_allclose(got, want, rtol=1e-6)


SHAPES = {"wavlm": {"a": (3, 4), "b": (5,)}, "other": {"c": (4,), "z": (2, 2)}}


@pytest.mark.parametrize("freeze, percentile, every_k",
                         [(False, 90.0, 1), (True, 50.0, 1), (False, 90.0, 2)],
                         ids=["dual-lr", "frozen-wavlm", "accumulate-2"])
def test_optimizer_matches_optax(freeze, percentile, every_k):
    rng = np.random.default_rng(0)
    init = {g: {n: rng.standard_normal(s).astype(np.float32) for n, s in shapes.items()}
            for g, shapes in SHAPES.items()}
    kwargs = dict(lr_small=2e-3, lr_big=5e-2, warmup_steps=3, weight_decay=0.01,
                  clip_percentile=percentile, freeze_wavlm=freeze)
    jax_params = jax.tree_util.tree_map(jnp.asarray, init)
    jax_opt = jax_accumulation(
        jax_dual_lr_optimizer(non_wavlm_param_labels(jax_params), **kwargs), every_k)
    jax_state = jax_opt.init(jax_params)

    groups = {g: {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in named.items()}
              for g, named in init.items()}
    opt = with_gradient_accumulation(dual_lr_optimizer(groups, **kwargs), every_k)
    for step in range(5 * every_k):
        grads = {g: {n: (0 if n == "z" else 1 + step) * rng.standard_normal(s).astype(np.float32)
                     for n, s in shapes.items()} for g, shapes in SHAPES.items()}
        updates, jax_state = jax_opt.update(jax.tree_util.tree_map(jnp.asarray, grads),
                                            jax_state, jax_params)
        jax_params = jax.tree_util.tree_map(lambda p, u: p + u, jax_params, updates)
        opt.step([torch.from_numpy(grads[g][n]) for g in SHAPES for n in SHAPES[g]])
        for g in SHAPES:
            for n in SHAPES[g]:
                np.testing.assert_allclose(groups[g][n].detach().numpy(),
                                           np.asarray(jax_params[g][n]), rtol=1e-5, atol=1e-6,
                                           err_msg=f"step {step} {g}.{n}")
    assert not np.array_equal(groups["other"]["z"].detach().numpy(), init["other"]["z"])
    inner = opt.optimizer if every_k > 1 else opt
    clip_state = jax_state.inner_opt_state[0] if every_k > 1 else jax_state[0]
    np.testing.assert_allclose(inner.state["clip"]["history"].numpy(),
                               np.asarray(clip_state.history), rtol=1e-5)
    assert int(inner.state["clip"]["count"]) == int(clip_state.count) == 5


def _tiny_configs(**wavlm_overrides):
    n = 3
    wavlm = JaxWavLMConfig(**{
        **dict(conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)),
               embed_dim=64, num_layers=n,
               use_attention=(True, False, True), use_feed_forward=(True, True, False),
               total_num_heads=(4,) * n, remaining_heads=((0, 2), (), (1, 2, 3)),
               ff_interm_features=(48, 32, 40), num_buckets=40, max_distance=100,
               layer_drop=0.0, dropout=0.0, attention_dropout=0.0, projection_dropout=0.0),
        **wavlm_overrides})
    cfg = JaxEendConfig(
        wavlm=wavlm,
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=2,
                                     dropout=0.0),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32,
    )
    fields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    fields["wavlm"] = WavLMConfig(**dataclasses.asdict(cfg.wavlm))
    fields["conformer"] = ConformerConfig(**dataclasses.asdict(cfg.conformer))
    return cfg, EendConfig(**fields)


def _jax_model(cfg, seed=0):
    rng = np.random.default_rng(seed)
    params, state = init_eend_params(jax.random.PRNGKey(seed), cfg)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + (0.1 * rng.standard_normal(x.shape).astype(np.float32)
                                   if np.ndim(x) == 1 else 0.0), params)
    params["wavlm"]["feature_extractor"]["output_scale"] = rng.uniform(
        0.5, 1.5, 32).astype(np.float32)
    state = jax.tree_util.tree_map(np.asarray, state)
    return params, state


def test_eend_train_gradients_match_jax():
    jcfg, cfg = _tiny_configs()
    params, state = _jax_model(jcfg)
    rng = np.random.default_rng(1)
    wave = (0.1 * rng.standard_normal((3, 1, 2400))).astype(np.float32)
    nf = jcfg.num_frames(2400)
    target = (rng.uniform(size=(3, nf, 4)) > 0.5).astype(np.float32)

    def loss_fn(p):
        scores, new_state = eend_forward(p, state, jcfg, jnp.asarray(wave), train=True,
                                         rng=jax.random.PRNGKey(3))
        return jax_segmentation_loss(jcfg.powerset, scores, jnp.asarray(target)), new_state

    set_flash_attention(True)  # the JAX side runs its trainable Pallas kernels
    try:
        (loss, new_state), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    finally:
        set_flash_attention(None)
    want = eend_state_dict_from_jax(jax.tree_util.tree_map(np.asarray, grads),
                                    jax.tree_util.tree_map(np.asarray, new_state), jcfg)

    model = EendModel(cfg)
    model.load_state_dict(eend_state_dict_from_jax(params, state, jcfg))
    scores = model(torch.from_numpy(wave), train=True, generator=torch.Generator().manual_seed(0))
    got_loss = segmentation_loss(cfg.powerset, scores, torch.from_numpy(target))
    got_loss.backward()
    # float32 on both sides: reassociation only. Each gradient within 2e-3
    # of its largest magnitude, with a 1e-7 floor for the gradients that are
    # zero in exact arithmetic (attention key biases: softmax ignores a
    # per-row shift), where both sides hold rounding noise
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    named = dict(model.named_parameters())
    assert set(named) <= set(want)
    for name, p in named.items():
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=2e-3,
                                   atol=max(2e-3 * float(np.abs(w).max()), 1e-7),
                                   err_msg=f"grad of {name}")
    buffers = dict(model.named_buffers())
    running = [k for k in buffers if k.endswith(("running_mean", "running_var"))]
    assert len(running) == 2 * jcfg.conformer.num_layers
    for name in running:  # the BatchNorm statistics moved as in JAX
        np.testing.assert_allclose(buffers[name].numpy(), want[name].numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _tiny_port_model(seed=0, **wavlm_overrides):
    jcfg, cfg = _tiny_configs(**wavlm_overrides)
    params, state = _jax_model(jcfg, seed)
    model = EendModel(cfg)
    model.load_state_dict(eend_state_dict_from_jax(params, state, jcfg))
    return cfg, model


def test_nan_batch_leaves_every_state_unchanged():
    cfg, model = _tiny_port_model(dropout=0.1, attention_dropout=0.1, layer_drop=0.3)
    opt = dual_lr_optimizer(model.param_groups(), lr_small=1e-3, lr_big=1e-2)
    state = TrainState(model, opt)
    rng = np.random.default_rng(0)
    nf = cfg.num_frames(2400)
    batch = {"xs": (0.1 * rng.standard_normal((2, 1, 2400))).astype(np.float32),
             "target": (rng.uniform(size=(2, nf, 4)) > 0.5).astype(np.uint8)}
    m = train_step(state, batch, seed=1, compute_dtype=torch.float32)
    assert not m["skipped"] and np.isfinite(m["loss"]) and m["grad_norm"] > 0

    def snapshot():
        return ({k: v.clone() for k, v in model.state_dict().items()},
                {k: v.clone() for k, v in opt.state["mu"].items()},
                {k: v.clone() for k, v in opt.state["nu"].items()},
                dict(opt.state["count"]),
                {k: v.clone() for k, v in opt.state["clip"].items()})

    before = snapshot()
    bad = dict(batch, xs=batch["xs"].copy())
    bad["xs"][0, 0, 0] = np.nan
    m = train_step(state, bad, seed=1, compute_dtype=torch.float32)
    assert m["skipped"] and m["grad_norm"] == 0.0 and state.step == 2
    after = snapshot()
    for old, new in zip(before, after):
        assert old.keys() == new.keys()
        for k in old:
            if isinstance(old[k], torch.Tensor):
                torch.testing.assert_close(new[k], old[k], rtol=0, atol=0, msg=k)
            else:
                assert new[k] == old[k], k
    m = train_step(state, batch, seed=1, compute_dtype=torch.float32)
    assert not m["skipped"] and opt.state["count"] == {"wavlm": 2, "other": 2}
