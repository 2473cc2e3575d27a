"""The port's pruning package against the JAX package's, on the JAX tests'
tiny WavLM (2 layers x 32 wide, 4 heads, 2000-sample waves) and the same
numpy inputs: HardConcrete masks, the analytic parameter count, the gated
forward's hidden states, the distill loss, the distill-prune objective and
its gradients, the step's dynamics and its skip of a non-finite batch, and
the surgery (conv channels and a pruned layer-0 attention included), all in
float32. JAX runs on the CPU, its attention through XLA as in its own
tests."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.build import distill_prune as jax_distill_prune
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.models.wavlm import init_wavlm_params, wavlm_extract_features
from diarizen_tpu.prune import apply_pruning as jax_apply_pruning
from diarizen_tpu.prune import compile_gates as jax_compile_gates
from diarizen_tpu.prune import compiled_mask as jax_compiled_mask
from diarizen_tpu.prune import count_params_pytree as jax_count_params
from diarizen_tpu.prune import distill_loss as jax_distill_loss
from diarizen_tpu.prune import expected_num_params as jax_expected_num_params
from diarizen_tpu.prune import init_gates as jax_init_gates
from diarizen_tpu.prune import l0_norm as jax_l0_norm
from diarizen_tpu.prune import sample_gates as jax_sample_gates
from diarizen_tpu.prune import sample_mask as jax_sample_mask
from diarizen_tpu.prune.distill import DistillConfig as JaxDistillConfig
from diarizen_tpu.prune.gates import PruneConfig as JaxPruneConfig
from diarizen_tpu.prune.hardconcrete import EPS
from diarizen_tpu_torch.models import build
from diarizen_tpu_torch.models.convert import (
    SEP,
    _flatten,
    gates_from_jax,
    wavlm_params_to_jax,
    wavlm_state_dict_from_jax,
)
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig, count_params
from diarizen_tpu_torch.prune import (
    DistillConfig,
    PruneConfig,
    apply_pruning,
    compile_gates,
    compiled_mask,
    create_distill_prune_state,
    distill_loss,
    expected_num_params,
    init_gates,
    l0_norm,
    make_distill_prune_step,
    sample_mask,
)
from diarizen_tpu_torch.prune.distill import distill_prune_loss, teacher_targets
from diarizen_tpu_torch.prune.gates import gate_leaves, gates_from_flat, map_gates

from test_prune import tiny_wavlm

LAYERS = (0, 1, 2)


def port_cfg(cfg: JaxWavLMConfig) -> WavLMConfig:
    return WavLMConfig(**dataclasses.asdict(cfg))


def to_numpy(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def port_model(params, cfg) -> WavLM:
    model = WavLM(port_cfg(cfg))
    model.load_state_dict(wavlm_state_dict_from_jax(params, port_cfg(cfg)), strict=True)
    return model


def spread_log_alphas(log_alphas, rng):
    """Log-alphas spread over [-3, 3] so that masks take every value:
    zeros, ones and soft values between."""
    return jax.tree_util.tree_map(
        lambda la: rng.uniform(-3.0, 3.0, la.shape).astype(np.float32), to_numpy(log_alphas))


@pytest.fixture(scope="module")
def tiny():
    """(JAX cfg, JAX params, port model, all-unit log-alphas, wave)."""
    cfg = tiny_wavlm()
    params = to_numpy(init_wavlm_params(jax.random.PRNGKey(0), cfg))
    rng = np.random.default_rng(0)
    gates = jax_init_gates(jax.random.PRNGKey(1), cfg, JaxPruneConfig(prune_conv_channels=True))
    wave = (0.1 * rng.standard_normal((2, 2000))).astype(np.float32)
    return cfg, params, port_model(params, cfg), spread_log_alphas(gates, rng), wave


def test_compiled_mask_equal():
    rng = np.random.default_rng(1)
    for n, scale in ((1, 4.0), (7, 1.0), (64, 3.0), (3072, 2.0)):
        la = (scale * rng.standard_normal(n) + rng.uniform(-2, 2)).astype(np.float32)
        assert np.array_equal(compiled_mask(la), jax_compiled_mask(la))


def test_sample_mask_from_same_uniform():
    la = np.random.default_rng(2).uniform(-4, 4, 257).astype(np.float32)
    key = jax.random.PRNGKey(7)
    u = np.array(jax.random.uniform(key, la.shape, minval=EPS, maxval=1 - EPS))
    got = sample_mask(torch.from_numpy(la), u=torch.from_numpy(u)).numpy()
    want = np.asarray(jax_sample_mask(jnp.asarray(la), key))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert 0 < (got == 0).sum() < la.size and (got == 1).sum() > 0
    drawn = sample_mask(torch.from_numpy(la), torch.Generator().manual_seed(0))
    assert drawn.min() >= 0 and drawn.max() <= 1


@pytest.mark.parametrize("which", ["tiny", "base"])
def test_l0_and_expected_num_params(which):
    cfg = tiny_wavlm() if which == "tiny" else JaxWavLMConfig.base()
    rng = np.random.default_rng(3)
    gates = spread_log_alphas(
        jax_init_gates(jax.random.PRNGKey(1), cfg, JaxPruneConfig(prune_conv_channels=True)), rng)
    port_gates = gates_from_jax(gates)
    for (_, got), want in zip(gate_leaves(port_gates), jax.tree_util.tree_leaves(gates)):
        np.testing.assert_allclose(float(l0_norm(got)), float(jax_l0_norm(jnp.asarray(want))),
                                   rtol=1e-5)
    for port_tree, jax_tree in ((port_gates, gates), ({}, {})):
        np.testing.assert_allclose(float(expected_num_params(port_cfg(cfg), port_tree)),
                                   float(jax_expected_num_params(cfg, jax_tree)), rtol=1e-5)


def test_count_params_counts_as_jax(tiny):
    cfg, params, model, _, _ = tiny
    assert count_params(model.state_dict()) == jax_count_params(params)
    assert _flatten(wavlm_params_to_jax(model.state_dict(), port_cfg(cfg))).keys() == \
        _flatten(params).keys()


@pytest.mark.parametrize("train", [False, True])
def test_gated_hidden_states_match_jax(tiny, train):
    cfg, params, model, log_alphas, wave = tiny
    masks = to_numpy(jax_sample_gates(jax.tree_util.tree_map(jnp.asarray, log_alphas),
                                      jax.random.PRNGKey(5)))
    want = wavlm_extract_features(params, cfg, jnp.asarray(wave), train=train, rng=None,
                                  gates=jax.tree_util.tree_map(jnp.asarray, masks))
    with torch.no_grad():
        got = model.hidden_states(torch.from_numpy(wave), torch.float32, train=train,
                                  gates=gates_from_jax(masks))
    assert len(got) == len(want) == cfg.num_layers + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cos_type", ["raw", "log_sig"])
def test_distill_loss_matches_jax(cos_type):
    rng = np.random.default_rng(4)
    student, teacher = (rng.standard_normal((2, 3, 9, 32)).astype(np.float32) for _ in range(2))
    fields = dict(l2_weight=0.5, l1_weight=1.0, cos_weight=1.0, cos_type=cos_type)
    got, got_parts = distill_loss(DistillConfig(**fields), torch.from_numpy(student),
                                  torch.from_numpy(teacher))
    want, want_parts = jax_distill_loss(JaxDistillConfig(**fields), jnp.asarray(student),
                                        jnp.asarray(teacher))
    np.testing.assert_allclose(float(got), float(want), rtol=0, atol=1e-6)
    for k in want_parts:
        np.testing.assert_allclose(float(got_parts[k]), float(want_parts[k]), rtol=0, atol=1e-6)


def test_objective_and_gradients_match_jax(tiny):
    """The distill-prune objective of one step (sampled masks from the same
    uniform draws, lambdas away from zero, the target mid warm-up) and its
    gradients with respect to the student, the log-alphas and the lambdas,
    each within 1e-4 of the tensor's largest magnitude."""
    cfg, params, _, log_alphas, wave = tiny
    rng = np.random.default_rng(6)
    teacher = jax.tree_util.tree_map(
        lambda x: x + 0.05 * rng.standard_normal(x.shape).astype(np.float32), params)
    lambdas = np.asarray([0.3, -0.2], np.float32)
    fields = dict(target_sparsity=0.5, sparsity_warmup_updates=4, distill_layers=LAYERS)
    jdcfg, dcfg, step = JaxDistillConfig(**fields), DistillConfig(**fields), 3
    key = jax.random.PRNGKey(9)

    leaves, treedef = jax.tree_util.tree_flatten(log_alphas)
    keys = jax.random.split(key, len(leaves))
    uniforms = jax.tree_util.tree_unflatten(treedef, [
        np.asarray(jax.random.uniform(k, la.shape, minval=EPS, maxval=1 - EPS))
        for la, k in zip(leaves, keys)])

    teacher_total = float(jax_count_params(teacher))
    targets = jnp.stack([wavlm_extract_features(teacher, cfg, jnp.asarray(wave))[i]
                         for i in LAYERS], axis=1)

    def jax_loss(trainable):
        gates = jax_sample_gates(trainable["log_alphas"], key)
        hidden = wavlm_extract_features(trainable["student"], cfg, jnp.asarray(wave),
                                        train=True, rng=None, gates=gates)
        loss, _ = jax_distill_loss(jdcfg, jnp.stack([hidden[i] for i in LAYERS], 1), targets)
        gap = (1.0 - jax_expected_num_params(cfg, trainable["log_alphas"]) / teacher_total
               - 0.5 * step / 4)
        return loss + trainable["lambdas"][0] * gap + trainable["lambdas"][1] * gap ** 2

    trainable = jax.tree_util.tree_map(jnp.asarray, {"student": params, "log_alphas": log_alphas,
                                                     "lambdas": lambdas})
    want_loss, want_grads = jax.jit(jax.value_and_grad(jax_loss))(trainable)

    pcfg = port_cfg(cfg)
    student = port_model(params, cfg)
    state = create_distill_prune_state(student, gates_from_jax(log_alphas), dcfg, device="cpu")
    with torch.no_grad():
        state.lambdas.copy_(torch.from_numpy(lambdas))
    port_targets = teacher_targets(port_model(teacher, cfg), torch.from_numpy(wave), dcfg,
                                   torch.float32)
    u = dict(gate_leaves(gates_from_jax(uniforms)))
    masks = gates_from_flat({n: sample_mask(la, u=u[n]) for n, la in gate_leaves(state.log_alphas)},
                            cfg.num_layers)
    loss, _ = distill_prune_loss(student, state.log_alphas, state.lambdas, masks,
                                 torch.from_numpy(wave), port_targets, pcfg, dcfg, teacher_total,
                                 step, torch.float32)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-5)

    grads = {k: (p.grad if p.grad is not None else torch.ones_like(p))
             for k, p in student.named_parameters()}
    got = _flatten({"student": wavlm_params_to_jax(grads, pcfg),
                    "log_alphas": map_gates(lambda la: la.grad.numpy(), state.log_alphas),
                    "lambdas": state.lambdas.grad.numpy()})
    want = _flatten(to_numpy(want_grads))
    assert got.keys() == want.keys()
    largest = max(np.abs(w).max() for w in want.values())
    for name, w in want.items():
        # the key bias's gradient is zero in exact arithmetic (softmax ignores
        # a shift of a row): both sides hold rounding noise, held to the
        # largest gradient of all
        scale = largest if name.endswith(f"d{SEP}k{SEP}d{SEP}b") else np.abs(w).max()
        err = np.abs(got[name] - w).max()
        assert err <= 1e-4 * scale, (name, err, scale)


def distill_setup(tiny, dcfg):
    cfg, params, _, _, wave = tiny
    teacher, student = port_model(params, cfg), port_model(params, cfg)
    gates = init_gates(port_cfg(cfg), PruneConfig(), torch.Generator().manual_seed(1))
    state = create_distill_prune_state(student, gates, dcfg, device="cpu")
    step = make_distill_prune_step(port_cfg(cfg), dcfg, teacher, compute_dtype=torch.float32)
    return state, step, wave


def test_distill_prune_step_dynamics(tiny):
    """The JAX package's dynamics test, on the port's step."""
    dcfg = DistillConfig(target_sparsity=0.5, sparsity_warmup_updates=4, pre_train_updates=0,
                         distill_lr=1e-3, reg_lr=5e-2, distill_layers=LAYERS)
    state, step, wave = distill_setup(tiny, dcfg)
    history = [step(state, torch.from_numpy(wave), seed=3) for _ in range(8)]
    assert history[0]["sparsity_target"] < 0.2
    assert history[5]["sparsity_target"] == pytest.approx(0.5)
    assert abs(history[-1]["lambda1"]) > 0
    assert all(np.isfinite(m["loss"]) and not m["skipped"] for m in history)
    assert history[0]["loss_distill"] < -0.5
    assert state.step == 8


def test_non_finite_batch_skips_the_update(tiny):
    state, step, wave = distill_setup(tiny, DistillConfig(distill_layers=LAYERS))
    step(state, wave)
    before = {k: v.detach().clone() for k, v in state.optimizer.params.items()}
    counts = dict(state.optimizer.state["count"])
    mu = {k: v.clone() for k, v in state.optimizer.state["mu"].items()}
    bad = wave.copy()
    bad[0, 100] = np.nan
    metrics = step(state, bad)
    assert metrics["skipped"] and not np.isfinite(metrics["loss"])
    assert state.step == 2 and state.optimizer.state["count"] == counts
    for k, v in state.optimizer.params.items():
        assert torch.equal(v, before[k]), k
        assert torch.equal(state.optimizer.state["mu"][k], mu[k]), k
    assert not step(state, wave)["skipped"]


SURGERY_CASES = {
    # heads, attention and FF layers, FF intermediates
    "units": dict(prune_conv_channels=False),
    # conv channels only, the last layer's mask into dummy_weight
    "conv": dict(prune_conv_channels=True, prune_attention_heads=False,
                 prune_attention_layer=False, prune_feed_forward_intermediate=False,
                 prune_feed_forward_layer=False),
    # everything, with layer 0's attention pruned away
    "layer0_attention": dict(prune_conv_channels=True),
}


def surgery_log_alphas(cfg, case):
    la = to_numpy(jax_init_gates(jax.random.PRNGKey(1), cfg, JaxPruneConfig(**SURGERY_CASES[case])))
    if case != "conv":
        la["layers"][0]["heads"] = np.asarray([-4.0, 3.0, 3.0, -4.0], np.float32)
        la["layers"][1]["ff_interm"] = np.where(np.arange(64) % 3 == 0, -4.0, 3.0).astype(
            np.float32)
    if case != "units":
        la["conv"][0] = np.where(np.arange(16) < 10, 6.0, -6.0).astype(np.float32)
        la["conv"][2] = np.where(np.arange(16) % 2 == 0, 6.0, -6.0).astype(np.float32)
    if case == "layer0_attention":
        la["layers"][0]["attn_layer"] = np.asarray([-8.0], np.float32)
        la["layers"][1]["ff_layer"] = np.asarray([6.0], np.float32)
    return la


@pytest.mark.parametrize("case", sorted(SURGERY_CASES))
def test_surgery_matches_jax(tiny, case):
    cfg, params, model, _, wave = tiny
    la = surgery_log_alphas(cfg, case)
    want_params, want_cfg = jax_apply_pruning(params, cfg, la)
    sd, got_cfg = apply_pruning(model.state_dict(), port_cfg(cfg), gates_from_jax(la))
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    got, want = _flatten(wavlm_params_to_jax(sd, got_cfg)), _flatten(to_numpy(want_params))
    assert got.keys() == want.keys()
    assert all(np.array_equal(got[k], want[k]) for k in want)
    assert count_params(sd) == jax_count_params(want_params) < jax_count_params(params)

    pruned = WavLM(got_cfg)
    pruned.load_state_dict(sd, strict=True)
    with torch.no_grad():
        out = pruned.hidden_states(torch.from_numpy(wave))
    want_out = wavlm_extract_features(want_params, want_cfg, jnp.asarray(wave))
    for g, w in zip(out, want_out):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
    if case == "layer0_attention":
        assert not got_cfg.use_attention[0] and "encoder.transformer.rel_attn_embed.weight" in sd
    if case != "conv":
        # the projection LayerNorm sees the pruned channels as zeros before
        # surgery: gated and pruned agree only without last-layer conv gates
        with torch.no_grad():
            gated = model.hidden_states(torch.from_numpy(wave),
                                        gates=compile_gates(gates_from_jax(la)))
        if case == "units":
            for g, p in zip(gated, out):
                np.testing.assert_allclose(p.numpy(), g.numpy(), rtol=1e-4, atol=1e-4)


def test_layer0_attention_pruned_matches_gated(tiny):
    """Layer 0's attention pruned, no conv gates: the pruned model (which
    keeps the relative-position table) equals the gated forward."""
    cfg, params, model, _, wave = tiny
    la = surgery_log_alphas(cfg, "units")
    la["layers"][0]["attn_layer"] = np.asarray([-8.0], np.float32)
    sd, pruned_cfg = apply_pruning(model.state_dict(), port_cfg(cfg), gates_from_jax(la))
    assert not pruned_cfg.use_attention[0] and pruned_cfg.use_attention[1]
    pruned = WavLM(pruned_cfg)
    pruned.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pruned.hidden_states(torch.from_numpy(wave))
        gated = model.hidden_states(torch.from_numpy(wave), gates=compile_gates(gates_from_jax(la)))
    want_params, want_cfg = jax_apply_pruning(params, cfg, la)
    want = wavlm_extract_features(want_params, want_cfg, jnp.asarray(wave))
    jax_gated = wavlm_extract_features(params, cfg, jnp.asarray(wave), gates=jax_compile_gates(
        jax.tree_util.tree_map(jnp.asarray, la)))
    for g, gg, w, wg in zip(got, gated, want, jax_gated):
        np.testing.assert_allclose(g.numpy(), gg.numpy(), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4, atol=1e-4)
        np.testing.assert_allclose(np.asarray(w), np.asarray(wg), rtol=1e-4, atol=1e-4)


def test_distill_prune_builder_matches_jax(tiny, tmp_path):
    """Both builders on one reference-format `{config, state_dict}` file."""
    cfg, _, model, _, _ = tiny
    path = str(tmp_path / "teacher.pt")
    torch.save({"config": port_cfg(cfg).to_reference_dict(), "state_dict": model.state_dict()},
               path)
    units = "conv,head,interm,attlayer,ffnlayer"
    want_cfg, want_params, want_state = jax_distill_prune(path, pruning_units=units,
                                                          distill_layers="0,2")
    got_cfg, got = build.distill_prune(path, pruning_units=units, distill_layers="0,2")
    assert dataclasses.asdict(got_cfg) == dataclasses.asdict(want_cfg)
    got_teacher = _flatten(wavlm_params_to_jax(got.teacher.state_dict(), got_cfg))
    want_teacher = _flatten(to_numpy(want_params["teacher"]))
    assert got_teacher.keys() == want_teacher.keys()
    assert all(np.array_equal(got_teacher[k], want_teacher[k]) for k in want_teacher)
    assert dataclasses.asdict(got.prune_config) == dataclasses.asdict(want_state["prune_config"])
    assert got.distill_layers == want_state["distill_layers"]
    shapes = jax.tree_util.tree_map(np.shape, to_numpy(want_params["log_alphas"]))
    assert map_gates(lambda la: tuple(la.shape), got.log_alphas) == shapes
    assert all(torch.equal(v, got.student.state_dict()[k])
               for k, v in got.teacher.state_dict().items())
