"""K1's three softmax schedules in the port against the JAX package's.

The JAX package's Pallas kernel has a static `softmax_mode` ("f32",
"deferred", "bf16"; `diarizen_tpu/ops/flash_attention.py:_kernel`), chosen by
`set_softmax_mode` / `softmax_mode_scope` for inference and pinned to "f32"
for a forward that has a backward. Here the port's plain versions (what its
wrappers take for CPU tensors) are held against that kernel in interpret mode
on the same numpy inputs, per schedule and type; the switch is checked to
restore the schedule, and the Trainer's steps and validation and the
distill-prune recipe's step to run under "f32" while serving keeps
"deferred". The CUDA instances of each schedule are held against these
plain versions on the card by chip_smoke.py.

The JAX kernels are compiled with XLA's excess precision off: with it on (the
CPU default), XLA drops a float32 -> bfloat16 -> float32 round trip, so the
"bf16" schedule's exp would stay in float32 on the CPU where the TPU kernel
holds it as a bfloat16 value.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.ops import flash_attention as jax_fa
from diarizen_tpu_torch.models import wavlm as port_wavlm
from diarizen_tpu_torch.ops import flash_attention as fa

from test_torch_prune_recipes import PRUNE_TOML, write_kaldi_dir
from test_torch_pretrained import TINY_WAVLM
from test_torch_train_data import _batches, _trainer, tiny_configs

B, H, T, D = 2, 3, 57, 32  # tests/test_flash_attention.py's softmax-mode shape
SEED = 20240917
TYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _arrays(b=B, h=H, t=T, d=D, seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(4))
    pos = rng.standard_normal((h, t, t)).astype(np.float32)
    gate = rng.uniform(1.0, 2.0, (b, h, t)).astype(np.float32)
    return (q, k, v, pos, gate), do


def _port_args(arrays, dtype):
    q, k, v, pos, gate = (torch.from_numpy(a) for a in arrays)
    return (q.to(dtype), k.to(dtype), v.to(dtype), pos, gate)


def _jax_args(arrays, dtype):
    q, k, v, pos, gate = (jnp.asarray(a) for a in arrays)
    return (q.astype(dtype), k.astype(dtype), v.astype(dtype), pos, gate)


def _jax_kernel(arrays, dtype, mode):
    """The JAX package's inference kernel in schedule `mode` (interpret
    mode, excess precision off), as float32 numpy."""
    args = _jax_args(arrays, dtype)
    with jax_fa.softmax_mode_scope(mode):  # read when the kernel is traced
        lowered = jax.jit(
            lambda *a: jax_fa.flash_attention_gated_bias(*a, interpret=True)).lower(*args)
    exe = lowered.compile({"xla_allow_excess_precision": False})
    return np.asarray(exe(*args).astype(jnp.float32))


def _tolerance(dtype, want):
    """f32: the JAX test's own 2e-6 for like-for-like schedules
    (reassociation). bf16: half of one bf16 step at the largest magnitude
    (2^-9 of it): the output is rounded to bf16 once, so schedules that
    agree differ only where a reassociation moves a value across a
    rounding boundary, which these inputs do not hit."""
    if dtype == torch.float32:
        return dict(rtol=2e-6, atol=2e-6)
    return dict(rtol=0, atol=2.0**-9 * float(np.abs(want).max()))


@pytest.fixture(scope="module")
def arrays():
    return _arrays()


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("mode", fa.SOFTMAX_MODES)
def test_plain_schedule_matches_jax(arrays, mode, dtype):
    inputs, _ = arrays
    port_dtype, jax_dtype = TYPES[dtype]
    want = _jax_kernel(inputs, jax_dtype, mode)
    got = fa.flash_attention_gated_bias_reference(*_port_args(inputs, port_dtype),
                                                  softmax_mode=mode)
    assert got.dtype == port_dtype
    np.testing.assert_allclose(got.float().numpy(), want, **_tolerance(port_dtype, want))
    # the inference wrapper on CPU tensors runs the plain version of the
    # process's schedule
    with fa.softmax_mode_scope(mode):
        wrapped = fa.flash_attention_gated_bias(*_port_args(inputs, port_dtype))
    torch.testing.assert_close(wrapped, got, rtol=0, atol=0)


def test_default_inference_matches_jax_default_tighter_than_the_schedule_gap():
    """The port's default inference (its plain version on CPU tensors) in
    bf16 against the JAX package's default-mode kernel ("deferred"), within
    half the gap between JAX's "f32" and "deferred" schedules on the same
    inputs: a plain version of the "f32" schedule in the deferred kernel's
    place misses by about the whole gap."""
    inputs, _ = _arrays(2, 4, 199, 64, seed=1)
    assert fa.softmax_mode() == "deferred"
    want = _jax_kernel(inputs, jnp.bfloat16, "deferred")
    gap = float(np.abs(_jax_kernel(inputs, jnp.bfloat16, "f32") - want).max())
    got = fa.flash_attention_gated_bias(*_port_args(inputs, torch.bfloat16)).float().numpy()
    err = float(np.abs(got - want).max())
    assert gap > 0.0
    assert err <= 0.5 * gap, (err, gap)


@pytest.mark.parametrize("dtype", TYPES)
@pytest.mark.parametrize("rate", [0.0, 0.1])
def test_trainable_matches_jax_f32_schedule(arrays, rate, dtype):
    """The port's differentiable function (f32 schedule whatever the
    process's schedule) against JAX's `flash_attention_gated_bias_trainable`:
    the output in both types, and in float32 the five gradients of jax.grad
    of <out, dO>, within 2e-6 of each gradient's largest magnitude (f32
    reassociation over T = 57 keys and the batch)."""
    inputs, do = arrays
    port_dtype, jax_dtype = TYPES[dtype]
    jax_args = _jax_args(inputs, jax_dtype)
    seed = jnp.int32(SEED)
    with jax_fa.softmax_mode_scope("bf16"):  # pinned to f32 all the same
        want = np.asarray(jax_fa.flash_attention_gated_bias_trainable(
            *jax_args, dropout_rate=rate, seed=seed).astype(jnp.float32))
    leaves = [x.clone().requires_grad_(port_dtype == torch.float32)
              for x in _port_args(inputs, port_dtype)]
    with fa.softmax_mode_scope("bf16"):
        got = fa.flash_attention_gated_bias_trainable(*leaves, dropout_rate=rate, seed=SEED)
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               **_tolerance(port_dtype, want))
    if port_dtype != torch.float32:
        return
    got.backward(torch.from_numpy(do))
    loss = lambda *a: jnp.vdot(jax_fa.flash_attention_gated_bias_trainable(  # noqa: E731
        *a, dropout_rate=rate, seed=seed), jnp.asarray(do))
    grads = jax.grad(loss, argnums=(0, 1, 2, 3, 4))(*jax_args)
    for name, x, g in zip(("q", "k", "v", "pos_bias", "gate"), leaves, grads):
        g = np.asarray(g)
        np.testing.assert_allclose(x.grad.numpy(), g, rtol=0,
                                   atol=2e-6 * float(np.abs(g).max()), err_msg=f"d{name}")


def test_scope_restores_and_bad_modes_raise():
    assert fa.softmax_mode() == "deferred"
    with fa.softmax_mode_scope("f32"):
        assert fa.softmax_mode() == "f32"
        with fa.softmax_mode_scope("bf16"):
            assert fa.softmax_mode() == "bf16"
        assert fa.softmax_mode() == "f32"
    assert fa.softmax_mode() == "deferred"
    with pytest.raises(RuntimeError, match="inside"):
        with fa.softmax_mode_scope("bf16"):
            raise RuntimeError("inside")
    assert fa.softmax_mode() == "deferred"
    try:
        fa.set_softmax_mode("f32")
        assert fa.softmax_mode() == "f32"
    finally:
        fa.set_softmax_mode("deferred")
    q, k, v, pos, gate = _port_args(_arrays(1, 1, 8, 8)[0], torch.float32)
    for bad in ("fp32", "F32", None):
        with pytest.raises(ValueError, match="softmax mode"):
            fa.set_softmax_mode(bad)
        with pytest.raises(ValueError, match="softmax mode"):
            with fa.softmax_mode_scope(bad):
                pass
        with pytest.raises(ValueError, match="softmax mode"):
            fa.flash_attention_gated_bias_reference(q, k, v, pos, gate, softmax_mode=bad)
    assert fa.softmax_mode() == "deferred"


class _ModeSpy:
    """Records the schedule each attention call of the port's WavLM reads:
    ("inference" | "trainable", softmax_mode() at the call)."""

    def __init__(self, monkeypatch):
        self.calls = []
        for name, kind in (("flash_attention_gated_bias", "inference"),
                           ("flash_attention_gated_bias_trainable", "trainable")):
            original = getattr(port_wavlm, name)

            def spy(*args, _original=original, _kind=kind, **kwargs):
                self.calls.append((_kind, fa.softmax_mode()))
                return _original(*args, **kwargs)

            monkeypatch.setattr(port_wavlm, name, spy)

    def modes(self, kind):
        return {mode for k, mode in self.calls if k == kind}


def test_trainer_steps_and_validation_run_f32(tmp_path, monkeypatch):
    _, cfg = tiny_configs()
    trainer = _trainer(tmp_path, cfg, max_epochs=1, log_every=1000)
    spy = _ModeSpy(monkeypatch)
    trainer.train_epoch(_batches(cfg, 2), epoch=0)
    assert spy.calls and spy.modes("trainable") == {"f32"} and not spy.modes("inference")
    assert fa.softmax_mode() == "deferred"
    spy.calls.clear()
    trainer.validate(_batches(cfg, 1))
    assert spy.calls and spy.modes("inference") == {"f32"} and not spy.modes("trainable")
    assert fa.softmax_mode() == "deferred"


def test_distill_prune_step_runs_its_teacher_in_f32(tmp_path, monkeypatch):
    """Each step of the distill-prune recipe, the teacher's inference forward
    included, reads "f32"; the process's schedule is back after the run."""
    import tomllib

    from diarizen_tpu_torch.models.convert import random_state_dict
    from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig
    from diarizen_tpu_torch.recipes.diar_ssl_pruning import run_distill_prune

    write_kaldi_dir(tmp_path / "data")
    teacher = tmp_path / "wavlm_tiny.pt"
    torch.save({"config": TINY_WAVLM, "state_dict": random_state_dict(
        WavLM(WavLMConfig.from_reference_dict(TINY_WAVLM)), seed=5)}, teacher)
    config = tomllib.loads(PRUNE_TOML.format(root=tmp_path, teacher=teacher))
    config["trainer"]["args"]["max_epochs"] = 1
    spy = _ModeSpy(monkeypatch)
    steps = []
    run_distill_prune.run(config, tmp_path / "exp", device="cpu", step_hook=steps.append)
    assert steps
    assert spy.modes("inference") == {"f32"} and spy.modes("trainable") == {"f32"}
    assert fa.softmax_mode() == "deferred"
