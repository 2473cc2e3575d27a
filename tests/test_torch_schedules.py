"""The port's learning-rate schedules, reduce-on-plateau and utils.py
against the JAX package and optax.

Schedules: every step 0..N (warmup, the peak, the end and past it) within
1e-7 relative. `noam_schedule` is float32 in both packages; optax's one-cycle
runs under jax's 64-bit mode here, so that the comparison sees the formula
and not float32 rounding (the port computes it in float64). Reduce-on-plateau:
its state after every value of one sequence (improving, flat past the
patience, cooldown, averaged) equals optax's (scale within 1e-7 relative,
counts exact), and AdamW followed by it moves a tiny tensor dict as
`optax.chain(adamw, reduce_on_plateau)` does (1e-5 relative, 1e-6 absolute:
the bar of the port's AdamW against optax), inside gradient accumulation too
(`optax.MultiSteps`: one value per real update).
"""

import math
import random
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from diarizen_tpu import utils as jax_utils
from diarizen_tpu.train import optim as jax_optim
from diarizen_tpu_torch import config, utils
from diarizen_tpu_torch.train import optim

VALUES = [5.0, 4.0, 3.0, 3.0, 3.0, 3.0, 3.0, 3.0, 2.9999, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5, 2.5,
          2.5, 2.5, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 1.0]
PLATEAUS = {"defaults": {}, "cooldown": {"patience": 2, "cooldown": 2},
            "averaged": {"accumulation_size": 2}, "absolute": {"rtol": 0.0, "atol": 0.1},
            "floor": {"factor": 0.1, "patience": 1, "min_scale": 0.05}}


def test_utils_equal_jax(tmp_path):
    for pkg in (utils, jax_utils):
        pkg.set_random_seed(1)
        a = (np.random.rand(3), random.random(), torch.rand(2))
        pkg.set_random_seed(1)
        np.testing.assert_array_equal(a[0], np.random.rand(3))
        assert a[1] == random.random() and torch.equal(a[2], torch.rand(2))

    x = np.array([1.0, np.inf, -np.inf, np.nan])
    np.testing.assert_array_equal(utils.clamp_inf_value(x), jax_utils.clamp_inf_value(x))
    np.testing.assert_array_equal(utils.clamp_inf_value(x, 5.0), [1.0, 5.0, -5.0, 0.0])
    t = utils.clamp_inf_value(torch.from_numpy(x))
    assert isinstance(t, torch.Tensor)
    np.testing.assert_array_equal(t.numpy(), [1.0, 1e10, -1e10, 0.0])

    d = utils.prepare_empty_dir(tmp_path / "x")
    (d / "f").write_text("1")
    assert not (utils.prepare_empty_dir(tmp_path / "x") / "f").exists()  # wiped
    (d / "f").write_text("1")
    assert (utils.prepare_empty_dir(tmp_path / "x", resume=True) / "f").exists()

    timer = utils.Timer()
    with timer:
        time.sleep(0.01)
    first = timer.elapsed
    assert first >= 0.01 and timer.stop() == first  # stop without start keeps it
    timer.start()
    assert timer.stop() >= first  # spans add up


def test_print_env_reports_torch_and_the_group(capsys):
    info = utils.print_env()
    assert info["torch"] == torch.__version__ and info["cuda"] == torch.version.cuda
    assert len(info["devices"]) == torch.cuda.device_count()
    assert (info["process_index"], info["process_count"]) == (0, 1)
    assert "jax" not in info and f"torch: {torch.__version__}" in capsys.readouterr().out


@pytest.mark.parametrize("model_size, warmup, factor", [(256, 25, 1.0), (768, 4000, 2.0),
                                                        (3, 7, 0.3)])
def test_noam_schedule_equals_jax(model_size, warmup, factor):
    ours = optim.noam_schedule(model_size, warmup, factor)
    ref = jax.jit(jax_optim.noam_schedule(model_size, warmup, factor))
    steps = list(range(3 * warmup if warmup < 100 else 120)) + [warmup - 1, warmup, 10**5]
    for step in steps:
        expected = float(ref(step))
        assert abs(ours(step) - expected) <= 1e-7 * expected, step


@pytest.mark.parametrize("max_lr, total_steps, pct_start", [(1e-3, 100, 0.3), (0.5, 37, 0.25),
                                                            (2e-4, 1000, 0.1)])
def test_one_cycle_schedule_equals_optax(max_lr, total_steps, pct_start):
    ours = optim.one_cycle_schedule(max_lr, total_steps, pct_start)
    steps = range(total_steps + 5)
    with jax.enable_x64(True):
        ref = jax_optim.one_cycle_schedule(max_lr, total_steps, pct_start)
        expected = [float(ref(step)) for step in steps]
    got = [ours(step) for step in steps]
    np.testing.assert_allclose(got, expected, rtol=1e-7, atol=0)
    peak = int(pct_start * total_steps)
    assert got[0] == pytest.approx(max_lr / 25, rel=1e-12)
    assert got[peak] == pytest.approx(max_lr, rel=1e-12)
    assert got[-1] == got[total_steps] == pytest.approx(max_lr / 25 / 1e4, rel=1e-12)


@pytest.mark.parametrize("kwargs", PLATEAUS.values(), ids=PLATEAUS.keys())
def test_plateau_state_equals_optax(kwargs):
    kwargs = {"factor": 0.5, "patience": 3, "min_scale": 1e-3, **kwargs}
    ref = optax.contrib.reduce_on_plateau(**kwargs)
    ref_state = ref.init({"w": jnp.zeros(2)})
    update = jax.jit(lambda s, v: ref.update({"w": jnp.ones(2)}, s, value=v)[1])
    plateau = optim.ReduceOnPlateau(**kwargs)
    state = plateau.init()
    scales = []
    for value in VALUES:
        ref_state = update(ref_state, value)
        state = plateau.update(state, value)
        scales.append(state["scale"])
        assert state["scale"] == pytest.approx(float(ref_state.scale), rel=1e-7)
        for key in ("plateau_count", "cooldown_count", "count"):
            assert state[key] == int(getattr(ref_state, key)), key
    assert scales[-1] < 1.0  # the sequence did reduce


def _tiny_params(seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(5).astype(np.float32)}


def _run_both(make_ours, ref_opt, values):
    """Steps both optimizers over the same gradients and values, holding the
    parameters equal after every call (1e-5 relative, 1e-6 absolute, as the
    port's AdamW is held to optax's); returns both optimizers' states."""
    init = _tiny_params()
    params = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in init.items()}
    ours = make_ours(params)
    ref_params = {n: jnp.asarray(a) for n, a in init.items()}
    ref_state = ref_opt.init(ref_params)
    rng = np.random.default_rng(1)
    for i, value in enumerate(values):
        grads = {n: (1 + i) * rng.standard_normal(a.shape).astype(np.float32)
                 for n, a in init.items()}
        updates, ref_state = ref_opt.update({n: jnp.asarray(g) for n, g in grads.items()},
                                            ref_state, ref_params, value=value)
        ref_params = optax.apply_updates(ref_params, updates)
        ours.step([torch.from_numpy(grads[n]) for n in params], value=value)
        for n in params:
            np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(ref_params[n]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {i} {n}")
    return ours, ref_state


def test_adamw_with_plateau_equals_optax():
    """The scale multiplies AdamW's whole update, weight decay included."""
    ref = optax.chain(optax.adamw(0.01, weight_decay=0.1), jax_optim.reduce_on_plateau())
    ours, ref_state = _run_both(
        lambda p: optim.Optimizer({"all": p}, {"all": lambda step: 0.01}, weight_decay=0.1,
                                  plateau=optim.reduce_on_plateau()), ref, VALUES[:12])
    assert ours.state["plateau"]["scale"] == float(ref_state[1].scale) == 0.25
    with pytest.raises(ValueError, match="value"):
        ours.step()


def test_plateau_inside_accumulation_equals_multisteps():
    """optax.MultiSteps around the chain: the plateau sees the value of every
    k-th call, one per real update."""
    ref = optax.MultiSteps(optax.chain(optax.adamw(0.01), jax_optim.reduce_on_plateau(
        patience=1)), every_k_schedule=2)
    ours, ref_state = _run_both(
        lambda p: optim.with_gradient_accumulation(optim.Optimizer(
            {"all": p}, {"all": lambda step: 0.01}, weight_decay=1e-4,
            plateau=optim.reduce_on_plateau(patience=1)), 2),
        ref, [3.0, 9.0, 2.0, 9.0, 2.0, 9.0, 2.0, 0.5, 9.0, 9.0])
    # the values of the odd calls (9.0) never reach the plateau: the scale
    # halves after 2.0, 2.0 and after 9.0, 9.0, not after every call
    scale = ours.optimizer.state["plateau"]["scale"]
    assert scale == float(ref_state.inner_opt_state[1].scale) == 0.125


def test_noam_adamw_equals_jax_and_plateau_state_round_trips():
    init = _tiny_params()
    params = {n: torch.nn.Parameter(torch.from_numpy(a.copy())) for n, a in init.items()}
    ours = optim.noam_adamw(params, model_size=1024, warmup=3)
    ref = jax_optim.noam_adamw(1024, 3)
    ref_params = {n: jnp.asarray(a) for n, a in init.items()}
    ref_state = ref.init(ref_params)
    rng = np.random.default_rng(1)
    for step in range(6):
        grads = {n: rng.standard_normal(a.shape).astype(np.float32) for n, a in init.items()}
        updates, ref_state = ref.update({n: jnp.asarray(g) for n, g in grads.items()},
                                        ref_state, ref_params)
        ref_params = optax.apply_updates(ref_params, updates)
        ours.step([torch.from_numpy(grads[n]) for n in params])
        for n in params:
            np.testing.assert_allclose(params[n].detach().numpy(), np.asarray(ref_params[n]),
                                       rtol=1e-5, atol=1e-6, err_msg=f"step {step} {n}")
    assert ours.weight_decay == 0.0

    plateau = optim.Optimizer({"all": params}, {"all": lambda step: 0.1},
                              plateau=optim.reduce_on_plateau(patience=1))
    for value in (3.0, 3.0, 3.0):
        plateau.step([torch.zeros_like(p) for p in params.values()], value=value)
    saved = plateau.state_dict()
    again = optim.Optimizer({"all": params}, {"all": lambda step: 0.1},
                            plateau=optim.reduce_on_plateau(patience=1))
    again.load_state_dict(saved)
    assert again.state["plateau"] == saved["plateau"] and saved["plateau"]["scale"] == 0.25


def test_jax_paths_resolve_to_the_port():
    for module, names in (
            ("train.optim", ("noam_schedule", "noam_adamw", "one_cycle_schedule",
                             "reduce_on_plateau")),
            ("utils", ("set_random_seed", "prepare_empty_dir", "clamp_inf_value", "Timer",
                       "print_env")),
            ("parallel.distributed", ("initialize_distributed", "is_main_process",
                                      "gather_to_host", "broadcast_from_host",
                                      "process_window_shard", "reassemble_window_shards",
                                      "gather_window_shards"))):
        for name in names:
            target = config.resolve(f"diarizen_tpu.{module}.{name}")
            assert target.__module__ == f"diarizen_tpu_torch.{module}", name
    sched = config.instantiate("diarizen_tpu.train.optim.one_cycle_schedule",
                               {"max_lr": 1.0, "total_steps": 10})
    assert sched(3) == 1.0 and math.isclose(sched(10), 1 / 25 / 1e4)
