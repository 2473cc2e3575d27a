"""The port's training data, checkpoints and trainer on the CPU: the loader
against the JAX package's on the same Kaldi directory, the checkpoint
directory logic, the trainer's epoch loop, and a trained checkpoint loading
into the serving model and into the JAX package."""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diarizen_tpu.models.conformer import ConformerConfig as JaxConformerConfig
from diarizen_tpu.models.convert import eend_params_from_torch
from diarizen_tpu.models.eend import EendConfig as JaxEendConfig
from diarizen_tpu.models.eend import eend_forward
from diarizen_tpu.models.wavlm import WavLMConfig as JaxWavLMConfig
from diarizen_tpu.train.dataset import DataLoader as JaxDataLoader
from diarizen_tpu.train.dataset import DiarizationDataset as JaxDataset
from diarizen_tpu.train.dataset import gen_chunk_indices as jax_gen_chunk_indices
from diarizen_tpu_torch.core.audio import read_audio, read_wav, write_wav
from diarizen_tpu_torch.core.io_rttm import load_rttm, load_scp, load_uem
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.wavlm import WavLMConfig
from diarizen_tpu_torch.train import Trainer, TrainerConfig, dual_lr_optimizer
from diarizen_tpu_torch.train.checkpoint import (
    average_checkpoints,
    gc_checkpoints,
    latest_checkpoint,
    list_checkpoints,
    load_checkpoint,
    load_metrics,
    save_checkpoint,
    select_checkpoints,
)
from diarizen_tpu_torch.train.dataset import (
    DataLoader,
    DiarizationDataset,
    collate,
    gen_chunk_indices,
)


def tiny_configs(chunk_size=1.0):
    n = 2
    wavlm = JaxWavLMConfig(
        conv_layers=((32, 10, 5), (32, 3, 2), (32, 2, 2)), embed_dim=64, num_layers=n,
        use_attention=(True,) * n, use_feed_forward=(True,) * n, total_num_heads=(4,) * n,
        remaining_heads=(tuple(range(4)),) * n, ff_interm_features=(128,) * n,
        num_buckets=40, max_distance=100, layer_drop=0.0, dropout=0.0,
        attention_dropout=0.0, projection_dropout=0.0)
    jcfg = JaxEendConfig(
        wavlm=wavlm,
        conformer=JaxConformerConfig(dim=32, ffn_hidden=64, num_heads=4, num_layers=1,
                                     dropout=0.0),
        wavlm_layer_num=n + 1, wavlm_feat_dim=64, attention_in=32, chunk_size=chunk_size)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["wavlm"] = WavLMConfig(**dataclasses.asdict(jcfg.wavlm))
    fields["conformer"] = ConformerConfig(**dataclasses.asdict(jcfg.conformer))
    return jcfg, EendConfig(**fields)


@pytest.fixture
def kaldi_dir(tmp_path):
    """Two 12-second recordings: speaker A on [1, 5], B on [4.5, 9], and C
    on [8, 10] in the second."""
    sr = 16000
    scp, rttm, uem = [], [], []
    for rec, freq in (("rec1", 220), ("rec2", 330)):
        t = np.arange(12 * sr) / sr
        wave = np.zeros_like(t, dtype=np.float32)
        segments = [("A", 1.0, 5.0), ("B", 4.5, 9.0)] + ([("C", 8.0, 10.0)] if rec == "rec2" else [])
        for i, (spk, s, e) in enumerate(segments):
            m = (t >= s) & (t < e)
            wave[m] += 0.2 * np.sin(2 * np.pi * freq * (1 + 0.5 * i) * t[m]).astype(np.float32)
            rttm.append(f"SPEAKER {rec} 1 {s:.2f} {e - s:.2f} <NA> <NA> {spk} <NA> <NA>")
        path = tmp_path / f"{rec}.wav"
        write_wav(path, wave[None], sr)
        scp.append(f"{rec} {path}")
        uem.append(f"{rec} 1 0.0 12.0")
    (tmp_path / "wav.scp").write_text("\n".join(scp) + "\n")
    (tmp_path / "rttm").write_text("\n".join(rttm) + "\n")
    (tmp_path / "all.uem").write_text("\n".join(uem) + "\n")
    return tmp_path


def _datasets(kaldi_dir, cfg, chunk=2.0, shift=2.0):
    nf = cfg.num_frames(int(chunk * 16000))
    step, dur = cfg.rf_info()
    args = (str(kaldi_dir / "wav.scp"), str(kaldi_dir / "rttm"), str(kaldi_dir / "all.uem"))
    kwargs = dict(model_num_frames=nf, model_rf_duration=dur, model_rf_step=step,
                  chunk_size=chunk, chunk_shift=shift)
    return JaxDataset(*args, **kwargs), DiarizationDataset(*args, **kwargs)


def test_kaldi_io_and_wav_reads(kaldi_dir):
    scp = load_scp(kaldi_dir / "wav.scp")
    assert list(scp) == ["rec1", "rec2"]
    full, sr = read_wav(scp["rec1"])
    part, _ = read_audio(scp["rec1"], start_frame=16000, num_frames=8000)
    assert sr == 16000 and full.shape == (1, 12 * 16000) and full.dtype == np.float32
    np.testing.assert_array_equal(part, full[:, 16000:24000])
    rttm = load_rttm(kaldi_dir / "rttm")
    assert sorted(rttm["rec2"].labels()) == ["A", "B", "C"] and len(rttm["rec1"]) == 2
    assert load_uem(kaldi_dir / "all.uem")["rec1"].extent().end == 12.0
    with pytest.raises(ValueError, match="WAV"):  # neither WAV nor FLAC
        read_audio(kaldi_dir / "rec1.mp3")


def test_loader_batches_match_jax(kaldi_dir):
    jcfg, cfg = tiny_configs(chunk_size=2.0)
    jds, ds = _datasets(kaldi_dir, cfg, chunk=2.0, shift=1.0)
    assert ds.chunk_indices == jds.chunk_indices and len(ds) > 8
    for args in ((0.0, 12.0, 2.0, 2.0), (0.5, 30.2, 8.0, 6.0), (0.0, 9.0, 8.0, 6.0)):
        assert list(gen_chunk_indices(*args)) == list(jax_gen_chunk_indices(*args))
    for epoch in (0, 3):
        jl = JaxDataLoader(jds, batch_size=3, shuffle=True, seed=11, max_speakers_per_chunk=2)
        pl = DataLoader(ds, batch_size=3, shuffle=True, seed=11, max_speakers_per_chunk=2)
        jl.set_epoch(epoch)
        pl.set_epoch(epoch)
        want, got = list(jl), list(pl)
        assert len(got) == len(want) == len(pl) > 0
        for w, g in zip(want, got):
            assert g["names"] == w["names"]
            assert g["xs"].dtype == np.float32
            np.testing.assert_array_equal(g["xs"], w["xs"].astype(np.float32) / 32768.0)
            np.testing.assert_array_equal(g["target"], w["target"])
    # talkativeness order: three speakers cut to two keep the two busiest
    y = np.zeros((10, 3), np.uint8)
    y[:2, 0], y[:, 1], y[:6, 2] = 1, 1, 1
    out = collate([(np.zeros((1, 8), np.float32), y, "s")], max_speakers_per_chunk=2)
    np.testing.assert_array_equal(out["target"][0], y[:, [1, 2]])


def test_checkpoint_round_trip_gc_average_select(tmp_path):
    root = tmp_path / "ckpts"
    for epoch in range(5):
        sd = {"w": torch.full((3,), float(epoch)), "n": torch.tensor(epoch)}
        opt = {"count": {"a": epoch}, "mu": {"w": torch.ones(3)}, "clip": None}
        save_checkpoint(root, epoch, sd, opt, meta={"der": 1.0 - 0.1 * epoch})
    sd, opt, meta = load_checkpoint(root / "epoch_0002")
    torch.testing.assert_close(sd["w"], torch.full((3,), 2.0))
    assert opt["count"] == {"a": 2} and meta == {"epoch": 2, "der": 0.8}
    gc_checkpoints(root, 3)
    ckpts = list_checkpoints(root)
    assert [c.name for c in ckpts] == ["epoch_0002", "epoch_0003", "epoch_0004"]
    assert latest_checkpoint(root).name == "epoch_0004"
    avg = average_checkpoints(ckpts)
    torch.testing.assert_close(avg["w"], torch.full((3,), 3.0))
    assert int(avg["n"]) == 2  # counters are taken from the first
    metrics = [{"epoch": e, "der": 1.0 - 0.1 * e} for e in range(5)]
    assert [b.name for b in select_checkpoints(metrics, root, 2, "der", "best")] == [
        "epoch_0004", "epoch_0003"]
    assert [b.name for b in select_checkpoints(metrics, root, 2, "der", "prev")] == [
        "epoch_0003", "epoch_0004"]

    # garbage collection spares the protected best epoch
    other = tmp_path / "protect"
    for epoch in range(8):
        save_checkpoint(other, epoch, {"w": torch.zeros(2)}, max_keep=3, protect={2})
    kept = sorted(p.name for p in other.glob("epoch_*"))
    assert "epoch_0002" in kept and kept[-3:] == ["epoch_0005", "epoch_0006", "epoch_0007"]

    # reference selection modes: prev ends at the best epoch, center around it
    sel = tmp_path / "select"
    losses = [5.0, 4.0, 3.5, 2.0, 2.5, 2.2, 3.0, 3.1]
    metrics = [{"epoch": e, "loss": v} for e, v in enumerate(losses)]
    for epoch in range(len(losses)):
        save_checkpoint(sel, epoch, {"w": torch.zeros(1)})

    def epochs(mode, num):
        return [int(p.name.split("_")[1])
                for p in select_checkpoints(metrics, sel, num=num, metric="loss", mode=mode)]

    assert epochs("best", 3) == [3, 5, 4]
    assert epochs("prev", 3) == [1, 2, 3]
    assert epochs("center", 3) == [2, 3, 4]
    with pytest.warns(UserWarning, match="only 4"):
        assert epochs("prev", 6) == [0, 1, 2, 3]


def _trainer(tmp_path, cfg, **tc):
    model = EendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=0))
    opt = dual_lr_optimizer(model.param_groups(), lr_small=1e-4, lr_big=3e-3,
                            clip_percentile=None)
    tc = TrainerConfig(exp_dir=str(tmp_path / "exp"), compute_dtype="float32", **tc)
    return Trainer(model, tc, opt, device="cpu")


def _batches(cfg, n, nan_at=None):
    rng = np.random.default_rng(0)
    nf = cfg.num_frames(16000)
    out = []
    for i in range(n):
        xs = (0.1 * rng.standard_normal((2, 1, 16000))).astype(np.float32)
        if i == nan_at:
            xs[0, 0, 0] = np.nan
        target = np.zeros((2, nf, 4), np.float32)
        target[:, :, 0] = 1.0
        out.append({"xs": xs, "target": target})
    return out


def test_trainer_counts_every_batch_and_nan_skips(tmp_path):
    _, cfg = tiny_configs()
    trainer = _trainer(tmp_path, cfg, max_epochs=1, log_every=1000)
    m = trainer.train_epoch(_batches(cfg, 3, nan_at=1), epoch=0)
    assert m["train_batches"] == 3 and m["skipped_batches"] == 1
    assert math.isfinite(m["train_loss"]) and math.isfinite(m["train_grad_norm"])
    assert trainer.state.step == 3
    v = trainer.validate(_batches(cfg, 2))
    assert math.isfinite(v["loss"]) and math.isfinite(v["der"])


def test_trainer_two_epochs_checkpoint_and_resume(kaldi_dir, tmp_path):
    jcfg, cfg = tiny_configs(chunk_size=2.0)
    _, ds = _datasets(kaldi_dir, cfg)
    trainer = _trainer(tmp_path, cfg, max_epochs=2, patience=5, log_every=1)
    trainer.train(DataLoader(ds, batch_size=2, shuffle=True), DataLoader(ds, 2, shuffle=False))
    metrics = load_metrics(tmp_path / "exp")
    assert [m["epoch"] for m in metrics] == [0, 1]
    assert metrics[1]["loss"] < metrics[0]["loss"]
    assert math.isfinite(metrics[1]["der"])
    ckpt = tmp_path / "exp" / "checkpoints" / "epoch_0001"
    assert ckpt.exists() and json.loads((ckpt / "meta.json").read_text())["step"] == 2 * len(
        DataLoader(ds, 2))

    resumed = _trainer(tmp_path, cfg, max_epochs=2)
    assert resumed.resume() and resumed.start_epoch == 2
    assert resumed.state.step == trainer.state.step
    assert resumed.state.optimizer.state["count"] == trainer.state.optimizer.state["count"]

    # the trained checkpoint serves: into EendModel, and into the JAX package
    state_dict, _, _ = load_checkpoint(ckpt)
    served = EendModel(cfg)
    served.load_state_dict(state_dict)
    wave = np.asarray(DataLoader(ds, 2, shuffle=False).__iter__().__next__()["xs"])
    with torch.no_grad():
        got = served.eval()(torch.from_numpy(wave)).numpy()
    params, state = eend_params_from_torch({k: v.numpy() for k, v in state_dict.items()}, jcfg)
    want, _ = eend_forward(params, state, jcfg, jnp.asarray(wave))
    np.testing.assert_allclose(got, np.asarray(want), rtol=5e-4, atol=5e-4)


def test_trainer_checkpoints_every_epoch_with_validation_interval(tmp_path):
    _, cfg = tiny_configs()
    trainer = _trainer(tmp_path, cfg, max_epochs=3, validation_interval=3, log_every=1000)
    batches = _batches(cfg, 1)
    trainer.train(batches, batches)
    ckpts = sorted((tmp_path / "exp" / "checkpoints").glob("epoch_*"))
    assert [p.name for p in ckpts] == ["epoch_0000", "epoch_0001", "epoch_0002"]
    resumed = _trainer(tmp_path, cfg, max_epochs=3, validation_interval=3)
    assert resumed.resume() and resumed.start_epoch == 3


def test_trainer_defaults_to_cuda(tmp_path):
    _, cfg = tiny_configs()
    model = EendModel(cfg)
    opt = dual_lr_optimizer(model.param_groups())
    tc = TrainerConfig(exp_dir=str(tmp_path / "exp"))
    if torch.cuda.is_available():
        assert Trainer(model, tc, opt).state.model.weight_sum.weight.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(model, tc, opt)
    assert Trainer(model, tc, opt, device="cpu").state.model.weight_sum.weight.device.type == "cpu"


def test_dataset_short_chunk_modes(tmp_path):
    """A file shorter than its UEM claims: 'pad' zero-pads the chunk,
    'resample' draws another full-length chunk, as in the JAX package."""
    rng = np.random.default_rng(0)
    write_wav(tmp_path / "long.wav", (0.1 * rng.standard_normal((1, 6 * 16000))).astype(np.float32),
              16000)
    write_wav(tmp_path / "short.wav", (0.1 * rng.standard_normal((1, 24000))).astype(np.float32),
              16000)
    (tmp_path / "wav.scp").write_text(f"long {tmp_path / 'long.wav'}\nshort {tmp_path / 'short.wav'}\n")
    (tmp_path / "rttm").write_text("SPEAKER long 1 0.50 2.00 <NA> <NA> spkA <NA> <NA>\n"
                                   "SPEAKER short 1 0.20 1.50 <NA> <NA> spkB <NA> <NA>\n")
    (tmp_path / "all.uem").write_text("long 1 0.00 6.00\nshort 1 0.00 6.00\n")
    kwargs = dict(scp_file=str(tmp_path / "wav.scp"), rttm_file=str(tmp_path / "rttm"),
                  uem_file=str(tmp_path / "all.uem"), model_num_frames=99,
                  model_rf_duration=0.025, model_rf_step=0.02, chunk_size=2.0, chunk_shift=2.0)
    padded = DiarizationDataset(**kwargs)
    resampled = DiarizationDataset(**kwargs, short_chunk_mode="resample")
    short_idx = next(i for i, c in enumerate(padded.chunk_indices) if c[0] == "short")
    x, _, session = padded[short_idx]
    assert session == "short" and x.shape == (1, 32000) and np.all(x[:, -16000:] == 0)
    want = JaxDataset(**kwargs, short_chunk_mode="resample").__getitem__(
        short_idx, rng=np.random.default_rng(5))
    x, y, session = resampled.__getitem__(short_idx, rng=np.random.default_rng(5))
    assert session == want[2] == "long" and x.shape == (1, 32000)
    np.testing.assert_array_equal(x, want[0])
    np.testing.assert_array_equal(y, want[1])
