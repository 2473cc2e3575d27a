"""Snapshot directory -> RTTM through the port's `pipelines.from_pretrained`,
against the JAX package's on the same faux snapshot (reference-schema
`config.toml`, `pytorch_model.bin`, a reference-format WavLM checkpoint, a
`plda/` directory, a ResNet34 checkpoint): AHC and VBx, float32 on the CPU.
Also VBx, the audio helpers, the config system and the out-of-memory batch
backoff against the JAX package's."""

import importlib
import inspect
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from diarizen_tpu import config as jax_config
from diarizen_tpu.core import audio as jax_audio
from diarizen_tpu.core.segments import Segment as JaxSegment
from diarizen_tpu.infer import SlidingInference as JaxSlidingInference
from diarizen_tpu.models.convert import load_eend_checkpoint as jax_load_eend_checkpoint
from diarizen_tpu.pipelines import from_pretrained as jax_from_pretrained
from diarizen_tpu.train.checkpoint import load_pytree as jax_load_pytree
from diarizen_tpu.train.checkpoint import save_pytree as jax_save_pytree
from diarizen_tpu_torch import config, pipelines, utils
from diarizen_tpu_torch.cluster import AgglomerativeClustering, VBxClustering
from diarizen_tpu_torch.core import audio
from diarizen_tpu_torch.core.segments import Segment
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models import build
from diarizen_tpu_torch.models.conformer import ConformerConfig
from diarizen_tpu_torch.models.convert import load_pytree, random_state_dict
from diarizen_tpu_torch.models.eend import EendConfig, EendModel
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.models.wavlm import WavLM, WavLMConfig

# the packages export the function `vbx` under the module's name
jax_vbx = importlib.import_module("diarizen_tpu.cluster.vbx")
port_vbx = importlib.import_module("diarizen_tpu_torch.cluster.vbx")

SR = 16000
DURATION, STEP = 2.0, 0.4  # 6400-sample hop: lands on the fbank's 160-sample hop

# a pruned post-LN WavLM in the reference's factory-kwargs format; 399 frames per 2 s
TINY_WAVLM = dict(
    extractor_mode="group_norm",
    extractor_conv_layer_config=[[32, 10, 5], [32, 5, 4], [32, 4, 4]],
    extractor_conv_bias=False,
    encoder_embed_dim=64,
    encoder_projection_dropout=0.1,
    encoder_pos_conv_kernel=16,
    encoder_pos_conv_groups=4,
    encoder_num_layers=3,
    encoder_use_attention=[True, True, False],
    encoder_use_feed_forward=[True, True, True],
    encoder_total_num_heads=[4, 4, 4],
    encoder_remaining_heads=[[0, 1, 2, 3], [1, 3], []],
    encoder_num_buckets=40,
    encoder_max_distance=100,
    encoder_attention_dropout=0.1,
    encoder_ff_interm_features=[48, 32, 24],
    encoder_ff_interm_dropout=0.0,
    encoder_dropout=0.1,
    encoder_layer_norm_first=False,
    encoder_layer_drop=0.05,
    normalize_waveform=False,
)

# the hub snapshot's schema with the reference's own class path
SNAPSHOT_TOML = """\
[model]
path = "diarizen.models.eend.model_wavlm_conformer.Model"
[model.args]
wavlm_src = "{wavlm_src}"
wavlm_layer_num = 4
wavlm_feat_dim = 64
attention_in = 32
ffn_hidden = 64
num_head = 4
num_layer = 1
dropout = 0.1
chunk_size = {chunk_size}
use_posi = false
output_activate_function = false
selected_channel = 0
max_speakers_per_chunk = 4

[inference]
[inference.args]
seg_duration = {chunk_size}
segmentation_step = {seg_step}
batch_size = 5
apply_median_filtering = true

[clustering]
[clustering.args]
method = "{method}"
min_speakers = 1
max_speakers = 5
min_cluster_size = 4
ahc_threshold = 0.62
ahc_criterion = "distance"
Fa = 0.07
Fb = 0.8
lda_dim = 16
max_iters = 10
"""


def make_plda_dir(path, rng, xdim, ldadim):
    lda = rng.standard_normal((xdim, ldadim))
    np.savez(path / "xvec_transform.npz", mean1=rng.standard_normal(xdim),
             mean2=rng.standard_normal(ldadim), lda=lda)
    tr = rng.standard_normal((ldadim, ldadim)) + np.eye(ldadim) * 2.0
    psi = np.sort(rng.uniform(0.5, 5.0, size=ldadim))[::-1]
    np.savez(path / "plda.npz", mu=rng.standard_normal(ldadim), tr=tr, psi=psi)
    return str(path)


def make_wave(dur_s=7.3):
    """Two-speaker synthetic meeting, quantised like PCM16; leaves an orphan
    last window."""
    t = np.arange(int(dur_s * SR)) / SR
    wave = np.zeros_like(t)
    rng = np.random.default_rng(0)
    pos, spk = 0.0, 0
    while pos < dur_s - 0.5:
        seg = rng.uniform(0.8, 2.0)
        m = (t >= pos) & (t < pos + seg)
        wave[m] += 0.3 * np.sin(2 * np.pi * (200 + 150 * spk) * t[m])
        wave[m] += 0.02 * rng.standard_normal(int(m.sum()))
        pos += seg * rng.uniform(0.5, 0.9)
        spk = 1 - spk
    wave = np.clip(np.rint(wave * 32767.0), -32768, 32767) / 32768.0
    return wave[None].astype(np.float32)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """{method: snapshot directory}, the EEND state dict both hold, the
    ResNet34 checkpoint and a wav file."""
    root = tmp_path_factory.mktemp("pretrained")
    wavlm_src = root / "wavlm_tiny.pt"
    args = dict(wavlm_layer_num=4, wavlm_feat_dim=64, attention_in=32, ffn_hidden=64,
                num_head=4, num_layer=1, chunk_size=DURATION)
    # the WavLM checkpoint: the architecture above with seeded weights
    wavlm = WavLM(WavLMConfig.from_reference_dict(TINY_WAVLM))
    torch.save({"config": TINY_WAVLM, "state_dict": random_state_dict(wavlm, seed=5)}, wavlm_src)
    _, model = build.wavlm_conformer(wavlm_src=str(wavlm_src), seed=3, **args)
    eend_sd = random_state_dict(model, seed=4)
    eend_sd["classifier.weight"] = eend_sd["classifier.weight"] * 100.0  # decisions far from ties
    resnet_ckpt = root / "resnet34.bin"
    torch.save({"state_dict": random_state_dict(ResNet(ResNetConfig()), seed=1)}, resnet_ckpt)

    dirs = {}
    for method in ("AgglomerativeClustering", "VBxClustering"):
        snap = root / method
        snap.mkdir()
        torch.save(eend_sd, snap / "pytorch_model.bin")
        (snap / "config.toml").write_text(SNAPSHOT_TOML.format(
            wavlm_src=wavlm_src, chunk_size=DURATION, seg_step=STEP / DURATION, method=method))
        if method == "VBxClustering":
            (snap / "plda").mkdir()
            make_plda_dir(snap / "plda", np.random.default_rng(3), xdim=256, ldadim=16)
        dirs[method] = snap
    wav = root / "meeting.wav"
    audio.write_wav(wav, make_wave(), SR)
    return dirs, eend_sd, resnet_ckpt, wav


def _port_pipeline(snap, resnet_ckpt, **kw):
    pipe = pipelines.from_pretrained(snap, embedding_ckpt=resnet_ckpt, device="cpu", **kw)
    pipe.seg_inference.compute_dtype = torch.float32
    return pipe


@pytest.mark.parametrize("method", ["AgglomerativeClustering", "VBxClustering"])
def test_from_pretrained_applies_the_snapshot(snapshots, method):
    dirs, eend_sd, resnet_ckpt, _ = snapshots
    pipe = _port_pipeline(dirs[method], resnet_ckpt)
    ref = jax_from_pretrained(dirs[method], embedding_ckpt=resnet_ckpt)
    if method == "VBxClustering":
        assert isinstance(pipe.clustering, VBxClustering)
        for name in ("plda_dir", "ahc_criterion", "ahc_threshold", "fa", "fb", "lda_dim",
                     "max_iters", "loop_prob"):
            assert getattr(pipe.clustering, name) == getattr(ref.clustering, name), name
        assert pipe.clustering.ahc_threshold == 0.62 and pipe.clustering.max_iters == 10
    else:
        assert isinstance(pipe.clustering, AgglomerativeClustering)
        assert pipe.clustering.threshold == ref.clustering.threshold == 0.62
        assert pipe.clustering.min_cluster_size == ref.clustering.min_cluster_size == 4
    for name in ("max_speakers", "min_speakers", "apply_median_filtering"):
        assert getattr(pipe, name) == getattr(ref, name), name
    seg, ref_seg = pipe.seg_inference, ref.seg_inference
    assert (seg.duration, seg.batch_size, seg.window_size, seg.step_size) == (
        ref_seg.duration, ref_seg.batch_size, ref_seg.window_size, ref_seg.step_size)
    assert np.isclose(seg.step, STEP) and seg.batch_size == 5 and pipe.max_speakers == 5
    assert pipe.emb_inference.batch_size == 5 and pipe.emb_inference.num_speakers == 4
    assert pipe.seg_inference.device.type == "cpu"
    # the snapshot's weights are live, in both packages
    loaded = pipe.seg_inference.model.state_dict()
    assert all(torch.equal(loaded[k], v) for k, v in eend_sd.items())
    np.testing.assert_array_equal(np.asarray(ref_seg._params["classifier"]["w"]),
                                  eend_sd["classifier.weight"].numpy().T)
    assert pipe.eend_cfg.wavlm == WavLMConfig.from_reference_dict(TINY_WAVLM)


@pytest.mark.parametrize("method", ["AgglomerativeClustering", "VBxClustering"])
def test_rttm_identical_to_jax(snapshots, method, tmp_path):
    dirs, _, resnet_ckpt, wav = snapshots
    pipe = _port_pipeline(dirs[method], resnet_ckpt, rttm_out_dir=tmp_path / "out")
    ref = jax_from_pretrained(dirs[method], embedding_ckpt=resnet_ckpt)
    old = ref.seg_inference
    ref.seg_inference = JaxSlidingInference(
        old._params, old._state, old.cfg, duration=old.duration, step=old.step,
        batch_size=old.batch_size, compute_dtype=jnp.float32)
    ref.fused_stitch = False
    wave, sr = jax_audio.read_audio(wav)
    expected = ref(wave, sr, uri="meeting").to_rttm()
    got = pipelines.diarize_file(pipe, wav)
    assert len(expected.splitlines()) > 1
    assert got.to_rttm() == expected
    assert (tmp_path / "out" / "meeting.rttm").read_text() == expected


@pytest.fixture(scope="module")
def npz_snapshot(snapshots):
    """A snapshot directory as the JAX trainer leaves one: the AHC
    snapshot's config.toml and, instead of pytorch_model.bin, the params of
    the fixture's state dict (through the JAX loader) in params.npz."""
    dirs, _, _, _ = snapshots
    src = dirs["AgglomerativeClustering"]
    snap = src.parent / "npz_only"
    snap.mkdir()
    (snap / "config.toml").write_text((src / "config.toml").read_text())
    cfg = jax_from_pretrained(src).seg_inference.cfg
    params, _ = jax_load_eend_checkpoint(str(src / "pytorch_model.bin"), cfg)
    jax_save_pytree(snap / "params.npz", params)
    return snap


def test_params_npz_snapshot_loads_its_weights(snapshots, npz_snapshot, tmp_path):
    _, eend_sd, resnet_ckpt, _ = snapshots
    loaded = _port_pipeline(npz_snapshot, resnet_ckpt).seg_inference.model.state_dict()
    assert loaded.keys() == eend_sd.keys()
    for name, value in eend_sd.items():
        assert torch.equal(loaded[name], value), name
    # pytorch_model.bin keeps its priority over params.npz
    both = tmp_path / "both"
    both.mkdir()
    (both / "config.toml").write_text((npz_snapshot / "config.toml").read_text())
    (both / "params.npz").write_bytes((npz_snapshot / "params.npz").read_bytes())
    other = {k: v + 1.0 if v.is_floating_point() else v for k, v in eend_sd.items()}
    torch.save(other, both / "pytorch_model.bin")
    loaded = _port_pipeline(both, resnet_ckpt).seg_inference.model.state_dict()
    assert torch.equal(loaded["classifier.weight"], other["classifier.weight"])


def test_params_npz_rttm_identical_to_jax(snapshots, npz_snapshot):
    _, _, resnet_ckpt, wav = snapshots
    pipe = _port_pipeline(npz_snapshot, resnet_ckpt)
    ref = jax_from_pretrained(npz_snapshot, embedding_ckpt=resnet_ckpt)
    old = ref.seg_inference
    ref.seg_inference = JaxSlidingInference(
        old._params, old._state, old.cfg, duration=old.duration, step=old.step,
        batch_size=old.batch_size, compute_dtype=jnp.float32)
    ref.fused_stitch = False
    wave, sr = jax_audio.read_audio(wav)
    expected = ref(wave, sr, uri="meeting").to_rttm()
    assert len(expected.splitlines()) > 1
    assert pipelines.diarize_file(pipe, wav).to_rttm() == expected


def test_npz_reader_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    tree = {"a": rng.standard_normal((3, 2)).astype(np.float32),
            "blocks": [{"w": rng.standard_normal(4), "pair": (np.arange(3), np.float32(2.5))},
                       {"w": rng.standard_normal(4), "pair": (np.arange(2), np.float32(-1.0))}],
            "nested": {"t": (np.ones(2, np.int32), [np.zeros((1, 1)), np.array(7)])}}
    jax_save_pytree(tmp_path / "tree.npz", tree)
    got, want = load_pytree(tmp_path / "tree.npz"), jax_load_pytree(tmp_path / "tree.npz")

    def same(a, b):
        assert type(a) is type(b)
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                same(a[k], b[k])
        elif isinstance(a, (list, tuple)):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                same(x, y)
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)

    same(got, want)
    assert isinstance(got["blocks"], list) and isinstance(got["nested"]["t"], tuple)
    jax_save_pytree(tmp_path / "leaf.npz", np.arange(5))
    np.testing.assert_array_equal(load_pytree(tmp_path / "leaf.npz"), np.arange(5))


def test_cli_writes_the_rttm_of_diarize_file(snapshots, tmp_path, capsys):
    dirs, _, resnet_ckpt, wav = snapshots
    snap = dirs["VBxClustering"]
    scp = tmp_path / "wav.scp"
    scp.write_text(f"recA {wav}\nrecB {wav}\n")
    # the CLI's segmentation runs in bfloat16; compare with the same setting
    pipe = pipelines.from_pretrained(snap, embedding_ckpt=resnet_ckpt, device="cpu")
    expected = {uri: pipelines.diarize_file(pipe, wav, uri=uri).to_rttm()
                for uri in ("recA", "recB")}
    pipelines.main(["--in_wav_scp", str(scp), "--model_dir", str(snap), "--embedding_model",
                    str(resnet_ckpt), "--rttm_out_dir", str(tmp_path / "rttm"),
                    "--device", "cpu"])
    for uri, text in expected.items():
        assert text and (tmp_path / "rttm" / f"{uri}.rttm").read_text() == text
    assert "recA:" in capsys.readouterr().out


def test_overrides_layer_as_in_jax(snapshots):
    dirs, _, resnet_ckpt, _ = snapshots
    kw = dict(inference_overrides=dict(batch_size=3, segmentation_step=None,
                                       apply_median_filtering=False),
              clustering_overrides=dict(method="AgglomerativeClustering", max_speakers=2,
                                        ahc_threshold=None, min_cluster_size=7))
    pipe = _port_pipeline(dirs["VBxClustering"], resnet_ckpt, **kw)
    ref = jax_from_pretrained(dirs["VBxClustering"], embedding_ckpt=resnet_ckpt, **kw)
    for p in (pipe, ref):
        assert type(p.clustering).__name__ == "AgglomerativeClustering"
        assert p.clustering.threshold == 0.62 and p.clustering.min_cluster_size == 7
        assert p.max_speakers == 2 and p.apply_median_filtering is False
        assert p.seg_inference.batch_size == 3 and np.isclose(p.seg_inference.step, STEP)


def test_entry_points_default_to_the_card(snapshots, tmp_path):
    dirs, _, resnet_ckpt, wav = snapshots
    if torch.cuda.is_available():
        pytest.skip("needs a machine without a CUDA device")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelines.from_pretrained(dirs["AgglomerativeClustering"], embedding_ckpt=resnet_ckpt)
    scp = tmp_path / "wav.scp"
    scp.write_text(f"rec {wav}\n")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pipelines.main(["--in_wav_scp", str(scp), "--model_dir",
                        str(dirs["AgglomerativeClustering"]), "--rttm_out_dir",
                        str(tmp_path / "rttm")])
    with pytest.raises(FileNotFoundError, match="neither a local model directory"):
        pipelines.from_pretrained(tmp_path / "no-such-snapshot", device="cpu")


_seen_kwargs = {}


def stub_factory(wavlm_src="wavlm_base", _allow_missing_wavlm_src=False, **kwargs):
    _seen_kwargs.update(wavlm_src=wavlm_src, allow=_allow_missing_wavlm_src, **kwargs)
    return build._load_wavlm(wavlm_src, allow_missing=_allow_missing_wavlm_src)


def plain_factory(wavlm_src="wavlm_base"):
    return wavlm_src


def test_missing_wavlm_src_falls_back_only_for_inference_loading():
    dead = "/YOUR_PATH/WavLM-Base+.pt"
    with pytest.raises(FileNotFoundError, match="neither a preset name"):
        build._load_wavlm(dead)
    with pytest.raises(FileNotFoundError, match="neither a preset name"):
        build.wavlm_conformer(wavlm_src=dead)  # a training entry point fails loudly
    with pytest.raises(FileNotFoundError):
        build._load_wavlm("/YOUR_PATH/hubert.pt", allow_missing=True)  # nothing to infer
    for name, preset in (("WavLM-Base+.pt", "wavlm_base"), ("wavlm_large.pt", "wavlm_large"),
                         ("large_s80_md.pt", "wavlm_large_s80_md"),
                         ("base-s80.pt", "wavlm_base_s80_md")):
        with pytest.warns(UserWarning, match=preset):
            cfg, sd = build._load_wavlm(f"/YOUR_PATH/{name}", allow_missing=True)
        assert sd is None and cfg == WavLMConfig.from_preset(preset)
    # only the inference instantiation sets the flag, and only where the factory takes it
    cfg, sd = config.instantiate(f"{__name__}.stub_factory", {"wavlm_src": "wavlm_base"})
    assert _seen_kwargs["allow"] is False
    with pytest.warns(UserWarning):
        cfg, sd = config.instantiate_model_for_inference(
            f"{__name__}.stub_factory", {"wavlm_src": dead})
    assert _seen_kwargs["allow"] is True and cfg == WavLMConfig.base()
    assert config.instantiate_model_for_inference(
        f"{__name__}.plain_factory", {"wavlm_src": dead}) == dead


def test_config_system_equals_jax(tmp_path):
    nested = {"meta": {"seed": 3, "save": True, "name": 'a "quoted" \\ name'},
              "model": {"path": "diarizen.models.eend.model_wavlm_conformer.Model",
                        "args": {"wavlm_src": "wavlm_base", "dropout": 0.1,
                                 "layers": [1, 2, 3]}}}
    config.dump_toml(nested, tmp_path / "a.toml")
    jax_config.dump_toml(nested, tmp_path / "b.toml")
    assert (tmp_path / "a.toml").read_text() == (tmp_path / "b.toml").read_text()
    assert config.load_toml(tmp_path / "a.toml") == nested == jax_config.load_toml(
        tmp_path / "a.toml")
    overrides = {"model.args.dropout": 0.2, "trainer.args.max_epochs": 5}
    assert config.apply_overrides(nested, overrides) == jax_config.apply_overrides(
        nested, overrides)
    assert nested["model"]["args"]["dropout"] == 0.1  # a copy was changed
    # every alias of the port points into the port and resolves (to a
    # factory, or to a module: the pruning TOMLs' `[trainer] path` names
    # `diarizen_tpu.prune.distill`); its key is a reference path of the JAX
    # package's table or a path that the JAX package resolves itself (the
    # repo's recipe TOMLs name those)
    def resolved(target):
        return callable(target) or inspect.ismodule(target)

    for ref_path, target in config.REFERENCE_PATH_ALIASES.items():
        assert ref_path in jax_config.REFERENCE_PATH_ALIASES or resolved(
            jax_config.resolve(ref_path))
        assert target.startswith("diarizen_tpu_torch.") and resolved(config.resolve(ref_path))
    # the JAX package's table is covered whole; its mesh paths resolve to the
    # port's mesh, and any other path into the JAX package that the table
    # does not alias raises, naming the path, instead of importing the JAX
    # package
    assert set(jax_config.REFERENCE_PATH_ALIASES) <= set(config.REFERENCE_PATH_ALIASES)
    from diarizen_tpu_torch.parallel import mesh as port_mesh

    for own in ("eend_param_shardings", "make_mesh"):
        path = f"diarizen_tpu.parallel.mesh.{own}"
        assert callable(jax_config.resolve(path))
        assert config.resolve(path) is getattr(port_mesh, own)
    other = "diarizen_tpu.parallel.mesh.shard_batch"
    assert callable(jax_config.resolve(other))
    with pytest.raises(NotImplementedError, match=other.replace(".", r"\.")):
        config.resolve(other)
    assert config.instantiate_section(
        {"x": {"path": f"{__name__}.plain_factory", "args": {"wavlm_src": "w"}}}, "x") == "w"


# ---------------------------------------------------------------------------
# VBx


@pytest.mark.parametrize("loop_prob", [0.0, 0.9], ids=["gmm", "hmm"])
def test_vbx_equals_jax(loop_prob):
    rng = np.random.default_rng(1)
    fea = rng.standard_normal((80, 8)) + 2.0 * np.eye(8)[rng.integers(0, 3, 80)]
    phi = np.sort(rng.uniform(0.5, 4.0, 8))[::-1]
    labels = rng.integers(0, 3, size=80)
    kw = dict(fa=0.3, fb=4.0, loop_prob=loop_prob, max_iters=15)
    gamma, pi = port_vbx.cluster_vbx(labels, fea.copy(), phi, **kw)
    ref_gamma, ref_pi = jax_vbx.cluster_vbx(labels, fea.copy(), phi, **kw)
    np.testing.assert_allclose(gamma, ref_gamma, rtol=0, atol=1e-10)
    np.testing.assert_allclose(pi, ref_pi, rtol=0, atol=1e-10)
    assert gamma.shape == (80, 3) and np.allclose(gamma.sum(axis=1), 1.0)
    qinit = np.full((80, 3), 1 / 3)
    out = port_vbx.vbx(fea, phi, loop_prob=loop_prob, pi=3, gamma=qinit, max_iters=4)
    ref = jax_vbx.vbx(fea, phi, loop_prob=loop_prob, pi=3, gamma=qinit, max_iters=4)
    for a, b in zip(out, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-10)


def test_forward_backward_equals_jax():
    rng = np.random.default_rng(2)
    log_p = rng.standard_normal((30, 4))
    tr = rng.uniform(size=(4, 4))
    tr /= tr.sum(axis=1, keepdims=True)
    pi = np.full(4, 0.25)
    for a, b in zip(port_vbx.forward_backward(log_p, tr, pi),
                    jax_vbx.forward_backward(log_p, tr, pi)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0, atol=1e-10)


def test_vbx_setup_and_clustering_equal_jax(tmp_path):
    rng = np.random.default_rng(3)
    make_plda_dir(tmp_path, rng, xdim=32, ldadim=8)
    x = rng.standard_normal((10, 32))
    xvec_tf, plda_tf, psi = port_vbx.vbx_setup(str(tmp_path))
    ref_xvec_tf, ref_plda_tf, ref_psi = jax_vbx.vbx_setup(str(tmp_path))
    np.testing.assert_allclose(psi, ref_psi, rtol=0, atol=1e-10)
    np.testing.assert_allclose(plda_tf(xvec_tf(x), 6), ref_plda_tf(ref_xvec_tf(x), 6),
                               rtol=0, atol=1e-10)
    np.testing.assert_array_equal(port_vbx.l2_norm(x), jax_vbx.l2_norm(x))

    centers = 4.0 * rng.standard_normal((3, 32))
    emb = centers[rng.integers(0, 3, size=(24, 3))] + rng.standard_normal((24, 3, 32))
    seg = (rng.uniform(size=(24, 50, 3)) > 0.4).astype(np.float32)
    seg[5, :, 2] = 0.0  # an inactive local speaker
    for kw in (dict(), dict(loop_prob=0.5, constrained_assignment=False)):
        got = port_vbx.VBxClustering(str(tmp_path), lda_dim=8, **kw)(emb, seg)
        ref = jax_vbx.VBxClustering(str(tmp_path), lda_dim=8, **kw)(emb, seg)
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-10)
        np.testing.assert_allclose(got[2], ref[2], rtol=0, atol=1e-10)
    # fewer than two usable embeddings: one cluster, as in the JAX package
    few = port_vbx.VBxClustering(str(tmp_path), lda_dim=8)(emb[:1], np.zeros((1, 50, 3)))
    ref_few = jax_vbx.VBxClustering(str(tmp_path), lda_dim=8)(emb[:1], np.zeros((1, 50, 3)))
    np.testing.assert_array_equal(few[0], ref_few[0])


# ---------------------------------------------------------------------------
# audio


def test_audio_helpers_equal_jax(tmp_path):
    rng = np.random.default_rng(4)
    stereo = (0.3 * rng.standard_normal((2, 8000))).astype(np.float32)
    path = tmp_path / "stereo8k.wav"
    audio.write_wav(path, stereo, 8000)
    assert audio.get_audio_info(path) == jax_audio.get_audio_info(path) == (8000, 8000, 2)
    assert audio.get_wav_info(path) == jax_audio.get_wav_info(path)
    with open(path, "rb") as fh:
        buf = io.BytesIO(fh.read())
    assert audio.get_audio_info(buf) == (8000, 8000, 2)

    for orig, target in ((8000, 16000), (44100, 16000), (16000, 16000)):
        np.testing.assert_array_equal(audio.resample(stereo, orig, target),
                                      jax_audio.resample(stereo, orig, target))
    assert audio.resample(stereo, 8000, 16000).dtype == np.float32

    for mono in ("downmix", None):
        loader, ref_loader = audio.Audio(16000, mono), jax_audio.Audio(16000, mono)
        got, sr = loader(path)
        want, ref_sr = ref_loader(path)
        np.testing.assert_array_equal(got, want)
        assert sr == ref_sr == 16000 and loader.get_duration(path) == 1.0
        # a crop that hangs over both ends of the file is zero-padded on both sides
        for start, end, duration in ((-0.25, 1.25, None), (0.2, 0.6, None), (0.9, 1.0, 0.5)):
            got, _ = loader.crop(path, Segment(start, end), duration=duration)
            want, _ = ref_loader.crop(path, JaxSegment(start, end), duration=duration)
            np.testing.assert_array_equal(got, want)
        both, _ = audio.Audio(8000, mono).crop(path, Segment(-0.25, 1.25))  # no resampling
        assert both.shape[-1] == 12000 and both[:, 2000:10000].any()
        assert not both[:, :2000].any() and not both[:, 10000:].any()
    a = audio.Audio(16000, "random", rng=np.random.default_rng(9))(path)[0]
    b = jax_audio.Audio(16000, "random", rng=np.random.default_rng(9))(path)[0]
    np.testing.assert_array_equal(a, b)

    # a broken FLAC file is refused with the JAX package's own error
    flac = tmp_path / "x.flac"
    flac.write_bytes(b"fLaC....")
    for call, ref_call, source in (
            (audio.read_audio, jax_audio.read_audio, flac),
            (audio.get_audio_info, jax_audio.get_audio_info, flac),
            (audio.read_audio, jax_audio.read_audio, io.BytesIO(b"fLaC...."))):
        with pytest.raises(ValueError) as want:
            ref_call(source)
        with pytest.raises(ValueError, match="FLAC|STREAMINFO") as got:
            call(source)
        assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------
# out-of-memory batch backoff


def test_halve_batch_or_raise():
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    assert utils.is_oom_error(oom) and not utils.is_oom_error(RuntimeError("out of memory"))
    assert utils.halve_batch_or_raise(oom, 32, "segmentation inference") == 16
    assert utils.halve_batch_or_raise(oom, 3, "segmentation inference") == 1
    with pytest.raises(RuntimeError, match="ran out of device memory even at batch_size=1"):
        utils.halve_batch_or_raise(oom, 1, "segmentation inference")
    other = KeyError("something else")
    with pytest.raises(KeyError) as caught:
        utils.halve_batch_or_raise(other, 32, "segmentation inference")
    assert caught.value is other


class _FailingModel(torch.nn.Module):
    """Delegates to a model; raises the queued exceptions first, and records
    the batch size of every call."""

    def __init__(self, inner, failures):
        super().__init__()
        self.inner, self.failures, self.batches = inner, list(failures), []
        self.cfg = inner.cfg

    def forward(self, x, *args, **kwargs):
        self.batches.append(x.shape[0])
        if self.failures:
            raise self.failures.pop(0)
        return self.inner(x, *args, **kwargs)


@pytest.fixture(scope="module")
def tiny_pair():
    wavlm = WavLMConfig.from_reference_dict(TINY_WAVLM)
    cfg = EendConfig(wavlm=wavlm, conformer=ConformerConfig(dim=32, ffn_hidden=64, num_heads=4,
                                                            num_layers=1),
                     wavlm_layer_num=4, wavlm_feat_dim=64, attention_in=32, chunk_size=2.0)
    model = EendModel(cfg)
    model.load_state_dict(random_state_dict(model, seed=2))
    resnet = ResNet(ResNetConfig(m_channels=4, num_blocks=(1, 1, 1, 1), embed_dim=16))
    resnet.load_state_dict(random_state_dict(resnet, seed=3))
    return model.eval(), resnet.eval()


def test_segmentation_halves_its_batch_on_oom(tiny_pair):
    model, _ = tiny_pair
    wave = make_wave(5.0)
    want = SlidingInference(model, batch_size=8, compute_dtype=torch.float32, device="cpu")(wave)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")
    failing = _FailingModel(model, [oom])
    seg = SlidingInference(failing, batch_size=8, compute_dtype=torch.float32, device="cpu")
    got = seg(wave)
    assert seg.batch_size == 4 and failing.batches[0] == 8 and max(failing.batches[1:]) == 4
    np.testing.assert_array_equal(got.data, want.data)
    # at batch 1 the actionable message; another error passes through unchanged
    seg = SlidingInference(_FailingModel(model, [oom] * 4), batch_size=4,
                           compute_dtype=torch.float32, device="cpu")
    with pytest.raises(RuntimeError, match="segmentation inference ran out of device memory"):
        seg(wave)
    assert seg.batch_size == 1
    seg = SlidingInference(_FailingModel(model, [ValueError("bad input")]), batch_size=4,
                           device="cpu")
    with pytest.raises(ValueError, match="bad input"):
        seg(wave)
    assert seg.batch_size == 4


def test_embedding_and_pipeline_halve_on_oom(tiny_pair):
    model, resnet = tiny_pair
    wave = make_wave(5.0)
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory")

    def pipeline(seg_model, emb_model):
        seg = SlidingInference(seg_model, batch_size=8, compute_dtype=torch.float32,
                               device="cpu")
        emb = EmbeddingInference(emb_model, seg.window_size, num_speakers=4, batch_size=8,
                                 device="cpu")
        return DiarizationPipeline(seg, emb, AgglomerativeClustering(min_cluster_size=2),
                                   model.cfg, max_speakers=4)

    class FailingResNet(_FailingModel):
        def __init__(self, inner, failures):
            torch.nn.Module.__init__(self)
            self.inner, self.failures, self.batches = inner, list(failures), []
            self.cfg = inner.cfg

    want = pipeline(model, resnet)(wave, SR, uri="f").to_rttm()
    # the embedding stage alone
    emb = EmbeddingInference(FailingResNet(resnet, [oom]), 32000, num_speakers=4, batch_size=8,
                             device="cpu")
    starts = np.arange(4) * 6400
    weights = np.ones((4, 4, 399), np.float32)
    ref = EmbeddingInference(resnet, 32000, num_speakers=4, batch_size=8, device="cpu")(
        torch.from_numpy(wave[0]), starts, weights)
    np.testing.assert_allclose(emb(torch.from_numpy(wave[0]), starts, weights), ref, atol=1e-6)
    assert emb.batch_size == 4
    # the pipeline: an OOM while the file's device chain is enqueued falls to the host
    # route with a halved batch, and the annotation is unchanged
    for seg_fail, emb_fail in (([oom], []), ([], [oom])):
        pipe = pipeline(_FailingModel(model, seg_fail), FailingResNet(resnet, emb_fail))
        assert pipe(wave, SR, uri="f").to_rttm() == want
        assert pipe.seg_inference.batch_size == 4
        assert list(a.to_rttm() for a in pipe.stream([wave, wave], SR, uris=["f", "f"])) == [
            want, want]
    pipe = pipeline(_FailingModel(model, [TypeError("not an OOM")]), resnet)
    with pytest.raises(TypeError, match="not an OOM"):
        pipe(wave, SR)
