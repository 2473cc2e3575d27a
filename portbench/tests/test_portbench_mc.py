"""The multi-channel cell's own code: its comparison catches a program that
is broken where a multi-channel model differs from a single-channel one,
and passes a sound one (whole runs of the cell on the CPU at the toy size of
`mc_toy.py`, every step but the look for a chip, the program patched where
it goes wrong); every seed's pool is the same work; the multi-channel FLOP
count against a hand count; the fused-channel stream reader; and a run that
loads no JAX. The control at the cell's own size runs on the card
(`card`)."""

import subprocess
import sys
import tempfile
import tomllib
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pytest
import torch

from portbench import control_mc, core, flops, flops_mc
from portbench.run import run_cell
from portbench.tests import mc_toy
from portbench.traffic import mc_files

CELL = "mc-chatt-base-s80-md.meetings"
FUSIONS = 4  # as the cell's: fusion 3 weighs the channels, the mean follows layer 3
# a toy seed whose decisions hold silence, one speaker and two at once, and
# whose channel weights differ between the fusions
TOY_SEED = 21


def toy_workload() -> dict:
    workload = core.load_workload(CELL)
    traffic = {**workload["traffic"], **mc_toy.TRAFFIC, "files": 2, "min_s": 5.0, "max_s": 6.0}
    return {**workload, "traffic": traffic, "warm_chunks": [9], "check_files": 1}


@pytest.fixture
def toy_cell(monkeypatch, tmp_path):
    """The cell at the toy configuration: the set-up directory holds the
    toy's config.toml, the reference reads the toy's architecture, and the
    segmentation runs in float32 so that a sound run reads near zero."""
    from diarizen_tpu_torch import pipelines

    text = mc_toy.toml_text(mc_toy.wavlm_checkpoint(tmp_path), TOY_SEED, FUSIONS)
    cfg = tomllib.loads(text)
    monkeypatch.setattr(core, "load_config", lambda name: cfg)
    write = mc_files.write_setup_dir

    def write_toy(root, config_name, seed):
        setup = write(root, config_name, seed)
        (setup / "config.toml").write_text(text)
        return setup

    monkeypatch.setattr(mc_files, "write_setup_dir", write_toy)
    build = pipelines.from_pretrained

    def float32(*args, **kwargs):
        pipe = build(*args, **kwargs)
        pipe.seg_inference.compute_dtype = torch.float32
        return pipe

    monkeypatch.setattr(pipelines, "from_pretrained", float32)

    def run(seed=2**31 + 23):
        return run_cell(core.manifest(), CELL, toy_workload(), seed, 0.05, False, "cpu", 1,
                        tmp_path)
    return run


def weights_from_fusion_2(monkeypatch):
    from diarizen_tpu_torch.models.mc import McEendModel

    monkeypatch.setattr(McEendModel, "weight_fusion", 2)


def weights_over_the_keys(monkeypatch):
    from diarizen_tpu_torch.models.mc import McEendModel

    monkeypatch.setattr(McEendModel, "channel_weights",
                        lambda self, attention: attention.mean(dim=2).mean(dim=(1, 3)))


def one_microphone_left_out(monkeypatch):
    from diarizen_tpu_torch.infer.pipeline import EmbeddingInference

    dispatch = EmbeddingInference.dispatch

    def broken(self, wave, starts, weights, hook=None, channel_weights=None):
        if channel_weights is not None:
            channel_weights = channel_weights.clone()
            channel_weights[:, 0] = 0.0
        return dispatch(self, wave, starts, weights, hook, channel_weights)

    monkeypatch.setattr(EmbeddingInference, "dispatch", broken)


def mean_after_layer_2(monkeypatch):
    """One fusion short: fusions 0-2 and layers 0-2 on every channel, the
    mean after layer 2, layer 3 on the single stream, and the weights read
    from fusion 2, the last that ran."""
    from diarizen_tpu_torch.models import mc

    fuse = mc.mc_fuse

    def broken(wavlm, fusions, x, b, c, train=False, rng=None):
        hidden, attentions, x, bias = fuse(wavlm, fusions[:-1], x, b, c, train, rng)
        last = len(fusions) - 1
        x, _ = wavlm._layer(last, wavlm.encoder.transformer.layers[last], x, bias, train, rng)
        return hidden + [x], attentions, x, bias

    monkeypatch.setattr(mc, "mc_fuse", broken)


def fusion_1_skipped(monkeypatch):
    from diarizen_tpu_torch.models import mc

    class Skipped(mc.CrossChannelAttention):
        def forward(self, x, generator=None):
            return x, super().forward(x, generator)[1]

    make = mc.make_fusions

    def broken(n_units, fcfg):
        fusions = make(n_units, fcfg)
        fusions[1].__class__ = Skipped
        return fusions

    monkeypatch.setattr(mc, "make_fusions", broken)


def test_sound_run_is_correct(toy_cell):
    result, checks = toy_cell()
    assert result["correct"], checks
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert set(result["metrics"]) == {"audio_s_per_s", "setup_s"}
    assert set(checks) == {"seg_flip_share", "count_mismatch_share", "chan_weight_err",
                           "emb_rel_err", "cluster_mismatch_share"}


@pytest.mark.parametrize("fault", [weights_from_fusion_2, weights_over_the_keys,
                                   one_microphone_left_out, mean_after_layer_2,
                                   fusion_1_skipped])
def test_fault_is_caught(fault, toy_cell, monkeypatch):
    fault(monkeypatch)
    result, checks = toy_cell()
    assert not result["correct"], checks
    assert result["failed"] >= 1


def test_a_single_channel_program_stops_in_setup(toy_cell, monkeypatch):
    """The parent of the multi-channel serving path builds the model with
    the single-channel segmentation: the run stops before the pool is made."""
    from diarizen_tpu_torch.infer.sliding import SlidingInference

    init = SlidingInference.__init__

    def one_channel(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.num_channels = None

    monkeypatch.setattr(SlidingInference, "__init__", one_channel)
    monkeypatch.setattr(mc_files, "make_pool", lambda *a: pytest.fail("made the pool"))
    with pytest.raises(SystemExit) as stop:
        toy_cell()
    assert stop.value.code == 1


def test_every_seed_is_the_same_work():
    traffic = {**mc_toy.TRAFFIC, "files": 3, "lengths": "uniform", "min_s": 2.0, "max_s": 4.0}
    a, b = mc_files.make_pool(traffic, 2**31 + 41, "cpu"), mc_files.make_pool(traffic, 7, "cpu")
    work = [sorted((x["seconds"], x["speakers"], x["wave"].shape) for x in p) for p in (a, b)]
    assert work[0] == work[1]
    assert all(x["wave"].shape[0] == mc_toy.CHANNELS for x in a)
    by_len = {x["seconds"]: x["wave"] for x in b}
    assert not any(np.array_equal(x["wave"], by_len[x["seconds"]]) for x in a)
    again = mc_files.make_pool(traffic, 7, "cpu")
    assert all(np.array_equal(x["wave"], y["wave"]) for x, y in zip(b, again))
    wave = a[0]["wave"]  # PCM16, and the microphones hear the speakers differently
    assert wave.dtype == np.float32 and np.allclose(wave * 32768.0, np.round(wave * 32768.0))
    assert not np.array_equal(wave[0], wave[1])


ARCH = {  # test_portbench_flops.py's shape, one fusion 4 wide in 2 heads
    "wavlm": {"conv_layers": [[4, 10, 5], [4, 3, 2]], "embed_dim": 8, "total_num_heads": [2],
              "remaining_heads": [[0]], "use_attention": [True], "use_feed_forward": [True],
              "ff_interm_features": [16], "pos_conv_kernel": 4, "pos_conv_groups": 2,
              "num_layers": 1},
    "eend": {"wavlm_layer_num": 2, "wavlm_feat_dim": 8, "attention_in": 4,
             "conformer_ffn_hidden": 8, "conformer_layers": 1, "conformer_kernel": 3,
             "max_speakers_per_chunk": 4, "max_speakers_per_frame": 2},
    "resnet": {"m_channels": 2, "num_blocks": [1, 1, 1, 1], "feat_dim": 16, "embed_dim": 4},
    "fusion": {"num_fusion_layers": 1, "hidden": 4, "num_heads": 2},
}


def test_mc_flops_by_hand():
    # 100 samples -> 9 frames. A stream's front (convs 760 + 432, projection 288,
    # pos-conv 1152) and layer 0 (4680) on each of 2 channels; the fusion's q, k,
    # v and out 2304 and its scores and values 288; the rest once (weighted sum
    # 144, projection 288, Conformer block 2916, classifier 396): 20960 MACs
    assert flops_mc.mc_segmentation_flops(ARCH, 100, 2) == 2 * 20960
    assert flops_mc.fusion_flops(ARCH, 100, 2) == 2 * 2592
    # one channel and no fusion work is the single-channel model
    assert (flops_mc.mc_segmentation_flops(ARCH, 100, 1) - flops_mc.fusion_flops(ARCH, 100, 1)
            == flops.segmentation_flops(ARCH, 100))
    # a file: each (window, channel) through the ResNet (1840 samples: 10 fbank
    # frames, 49216 MACs for 2 speakers), the channels' embeddings summed (2 x 2 x 4
    # MACs a window), each channel's fbank of the file
    seg = flops_mc.mc_segmentation_flops(ARCH, 1840, 2)
    assert flops_mc.mc_file_flops(ARCH, 3, 4000, 1840, 2, 2) == (
        3 * (seg + 2 * 2 * 49216 + 2 * 16) + 2 * flops.fbank_flops(4000))


MS = 1_000_000  # ns


@dataclass
class Rec:
    pipeline: int
    file: int
    audio_s: float
    spans: list = field(default_factory=list)
    seg_fuse_ms: float = None

    def ms(self, name):  # as tracing.FileRecord.ms
        return sum(end - start for n, start, end in self.spans if n == name) / 1e6


def records():
    """One warm-up file, four untraced files (15, 30, 45, 60 audio seconds,
    10, 20, 30, 40 fused-channel stream ms), a traced one."""
    out = []
    for k in range(6):
        t = k * 10_000 * MS
        r = Rec(5, k, 15.0 * k if 1 <= k <= 4 else 30.0,
                [("diarize.cluster", t, t + (10 + k) * MS)])
        r.seg_fuse_ms = 10.0 * k
        out.append(r)
    return out


CTX = {"workload": {"warm_chunks": [33]}, "files": 4, "cluster_ms": [11.0, 12.0, 13.0, 14.0]}


def test_fuse_reader(monkeypatch):
    from diarizen_tpu_torch import tracing

    read = core.metric_reader("fuse_stream_ms_per_audio_min.serve")
    monkeypatch.setattr(tracing, "records", records)
    assert read(CTX) == pytest.approx(100.0 / 2.5)  # 100 ms over 2.5 audio minutes
    assert read({**CTX, "cluster_ms": [1.0, 2.0, 3.0, 4.0]}) is None
    assert read(None) is None

    def single_channel():  # a record without the field's value: a single-channel model's
        out = records()
        out[3].seg_fuse_ms = None
        return out

    monkeypatch.setattr(tracing, "records", single_channel)
    assert read(CTX) is None

    @dataclass
    class Older:  # a program's record from before the field
        pipeline: int
        file: int
        audio_s: float
        spans: list

        def ms(self, name):
            return sum(end - start for n, start, end in self.spans if n == name) / 1e6

    monkeypatch.setattr(tracing, "records",
                        lambda: [Older(r.pipeline, r.file, r.audio_s, r.spans) for r in records()])
    assert read(CTX) is None


SCRIPT = """
import sys
sys.path.insert(0, {root!r})
import portbench.run, portbench.control_mc, portbench.traffic.mc_files, portbench.flops_mc
from portbench import core
from diarizen_tpu_torch import pipelines
core.metric_reader("fuse_stream_ms_per_audio_min.serve")
print("loaded:" + ",".join(core.forbidden_modules()))
"""


def test_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", SCRIPT.format(root=str(core.ROOT))],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "loaded:"


@pytest.mark.card
def test_control_fails_at_cell_size(card):
    workload = core.load_workload(CELL)
    for seed in (2**31 + 107, 2**31 + 108, 2**31 + 109):
        worst = control_mc.readings(workload, seed, card, Path(tempfile.mkdtemp()))
        print("control", CELL, seed, worst)
        assert any(worst[k] > workload["limits"][k] for k in worst), (seed, worst)
