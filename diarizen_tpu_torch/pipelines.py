"""High-level loader: pretrained model directory -> DiarizationPipeline (port
of diarizen_tpu/pipelines.py).

A model directory, laid out like a released DiariZen snapshot, holds
`config.toml` (model, inference and clustering sections), the segmentation
checkpoint `pytorch_model.bin` (or, failing that, the JAX trainer's
`params.npz`), and a `plda/` directory for VBx; the WeSpeaker
ResNet34 embedding checkpoint is a separate file. A `config.toml` whose
model is the multi-channel one (`wavlm_conformer_mc`, DiariZen's
`recipes/diar_ssl_mc`) gives the same pipeline on (C, N) recordings: its
segmentation reads the model's microphones, its embeddings run every
(window, microphone) and are fused under the model's channel weights, with
the recipe's plain masks. `from_pretrained` takes a
local directory or a Hugging Face repo id: an id resolves through
`huggingface_hub.snapshot_download` (cache first, so a populated cache works
offline), with an actionable error when the package or the model is missing.

    python -m diarizen_tpu_torch.pipelines --in_wav_scp wav.scp \
        --model_dir DIR --embedding_model resnet34.bin --rttm_out_dir OUT

Everything runs on the CUDA device unless `device="cpu"` (`--device cpu`) is
given; without a CUDA device it raises.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Union

import torch

from diarizen_tpu_torch.cluster import AgglomerativeClustering, VBxClustering
from diarizen_tpu_torch.config import instantiate_model_for_inference, load_toml
from diarizen_tpu_torch.core.audio import read_audio
from diarizen_tpu_torch.core.io_rttm import load_scp
from diarizen_tpu_torch.infer import DiarizationPipeline, EmbeddingInference, SlidingInference
from diarizen_tpu_torch.models.convert import (
    eend_state_dict_from_params,
    load_eend_checkpoint,
    load_pytree,
    random_state_dict,
)
from diarizen_tpu_torch.models.resnet import ResNet, ResNetConfig
from diarizen_tpu_torch.utils import resolve_device


def resolve_model_dir(model_dir_or_repo: Union[str, Path]) -> Path:
    """A local directory passes through; anything else is taken for a
    Hugging Face repo id and resolved with `snapshot_download` (cache first:
    a repo already in the cache loads with no network)."""
    p = Path(model_dir_or_repo)
    if p.is_dir():
        return p
    try:
        from huggingface_hub import snapshot_download

        return Path(snapshot_download(repo_id=str(model_dir_or_repo)))
    except Exception as e:  # noqa: BLE001 - package, cache and network errors in one message
        raise FileNotFoundError(
            f"{model_dir_or_repo!r} is neither a local model directory nor a "
            "resolvable Hugging Face repo id (offline and not in the HF "
            "cache?). Download it on a connected machine with "
            f"`huggingface-cli download {model_dir_or_repo}` and point "
            "from_pretrained at the local path."
        ) from e


def load_resnet(embedding_ckpt: Optional[Union[str, Path]] = None) -> ResNet:
    """The WeSpeaker ResNet34 from a torch checkpoint (a state dict, or a
    dict holding one under "state_dict"; keys with or without the "resnet."
    prefix), or with seeded random weights when none is given."""
    resnet = ResNet(ResNetConfig())
    if embedding_ckpt is None:
        resnet.load_state_dict(random_state_dict(resnet, seed=0))
        return resnet
    sd = torch.load(embedding_ckpt, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    resnet.load_state_dict({k.removeprefix("resnet."): v for k, v in sd.items()}, strict=True)
    return resnet


def from_pretrained(
    model_dir: Union[str, Path],
    embedding_ckpt: Optional[Union[str, Path]] = None,
    rttm_out_dir: Optional[Union[str, Path]] = None,
    device: Optional[Union[str, torch.device]] = None,
    inference_overrides: Optional[dict] = None,
    clustering_overrides: Optional[dict] = None,
    mesh=None,
) -> DiarizationPipeline:
    """Build the full diarization pipeline from a local pretrained directory
    or a hub repo id, on the CUDA device unless `device` says otherwise. The
    override dicts layer on top of the directory's `[inference.args]` and
    `[clustering.args]` sections (None values are ignored). With `mesh`
    (`parallel/mesh.py`) both models shard their windows over its data
    axis, parameters replicated. A multi-channel model's pipeline serves
    (C, N) recordings, its channels wrapped or cut to the model's."""
    device = resolve_device(device)
    model_dir = resolve_model_dir(model_dir)
    config = load_toml(model_dir / "config.toml")
    if inference_overrides:
        config.setdefault("inference", {}).setdefault("args", {}).update(
            {k: v for k, v in inference_overrides.items() if v is not None}
        )
    if clustering_overrides:
        config.setdefault("clustering", {}).setdefault("args", {}).update(
            {k: v for k, v in clustering_overrides.items() if v is not None}
        )

    # released snapshots carry training-time wavlm_src paths that do not
    # resolve locally; the snapshot's checkpoint supplies the weights anyway,
    # so the factory may fall back to the preset architecture (inference
    # loading only: training entry points keep the loud failure)
    cfg, model = instantiate_model_for_inference(
        config["model"]["path"], config["model"].get("args", {})
    )
    ckpt_bin = model_dir / "pytorch_model.bin"
    ckpt_npz = model_dir / "params.npz"
    if ckpt_bin.exists():
        model.load_state_dict(load_eend_checkpoint(str(ckpt_bin)), strict=True)
    elif ckpt_npz.exists():  # the JAX trainer's params; BatchNorm statistics stay initial
        model.load_state_dict(eend_state_dict_from_params(load_pytree(ckpt_npz), model),
                              strict=True)

    inference_args = config.get("inference", {}).get("args", {})
    seg_duration = float(inference_args.get("seg_duration", 8))
    batch_size = inference_args.get("batch_size", 32)
    seg_inf = SlidingInference(
        model, duration=seg_duration,
        step=inference_args.get("segmentation_step", 0.1) * seg_duration,
        batch_size=batch_size, device=device, mesh=mesh,
    )

    emb_inf = EmbeddingInference(
        load_resnet(embedding_ckpt), window_size=seg_inf.window_size,
        num_speakers=cfg.max_speakers_per_chunk, batch_size=batch_size, device=device,
    )

    cl = config.get("clustering", {}).get("args", {})
    method = cl.get("method", "AgglomerativeClustering")
    if method in ("AHC", "AgglomerativeClustering"):
        clustering = AgglomerativeClustering(
            threshold=cl.get("ahc_threshold", 0.70),
            min_cluster_size=cl.get("min_cluster_size", 30),
        )
    else:
        clustering = VBxClustering(
            plda_dir=str(model_dir / "plda"),
            ahc_criterion=cl.get("ahc_criterion", "distance"),
            ahc_threshold=cl.get("ahc_threshold", 0.6),
            fa=cl.get("Fa", 0.07), fb=cl.get("Fb", 0.8),
            lda_dim=cl.get("lda_dim", 128), max_iters=cl.get("max_iters", 20),
        )

    pipeline = DiarizationPipeline(
        seg_inference=seg_inf,
        emb_inference=emb_inf,
        clustering=clustering,
        eend_cfg=cfg,
        min_speakers=cl.get("min_speakers", 1),
        max_speakers=cl.get("max_speakers", 8),
        apply_median_filtering=inference_args.get("apply_median_filtering", True),
        # the multi-channel recipe embeds with the plain masks
        embedding_exclude_overlap=seg_inf.num_channels is None,
        mesh=mesh,
    )
    pipeline.rttm_out_dir = Path(rttm_out_dir) if rttm_out_dir else None
    return pipeline


def diarize_file(pipeline: DiarizationPipeline, wav_path: Union[str, Path],
                 uri: Optional[str] = None):
    """wav path -> Annotation (and an RTTM file when the pipeline has an
    `rttm_out_dir`)."""
    uri = uri or Path(wav_path).stem
    wave, sr = read_audio(wav_path)
    ann = pipeline(wave, sr, uri=uri)
    out_dir = getattr(pipeline, "rttm_out_dir", None)
    if out_dir:
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / f"{uri}.rttm").write_text(ann.to_rttm())
    return ann


def main(argv=None):
    """wav.scp-driven CLI: one RTTM per recording. Files go through
    `DiarizationPipeline.stream`, so each file's device work overlaps the
    previous file's host stages."""
    import argparse

    ap = argparse.ArgumentParser(
        "python -m diarizen_tpu_torch.pipelines",
        description="Diarize a wav.scp with a pretrained DiariZen-style model",
    )
    ap.add_argument("--in_wav_scp", required=True, help="rec-id -> wav path")
    ap.add_argument("--model_dir", required=True,
                    help="local model dir or HF hub repo id (config.toml + ckpt)")
    ap.add_argument("--embedding_model", default=None,
                    help="WeSpeaker ResNet34 checkpoint (torch .bin)")
    ap.add_argument("--rttm_out_dir", required=True)
    ap.add_argument("--device", default=None,
                    help="torch device; the CUDA device when not given")
    # inference overrides
    ap.add_argument("--seg_duration", type=float, default=None)
    ap.add_argument("--segmentation_step", type=float, default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--apply_median_filtering",
                    action=argparse.BooleanOptionalAction, default=None)
    # clustering overrides
    ap.add_argument("--clustering_method", default=None,
                    choices=["VBxClustering", "AgglomerativeClustering"])
    ap.add_argument("--min_speakers", type=int, default=None)
    ap.add_argument("--max_speakers", type=int, default=None)
    ap.add_argument("--ahc_criterion", default=None)
    ap.add_argument("--ahc_threshold", type=float, default=None)
    ap.add_argument("--min_cluster_size", type=int, default=None)
    ap.add_argument("--Fa", type=float, default=None)
    ap.add_argument("--Fb", type=float, default=None)
    ap.add_argument("--lda_dim", type=int, default=None)
    args = ap.parse_args(argv)

    pipeline = from_pretrained(
        args.model_dir,
        embedding_ckpt=args.embedding_model,
        rttm_out_dir=args.rttm_out_dir,
        device=args.device,
        inference_overrides=dict(
            seg_duration=args.seg_duration,
            segmentation_step=args.segmentation_step,
            batch_size=args.batch_size,
            apply_median_filtering=args.apply_median_filtering,
        ),
        clustering_overrides=dict(
            method=args.clustering_method,
            min_speakers=args.min_speakers,
            max_speakers=args.max_speakers,
            ahc_criterion=args.ahc_criterion,
            ahc_threshold=args.ahc_threshold,
            min_cluster_size=args.min_cluster_size,
            Fa=args.Fa, Fb=args.Fb, lda_dim=args.lda_dim,
        ),
    )
    scp = load_scp(args.in_wav_scp)
    out_dir = Path(args.rttm_out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)

    def waves():
        for path in scp.values():
            wave, sr = read_audio(path)
            if sr != pipeline.seg_inference.sample_rate:
                raise ValueError(
                    f"{path}: resample {sr} -> {pipeline.seg_inference.sample_rate}")
            yield wave

    for uri, ann in zip(scp, pipeline.stream(waves(), uris=list(scp))):
        (out_dir / f"{uri}.rttm").write_text(ann.to_rttm())
        print(f"{uri}: {len(ann.labels())} speakers", flush=True)


if __name__ == "__main__":
    main()
