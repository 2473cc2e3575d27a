"""PyTorch/CUDA port of diarizen_tpu for one NVIDIA H100.

Mirrors the JAX package's layout (`core/`, `ops/`, `models/`, `infer/`,
`cluster/`) and computes the same values: plain tensor code is PyTorch, and
each Pallas kernel of the JAX package on the ported path is a hand-written
Hopper kernel under `csrc/` (see `ops/flash_attention.py`).

The port imports neither jax nor `diarizen_tpu`; the JAX package is the
reference it is tested against. Entry points run on the CUDA device unless
the caller passes `device="cpu"`.
"""
