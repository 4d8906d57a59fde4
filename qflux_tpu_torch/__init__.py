"""qflux_tpu_torch — the PyTorch/CUDA port of qflux_tpu for one NVIDIA H100.

The JAX package `qflux_tpu/` is the reference; this package keeps its module
paths and function names so each counterpart is easy to find.  It imports
torch and never jax.  Its hand-written Hopper kernels live in `csrc/` and
are built on first use by `runtime/build.py`.

Ported so far: the FLUX.1-Kontext predict path from cached embeddings
(`trainer/base.py:Trainer.predict_from_embeddings`), with kernel K1 (fused
qk-RMSNorm + RoPE + flash attention forward, `csrc/flash_nr_fwd.cu`).
"""
