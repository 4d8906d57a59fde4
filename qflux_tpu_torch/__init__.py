"""qflux_tpu_torch — the PyTorch/CUDA port of qflux_tpu for one NVIDIA H100.

The JAX package `qflux_tpu/` is the reference; this package keeps its module
paths and function names so each counterpart is easy to find.  It imports
torch and never jax.  Its hand-written Hopper kernels live in `csrc/` and
are built on first use by `runtime/build.py`.

Ported so far: FLUX.1-Kontext and the 20B Qwen-Image-Edit, predict and the
LoRA train step from cached embeddings (`trainer/base.py:Trainer`), over
a full-precision base or any quantized base of JAX's `quantize.dtype`
(int8 / fp8 weight-only, W8A8 on the int8 GEMM of `csrc/int8_gemm.cu`,
W4A8 per group, W4A8-requant, W4A16), with every Pallas kernel
of the JAX package as a CUDA kernel: K1 / K2 (fused qk-RMSNorm + RoPE +
flash attention and its backward, `csrc/flash_nr_*.cu`), K3 / K4 (plain
flash attention and its backward, `csrc/flash_fwd.cu`, `csrc/flash_bwd.cu`),
K5a / K5b (`csrc/rq_int4_*.cu`) and K6a / K6b (`csrc/int4_*.cu`).  The
data layer (`data/`: the JAX package's embedding cache, the dataset, shape
buckets and padded mixed-resolution batches), TensorBoard logging and
`python -m qflux_tpu_torch.main` (fit from the cache) drive the trainer.
Both families also run from raw images: their encoders (FLUX's CLIP-L,
T5-XXL and VAE encoder; Qwen's Qwen2.5-VL and 3D VAE encoder) write the
embedding cache (`--cache`), train from pixels (`--fit-no-cache`), edit a
raw image (`--predict`), sample for validation and serve mixed-size
batches (`Trainer.predict_multires`).
"""
