"""AdamW with blockwise-fp8 moment states: qflux_tpu/ops/adam8bit.py's
`adamw8bit` as a `torch.optim.Optimizer`.

The JAX optimizer is an optax chain of three steps, each reproduced here in
the order and the f32 arithmetic its jitted update runs:

  1. `scale_by_adam8bit`: the first and second moments live as float8
     e4m3fn values with one f32 scale per block of `block_size` elements
     (the leaf flattened and zero-padded to whole blocks); each update
     dequantizes them, takes m = b1·m + (1 - b1)·g and v = b2·v + (1 -
     b2)·g·g, the update (m / c1) / (sqrt(v / c2) + eps) with the bias
     corrections c = 1 - b^count in f32, and quantizes m and v again;
  2. `add_decayed_weights(weight_decay)`: u + weight_decay · p (1e-2 by
     default, not adamw's 1e-4);
  3. `scale_by_learning_rate`: (-lr) · u, added to p.

A block's scale is amax · fl32(1/448), not amax / 448: JAX runs the update
under `jit`, where XLA turns the division by the constant into that
product (the row-scale lesson of ops/quant.py:_rowquant); the codes are
x / scale, a true division.  The bias corrections divide by a 0-dim f32
tensor on the moments' device, a true division on either device.  The
square root is taken in f64 and rounded to f32 once, which is the
correctly rounded f32 root (XLA's and the CPU's): torch's f32 `sqrt` on
CUDA is not, so the card's update would differ from the CPU's.

JAX keeps one moment pair per leaf of its LoRA tree, where a block stack's
layers are one stacked leaf [L, ...]: its blocks run across the layers.
`stacks` gives the tensors that form one such leaf, in layer order, and the
optimizer blocks their concatenation, so its moments are the JAX state's
element for element (utils/checkpoint.py writes and reads them in the JAX
trainer's `optimizer_state.npz`).  The moments are elementwise work over
the LoRA alone: torch ops, no kernel (JAX has none: XLA fuses the update).
"""

from __future__ import annotations

import numpy as np
import torch

BLOCK_SIZE = 256
E4M3_MAX = 448.0  # the largest e4m3fn value


def quantize(x, block_size: int = BLOCK_SIZE):
    """x [n] f32 → (q [n_blocks · block_size] float8_e4m3fn, scale [n_blocks]
    f32): JAX's `_quantize` under `jit`."""
    pad = (-x.numel()) % block_size
    xp = torch.nn.functional.pad(x.float(), (0, pad)).reshape(-1, block_size)
    amax = xp.abs().amax(dim=1)
    scale = torch.clamp_min(amax * (1.0 / E4M3_MAX), 1e-30)
    q = (xp / scale[:, None]).to(torch.float8_e4m3fn)
    return q.reshape(-1), scale


def dequantize(q, scale, n: int, block_size: int = BLOCK_SIZE):
    """The first n values of (q, scale) in f32: JAX's `_dequantize`."""
    return (q.reshape(-1, block_size).float() * scale[:, None]).reshape(-1)[:n]


def _f32_tensor(value, device):
    return torch.tensor(np.float32(value), dtype=torch.float32, device=device)


class AdamW8bit(torch.optim.Optimizer):
    """JAX's `adamw8bit(learning_rate, b1, b2, eps, weight_decay,
    block_size)` over `params` (f32 leaves).  `stacks`: lists of the params
    that form one JAX leaf, each list in layer order (default: every param a
    leaf of its own); each stack's state ("m", "v": (codes, scales), and
    "count") sits under its first param.  The lr is read from the param
    group at every step, as `make_train_step` sets it."""

    def __init__(self, params, lr: float = 1e-3, betas=(0.9, 0.999), eps: float = 1e-8,
                 weight_decay: float = 1e-2, block_size: int = BLOCK_SIZE, stacks=None):
        params = list(params)
        super().__init__(params, {"lr": lr, "betas": tuple(betas), "eps": eps,
                                  "weight_decay": weight_decay, "block_size": block_size})
        if len(self.param_groups) != 1:
            raise ValueError("AdamW8bit takes one parameter group")
        stacks = [list(s) for s in stacks] if stacks is not None else [[p] for p in params]
        seen = [p for s in stacks for p in s]
        if len(seen) != len(params) or {id(p) for p in seen} != {id(p) for p in params}:
            raise ValueError("stacks must hold every param exactly once")
        self.stacks = stacks

    def init_state(self, stack):
        """The zero state of a stack (optax's `init`): quantized zeros."""
        bs = self.param_groups[0]["block_size"]
        zeros = torch.zeros(sum(p.numel() for p in stack), dtype=torch.float32,
                            device=stack[0].device)
        return {"count": 0, "m": quantize(zeros, bs), "v": quantize(zeros, bs)}

    def stack_state(self, stack):
        state = self.state[stack[0]]
        if not state:
            state.update(self.init_state(stack))
        return state

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        group = self.param_groups[0]
        b1, b2 = group["betas"]
        eps, wd, lr, bs = group["eps"], group["weight_decay"], group["lr"], group["block_size"]
        for stack in self.stacks:
            state = self.stack_state(stack)
            count = state["count"] + 1
            dev = stack[0].device
            c1 = _f32_tensor(np.float32(1.0) - np.float32(b1) ** np.float32(count), dev)
            c2 = _f32_tensor(np.float32(1.0) - np.float32(b2) ** np.float32(count), dev)
            g = torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).reshape(-1)
                           for p in stack]).float()
            n = g.numel()
            m = b1 * dequantize(*state["m"], n, bs) + (1 - b1) * g
            v = b2 * dequantize(*state["v"], n, bs) + (1 - b2) * g * g
            root = torch.sqrt((v / c2).double()).float()  # see the module docstring
            upd = (m / c1) / (root + eps)
            state["m"], state["v"], state["count"] = quantize(m, bs), quantize(v, bs), count
            off = 0
            for p in stack:
                u = upd[off:off + p.numel()].view_as(p).to(p.dtype)
                off += p.numel()
                p.add_((u + wd * p) * -lr)
        return loss

    def state_bytes(self) -> int:
        """Bytes of the moment states (codes and scales)."""
        return sum(t.numel() * t.element_size() for s in self.stacks
                   for key in ("m", "v") for t in self.state.get(s[0], {}).get(key, ()))
