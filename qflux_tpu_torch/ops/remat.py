"""Store and replay: what a checkpointed block keeps from its forward for its
backward, under the remat policies of the JAX forward.

A block runs under non-reentrant `torch.utils.checkpoint`: its forward
saves nothing, and its backward first recomputes it for the tensors its
autograd nodes saved.  Only those saved tensors matter in the recompute;
its outputs are thrown away.  A policy keeps some tensors of the forward
so that the recompute does not have to run the work that made them: one
store per block (`contexts`), filled in call order in the block's
forward and read back in the same order in its recompute.  A save point
carries a name, and a policy keeps the names of its set (`POLICY_NAMES`,
JAX's `jax.checkpoint_policies`):

  * FLASH — an attention op's (out, lse), K1's or K3's ("flash_out",
    "flash_lse"): the op body replays them instead of launching;
  * DOT — the output of a product with no batch dimension
    (`dots_with_no_batch_dims_saveable`): every dense layer's base product,
    whatever route its frozen weight takes, and both LoRA products;
  * DOT_BATCH — a batched product (`dots_saveable` adds these): the group
    products of the W4A8 per-group route;
  * QKV — the q / k / v that reach the attention kernel ("flash_q",
    "flash_k", "flash_v"): on K1's route the raw projections, on K3's the
    normed and roped q / k and the raw v;
  * MLP_H — the MLP's bf16 pre-activation, a dense layer's whole output
    ("mlp_h").

The trap is that a replayed op's autograd node must still save its inputs
in the recompute: the backward needs them, and the recompute must save as
many tensors, in the same order, as the forward did.  So a replay never
swaps a tensor outside autograd; it sits where the op's autograd record is
already made:

  * `keep` runs inside an op whose autograd formula the port owns (a custom
    op or an autograd.Function: the attention kernels, the base product of
    every weight form), whose setup saves the inputs whatever the body
    returns;
  * `product` runs a torch product (the LoRA dots) under a dispatch mode
    that is active for that one call, below autograd: the op's own
    autograd node is recorded as always, and only the kernel under it
    returns the stored tensor;
  * `skipping` makes the base product of a dense layer whose whole output
    is kept (QKV, MLP_H) return an empty placeholder in the recompute: its
    autograd node saves what it always saves, the LoRA path beside it runs
    for its own saved tensors, and the layer returns the stored output
    (ops/layers.py:dense).

The store lives on the device, except under "flash_offload", which parks
the attention pairs in pinned host memory (JAX's
save_and_offload_only_these_names to pinned_host).  No selective-checkpoint
dispatch mode runs over a whole block: outside a replayed call, a block's
ops see only a thread-local lookup.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FLASH = "flash"
DOT = "dot"
DOT_BATCH = "dot_batch"
QKV = "flash_qkv"
MLP_H = "mlp_h"

# what each policy keeps per block ("mod_out" is kept by construction: the
# port computes the AdaLN mods outside the checkpointed block); "full" keeps
# nothing
POLICY_NAMES = {
    "full": frozenset(),
    "flash": frozenset({FLASH}),
    "flash_offload": frozenset({FLASH}),
    "flash_qkv": frozenset({FLASH, QKV}),
    "flash_mlp": frozenset({FLASH, MLP_H}),
    "flash_single": frozenset({FLASH}),
    "dots": frozenset({DOT}),
    "dots_all": frozenset({DOT, DOT_BATCH}),
}
# where a policy keeps something else in one kind of block: "flash_single"
# keeps nothing in FLUX's dual blocks ("full") and "flash"'s set in its
# single blocks and in Qwen's (JAX: models/flux/transformer.py:333-349,
# models/qwen/transformer.py:256-258)
_BY_KIND = {("flash_single", "flux_dual"): frozenset()}


def names(policy: str, kind: str) -> frozenset:
    """What `policy` keeps in a block of `kind` ("flux_dual", "flux_single"
    or "qwen"); an unknown policy raises."""
    if policy not in POLICY_NAMES:
        raise ValueError(f"unknown remat_policy {policy!r} (the policies: "
                         f"{sorted(POLICY_NAMES)})")
    return _BY_KIND.get((policy, kind), POLICY_NAMES[policy])


class _Store:
    """One block's kept tensors in call order: on the device (detached
    aliases of the forward's tensors), or copied to pinned host memory with
    `offload`."""

    def __init__(self, offload: bool):
        self.offload = offload
        self.saved = []
        self.next = 0

    def put(self, name, value):
        """`value`: a tensor or a tuple of tensors, kept at a save point
        named `name`."""
        single = torch.is_tensor(value)
        ts = (value,) if single else tuple(value)
        if self.offload:
            ts = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=t.is_cuda).copy_(
                t, non_blocking=t.is_cuda) for t in ts)
        else:
            ts = tuple(t.detach() for t in ts)
        self.saved.append((name, single, ts))

    def take(self, device):
        _, single, ts = self.saved[self.next]
        self.next += 1
        if self.offload:
            # a CPU op's outputs must be fresh tensors, not the store's
            ts = tuple(t.clone() if device.type == "cpu"
                       else t.to(device, non_blocking=True) for t in ts)
        else:
            ts = tuple(t.detach() for t in ts)
        return ts[0] if single else ts


class _Region:
    __slots__ = ("store", "names", "replaying", "busy", "skip")

    def __init__(self, store, names, replaying):
        self.store, self.names, self.replaying = store, names, replaying
        self.busy = False  # inside a kept call: nested save points just run
        self.skip = False  # inside `skipping`: base products return placeholders


_STATE = threading.local()  # .region: the _Region of the block running in this thread


def _region():
    return getattr(_STATE, "region", None)


@contextlib.contextmanager
def _enter(store, names, replaying):
    prev = _region()
    store.next = 0
    _STATE.region = _Region(store, names, replaying)
    try:
        yield
    finally:
        _STATE.region = prev


def contexts(names, offload: bool = False):
    """The `context_fn` of torch.utils.checkpoint for a policy keeping
    `names`: (forward context, recompute context) over one fresh store.  The
    recompute context runs in whichever thread the autograd engine
    recomputes in; the state is per thread."""
    store = _Store(offload)
    return _enter(store, names, False), _enter(store, names, True)


def in_kept_block() -> bool:
    """Whether this thread runs a block that keeps tensors (its forward or
    its recompute)."""
    return _region() is not None


def _active(name, region=None):
    region = region or _region()
    if region is None or region.busy or name not in region.names:
        return None
    return region


def keep(name, device, fn, empty=None):
    """The body of an op whose autograd formula the port owns: `fn()` (a
    tensor or a tuple of tensors), except in a block that keeps `name`,
    where the forward also stores it and the recompute returns the stored
    value instead of calling `fn`.  Under `skipping`, `empty()` instead (an
    op passes it where it is a dense layer's base product).  Save points
    inside `fn` do not keep anything of their own."""
    region = _region()
    if region is None:
        return fn()
    if region.skip and empty is not None:
        return empty()
    region = _active(name, region)
    if region is None:
        return fn()
    if region.replaying:
        return region.store.take(device)
    region.busy = True
    try:
        out = fn()
    finally:
        region.busy = False
    region.store.put(name, out)
    return out


class _ReturnStored(TorchDispatchMode):
    """Below autograd, for one call: the first `aten.mm` returns `out`
    (reshaped to the mm's [rows, cols]) instead of running."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func is torch.ops.aten.mm.default and self.out is not None:
            out, self.out = self.out, None
            return out.reshape(args[0].shape[0], args[1].shape[1])
        return func(*args, **(kwargs or {}))


def product(name, fn):
    """A torch product `fn()` (a matmul by a 2-D weight, which autograd folds
    into one `aten.mm`) at a save point named `name`: in a block that keeps
    it, the forward stores the result and the recompute runs `fn` with its
    mm returning the stored tensor, so the op's autograd node saves its
    inputs as always."""
    region = _active(name)
    if region is None:
        return fn()
    if not region.replaying:
        out = fn()
        region.store.put(name, out)
        return out
    mode = _ReturnStored(region.store.take(None))
    with mode:
        out = fn()
    if mode.out is not None:
        raise RuntimeError(f"remat: the replayed {name!r} call ran no aten.mm")
    return out


def replays(name) -> bool:
    """Whether a block that keeps `name` is being recomputed right now."""
    region = _active(name)
    return region is not None and region.replaying


def put(name, value):
    """Store `value` where a block keeps `name` and runs its forward;
    returns `value`."""
    region = _active(name)
    if region is not None and not region.replaying:
        region.store.put(name, value)
    return value


class _Attach(torch.autograd.Function):
    """`value` with the autograd history of `deps`: in a recompute, a stored
    tensor standing for one the forward computed from `deps` must require
    grad as that one did, or the ops after it would save less.  The
    recompute's graph is thrown away, so its backward never runs."""

    @staticmethod
    def forward(ctx, value, *deps):
        return value.view_as(value)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError("remat: a recompute's graph is never differentiated")


def take(name, device, *deps):
    """The value `put` stored at this save point (call it where `replays`),
    with the autograd history of `deps`, what the forward computed it from."""
    return _Attach.apply(_active(name).store.take(device), *deps)


def kept(name, value):
    """`value` at a save point named `name` where a block keeps a tensor as
    it is: the forward stores it, the recompute (which computed `value`
    again for the tensors its autograd nodes save) returns the stored one
    with `value`'s autograd history."""
    if replays(name):
        return take(name, value.device, value)
    return put(name, value)


@contextlib.contextmanager
def skipping():
    """Inside a recompute: base products (`keep` with `empty`) return
    placeholders instead of running or replaying."""
    region = _region()
    region.skip = True
    try:
        yield
    finally:
        region.skip = False
