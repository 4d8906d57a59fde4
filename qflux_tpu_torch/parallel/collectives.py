"""Host-level collectives across ranks.

Counterpart of qflux_tpu/parallel/collectives.py: the operations on host
objects (numpy arrays, numbers, small trees of them) that a multi-process
run needs outside the train step: the main-rank test, the barrier, the
gather and broadcast of host data, the validation sample shard and image
gather, the mean across ranks, and (the port's own) the decisions every
rank must take together.  Each takes the single-process fast path where
there is no process group or it has one rank.

NCCL carries no CPU tensors, so host objects travel over a gloo group
beside the NCCL one: the default group where the run's backend is gloo,
else `host_group()` (made once, by every rank, when the mesh is built).
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

_HOST_GROUP: list = [None]


def _world() -> tuple[int, int]:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def host_group():
    """The gloo group over every rank for host objects: None (the default
    group) where the default backend is gloo; else a gloo group, created on
    the first call, which every rank must make (it is collective)."""
    import torch.distributed as dist

    if dist.get_backend() == "gloo":
        return None
    if _HOST_GROUP[0] is None:
        _HOST_GROUP[0] = dist.new_group(backend="gloo")
    return _HOST_GROUP[0]


def is_main_process() -> bool:
    return _world()[0] == 0


def process_count() -> int:
    return _world()[1]


def barrier(name: str = "qflux_barrier") -> None:
    """Every rank waits for every other (JAX's `sync_global_devices`)."""
    if process_count() == 1:
        return
    import torch.distributed as dist

    dist.barrier(group=host_group())


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _stack(trees: list):
    """Trees of one structure → one tree of [world, ...] arrays."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([t[i] for t in trees]) for i in range(len(first)))
    return np.stack([np.asarray(t) for t in trees])


def all_gather_host(tree: Any) -> Any:
    """Host arrays of every rank → on every rank, each leaf stacked over the
    ranks ([world, ...]), as JAX's `process_allgather`."""
    if process_count() == 1:
        return _tree_map(lambda x: np.asarray(x)[None], tree)
    import torch.distributed as dist

    out: list = [None] * process_count()
    dist.all_gather_object(out, _tree_map(np.asarray, tree), group=host_group())
    return _stack(out)


def broadcast_from_main(tree: Any) -> Any:
    """Rank 0's host data on every rank (JAX's `broadcast_one_to_all`)."""
    if process_count() == 1:
        return tree
    import torch.distributed as dist

    box = [tree if is_main_process() else None]
    dist.broadcast_object_list(box, src=0, group=host_group())
    return box[0]


def shard_validation_samples(n_samples: int, rank: int | None = None,
                             world: int | None = None) -> list[int]:
    """Round-robin validation-sample shard of this rank (i % world == rank);
    `rank` / `world` override the process group's (the Trainer shards over
    the dp axis, whose ranks sample alone)."""
    r, w = _world()
    rank, world = (r if rank is None else rank), (w if world is None else world)
    return [i for i in range(n_samples) if i % world == rank]


def gather_validation_images(indices: list[int], images: list[np.ndarray],
                             n_total: int) -> tuple[list[int], list[np.ndarray]]:
    """Collect every rank's validation results onto every rank, in index
    order.  All images must share one shape.  Each rank pads its shard to
    ceil(n/world) entries, or to the largest shard where a rank holds more
    (the Trainer shards over the dp axis; index -1 = padding), so the
    gather is shape-uniform.  Single-process: identity.  Every rank must
    call this."""
    world = process_count()
    if world == 1:
        return list(indices), list(images)
    shapes = {tuple(np.shape(im)) for im in images}
    if len(shapes) > 1:
        raise ValueError(f"validation images must share one shape, got {shapes}")
    # a rank may own no sample when n_total < world; learn the shape from
    # whoever has one
    meta = (np.asarray(list(shapes)[0], np.int64) if images else np.zeros((0,), np.int64))
    metas = np.asarray(all_gather_host(np.concatenate(
        [[len(meta)], meta, np.zeros(8 - len(meta), np.int64), [len(indices)]])))
    pad_to = max(-(-max(n_total, 1) // world), int(metas[:, -1].max()))
    have = [m for m in metas if m[0] > 0]
    if not have:
        return [], []
    n_dims = int(have[0][0])
    shape = tuple(int(x) for x in have[0][1:1 + n_dims])
    arr = np.zeros((pad_to,) + shape, np.uint8)
    idx = np.full((pad_to,), -1, np.int32)
    for j, (i, im) in enumerate(zip(indices, images)):
        arr[j], idx[j] = np.asarray(im).astype(np.uint8), i
    g_idx = np.asarray(all_gather_host(idx))  # [world, pad_to]
    g_arr = np.asarray(all_gather_host(arr))
    out_i, out_im = [], []
    for w in range(g_idx.shape[0]):
        for j in range(g_idx.shape[1]):
            if g_idx[w, j] >= 0:
                out_i.append(int(g_idx[w, j]))
                out_im.append(g_arr[w, j])
    order = np.argsort(out_i, kind="stable")
    return [out_i[o] for o in order], [out_im[o] for o in order]


def mean_across_hosts(value: float) -> float:
    """Scalar mean over ranks."""
    if process_count() == 1:
        return float(value)
    return float(np.mean(all_gather_host(np.asarray([value], np.float64))))


def any_across(flag: bool) -> bool:
    """Whether any rank's `flag` is set: the decisions that exist only
    where each rank runs its own program (a retry after running out of
    memory, a stop after SIGINT / SIGTERM) are taken by every rank
    together, or the others would wait in a collective forever."""
    if process_count() == 1:
        return bool(flag)
    import torch.distributed as dist

    t = torch.tensor([1 if flag else 0], dtype=torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=host_group())
    return bool(t.item())
