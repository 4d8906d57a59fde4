"""The (dp, fsdp, tp, sp) mesh over torch.distributed.

Counterpart of qflux_tpu/parallel/mesh.py.  JAX runs one program over a
device mesh and XLA inserts the collectives; here every rank is a process
that drives one device, and the mesh says which ranks share what:

  dp    data parallel: the batch is split here; LoRA gradients are
        all-reduced over it.
  fsdp  a second data axis, and, where it has more than one rank, the axis
        the frozen base is sharded over (FSDP2 `fully_shard` per
        transformer block and on the root,
        `parallel/partitioning.py:shard_base`): each block's weights are
        all-gathered before its forward and again before its backward.
  tp    tensor parallelism: only tp = 1 runs (tp > 1 raises, naming queue 1
        item 8b).
  sp    sequence parallelism: ring attention over the sp ranks
        (`ops/ring_attention.py`); every other op is replicated over sp.

Ranks are laid out row-major over AXIS_ORDER, so sp is the innermost axis
(rank = ((dp·F + fsdp)·T + tp)·SP + sp).  `build_mesh` builds
`torch.distributed.device_mesh.init_device_mesh` over the process group's
world; without a process group it builds a world-of-one mesh that needs no
init.  One difference from JAX: JAX runs a fully explicit mesh smaller than
its device count on the first devices, while here each rank is a process
whose device would sit idle, so a mesh whose size is not the world size
raises.  `dcn_axes` is accepted and has no effect, as on JAX's
single-slice backend.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional

import torch

ITEM_8B = ("ROADMAP.md, queue 1 item 8b: tensor parallelism (column- and row-parallel dense "
           "layers around the port's kernels)")


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical mesh description.

    -1 for an axis size means "absorb all remaining devices" (at most one
    axis may be -1).
    """

    dp: int = 1
    fsdp: int = -1
    tp: int = 1
    sp: int = 1
    dcn_axes: tuple[str, ...] = ()

    def resolve(self, n_devices: int) -> dict[str, int]:
        sizes = {"dp": self.dp, "fsdp": self.fsdp, "tp": self.tp, "sp": self.sp}
        wild = [k for k, v in sizes.items() if v == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one mesh axis may be -1, got {wild}")
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(f"{n_devices} devices not divisible by fixed axes {sizes}")
            sizes[wild[0]] = n_devices // fixed
        if math.prod(sizes.values()) > n_devices:
            raise ValueError(f"mesh {sizes} needs more than the {n_devices} devices available")
        return sizes


AXIS_ORDER = ("dp", "fsdp", "tp", "sp")


@dataclasses.dataclass(eq=False)
class Mesh:
    """A resolved mesh and this rank's place in it.

    `shape` maps each axis of AXIS_ORDER to its size; `coords` this rank's
    index on each.  `device_mesh` is the torch DeviceMesh (None for a world
    of one without a process group); `data_group` the process group of the
    dp × fsdp ranks that share this rank's tp and sp indices (the LoRA
    gradients and the loss's normaliser reduce over it), `data_index` this
    rank's index in it; `sp_group` the ring's group.  Both are None
    without a process group (and exist, of one rank, where their axes have
    size 1 in one)."""

    shape: dict
    coords: dict
    rank: int = 0
    world: int = 1
    device_type: str = "cpu"
    device_mesh: object = None
    data_group: object = None
    sp_group: object = None

    @property
    def data_size(self) -> int:
        return self.shape["dp"] * self.shape["fsdp"]

    @property
    def data_index(self) -> int:
        return self.coords["dp"] * self.shape["fsdp"] + self.coords["fsdp"]

    @property
    def shards_base(self) -> bool:
        """Whether the frozen base is sharded: over fsdp > 1 ranks of a
        process group.  At fsdp = 1 FSDP2 would add its hooks and copies
        to every block and save no memory."""
        return self.device_mesh is not None and self.shape["fsdp"] > 1

    @property
    def step_collectives(self) -> bool:
        """Whether a train step's forward and backward exchange tensors
        with other ranks: the base's all-gathers (`shards_base`) or the
        ring's rotations (sp > 1).  A rank that leaves such a step early
        leaves the others waiting in a collective."""
        return self.shards_base or (self.device_mesh is not None and self.shape["sp"] > 1)

    def sub_mesh(self, axis: str):
        """The 1-D DeviceMesh of `axis` that holds this rank (FSDP2's mesh
        for "fsdp"), or None without a process group."""
        return None if self.device_mesh is None else self.device_mesh[axis]


_ACTIVE_MESH: list = [None]


def active_mesh() -> Optional[Mesh]:
    """The mesh most recently built by `build_mesh` (or set by
    `set_active_mesh`): leaf ops (the attention dispatch) find it here."""
    return _ACTIVE_MESH[0]


def set_active_mesh(mesh: Optional[Mesh]) -> Optional[Mesh]:
    """Make `mesh` the active one; returns the mesh it replaced."""
    old, _ACTIVE_MESH[0] = _ACTIVE_MESH[0], mesh
    return old


def _coords(rank: int, shape: tuple) -> dict:
    out = {}
    for axis, size in zip(reversed(AXIS_ORDER), reversed(shape)):
        out[axis] = rank % size
        rank //= size
    return {a: out[a] for a in AXIS_ORDER}


def data_ranks(shape: dict) -> list[list[int]]:
    """Every data group's ranks: for each (tp, sp) index pair, the ranks of
    the dp × fsdp grid that share it, in data-index order."""
    sizes = tuple(shape[a] for a in AXIS_ORDER)
    groups: dict = {}
    for r in range(math.prod(sizes)):
        c = _coords(r, sizes)
        groups.setdefault((c["tp"], c["sp"]), []).append(r)
    return list(groups.values())


def build_mesh(config: Optional[MeshConfig] = None, device_type: Optional[str] = None) -> Mesh:
    """Resolve `config` over the process group's world (1 without one),
    build the mesh and make it the active one.

    Raises NotImplementedError for tp > 1 (item 8b) and ValueError where
    JAX's `resolve` raises, or where the mesh's size is not the world size
    (each rank is a process that would sit idle).  `device_type` is the
    DeviceMesh's ("cuda" or "cpu"; default: cuda where the process group's
    backend is NCCL)."""
    import torch.distributed as dist

    config = config or MeshConfig()
    if config.tp > 1:
        raise NotImplementedError(f"mesh.tp = {config.tp} is not ported yet ({ITEM_8B}); "
                                  "dp, fsdp and sp run")
    init = dist.is_available() and dist.is_initialized()
    world = dist.get_world_size() if init else 1
    sizes = config.resolve(world)
    if sizes["tp"] > 1:
        raise NotImplementedError(f"mesh.tp = {sizes['tp']} is not ported yet ({ITEM_8B}); "
                                  "dp, fsdp and sp run")
    shape = tuple(sizes[a] for a in AXIS_ORDER)
    if math.prod(shape) != world:
        raise ValueError(
            f"mesh {sizes} covers {math.prod(shape)} ranks but the world has {world}: each "
            "rank is a process driving one device, so the mesh must cover the world (JAX "
            "runs a smaller mesh on its first devices)")
    if not init:
        mesh = Mesh(shape=sizes, coords=dict.fromkeys(AXIS_ORDER, 0))
        set_active_mesh(mesh)
        return mesh
    from torch.distributed.device_mesh import init_device_mesh

    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    rank = dist.get_rank()
    dm = init_device_mesh(device_type, shape, mesh_dim_names=AXIS_ORDER)
    # every rank creates every group, in the same order: the data groups,
    # and the gloo group for host objects where the backend is not gloo
    data_group, _ = dist.new_subgroups_by_enumeration(data_ranks(sizes))
    from qflux_tpu_torch.parallel.collectives import host_group

    host_group()
    mesh = Mesh(shape=sizes, coords=_coords(rank, shape), rank=rank, world=world,
                device_type=device_type, device_mesh=dm, data_group=data_group,
                sp_group=dm["sp"].get_group())
    set_active_mesh(mesh)
    return mesh


def local_batch_size(mesh: Mesh, global_batch_size: int) -> int:
    """The rows of a global batch that one rank holds: the batch is split
    over (dp, fsdp) and replicated over sp (JAX's per-host size, with one
    process per device)."""
    data_ways = mesh.shape["dp"] * mesh.shape["fsdp"]
    if global_batch_size % data_ways != 0:
        raise ValueError(
            f"global batch {global_batch_size} not divisible by dp*fsdp={data_ways}")
    return global_batch_size // data_ways


def data_axis_size(mesh: Mesh) -> int:
    return mesh.shape["dp"] * mesh.shape["fsdp"]


def init_distributed(device: str) -> torch.device:
    """`torch.distributed.init_process_group` from torchrun's environment
    (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), as JAX calls
    `jax.distributed.initialize()`: NCCL for a cuda device, gloo only for
    "cpu".  Returns this rank's device (cuda:LOCAL_RANK on the card), set as
    the current one.  A missing variable or a failed rendezvous raises."""
    import torch.distributed as dist

    missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
               if k not in os.environ]
    if missing:
        raise RuntimeError(f"--distributed needs torchrun's environment; {missing} unset "
                           "(launch with torchrun --nproc-per-node N -m qflux_tpu_torch.main "
                           "--distributed ...)")
    kind = torch.device(device).type
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif kind == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        raise ValueError(f"--distributed runs on cuda (NCCL) or cpu (gloo), not {device!r}")
    if not dist.is_initialized():
        kw = {"device_id": dev} if kind == "cuda" else {}
        dist.init_process_group(backend, init_method="env://", **kw)
    elif dist.get_backend() != backend:
        raise RuntimeError(f"the process group runs {dist.get_backend()}, {device} needs "
                           f"{backend}")
    return dev
