"""Regex-rule parameter partitioning, and the frozen base sharded with FSDP2.

Counterpart of qflux_tpu/parallel/partitioning.py.  The rules are JAX's:
(regex, spec) pairs matched against '/'-joined paths of the JAX parameter
tree (first match wins), a spec a plain tuple with one entry per dim (an
axis name, a tuple of them, or None).  A spec is clipped per leaf
(`clip_spec_to_shape`): right-aligned to the leaf's dims, with each axis
that does not divide its dim dropped, so one rule set serves every size.

`shard_base` is JAX's `shard_pytree(dit_params, mmdit_rules(), mesh)`: each
transformer block, and then the root, goes through FSDP2's `fully_shard`
over the mesh's fsdp sub-mesh (replicated over dp and sp).  The Trainer
shards only where fsdp > 1 (`Mesh.shards_base`).  Each parameter
is read in the JAX layout (`jax_leaf`: a dense `weight [out, in]` is JAX's
`kernel [in, out]`, a per-channel `q [out, in]` JAX's `kernel_q`, the int4
`q4` and the scales are JAX's own layout) and sharded on the dim the rules
put "fsdp" on (`shard_placement_fn`); a parameter whose clipped spec holds
no "fsdp" (norm scales, biases, quantization scales, anything whose dims
fsdp does not divide) stays whole on every rank (`ignored_params`), as the
rules' replication.  The rules' "tp" entries act as replication while tp =
1.  The LoRA is no parameter of the model (`Dense.lora`), so it stays
replicated, as `lora_rules` says.
"""

from __future__ import annotations

import contextlib
import re
from typing import Optional, Sequence

from torch import nn

from qflux_tpu_torch.ops.layers import Dense
from qflux_tpu_torch.ops.quant import _jax_path

Spec = tuple

# the JAX leaf of each quantized parameter of a Dense, by its form
_Q4_LEAF = {"int4_requant": "kernel_q4_rq", "int4": "kernel_q4", "int4_dynamic": "kernel_q4_dyn"}


def _axis_size(mesh_shape: dict, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, (tuple, list)):
        n = 1
        for a in axis:
            n *= mesh_shape[a]
        return n
    return mesh_shape[axis]


def clip_spec_to_shape(spec: Optional[Spec], shape: Sequence[int], mesh_shape: dict) -> Spec:
    """Drop sharded axes that don't evenly divide the array dims: the spec
    right-aligned to `shape` (leading dims replicated), an axis that cannot
    divide its dim replaced by None, trailing Nones removed.  `mesh_shape`
    maps axis names to sizes (a `Mesh`'s `shape`)."""
    if spec is None:
        return ()
    axes = list(spec)
    if len(axes) < len(shape):
        axes = [None] * (len(shape) - len(axes)) + axes
    else:
        axes = axes[len(axes) - len(shape):]
    out = []
    for dim, axis in zip(shape, axes):
        size = _axis_size(mesh_shape, axis)
        out.append(axis if (size > 1 and dim % size == 0) or size == 1 else None)
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


class PartitionRules:
    def __init__(self, rules: Sequence[tuple[str, Spec]]):
        self._rules = [(re.compile(pat), spec) for pat, spec in rules]

    def spec_for(self, path_str: str, shape: Optional[Sequence[int]] = None,
                 mesh_shape: Optional[dict] = None) -> Spec:
        for pat, spec in self._rules:
            if pat.fullmatch(path_str):
                if shape is not None and mesh_shape is not None:
                    return clip_spec_to_shape(spec, shape, mesh_shape)
                return spec
        return ()

    def __add__(self, other: "PartitionRules") -> "PartitionRules":
        new = PartitionRules([])
        new._rules = self._rules + other._rules
        return new


def mmdit_rules() -> PartitionRules:
    """Sharding for MMDiT-family transformers (FLUX / Qwen-Image / Klein),
    JAX's: frozen base params shard over fsdp (+ tp on the hidden dims);
    LoRA params are replicated (`lora_rules`)."""
    return PartitionRules([
        (r".*(attn|attention).*/(to_q|to_k|to_v|add_q|add_k|add_v|qkv)/kernel", ("fsdp", "tp")),
        (r".*(attn|attention).*/(to_out|add_out|proj)/kernel", ("tp", "fsdp")),
        (r".*(mlp|ff|ffn)[^/]*/(in|up|gate|fc1|proj_mlp)/kernel", ("fsdp", "tp")),
        (r".*(mlp|ff|ffn)[^/]*/(out|down|fc2|proj_out)/kernel", ("tp", "fsdp")),
        (r".*mod[^/]*/kernel", ("fsdp", "tp")),
        (r".*(img_in|txt_in|x_embedder|context_embedder|proj_out(_mlp)?|final_proj)/kernel",
         ("fsdp",)),
        (r".*(time|guidance|text)_embed.*/kernel", ("fsdp",)),
        (r".*(norm|scale|shift).*", ()),
        (r".*bias", ()),
        (r".*", ("fsdp",)),
    ])


def lora_rules() -> PartitionRules:
    """LoRA adapters are tiny: replicated everywhere."""
    return PartitionRules([(r".*", ())])


def batch_rules() -> PartitionRules:
    """Batch-dim-leading arrays (latents, embeddings) shard over (dp, fsdp)."""
    return PartitionRules([(r".*", (("dp", "fsdp"),))])


def jax_leaf(module: nn.Module, name: str) -> tuple[str, bool]:
    """The JAX tree leaf that `module`'s parameter `name` stands for, and
    whether the port holds it transposed: a Dense's `weight` is `kernel`
    ([out, in] for [in, out]), its `q` `kernel_q` / `kernel_q_dyn`
    (transposed too), `q4` the form's `kernel_q4*`, `scale` `kernel_scale`;
    the requant factors the port caches beside q4 (`rq_f`, `rq_s_vec`,
    derived from the scale) take the scale's leaf.  Anything else keeps its
    name (biases, norm scales)."""
    if isinstance(module, Dense):
        if name == "weight":
            return "kernel", True
        if name == "q":
            return ("kernel_q_dyn" if module.q_form == "int8_dynamic" else "kernel_q"), True
        if name == "q4":
            return _Q4_LEAF[module.q_form], False
        if name in ("scale", "rq_f", "rq_s_vec"):
            return "kernel_scale", False
    return name, False


def param_specs(model: nn.Module, mesh_shape: dict, prefix: str = "") -> dict:
    """{parameter name: (JAX path, clipped `mmdit_rules` spec over the JAX
    layout, torch dim of the fsdp shard or None)} for every parameter of
    `model`; `prefix` is `model`'s path in the whole DiT ("dual/3/")."""
    rules = mmdit_rules()
    out = {}
    for full, param in model.named_parameters():
        mod_name, _, leaf = full.rpartition(".")
        owner = model.get_submodule(mod_name) if mod_name else model
        jleaf, transposed = jax_leaf(owner, leaf)
        mod_path = prefix + mod_name.replace(".", "/")
        path = _jax_path(mod_path.strip("/")) + "/" + jleaf if mod_path.strip("/") else jleaf
        shape = tuple(param.shape)
        jshape = shape[::-1] if transposed else shape
        spec = rules.spec_for(path, jshape, mesh_shape)
        dim = None
        aligned = [None] * (len(jshape) - len(spec)) + list(spec)
        for j, axis in enumerate(aligned):
            if axis == "fsdp" or (isinstance(axis, tuple) and "fsdp" in axis):
                dim = (len(shape) - 1 - j) if transposed else j
        out[full] = (path, spec, dim)
    return out


@contextlib.contextmanager
def _integer_parameters_frozen():
    """While active, `nn.Parameter(t)` of an integer tensor is made with
    requires_grad False.  FSDP2 in torch 2.11 wraps each shard as
    `nn.Parameter(shard)` (requires_grad True by default) before it copies
    the original's flag, which an int8 tensor refuses; later releases pass
    the flag.  The quantized weights (int8 `q4` / `q`) are such tensors."""
    new = nn.Parameter.__new__

    def frozen_if_integer(cls, data=None, requires_grad=True):
        if data is not None and not (data.is_floating_point() or data.is_complex()):
            requires_grad = False
        return new(cls, data, requires_grad)

    nn.Parameter.__new__ = frozen_if_integer
    try:
        yield
    finally:
        nn.Parameter.__new__ = new


def shard_module(module: nn.Module, mesh, prefix: str = "", reshard_after_forward: bool = True):
    """FSDP2 `fully_shard` of `module` over the mesh's fsdp sub-mesh: each
    parameter the rules shard over fsdp on its dim (`param_specs`), the rest
    left whole (`ignored_params`).  Parameters already under a `fully_shard`
    of a submodule stay with it.  Returns the module."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Shard

    specs = param_specs(module, mesh.shape, prefix)
    params = dict(module.named_parameters())
    placement = {id(params[n]): Shard(d) for n, (_, _, d) in specs.items() if d is not None}
    ignored = {params[n] for n, (_, _, d) in specs.items() if d is None}
    with _integer_parameters_frozen():
        fully_shard(module, mesh=mesh.sub_mesh("fsdp"),
                    reshard_after_forward=reshard_after_forward,
                    shard_placement_fn=lambda p: placement.get(id(p)), ignored_params=ignored)
    return module


def block_lists(model: nn.Module) -> list[tuple[str, nn.ModuleList]]:
    """(name, ModuleList) of the DiT's transformer blocks: FLUX's "dual"
    and "single", Qwen's "blocks"."""
    return [(n, getattr(model, n)) for n in ("dual", "single", "blocks")
            if isinstance(getattr(model, n, None), nn.ModuleList)]


def shard_base(model: nn.Module, mesh) -> nn.Module:
    """JAX's `shard_pytree(dit_params, mmdit_rules(), mesh)`: `fully_shard`
    per transformer block not yet sharded (`shard_module`; a loader given
    the mesh shards each block as it loads), then on the root (its own
    parameters: the embedders, the output norm and projection).  A no-op
    without a process group; the Trainer calls it where the mesh shards
    the base (`Mesh.shards_base`: fsdp > 1).  Returns the model."""
    if mesh is None or mesh.device_mesh is None:
        return model
    from torch.distributed.fsdp import FSDPModule

    for name, blocks in block_lists(model):
        for i, block in enumerate(blocks):
            if not isinstance(block, FSDPModule):
                shard_module(block, mesh, f"{name}/{i}/")
    return shard_module(model, mesh, "", reshard_after_forward=False)
