"""One rank of a multi-process run of the port over gloo on the CPU.

`python tests/torch_dist_worker.py CASE RANK WORLD DIR` joins a process
group of WORLD ranks through a file rendezvous in DIR, runs CASE and writes
what the test compares to DIR/CASE-RANK.npz (or .json).  The inputs come
from DIR/inputs.npz, written by tests/test_torch_distributed.py from the
same numpy arrays it hands the JAX package.  Imports torch, numpy and the
port only (no jax), as a rank on the card's machine does.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

torch.set_num_threads(1)


def _unflatten(flat: dict) -> dict:
    """{"a/b/c": array} → nested dicts."""
    out: dict = {}
    for key, val in flat.items():
        node = out
        *parents, leaf = key.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = val
    return out


def _inputs(root: Path) -> dict:
    with np.load(root / "inputs.npz") as f:
        return {k: f[k] for k in f.files}


def case_collectives(rank, world, root):
    from qflux_tpu_torch.parallel import collectives as col

    out = {"main": col.is_main_process(), "count": col.process_count(),
           "mine": col.shard_validation_samples(5)}
    col.barrier()
    mine = ([0], [np.full((1, 4, 4, 3), 10, np.uint8)]) if rank == 0 else \
        ([1], [np.full((1, 4, 4, 3), 20, np.uint8)])
    idxs, imgs = col.gather_validation_images(mine[0], mine[1], n_total=2)
    out["gather_idx"] = idxs
    out["gather_px"] = [int(im[0, 0, 0, 0]) for im in imgs]
    # a rank with no sample, and ranks holding more than ceil(n / world)
    idxs, imgs = col.gather_validation_images([0, 2, 4] if rank == 0 else [],
                                              [np.full((2, 2), i, np.uint8) for i in (0, 2, 4)]
                                              if rank == 0 else [], n_total=5)
    out["gather_uneven"] = [idxs, [int(im[0, 0]) for im in imgs]]
    out["broadcast"] = col.broadcast_from_main({"v": np.arange(3) + 10 * rank})["v"].tolist()
    out["mean"] = col.mean_across_hosts(float(rank + 1))
    out["allgather"] = col.all_gather_host({"x": np.full(2, rank)})["x"].tolist()
    out["any"] = [col.any_across(rank == 1), col.any_across(False)]
    from qflux_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    try:  # a mesh of one rank in a world of two leaves a rank idle
        build_mesh(MeshConfig(dp=1, fsdp=1))
        out["small_mesh"] = "built"
    except ValueError as e:
        out["small_mesh"] = str(e)
    mesh = build_mesh(MeshConfig())  # fsdp's -1 absorbs the world
    out["mesh"] = [mesh.shape, mesh.coords, mesh.data_index, mesh.data_size]
    (root / f"collectives-{rank}.json").write_text(json.dumps(out))


def case_ring(rank, world, root):
    from qflux_tpu_torch.ops import attention, flash_attention
    from qflux_tpu_torch.ops.ring_attention import ring_attention_sharded
    from qflux_tpu_torch.parallel.mesh import MeshConfig, build_mesh

    inp = _inputs(root)
    mesh = build_mesh(MeshConfig(dp=1, fsdp=1, sp=world))
    res = {}
    for name in ("plain", "padded"):
        seg = torch.from_numpy(inp[f"seg_{name}"]) if f"seg_{name}" in inp else None
        q, k, v = (torch.from_numpy(inp[x]).requires_grad_() for x in ("q", "k", "v"))
        before = flash_attention.KERNEL_LAUNCHES
        out = ring_attention_sharded(q, k, v, mesh, segment_ids=seg)
        out.backward(torch.from_numpy(inp["dout"]))
        # the dispatch takes the ring under the active sp mesh
        via = attention.dot_product_attention(*(torch.from_numpy(inp[x]) for x in "qkv"),
                                              segment_ids=seg)
        res[f"{name}_out"] = out.detach().numpy()
        res[f"{name}_dispatch"] = via.numpy()
        for x, t in (("dq", q), ("dk", k), ("dv", v)):
            res[f"{name}_{x}"] = t.grad.numpy()
        res[f"{name}_cuda_launches"] = np.asarray(flash_attention.KERNEL_LAUNCHES - before)
    np.savez(root / f"ring-{rank}.npz", **res)


def _block_fraction(model, rank_bytes: dict) -> None:
    """Each block's bytes held on this rank over its whole bytes, and the
    same over the tensors FSDP2 shards alone ("sharded/...")."""
    from torch.distributed.tensor import DTensor

    for name in ("dual", "single"):
        for i, block in enumerate(getattr(model, name)):
            local = whole = s_local = s_whole = 0
            for p in block.parameters():
                n = p.numel() * p.element_size()
                whole += n
                if isinstance(p, DTensor):
                    mine = p.to_local().numel() * p.element_size()
                    local, s_local, s_whole = local + mine, s_local + mine, s_whole + n
                else:
                    local += n
            rank_bytes[f"{name}/{i}"] = local / whole
            rank_bytes[f"sharded/{name}/{i}"] = s_local / s_whole if s_whole else 1.0


def case_steps(rank, world, root):
    """Every case directory named in cases.json, one after the other."""
    for name in json.loads((root / "cases.json").read_text()):
        _step(rank, root / name)


def _step(rank, root):
    from qflux_tpu_torch import losses
    from qflux_tpu_torch.models import bridge
    from qflux_tpu_torch.models.flux import transformer as tflux
    from qflux_tpu_torch.ops.layers import mark_trainable
    from qflux_tpu_torch.parallel.partitioning import shard_base
    from qflux_tpu_torch.trainer import optimizers
    from qflux_tpu_torch.trainer.base import Trainer, train_config
    from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter
    from qflux_tpu_torch.trainer.train_step import (TrainStepConfig, lora_leaves,
                                                    make_train_step)

    inp = _inputs(root)
    spec = json.loads((root / "step.json").read_text())
    cfg = train_config("test")
    for k, v in spec["mesh"].items():
        setattr(cfg.mesh, k, v)
    cfg.train.gradient_accumulation_steps = spec["accum"]
    trainer = Trainer(cfg, "cpu")
    params = _unflatten({k[2:]: v for k, v in inp.items() if k.startswith("p/")})
    model = bridge.load_params(tflux.FluxTransformer(tflux.FluxConfig.tiny(),
                                                     dtype=torch.float32), params)
    if spec.get("quantize"):
        from qflux_tpu_torch.config import config_from_dict
        from qflux_tpu_torch.ops.quant import quantize_tree

        quantize_tree(model, config_from_dict(
            {"model": {"quantize": {"enabled": True, "dtype": spec["quantize"]}}}
        ).model.quantize)
    if trainer.mesh.shards_base:  # as the Trainer's load_model
        shard_base(model, trainer.mesh)
    frac: dict = {}
    _block_fraction(model, frac)
    lora_np = _unflatten({k[2:]: v for k, v in inp.items() if k.startswith("l/")})
    lora = {path: {"a": torch.from_numpy(leaf["a"]), "b": torch.from_numpy(leaf["b"]),
                   "scaling": torch.tensor(float(leaf["scaling"]))}
            for path, leaf in ((p.replace("|", "/"), leaf) for p, leaf in lora_np.items())}
    lora = mark_trainable(lora)
    batch = {k[2:]: v for k, v in inp.items() if k.startswith("b/")}
    local, data = trainer._rank_rows(batch)
    local = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in local.items()}
    opt = optimizers.build("optax.sgd", lora_leaves(lora)[0], spec["lr"], {})
    criterion = getattr(losses, spec["loss"])()
    step = make_train_step(FluxKontextAdapter(model.cfg).predict_velocity, criterion, opt,
                           lambda i: spec["lr"],
                           TrainStepConfig(max_grad_norm=spec["max_norm"],
                                           grad_accum_steps=spec["accum"]))
    m = step(model, lora, local, None, noise=torch.from_numpy(inp["noise"]),
             sigma=torch.from_numpy(inp["sigma"]), data=data)
    out = {"loss": np.asarray(float(m["loss"])), "grad_norm": np.asarray(float(m["grad_norm"])),
           "data_size": np.asarray(data.size), "rows": np.asarray(local["image_latents"].shape[0])}
    for path, leaf in lora.items():
        for key in ("a", "b"):
            out[f"lora/{path}/{key}"] = leaf[key].detach().numpy()
    for name, f in frac.items():
        out[f"frac/{name}"] = np.asarray(f)
    np.savez(root / f"step-{rank}.npz", **out)


def case_fit(rank, world, root):
    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.trainer.base import Trainer

    cfg = config_from_dict(json.loads((root / "fit.json").read_text()))
    t = Trainer(cfg, "cpu")
    ds = ImageDataset(dataset_path=cfg.data.init_args["dataset_path"],
                      processor=ImageProcessor(cfg.data.processor))
    t.fit(DataLoader(ds, batch_size=2, shuffle=False, drop_last=False))
    (root / f"fit-{rank}.json").write_text(json.dumps(
        {"global_step": t.global_step, "output_dir": str(t.output_dir),
         "losses": [h["loss"] for h in t.history],
         "lora": {p: float(leaf["b"].detach().abs().sum()) for p, leaf in t.lora.items()}}))


def case_fit_oom(rank, world, root):
    """The fit of fit.json under mesh.remat "minimal" whose forward runs out
    of device memory on rank 1 alone until the policy is "full", then the
    same fit under "full" from the start; each rank's policy after the
    fit, its losses and its LoRA."""
    import dataclasses

    from qflux_tpu_torch.config import config_from_dict
    from qflux_tpu_torch.data.dataset import ImageDataset
    from qflux_tpu_torch.data.loader import DataLoader
    from qflux_tpu_torch.data.preprocess import ImageProcessor
    from qflux_tpu_torch.trainer.base import Trainer
    from qflux_tpu_torch.trainer.flux_kontext import FluxKontextAdapter

    @dataclasses.dataclass(frozen=True)
    class OomUnlessFull(FluxKontextAdapter):
        def predict_velocity(self, *a, **k):
            if self.remat_policy != "full":
                raise torch.OutOfMemoryError("CUDA out of memory (planted on rank 1)")
            return super().predict_velocity(*a, **k)

    out = {}
    for name, policy in (("planted", "minimal"), ("full", "full")):
        cfg = config_from_dict(json.loads((root / "fit.json").read_text()))
        cfg.mesh.remat = policy
        cfg.logging.output_dir = str(root / name)
        t = Trainer(cfg, "cpu")
        t.load_model()
        if name == "planted" and rank == 1:
            t.adapter = OomUnlessFull(**{f.name: getattr(t.adapter, f.name)
                                         for f in dataclasses.fields(t.adapter)})
        ds = ImageDataset(dataset_path=cfg.data.init_args["dataset_path"],
                          processor=ImageProcessor(cfg.data.processor))
        t.fit(DataLoader(ds, batch_size=2, shuffle=False, drop_last=False))
        out[name] = {"policy": t.adapter.remat_policy, "steps": [h["step"] for h in t.history],
                     "losses": [h["loss"] for h in t.history],
                     "lora": {f"{p}/{k}": leaf[k].detach().numpy().tolist()
                              for p, leaf in t.lora.items() for k in ("a", "b")}}
    (root / f"fit_oom-{rank}.json").write_text(json.dumps(out))


def main(case, rank, world, root):
    root = Path(root)
    dist.init_process_group("gloo", init_method=f"file://{root / 'rendezvous'}", rank=rank,
                            world_size=world)
    try:
        globals()[f"case_{case}"](rank, world, root)
    finally:
        dist.destroy_process_group()
    print(f"rank {rank} ok", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
