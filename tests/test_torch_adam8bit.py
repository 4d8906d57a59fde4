"""The port's blockwise-fp8 AdamW (qflux_tpu_torch/ops/adam8bit.py) against
JAX's jitted `qflux_tpu.ops.adam8bit.adamw8bit`, and its moments in the JAX
trainer's `optimizer_state.npz` (qflux_tpu_torch/utils/checkpoint.py), on
the CPU.

The LoRA tree has a stacked leaf of two layers whose size is no multiple of
the block size (the blocks run across the layers, as JAX stacks them) and a
top-level one.  XLA fuses the jitted update and may contract b1·m + (1 -
b1)·g into one fused multiply-add, which rounds once where the port's torch
ops round twice, so a moment can sit one f32 ulp from JAX's: a block scale
(amax · fl32(1/448)) then moves by an ulp, and a code could round to the
neighbouring e4m3 value.  So the codes are held equal to the bit except
where such a flip is found, which the assertion lists and holds to one
e4m3 step; the scales to 2 f32 ulps; the parameters to 1e-6 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from qflux_tpu.ops.adam8bit import adamw8bit
from qflux_tpu.trainer.base import _flatten_with_paths
from qflux_tpu_torch.ops.adam8bit import AdamW8bit
from qflux_tpu_torch.utils import checkpoint

LR, WD = 1e-2, 1e-2
SHAPES = {("dual", "attn", "to_q"): ((37, 5), (5, 64), 2),   # stacked over 2 layers
          ("x_embedder",): ((16, 4), (4, 96), None)}


def _jax_tree(rng):
    """A JAX LoRA tree: a stacked leaf [L, ...] and a top-level one."""
    tree = {}
    for path, (sa, sb, layers) in SHAPES.items():
        lead = (layers,) if layers else ()
        leaf = {"a": rng.standard_normal(lead + sa).astype(np.float32) * 0.1,
                "b": rng.standard_normal(lead + sb).astype(np.float32) * 0.1,
                "scaling": np.full(lead, 1.0, np.float32)}
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = leaf
    return tree


def _node(tree, path):
    for part in path:
        tree = tree[part]
    return tree


def _port_lora(jtree):
    """The port's flat LoRA tree holding `jtree`'s a / b (per layer)."""
    lora = {}
    for path, (_, _, layers) in SHAPES.items():
        leaf = _node(jtree, path)
        for layer in (range(layers) if layers else [None]):
            name = "/".join(path) if layer is None else f"{path[0]}/{layer}/" + "/".join(path[1:])
            pick = (lambda x: x) if layer is None else (lambda x, i=layer: x[i])
            lora[name] = {k: torch.tensor(np.asarray(pick(leaf[k]))).requires_grad_()
                          for k in ("a", "b")}
            lora[name]["scaling"] = torch.tensor(1.0)
    return lora


def _grads(rng, jtree):
    """Gradients across six decades (the moments' blocks then hold small and
    large values), zero for the scaling leaves."""
    def one(x, key):
        if key == "scaling":
            return np.zeros_like(x)
        return (rng.standard_normal(x.shape) * 10.0 ** rng.uniform(-6, 0, x.shape)
                ).astype(np.float32)
    return jax.tree_util.tree_map_with_path(lambda p, x: one(x, p[-1].key), jtree)


def _set_port_grads(lora, jgrads):
    for name, leaf in lora.items():
        parts = name.split("/")
        if parts[1:2] and parts[1].isdigit():
            jleaf = _node(jgrads, (parts[0], *parts[2:]))
            for k in ("a", "b"):
                leaf[k].grad = torch.tensor(np.asarray(jleaf[k][int(parts[1])]))
        else:
            jleaf = _node(jgrads, tuple(parts))
            for k in ("a", "b"):
                leaf[k].grad = torch.tensor(np.asarray(jleaf[k]))


def _jax_update():
    opt = adamw8bit(LR, weight_decay=WD)

    @jax.jit
    def update(params, state, grads):
        u, state = opt.update(grads, state, params)
        return optax.apply_updates(params, u), state

    return opt, update


def _e4m3_step(a, b):
    """How many e4m3 values apart two codes of one sign are."""
    return np.abs(a.astype(np.int16) - b.astype(np.int16))


def _assert_state_matches(lora, opt, jstate, jparams, where):
    """The port's codes, scales and parameters against JAX's state and
    parameters (the bounds in the module docstring)."""
    flat = {"/".join(p): np.asarray(v) for p, v in _flatten_with_paths(jstate)}
    flips = []
    for stack in checkpoint.lora_stacks(lora):
        name = next(n for n, leaf in lora.items() if any(leaf[k] is stack[0] for k in "ab"))
        key = next(k for k in "ab" if lora[name][k] is stack[0])
        parts = name.split("/")
        jpath = "/".join([parts[0]] + parts[2:]) if parts[1:2] and parts[1].isdigit() else name
        state = opt.state[stack[0]]
        for mom in ("m", "v"):
            jq = flat[f"0/moments/{jpath}/{key}/{mom}/q"].view(np.uint8)
            js = flat[f"0/moments/{jpath}/{key}/{mom}/scale"]
            tq = state[mom][0].view(torch.uint8).numpy()
            ts = state[mom][1].numpy()
            np.testing.assert_allclose(ts, js, rtol=2 * 2.0 ** -23, atol=0,
                                       err_msg=f"{where} {jpath}/{key}/{mom} scale")
            diff = np.nonzero(jq != tq)[0]
            same_sign = (jq[diff] & 0x80) == (tq[diff] & 0x80)
            assert same_sign.all() and (_e4m3_step(jq[diff], tq[diff]) <= 1).all(), (
                f"{where} {jpath}/{key}/{mom}: codes at {diff.tolist()}: port "
                f"{tq[diff].tolist()} JAX {jq[diff].tolist()}")
            flips += [(jpath, key, mom, int(i)) for i in diff]
        jp = _node(jparams, tuple(jpath.split("/")))[key]
        tp = torch.cat([p.detach().reshape(-1) for p in stack]).numpy()
        np.testing.assert_allclose(tp, np.asarray(jp).reshape(-1), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(jp)).max(),
                                   err_msg=f"{where} {jpath}/{key}")
    return flips


def test_twenty_updates_match_jax():
    """20 updates from the same parameters and gradients: JAX's jitted
    adamw8bit over the stacked tree, and AdamW8bit over the port's per-layer
    tensors grouped as JAX stacks them (`checkpoint.lora_stacks`).  After
    every update the codes, scales and parameters agree (module docstring);
    the codes that flipped by one e4m3 step, if any, are printed."""
    rng = np.random.default_rng(0)
    jtree = _jax_tree(rng)
    lora = _port_lora(jtree)
    jopt, update = _jax_update()
    jparams = jax.tree.map(jnp.asarray, jtree)
    jstate = jopt.init(jparams)
    params = [leaf[k] for leaf in lora.values() for k in ("a", "b")]
    opt = AdamW8bit(params, lr=LR, weight_decay=WD, stacks=checkpoint.lora_stacks(lora))
    flips = []
    for i in range(20):
        g = _grads(rng, jtree)
        jparams, jstate = update(jparams, jstate, jax.tree.map(jnp.asarray, g))
        _set_port_grads(lora, g)
        opt.step()
        flips += _assert_state_matches(lora, opt, jstate, jparams, f"update {i + 1}")
    assert all(opt.state[s[0]]["count"] == 20 for s in opt.stacks)
    print("codes one e4m3 step from JAX's:", flips)


def _npz(path, arrays):
    np.savez(path, **arrays)
    with np.load(path) as f:
        return dict(f)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_optimizer_state_npz_resumes_across_packages(tmp_path, writer):
    """Three updates by one package, its state written as the JAX trainer
    writes `optimizer_state.npz` (the port: `checkpoint.optimizer_state_arrays`;
    the same keys, shapes and `|V1` code bytes as JAX's), read back by the
    other, and a fourth update on both that agrees as in
    `test_twenty_updates_match_jax`.  JAX's own loader
    (`Trainer._load_train_state`) hands a `|V1` array to jnp.asarray, which
    JAX refuses, for its own files too; the JAX side here views the codes as
    float8_e4m3fn first."""
    rng = np.random.default_rng(1)
    jtree = _jax_tree(rng)
    grads = [_grads(rng, jtree) for _ in range(4)]
    jopt, update = _jax_update()
    jparams = jax.tree.map(jnp.asarray, jtree)
    jstate = jopt.init(jparams)
    for g in grads[:3]:
        jparams, jstate = update(jparams, jstate, jax.tree.map(jnp.asarray, g))
    jax_arrays = {"/".join(p): np.asarray(v) for p, v in _flatten_with_paths(jstate)}

    lora = _port_lora(jax.tree.map(np.asarray, jparams) if writer == "jax" else jtree)
    params = [leaf[k] for leaf in lora.values() for k in ("a", "b")]
    opt = AdamW8bit(params, lr=LR, weight_decay=WD, stacks=checkpoint.lora_stacks(lora))
    if writer == "jax":
        arrays = _npz(tmp_path / "jax.npz", jax_arrays)
        assert checkpoint.restore_optimizer_state(arrays, lora, opt) == 3
    else:
        for g in grads[:3]:
            _set_port_grads(lora, g)
            opt.step()
        arrays = _npz(tmp_path / "port.npz",
                      checkpoint.optimizer_state_arrays(lora, opt, 3, schedule_count=False))
        assert sorted(arrays) == sorted(jax_arrays)
        for key, want in jax_arrays.items():
            got = arrays[key]
            assert got.shape == want.shape and (got.dtype == np.dtype("V1")) == (
                want.dtype.name == "float8_e4m3fn"), key
        leaves = [jnp.asarray(arrays[k].view(jnp.float8_e4m3fn) if arrays[k].dtype.kind == "V"
                              else arrays[k]) for k, _ in
                  (("/".join(p), v) for p, v in _flatten_with_paths(jstate))]
        jstate = jax.tree.unflatten(jax.tree.structure(jstate), leaves)
    jparams, jstate = update(jparams, jstate, jax.tree.map(jnp.asarray, grads[3]))
    _set_port_grads(lora, grads[3])
    opt.step()
    _assert_state_matches(lora, opt, jstate, jparams, f"{writer}'s file, update 4")


def test_state_is_a_quarter_of_adamw():
    """The moments take one byte an element plus one f32 scale a block, a
    quarter of AdamW's two f32 moments and some."""
    p = [torch.zeros(3072, 16, requires_grad=True), torch.zeros(16, 3072, requires_grad=True)]
    for t in p:
        t.grad = torch.ones_like(t)
    opt = AdamW8bit(p)
    opt.step()
    n = sum(t.numel() for t in p)
    assert opt.state_bytes() == 2 * n + 2 * 4 * (n // 256)
