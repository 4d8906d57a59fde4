"""The port's distribution across processes, over gloo on the CPU.

Each case spawns 2 or 4 ranks of tests/torch_dist_worker.py (torch and the
port only), joined by a file rendezvous in tmp_path, each with a timeout;
the JAX references are computed here, on the conftest's 8-device CPU mesh,
from the same numpy inputs.  JAX's `build_mesh` sets a process-wide active
mesh, so every case that builds one restores an sp = 1 mesh afterwards, as
JAX's `test_train_step_sp2_matches_sp1` does.

  1. the host collectives (JAX's two-process worker,
     tests/parallel/test_multiprocess.py);
  2. ring attention at sp = 2 and 4 against JAX's `ring_attention_sharded`
     and the port's `sdpa_reference` (atol 2e-5, JAX's own test's);
  3. the LoRA train step on a mesh: tests/test_torch_distributed_step.py
     and tests/test_torch_distributed_step_sp.py;
  4. a two-process `Trainer.fit` with validation (JAX's `FIT_WORKER`) and
  5. the CLI under --distributed --device cpu with torchrun's variables:
     tests/test_torch_distributed_fit.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from qflux_tpu.ops.ring_attention import ring_attention_sharded as j_ring
from qflux_tpu.parallel import MeshConfig as JMeshConfig, build_mesh as j_build_mesh
from qflux_tpu_torch.ops.attention import sdpa_reference

REPO = Path(__file__).parents[1]
WORKER = REPO / "tests" / "torch_dist_worker.py"
TIMEOUT = 240


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def _start(case: str, world: int, root: Path) -> list:
    """Start `case` on `world` ranks of the worker; `_finish` waits."""
    return [subprocess.Popen([sys.executable, str(WORKER), case, str(r), str(world),
                              str(root)], env=_env(), stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for r in range(world)]


def _spawn(case: str, world: int, root: Path) -> None:
    """Run `case` on `world` ranks of the worker; every rank must exit 0."""
    _finish(_start(case, world, root))


def _finish(procs: list) -> None:
    """Wait for the ranks (each within TIMEOUT); every rank must exit 0."""
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-6000:]}"


def _restore_jax_mesh():
    j_build_mesh(JMeshConfig(dp=1, fsdp=1))


# ---------------------------------------------------------------------------
# 1. the host collectives

def test_collectives_across_two_ranks(tmp_path):
    """JAX's two-process worker: the round-robin shard differs per rank,
    the validation-image gather gives both ranks the union in index order
    (also where one rank holds more than ceil(n / world) and another none),
    broadcast, mean, all-gather and the shared decision; a mesh smaller
    than the world raises (each rank would sit idle), and the default mesh
    puts both ranks on fsdp."""
    _spawn("collectives", 2, tmp_path)
    for rank in range(2):
        out = json.loads((tmp_path / f"collectives-{rank}.json").read_text())
        assert out["main"] == (rank == 0) and out["count"] == 2
        assert out["mine"] == [i for i in range(5) if i % 2 == rank]
        assert out["gather_idx"] == [0, 1] and out["gather_px"] == [10, 20]
        assert out["gather_uneven"] == [[0, 2, 4], [0, 2, 4]]
        assert out["broadcast"] == [0, 1, 2]
        assert out["mean"] == 1.5
        assert out["allgather"] == [[0, 0], [1, 1]]
        assert out["any"] == [True, False]
        assert "must cover the world" in out["small_mesh"]
        assert out["mesh"] == [{"dp": 1, "fsdp": 2, "tp": 1, "sp": 1},
                               {"dp": 0, "fsdp": rank, "tp": 0, "sp": 0}, rank, 2]


# ---------------------------------------------------------------------------
# 2. ring attention

B, S, H, D = 2, 128, 2, 16


def _ring_inputs():
    rng = np.random.default_rng(11)
    f = np.float32
    inp = {x: rng.standard_normal((B, S, H, D)).astype(f) for x in ("q", "k", "v", "dout")}
    seg = np.ones((B, S), np.int32)
    seg[1, 100:] = 0          # padding rows
    seg[0, 64:] = 2           # a second segment
    inp["seg_padded"] = seg
    return inp


def _jax_ring(inp, sp, seg):
    mesh = j_build_mesh(JMeshConfig(dp=1, fsdp=1, sp=sp))
    try:
        def f(q, k, v):
            return j_ring(q, k, v, mesh, "sp", segment_ids=None if seg is None
                          else jnp.asarray(seg))

        out, vjp = jax.vjp(f, *(jnp.asarray(inp[x]) for x in ("q", "k", "v")))
        grads = vjp(jnp.asarray(inp["dout"]))
        return [np.asarray(x) for x in (out, *grads)]
    finally:
        _restore_jax_mesh()


def _sdpa(inp, seg):
    q, k, v = (torch.from_numpy(inp[x]).requires_grad_() for x in ("q", "k", "v"))
    out = sdpa_reference(q, k, v, segment_ids=None if seg is None else torch.from_numpy(seg))
    out.backward(torch.from_numpy(inp["dout"]))
    return [t.detach().numpy() for t in (out, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_attention_matches_jax_and_sdpa(tmp_path, sp):
    """`ring_attention_sharded` over sp ranks (S = 128, H = 2, D = 16, f32,
    unmasked and with padding and two segments): out and the q / k / v
    gradients equal JAX's `ring_attention_sharded` on an sp mesh and the
    port's unsharded `sdpa_reference` within 2e-5, the same on every rank;
    the attention dispatch takes the ring under the active sp mesh; the CPU
    hops launch no kernel."""
    inp = _ring_inputs()
    np.savez(tmp_path / "inputs.npz", **inp)
    procs = _start("ring", sp, tmp_path)
    refs = {name: (_jax_ring(inp, sp, inp.get(f"seg_{name}")), _sdpa(inp, inp.get(f"seg_{name}")))
            for name in ("plain", "padded")}  # while the ranks run
    _finish(procs)
    outs = [dict(np.load(tmp_path / f"ring-{r}.npz")) for r in range(sp)]
    for name in ("plain", "padded"):
        got = [outs[0][f"{name}_{x}"] for x in ("out", "dq", "dk", "dv")]
        for ref in refs[name]:
            for g, w in zip(got, ref):
                np.testing.assert_allclose(g, w, atol=2e-5, rtol=0)
        for o in outs[1:]:
            for x in ("out", "dq", "dk", "dv"):
                np.testing.assert_array_equal(o[f"{name}_{x}"], outs[0][f"{name}_{x}"])
        for o in outs:
            np.testing.assert_array_equal(o[f"{name}_dispatch"], o[f"{name}_out"])
            assert int(o[f"{name}_cuda_launches"]) == 0
