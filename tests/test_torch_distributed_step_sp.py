"""The port's LoRA train step on a mesh of ranks over gloo on the CPU: the
sp = 2 (ring attention), dp = 2 × grad_accum_steps = 2 (AttentionMaskMseLoss
on a right-padded batch) and fsdp = 2 over an int4-requant base (the int8
q4 sharded by FSDP2) cases of tests/test_torch_distributed_step.py, in a
spawn of their own, held to the same references with the same bounds."""

from __future__ import annotations

import pytest

from tests.test_torch_distributed_step import Ranks, check_case

MINE = ["sp2", "dp2_accum2_mask", "fsdp2_int4_requant"]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return Ranks(tmp_path_factory.mktemp("steps"), MINE)


@pytest.mark.parametrize("case", MINE)
def test_train_step_on_a_mesh_matches_one_process_and_jax(ranks, case):
    """The case's step on two ranks equals the port's one-process step and
    JAX's step on the same mesh (`check_case`): under sp = 2 the joint
    sequence (8 + 16 + 16 tokens) runs through the ring; under dp = 2 ×
    accum 2 each rank holds its row of each global microbatch, and the
    token loss divides by Σa over both ranks; under fsdp = 2 over the
    int4-requant base each rank holds half of each q4."""
    check_case(ranks, case)
