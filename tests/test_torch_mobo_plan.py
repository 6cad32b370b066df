"""The cluster plan of the MoBo sweeps H7 and H9 (`_cluster_plan` in
aligner_tpu_torch/ops/mobo_kernel.py), on the CPU: the kernels take the
blocks per item C and the positions per block w from it and never infer
them, so its invariants are the kernels' preconditions."""
import pytest

from aligner_tpu_torch.ops.mobo_kernel import (MAX_CLUSTER, MIN_SLICE, SMS,
                                               _cluster_plan)


@pytest.mark.parametrize("B", [1, 4, 16, 64, 256])
@pytest.mark.parametrize("D", [1, 4, 6, 32, 64])
@pytest.mark.parametrize("n", [2, 41, 131, 301, 1025, 1101, 4097])
def test_cluster_plan_keeps_its_invariants(n, D, B):
    """C within the portable cluster size; the slices cover the n
    positions and each block owns at least one; a block with neighbours
    owns at least max(D, 32) positions, so its halo comes from one
    neighbour; B*C within the card's SMs while B is; C does not grow with
    B."""
    C, w = _cluster_plan(B, n, D)
    assert 1 <= C <= MAX_CLUSTER
    assert w >= min(D, n)
    assert C * w >= n > (C - 1) * w
    if C > 1:
        assert w >= max(D, MIN_SLICE)
    if B <= SMS:
        assert B * C <= SMS
    assert C <= _cluster_plan(max(1, B // 2), n, D)[0]


@pytest.mark.parametrize("B,plan", [(16, (8, 129)), (64, (2, 513)),
                                    (256, (1, 1025))])
def test_cluster_plan_at_the_main_path_shape(B, plan):
    """T_mel 1024 (1025 positions), D = 32: 128 of the card's 132 SMs at
    the training batch and at B = 64; one block per item at the serving
    batch."""
    assert _cluster_plan(B, 1025, 32) == plan
