"""The port's conformance sweeps (`aligner_tpu_torch.conformance` and
`conformance_losses`) on the CPU: a reduced grid through `main` with
`--device cpu` (where the wrappers run their kernels' plain versions), the
stop at the first failure, the refusal of a missing card, and the full
grids' reach: every plan of MAS_PLANS (and H1's wide kernel), WALK_PLANS,
SKIP_VITERBI_PLANS and SWEEP_PLANS, computed from the plan functions
without running a kernel. The oracle is held against the JAX package's."""
import numpy as np
import pytest
import torch

from aligner_tpu.ops.mas_reference import maximum_path_numpy
from aligner_tpu_torch import conformance, conformance_losses
from aligner_tpu_torch.ops import forward_sum_kernel as fk
from aligner_tpu_torch.ops import mas_kernel as mk
from aligner_tpu_torch.ops import skip_dp_kernel as sk

MAX_CELLS = 300_000


@pytest.mark.parametrize("module", [conformance, conformance_losses],
                         ids=["mas", "losses"])
def test_reduced_grid_passes_on_the_cpu(module, capsys):
    assert module.main(["--device", "cpu", "--seeds", "1", "--max-cells",
                        str(MAX_CELLS)]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    ok = [line for line in lines if line.startswith("OK  ")]
    assert len(ok) >= 15
    assert not [line for line in lines if line.startswith("FAIL")]
    assert lines[-1].startswith("all ") and "on cpu" in lines[-1]
    assert str(len(ok)) in lines[-1].split()


def test_mas_oracle_matches_the_jax_packages():
    value, t_x, t_y = conformance.make_case(0, 8, 40, 200, "ties")
    mask = ((np.arange(40)[None, :, None] < t_x[:, None, None])
            & (np.arange(200)[None, None, :] < t_y[:, None, None]))
    np.testing.assert_array_equal(
        conformance.oracle(value, t_x, t_y),
        maximum_path_numpy(value, mask.astype(np.float32)))


@pytest.mark.parametrize("module,target", [
    (conformance, "mas_single"), (conformance_losses, "mas_skip_single")],
    ids=["mas", "losses"])
def test_a_failure_stops_the_run(module, target, monkeypatch, capsys):
    def wrong(value, *args, **kwargs):
        return np.zeros(value.shape, np.int32)

    monkeypatch.setattr(module, target, wrong)
    assert module.main(["--device", "cpu", "--seeds", "2", "--max-cells",
                        str(MAX_CELLS)]) == 1
    lines = capsys.readouterr().out.strip().splitlines()
    assert [line.startswith("FAIL ") for line in lines].count(True) == 1
    assert lines[-2].startswith("FAIL ") and lines[-1].startswith("FAILED")


@pytest.mark.parametrize("module", [conformance, conformance_losses],
                         ids=["mas", "losses"])
def test_no_card_runs_nothing(module, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert module.main([]) == 1
    assert capsys.readouterr().out == ""


def test_mas_grid_reaches_every_plan():
    h1, walks = set(), set()
    for B, T_x, T_y, _, _ in conformance.MAS_CASES:
        for contiguous in (True, False):
            h1.add(mk._mas_plan(T_x, T_y, contiguous)[1:5])
            for name in (*conformance.ROUTES, *conformance.BIT_WALKS):
                if not conformance.route_skip(name, B, T_x, T_y, contiguous):
                    walks.update(conformance.walk_plans(name, T_x, T_y))
    assert set(mk.MAS_PLANS) <= h1
    assert any(plan[3] == "wide" for plan in h1)
    assert set(mk.WALK_PLANS) <= walks


def test_loss_grids_reach_every_plan():
    viterbi = {sk._skip_viterbi_plan(2 * T_x + 1, T_y, contiguous)[1:5]
               for _, T_x, T_y, *_ in conformance_losses.SKIP_VITERBI
               for contiguous in (True, False)}
    assert set(sk.SKIP_VITERBI_PLANS) <= viterbi
    fs = {fk._sweep_plan(T_x)[1:3]
          for _, T_x, *_ in conformance_losses.FORWARD_SUM}
    skip_fs = {fk._sweep_plan(2 * T_x + 1)[1:3]
               for _, T_x, *_ in conformance_losses.SKIP_FORWARD_SUM}
    assert set(fk.SWEEP_PLANS) <= fs and set(fk.SWEEP_PLANS) <= skip_fs
    # t_x > 63 reaches the oracle's int8 promotion
    assert any(T_x > 63 and mode != "short" for _, T_x, _, mode, *_
               in conformance_losses.SKIP_VITERBI)
