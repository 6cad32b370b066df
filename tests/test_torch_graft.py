"""`aligner_tpu_torch.graft_entry`, the twin of `__graft_entry__.py`:
`entry(device="cpu")` from the JAX entry's converted params gives the JAX
forward's losses and durations on the same seeded batch; the dry run on
four gloo ranks completes with the JAX dry run's summary line; a rank that
fails makes `parallel.launch.spawn` raise."""
import numpy as np
import pytest
import torch

import jax

import __graft_entry__ as jax_graft
from aligner_tpu_torch import graft_entry
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.models.ota import OTAConfig
from aligner_tpu_torch import _parallel_checks as ranks
from aligner_tpu_torch.parallel.launch import spawn


def test_entry_matches_the_jax_entry():
    jfn, jargs = jax_graft.entry()
    fn, args = graft_entry.entry(device="cpu")
    for got, want in zip(args[1:], jargs[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    params = flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jargs[0]),
        OTAConfig(vocab_size=100, dim=96, hidden=128))
    assert params.keys() == args[0].keys()
    got = fn(params, *args[1:])
    want = jax.jit(jfn)(*jargs)
    for g, w in zip(got[:2], want[:2]):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_entry_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        graft_entry.entry()


def test_dryrun_multichip_completes(capsys):
    graft_entry.dryrun_multichip(4)
    line = capsys.readouterr().out.strip()
    assert line.startswith("dryrun_multichip ok: mesh={'data': 2, "
                           "'model': 2} loss=")
    assert line.endswith("seq-parallel MAS over 4 devices bit-identical "
                         "(gated + overlapped)")


def test_a_failed_rank_raises(tmp_path):
    """T_y = 5 over 2 ranks: every rank raises ValueError, and spawn
    reports it."""
    value = np.zeros((1, 2, 5), np.float32)
    lengths = np.full(1, 2, np.int32)
    with pytest.raises(RuntimeError, match="sequence_ranks failed"):
        spawn(ranks.sequence_ranks, 2,
              (str(tmp_path), [(value, lengths, lengths, None)],
               (value, value)), timeout=120.0)
