"""The benchmark's plain reference against the port's own plain versions
on the CPU, at a tiny size. The test imports the port; the reference
does not."""
import ast
import os

import numpy as np
import pytest
import torch

from harness import traffic
from reference import batching, dp, ota, viterbi

REF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "reference")
CFG = {"vocab_size": 12, "n_mels": 8, "dim": 8, "hidden": 12,
       "temperature": 0.15, "prior_omega": 1.0, "use_prior": True,
       "mas_implementation": "auto", "use_recon": True,
       "model_pauses": False, "pause_prior": "bridge", "pause_bias": 0.0,
       "pause_enter_cost": 0.0, "pause_silence_anchor": 0.0,
       "compute_dtype": "float32"}
MIX = {"utterances": 6, "sizes_seed": 1, "tokens": {"min": 3, "max": 7},
       "frames": {"per_token": {"min": 2, "max": 5}, "min": 8, "max": 30},
       "pauses": {"prob": 0.4, "min": 1, "max": 3}}


def test_reference_imports_nothing_of_the_program():
    for name in os.listdir(REF_DIR):
        if not name.endswith(".py"):
            continue
        with open(os.path.join(REF_DIR, name)) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            mods = ([a.name for a in node.names]
                    if isinstance(node, ast.Import) else
                    [node.module or ""] if isinstance(node, ast.ImportFrom)
                    and node.level == 0 else [])
            for m in mods:
                assert m.split(".")[0] not in (
                    "aligner_tpu_torch", "aligner_tpu", "jax", "jaxlib",
                    "flax"), (name, m)


def lattice(seed, B=4, T_y=20, T_x=6, skip=False):
    g = torch.Generator().manual_seed(seed)
    t_x = torch.randint(1, T_x + 1, (B,), generator=g)
    t_y = torch.maximum(torch.randint(T_y // 2, T_y + 1, (B,),
                                      generator=g), 2 * t_x + 1)
    T = 2 * T_x + 1 if skip else T_x
    lp = torch.log_softmax(torch.randn(B, T_y, T, generator=g) * 2, -1)
    n = 2 * t_x + 1 if skip else t_x
    live = torch.arange(T)[None, None, :] < n[:, None, None]
    return torch.where(live, lp, dp.NEG), t_x, t_y


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_forward_sum_and_gradient_match_the_port(seed, skip):
    from aligner_tpu_torch.ops.forward_sum import forward_sum_loss
    from aligner_tpu_torch.ops.skip_dp import forward_sum_skip_loss
    lp, t_x, t_y = lattice(seed, skip=skip)
    a = lp.clone().requires_grad_(True)
    b = lp.clone().requires_grad_(True)
    if skip:
        mine = dp.forward_sum_skip_nll(a, t_x, t_y, -0.7)
        theirs = forward_sum_skip_loss(b, t_x, t_y, -0.7)
    else:
        mine = dp.forward_sum_nll(a, t_x, t_y)
        theirs = forward_sum_loss(b, t_x, t_y)
    torch.testing.assert_close(mine, theirs, rtol=1e-5, atol=1e-5)
    mine.sum().backward()
    theirs.sum().backward()
    torch.testing.assert_close(a.grad, b.grad, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_best_path_scores_as_the_port_path(seed, skip):
    from aligner_tpu_torch.ops.mas import mas_path_frame_major
    from aligner_tpu_torch.ops.skip_dp import (mas_skip_path_frame_major,
                                               split_state_durations)
    lp, t_x, t_y = lattice(seed, skip=skip)
    best, d, p = viterbi.best_paths(lp.numpy(), t_x.numpy(), t_y.numpy(),
                                    skip, 0.3 if skip else 0.0)
    if skip:
        path = mas_skip_path_frame_major(lp, t_x, t_y, enter_cost=0.3)
        pd, pp = split_state_durations(path.sum(1).long())
    else:
        pd, pp = mas_path_frame_major(lp, t_x, t_y).sum(1).long(), None
    theirs = viterbi.path_score(lp.numpy(), t_x.numpy(), t_y.numpy(),
                                pd.numpy(), None if pp is None
                                else pp.numpy(), 0.3 if skip else 0.0)
    mine = viterbi.path_score(lp.numpy(), t_x.numpy(), t_y.numpy(), d, p,
                              0.3 if skip else 0.0)
    np.testing.assert_allclose(mine, best, rtol=0, atol=1e-9)
    np.testing.assert_allclose(theirs, best, rtol=1e-6, atol=1e-4)


def test_path_score_refuses_what_is_no_path():
    lp, t_x, t_y = lattice(0)
    _, d, _ = viterbi.best_paths(lp.numpy(), t_x.numpy(), t_y.numpy(),
                                 False)
    bad = d.copy()
    bad[0, 0] += 1                      # one frame too many
    assert np.isneginf(viterbi.path_score(lp.numpy(), t_x.numpy(),
                                          t_y.numpy(), bad)[0])


def test_prior_matches_the_port():
    from aligner_tpu_torch.ops.prior import beta_binomial_log_prior
    from aligner_tpu_torch.ops.skip_dp import expand_prior_to_states
    t_x = torch.tensor([1, 3, 6, 6])
    t_y = torch.tensor([5, 9, 20, 6])
    mine = ota.log_beta_binomial_prior(t_x, t_y, 6, 20)
    theirs = beta_binomial_log_prior(t_x, t_y, 6, 20)
    live = mine > -1e14
    assert torch.equal(live, theirs > -1e14)
    torch.testing.assert_close(mine[live], theirs[live], rtol=1e-5,
                               atol=2e-5)
    torch.testing.assert_close(ota.bridge_prior(mine, t_x),
                               expand_prior_to_states(theirs, t_x, "bridge"),
                               rtol=1e-5, atol=2e-5)


def port_model(cfg, params):
    from aligner_tpu_torch.models.ota import OTAAligner, OTAConfig
    m = OTAAligner(OTAConfig(**{k: v for k, v in cfg.items()}))
    with torch.no_grad():
        for k, p in m.named_parameters():
            p.copy_(params[k])
    return m


@pytest.mark.parametrize("pauses,dtype", [(False, "float32"),
                                          (True, "float32"),
                                          (True, "bfloat16")])
def test_forward_losses_and_gradient_match_the_port(pauses, dtype):
    cfg = dict(CFG, model_pauses=pauses, compute_dtype=dtype)
    items = traffic.make_corpus(MIX, 7, cfg["vocab_size"], cfg["n_mels"])
    b = {k: torch.as_tensor(v) for k, v in
         batching.batches(items, 6, None, (8,), (32,))[0].items()}
    params = ota.init_params(cfg, 3, "cpu")
    names = [n for n, _ in ota.param_shapes(cfg)]
    model = port_model(cfg, params)
    assert names == [n for n, _ in model.named_parameters()]
    for p in params.values():
        p.requires_grad_(True)
    loss, out = ota.train_loss(params, cfg, b, dtype)
    theirs = model(b["tokens"], b["mel"], b["text_lengths"],
                   b["mel_lengths"])
    tol = dict(rtol=1e-5, atol=1e-5) if dtype == "float32" else \
        dict(rtol=2e-2, atol=2e-2)
    # the port masks states past an item's inside its DPs
    live = out["logp_with_prior"] > -1e14
    torch.testing.assert_close(out["logp_with_prior"][live],
                               theirs["logp_with_prior"][live], **tol)
    torch.testing.assert_close(out["loss_forward_sum"],
                               theirs["loss_forward_sum"], **tol)
    torch.testing.assert_close(out["loss_recon"], theirs["loss_recon"],
                               **tol)
    torch.testing.assert_close(out["loss_bin"], theirs["loss_bin"], **tol)
    grads = torch.autograd.grad(loss, list(params.values()))
    (theirs["loss_forward_sum"] + theirs["loss_bin"]
     + theirs["loss_recon"]).backward()
    for (k, p), g in zip(model.named_parameters(), grads):
        torch.testing.assert_close(g, p.grad, **tol, msg=k)


def test_init_draws_as_the_port():
    from aligner_tpu_torch.models.ota import OTAAligner, OTAConfig
    cfg = dict(CFG, model_pauses=True)
    params = ota.init_params(cfg, 2**31 + 5, "cpu")
    m = OTAAligner(OTAConfig(**cfg),
                   generator=torch.Generator().manual_seed(2**31 + 5))
    for k, p in m.named_parameters():
        assert torch.equal(p.detach(), params[k]), k


def test_adamw_matches_torch():
    g = torch.Generator().manual_seed(0)
    w = {"a": torch.randn(5, 3, generator=g), "b": torch.randn(4,
                                                               generator=g)}
    ref = {k: v.clone() for k, v in w.items()}
    mods = {k: torch.nn.Parameter(v.clone()) for k, v in w.items()}
    opt = torch.optim.AdamW(mods.values(), lr=3e-4, betas=(0.9, 0.999),
                            eps=1e-8, weight_decay=1e-6)
    state = {}
    for _ in range(3):
        grads = {k: torch.randn(v.shape, generator=g) for k, v in w.items()}
        for k, p in mods.items():
            p.grad = grads[k].clone()
        opt.step()
        ota.adamw_step(ref, grads, state, 3e-4, 1e-6)
    for k in w:
        torch.testing.assert_close(ref[k], mods[k].detach(), rtol=1e-6,
                                   atol=1e-7)


def test_batching_matches_the_port():
    from aligner_tpu_torch.data.batching import BucketSpec, bucket_batches
    items = traffic.make_corpus(dict(MIX, utterances=23), 1, 12, 8)
    spec = BucketSpec((4, 8), (16, 24, 32))
    theirs = list(bucket_batches(items, 3, spec, shuffle_seed=2**31 + 3))
    mine = batching.batches(items, 3, 2**31 + 3, (4, 8), (16, 24, 32))
    assert len(mine) == len(theirs)
    for a, b in zip(mine, theirs):
        for k in a:
            assert np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("skip", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_float32_durations_are_the_port_paths_bit_for_bit(seed, skip):
    """Rounded lattices make ties; the tie rules have to agree too."""
    from aligner_tpu_torch.ops.mas_kernel import mas_plain
    from aligner_tpu_torch.ops.skip_dp_kernel import mas_skip_plain
    lp, t_x, t_y = lattice(seed, B=6, T_y=30, T_x=7, skip=skip)
    lp = torch.round(lp * (10 if seed % 2 else 1e5)) / (10 if seed % 2
                                                        else 1e5)
    d, p = viterbi.float32_durations(lp.numpy(), t_x.numpy(), t_y.numpy(),
                                     skip, 0.3 if skip else 0.0)
    value = lp.transpose(1, 2).contiguous()
    if skip:
        occ = mas_skip_plain(value, t_x, t_y, enter_cost=0.3).sum(2).long()
        assert np.array_equal(occ[:, 1::2].numpy(), d)
        assert np.array_equal(occ[:, 0::2].numpy(), p)
    else:
        occ = mas_plain(value, t_x, t_y).sum(2).long()
        assert np.array_equal(occ.numpy(), d) and p is None
