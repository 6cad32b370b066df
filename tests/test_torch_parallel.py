"""`aligner_tpu_torch.parallel` on CPU ranks (gloo) against the unsharded
port and the JAX package.

Two spawns of four ranks each, shared by the tests below (module
fixtures), each with its own deadline:

* a 2 x 2 ("data", "model") mesh takes 4 sharded train steps of the OTA
  aligner with its reconstruction, the pause-aware OTA with the silence
  anchor and clipping, MoBo and RoMo, on a ragged batch whose two data
  ranks hold different frame counts; each equals the unsharded port step
  from the same init (the OTA one also JAX's steps from the same flax
  init) at the JAX sharded test's rtol 2e-4 / atol 1e-5. Then
  `train_aligner(mesh=)` takes 2 steps with a checkpoint, which restores
  into an unsharded model;
* a (4, 1) mesh runs `mas_sequence_parallel` gated and pipelined,
  bit-identical to `mas_plain` and to JAX's on 4 virtual devices, its two
  errors, a batch the data axis does not divide, and per-rank
  `maximum_path` on batch slices, gathered.

The rank bodies are `aligner_tpu_torch._parallel_checks`: the ranks import
neither this module nor JAX.
"""
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import aligner_tpu.parallel as jax_parallel
from aligner_tpu.models import MoBoAligner as JaxMoBo
from aligner_tpu.models import MoBoConfig as JaxMoBoConfig
from aligner_tpu.models import OTAAligner as JaxOTA
from aligner_tpu.models import OTAConfig as JaxOTAConfig
from aligner_tpu.models import RoMoAligner as JaxRoMo
from aligner_tpu.models import RoMoConfig as JaxRoMoConfig
from aligner_tpu.train import step as jax_step
import aligner_tpu_torch.parallel as parallel
from aligner_tpu_torch import _parallel_checks as ranks
from aligner_tpu_torch.models.convert import _expected_keys, flax_to_state_dict
from aligner_tpu_torch.ops.mas import maximum_path
from aligner_tpu_torch.ops.mas_kernel import mas_plain
from aligner_tpu_torch.parallel import mesh as port_mesh
from aligner_tpu_torch.parallel.launch import spawn
from aligner_tpu_torch.train import checkpoint
from aligner_tpu_torch.train.loop import train_aligner
from aligner_tpu_torch.train.step import (clip_by_global_norm_,
                                          create_train_state,
                                          make_train_step)
from aligner_tpu_torch.utils.masks import lattice_mask

SPAWN_SECONDS = 120.0
RTOL, ATOL = 2e-4, 1e-5              # tests/test_ota_train.py's sharded test
VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 16, 16
B, T_X, T_Y = 4, 12, 40
LR, CLIP = 1e-3, 0.02


def make_batch(seed):
    """A ragged batch of B = 4: the data ranks' halves (items 0-1 and 2-3)
    hold different frame counts."""
    rng = np.random.default_rng(seed)
    tl = rng.integers(T_X // 2, T_X + 1, B).astype(np.int32)
    tl[0] = T_X
    ml = np.maximum(tl, rng.integers(T_Y // 2, T_Y + 1, B)).astype(np.int32)
    ml[0] = T_Y
    return {"tokens": rng.integers(0, VOCAB, (B, T_X)).astype(np.int32),
            "mel": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
            "text_lengths": tl, "mel_lengths": ml}


BASE = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
            use_recon=True)
# name -> (family, config, grad_clip_norm)
CASES = {
    "ota": ("ota", BASE, None),
    "pause": ("ota", dict(BASE, model_pauses=True, pause_silence_anchor=0.5,
                          pause_enter_cost=-0.3), CLIP),
    "mobo": ("mobo", dict(BASE, max_duration=8), None),
    "romo": ("romo", dict(BASE, window=8, max_duration=8), None),
}
STEPS = 4


def jax_ota():
    """The JAX OTA model and train state at BASE from PRNGKey(0)."""
    model = JaxOTA(JaxOTAConfig(**BASE))
    jb = {k: jnp.asarray(v) for k, v in make_batch(1).items()}
    return model, jax_step.create_train_state(jax.random.PRNGKey(0), model,
                                              jb, learning_rate=LR)


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def unsharded(name, init, batch):
    """The unsharded port's STEPS steps of case `name` on `batch`: the
    metrics of each and the model after the last."""
    family, config, clip = CASES[name]
    model, objective, apply_extra = ranks.build(family, config)
    model.load_state_dict(init)
    state = create_train_state(model, learning_rate=LR, grad_clip_norm=clip)
    step = make_train_step(model, bin_start=-1, bin_ramp=1,
                           objective=objective, apply_extra=apply_extra)
    metrics = []
    for _ in range(STEPS):
        state, m = step(state, torch_batch(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, model


def unsharded_checkpoint(out):
    """An unsharded OTA run's checkpoint after one step on batch 7; its
    directory."""
    model, _, _ = ranks.build("ota", BASE)
    state = create_train_state(model, learning_rate=LR)
    make_train_step(model)(state, torch_batch(make_batch(7)))
    path = os.path.join(out, "unsharded")
    checkpoint.save_checkpoint(path, state)
    return path


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Spawn 1: the sharded steps of every case and the sharded loop."""
    out = str(tmp_path_factory.mktemp("train"))
    batch = make_batch(1)
    _, jstate = jax_ota()
    inits = {"ota": flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params),
        ranks.build("ota", BASE)[0].config)}
    for name in ("pause", "mobo", "romo"):
        family, config, _ = CASES[name]
        inits[name] = ranks.build(family, config)[0].state_dict()
    cases = [dict(name=name, family=family, config=config, init=inits[name],
                  batches=[batch] * STEPS, lr=LR, clip=clip, bin_start=-1,
                  bin_ramp=1)
             for name, (family, config, clip) in CASES.items()]
    loop = dict(family="ota", config=BASE, steps=2, lr=LR, seed=3,
                batches=[make_batch(5), make_batch(6)],
                unsharded_checkpoint=unsharded_checkpoint(out))
    spawn(ranks.train_ranks, 4, (out, 2, 2, cases, loop),
          timeout=SPAWN_SECONDS)
    results = torch.load(os.path.join(out, "train.pt"), weights_only=False)
    return results, inits, batch, loop, out


def test_parallel_exports_the_jax_names():
    assert parallel.__all__ == jax_parallel.__all__


def test_ragged_batch_splits_unevenly():
    ml = make_batch(1)["mel_lengths"]
    assert ml[:2].sum() != ml[2:].sum()


# The JAX model families at the port's config, for the sharding rule.
JAX_FAMILIES = {"ota": (JaxOTA, JaxOTAConfig), "mobo": (JaxMoBo,
                                                        JaxMoBoConfig),
                "romo": (JaxRoMo, JaxRoMoConfig)}
# n_mels and dim odd: the mel decoder and both last convs do not divide by
# a model axis of 2 and stay replicated, as in the JAX rule.
RULE_CONFIGS = {
    "ota-pauses": ("ota", dict(vocab_size=20, n_mels=15, dim=15, hidden=16,
                               use_recon=True, model_pauses=True)),
    "mobo": ("mobo", dict(vocab_size=20, n_mels=15, dim=15, hidden=16,
                          use_recon=True)),
    "romo": ("romo", dict(vocab_size=20, n_mels=15, dim=15, hidden=16,
                          use_recon=True)),
}


@pytest.mark.parametrize("case", sorted(RULE_CONFIGS))
def test_param_spec_and_shard_params_follow_the_jax_rule(case):
    """The dim `sharded_dims` splits at a model axis of 2 (param_spec plus
    the divisibility fallback) is, through the converted flax tree, the
    axis JAX's shard_params puts on "model" on a 4 x 2 mesh."""
    family, config = RULE_CONFIGS[case]
    jax_cls, jax_config_cls = JAX_FAMILIES[family]
    jmodel = jax_cls(jax_config_cls(**config))
    rng = np.random.default_rng(0)
    B_, T_x, T_y = 2, 6, 64
    # the param tree's shapes, traced without compiling the model
    params = jax.eval_shape(
        jmodel.init, jax.random.PRNGKey(0),
        jnp.asarray(rng.integers(1, 20, (B_, T_x))),
        jnp.asarray(rng.standard_normal((B_, T_y, config["n_mels"])),
                    jnp.float32),
        jnp.full((B_,), T_x), jnp.full((B_,), T_y))["params"]
    mesh = jax_parallel.make_mesh(n_data=4, n_model=2)
    flat = jax.tree_util.tree_flatten_with_path(
        jax_parallel.shard_params(params, mesh))[0]
    model = ranks.build(family, config)[0]
    keys = _expected_keys(model.config)
    want = {}
    for path, sharding in flat:
        flax_path = "/".join(str(getattr(k, "key", k)) for k in path)
        spec = list(sharding.spec) + [None] * 4
        axis = spec.index("model") if "model" in spec else None
        leaf = params
        for part in flax_path.split("/"):
            leaf = leaf[part]
        if axis is not None and flax_path.endswith("kernel"):
            axis = len(leaf.shape) - 1 - axis    # [.., out] -> [out, ..]
        want[keys[flax_path]] = axis
    got = port_mesh.sharded_dims(model, 2)
    assert got == want
    assert any(d is not None for d in got.values())
    assert any(d is None and name.endswith("weight")
               for name, d in got.items())
    for name, p in model.named_parameters():
        spec = parallel.param_spec(name, p)
        assert got[name] in (spec, None)


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_steps_match_the_unsharded_port(trained, name):
    results, inits, batch, _, _ = trained
    got = results[name]
    want, model = unsharded(name, inits[name], batch)
    assert got["sharded"], "no parameter was split over the model axis"
    for i, (g, w) in enumerate(zip(got["metrics"], want)):
        assert g.keys() == w.keys()
        for key in w:
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL, atol=ATOL,
                                       err_msg=f"{name} step {i} {key}")
    losses = [m["loss"] for m in got["metrics"]]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    for key, w in model.state_dict().items():
        torch.testing.assert_close(got["params"][key], w, rtol=RTOL,
                                   atol=ATOL, msg=f"{name} {key}")


def test_pause_case_clips():
    """The pause case's first gradient is above CLIP, so its steps run the
    sharded global norm."""
    family, config, clip = CASES["pause"]
    model, _, _ = ranks.build(family, config)
    out = model(*torch_batch(make_batch(1)).values())
    (out["loss_forward_sum"] + out["loss_bin"] + out["loss_recon"]).backward()
    grads = [p.grad for p in model.parameters()]
    norm = float(torch.sqrt(sum(torch.sum(g * g) for g in grads)))
    assert norm > clip
    clip_by_global_norm_(grads, clip)
    assert float(torch.sqrt(sum(torch.sum(g * g) for g in grads))) == \
        pytest.approx(clip, rel=1e-5)


def test_sharded_ota_matches_the_jax_steps(trained):
    results, _, batch, _, _ = trained
    model, jstate = jax_ota()
    jstep = jax_step.make_train_step(model, bin_start=-1, bin_ramp=1,
                                     donate=False)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for i in range(STEPS):
        jstate, jm = jstep(jstate, jb)
        for key, value in jm.items():
            np.testing.assert_allclose(results["ota"]["metrics"][i][key],
                                       float(value), rtol=RTOL, atol=ATOL,
                                       err_msg=f"step {i} {key}")


def test_sharded_loop_checkpoint_restores_unsharded(trained):
    results, _, _, loop, out = trained
    got = results["loop"]
    assert got["step"] == loop["steps"]
    model, objective, apply_extra = ranks.build(loop["family"],
                                                loop["config"])
    _, history = train_aligner(model, loop["batches"], steps=loop["steps"],
                               device="cpu", learning_rate=loop["lr"],
                               log_every=1, seed=loop["seed"],
                               log_fn=lambda line: None)
    assert len(got["history"]) == len(history) == loop["steps"]
    for g, w in zip(got["history"], history):
        for key in ("loss", "loss_forward_sum", "loss_bin",
                    "mean_max_attn"):
            np.testing.assert_allclose(g[key], w[key], rtol=RTOL,
                                       atol=ATOL)
    ckpt = os.path.join(out, "ckpt")
    assert checkpoint.latest_step(ckpt) == loop["steps"]
    restored = checkpoint.restore_params(
        ckpt, ranks.build(loop["family"], loop["config"])[0])
    for key, value in restored.state_dict().items():
        assert torch.equal(value, got["params"][key]), key
    # the whole train state too: an unsharded step from it runs
    state = create_train_state(restored, learning_rate=loop["lr"])
    state = checkpoint.restore_checkpoint(ckpt, state)
    assert state.step == loop["steps"]
    _, m = make_train_step(restored)(state, torch_batch(loop["batches"][0]))
    assert np.isfinite(float(m["loss"]))


def test_unsharded_checkpoint_restores_sharded(trained):
    """The other way round: the sharded step from an unsharded run's
    checkpoint equals the unsharded step from it."""
    results, _, _, loop, _ = trained
    model, _, _ = ranks.build(loop["family"], loop["config"])
    state = checkpoint.restore_checkpoint(
        loop["unsharded_checkpoint"],
        create_train_state(model, learning_rate=loop["lr"]))
    _, m = make_train_step(model)(state, torch_batch(loop["batches"][0]))
    got = results["restored"]
    np.testing.assert_allclose(got["loss"], float(m["loss"]), rtol=RTOL,
                               atol=ATOL)
    for key, value in model.state_dict().items():
        torch.testing.assert_close(got["params"][key], value, rtol=RTOL,
                                   atol=ATOL, msg=key)


def lattice(seed, B_, T_x, T_y):
    rng = np.random.default_rng(seed)
    value = (rng.standard_normal((B_, T_x, T_y)) * 3).astype(np.float32)
    t_x = rng.integers(1, T_x + 1, B_).astype(np.int32)
    t_y = np.maximum(t_x, rng.integers(1, T_y + 1, B_)).astype(np.int32)
    return value, t_x, t_y


# (seed, B, T_x, T_y, microbatch): tests/test_sharded_mas.py's lattices
SP_CASES = [(5, 4, 24, 64, None), (5, 4, 24, 64, 2), (5, 4, 24, 64, 4),
            (13, 8, 16, 64, 2), (15, 8, 16, 64, 4), (11, 8, 16, 64, None)]


@pytest.fixture(scope="module")
def sequenced(tmp_path_factory):
    """Spawn 2: sequence-parallel MAS, its errors and batch-sharded
    maximum_path on a (4, 1) mesh; every rank's results."""
    out = str(tmp_path_factory.mktemp("sequence"))
    cases = [(*lattice(seed, B_, T_x, T_y), m)
             for seed, B_, T_x, T_y, m in SP_CASES]
    value, t_x, t_y = lattice(0, 16, 24, 48)
    mask = lattice_mask(torch.from_numpy(t_x), torch.from_numpy(t_y), 24,
                        48).numpy()
    spawn(ranks.sequence_ranks, 4, (out, cases, (value, mask)),
          timeout=SPAWN_SECONDS)
    return cases, (value, mask), [
        torch.load(os.path.join(out, f"sp{r}.pt")) for r in range(4)]


@pytest.mark.parametrize("i", range(len(SP_CASES)),
                         ids=[f"seed{c[0]}-B{c[1]}-M{c[4]}"
                              for c in SP_CASES])
def test_sequence_parallel_is_bit_identical(sequenced, i):
    cases, _, per_rank = sequenced
    value, t_x, t_y, microbatch = cases[i]
    want = mas_plain(torch.from_numpy(value), torch.from_numpy(t_x),
                     torch.from_numpy(t_y))
    jax_mesh = jax_parallel.make_mesh(n_data=4, n_model=1,
                                      devices=jax.devices()[:4])
    jax_sp = np.asarray(jax_parallel.mas_sequence_parallel(
        jnp.asarray(value), jnp.asarray(t_x), jnp.asarray(t_y), jax_mesh,
        microbatch=microbatch))
    for rank, res in enumerate(per_rank):
        got = res["paths"][i]
        assert got.dtype == torch.float32
        assert torch.equal(got, want), f"rank {rank}"
        np.testing.assert_array_equal(got.numpy(), jax_sp)


def test_sequence_parallel_errors_raise_before_any_message(sequenced):
    """Both errors raise on every rank, which then all reach a barrier:
    none waited on a message from a rank that raised."""
    for res in sequenced[2]:
        divisible, microbatch = res["errors"][:2]
        assert "divisible" in divisible and "T_y=17" in divisible
        assert "microbatch" in microbatch


def test_mesh_and_batch_errors_raise(sequenced):
    """A batch the data axis does not divide, a CUDA mesh over a gloo
    group and a mesh of fewer ranks than the group (JAX takes the first
    devices; see ROADMAP, deliberate differences) raise on every rank."""
    for res in sequenced[2]:
        assert "not divisible by the data axis" in res["errors"][2]
        assert "needs the nccl backend" in res["errors"][3]
        assert "spans every rank" in res["errors"][4]


def test_unused_parameter_decays_as_optax_and_the_sharded_step_refuses_it(
        trained):
    """An objective that leaves the reconstruction decoder out: the port's
    unsharded step gives it a zero gradient, as optax's adamw does, so two
    steps from the same converted parameters match JAX's on every
    parameter (the train step's atol 1e-5) and the decoder shrinks by
    (1 - lr*wd) a step. The sharded step raises ValueError naming it
    before any update (ROADMAP, deliberate differences)."""
    assert "mel_decoder.weight" in trained[0]["unused"]
    lr, wd, steps = LR, 0.1, 2
    model = JaxOTA(JaxOTAConfig(**BASE))
    objective = lambda out, _: (out["loss_forward_sum"], {})  # noqa: E731
    jb = {k: jnp.asarray(v) for k, v in make_batch(1).items()}
    jstate = jax_step.create_train_state(jax.random.PRNGKey(0), model, jb,
                                         learning_rate=lr, weight_decay=wd)
    port, _, _ = ranks.build("ota", BASE)
    port.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), port.config))
    decoder = port.mel_decoder.weight.detach().clone()
    jstep = jax_step.make_train_step(model, objective=objective,
                                     donate=False)
    state = create_train_state(port, learning_rate=lr, weight_decay=wd)
    step = make_train_step(port, objective=objective)
    for _ in range(steps):
        jstate, _ = jstep(jstate, jb)
        step(state, torch_batch(make_batch(1)))
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params),
                              port.config)
    got = port.state_dict()
    assert got.keys() == want.keys()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
    assert not torch.equal(port.mel_decoder.weight, decoder)
    torch.testing.assert_close(port.mel_decoder.weight,
                               decoder * (1 - lr * wd) ** steps,
                               rtol=2 ** -22, atol=0)


def test_a_step_refuses_a_state_of_another_mesh(trained):
    """An unsharded state under a sharded step (each data rank would apply
    its own gradient) and a sharded state under an unsharded step (each
    would run the whole batch) raise, in the train and the eval step."""
    errors = trained[0]["mesh_mismatch"]
    assert len(errors) == 4
    for e in errors:
        assert "built for another mesh" in e


def test_batch_sharded_maximum_path_matches_single_process(sequenced):
    _, (value, mask), per_rank = sequenced
    want = maximum_path(torch.from_numpy(value), torch.from_numpy(mask))
    for res in per_rank:
        assert torch.equal(res["batch_sharded"], want)


def test_meshes_need_an_initialised_group_and_nccl(monkeypatch, tmp_path):
    with pytest.raises(RuntimeError, match="initialised process group"):
        parallel.make_mesh(1, 1, device_type="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_mesh.init_process_group(str(tmp_path / "store"), 0, 1, "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.distributed, "is_nccl_available",
                        lambda: False)
    with pytest.raises(RuntimeError, match="no NCCL"):
        port_mesh.init_process_group(str(tmp_path / "store"), 0, 1, "cuda")
