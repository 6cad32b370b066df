"""aligner_tpu_torch MoBoAligner and RoMoAligner against the JAX models on
the CPU (the kernels' plain versions): forwards from one flax init carried
across by `flax_to_state_dict`, train steps with the train command's
objectives against the JAX step, the loop with checkpoints, and
`demo-mobo` / `demo-romo`."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu import cli as jax_cli
from aligner_tpu.models import MoBoAligner as JaxMoBo
from aligner_tpu.models import MoBoConfig as JaxMoBoConfig
from aligner_tpu.models import RoMoAligner as JaxRoMo
from aligner_tpu.models import RoMoConfig as JaxRoMoConfig
from aligner_tpu.train import step as jax_step
from aligner_tpu_torch import (MoBoAligner, MoBoConfig, OTAConfig,
                               RoMoAligner, RoMoConfig, cli)
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.train import checkpoint, step
from aligner_tpu_torch.train.loop import train_aligner

VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 32, 48
B, T_X, T_Y, D, WINDOW = 4, 12, 40, 6, 8
FAMILIES = {
    "mobo": (JaxMoBo, JaxMoBoConfig, MoBoAligner, MoBoConfig,
             dict(max_duration=D)),
    "romo": (JaxRoMo, JaxRoMoConfig, RoMoAligner, RoMoConfig,
             dict(max_duration=D, window=WINDOW)),
}


def config_kw(family, use_recon=True):
    return dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                use_recon=use_recon, **FAMILIES[family][4])


def make_batch(seed):
    """Ragged and feasible under D (t_y <= t_x * D); item 0 fills the
    grid."""
    rng = np.random.default_rng(seed)
    text_lengths = rng.integers(T_X // 2 + 1, T_X + 1, B).astype(np.int32)
    text_lengths[0] = T_X
    mel_lengths = np.clip(rng.integers(T_Y // 2, T_Y + 1, B), text_lengths,
                          np.minimum(text_lengths * D, T_Y)).astype(np.int32)
    mel_lengths[0] = T_Y
    return {"tokens": rng.integers(0, VOCAB, (B, T_X)).astype(np.int32),
            "mel": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
            "text_lengths": text_lengths, "mel_lengths": mel_lengths}


ORDER = ("tokens", "mel", "text_lengths", "mel_lengths")


@pytest.fixture(scope="module", params=sorted(FAMILIES))
def converted(request):
    """(family, batch, JAX outputs, port outputs, JAX params)."""
    family = request.param
    jax_cls, jax_cfg, cls, cfg, _ = FAMILIES[family]
    jax_model = jax_cls(jax_cfg(**config_kw(family)))
    batch = make_batch(1)
    jbatch = [jnp.asarray(batch[k]) for k in ORDER]
    params = jax_model.init(jax.random.PRNGKey(0), *jbatch)["params"]
    jax_out = jax_model.apply({"params": params}, *jbatch)
    model = cls(cfg(**config_kw(family)))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model.config))
    with torch.no_grad():
        out = model(*[torch.from_numpy(batch[k]) for k in ORDER])
    return family, batch, jax_out, out, params


SOFT_KEYS = {
    "mobo": ("energies", "loss_mobo", "soft_alignment",
             "expected_durations", "loss_recon"),
    "romo": ("log_attn", "loss_rough", "loss_refine", "loss", "anchors",
             "rough_posteriors", "rough_durations", "soft_alignment",
             "expected_durations", "loss_recon"),
}


def test_soft_outputs_match_jax(converted):
    """rtol 1e-4 / atol 1e-5 (anchors atol 1e-4: a cumulative sum over up
    to 12 expected durations)."""
    family, _, jax_out, out, _ = converted
    assert set(out) == set(jax_out)
    for key in SOFT_KEYS[family]:
        want = np.asarray(jax_out[key])
        got = out[key].numpy()
        assert got.shape == want.shape, key
        np.testing.assert_allclose(
            got, want, rtol=1e-4, atol=1e-4 if key == "anchors" else 1e-5,
            err_msg=key)


def test_hard_outputs_equal_jax(converted):
    family, batch, jax_out, out, _ = converted
    if family == "romo":
        np.testing.assert_array_equal(out["refine_feasible"].numpy(),
                                      np.asarray(jax_out["refine_feasible"]))
        assert out["refine_feasible"].all()
    else:
        lb, want = (out["log_boundaries"].numpy(),
                    np.asarray(jax_out["log_boundaries"]))
        live = want > -1e14
        np.testing.assert_allclose(lb[live], want[live], rtol=1e-4,
                                   atol=1e-4)
    for key in ("hard_durations", "hard_path"):
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(jax_out[key]), err_msg=key)
    assert out["hard_durations"].dtype == torch.int32
    np.testing.assert_array_equal(out["hard_durations"].sum(1).numpy(),
                                  batch["mel_lengths"])


def test_compute_hard_false_drops_the_hard_outputs(converted):
    family, batch, _, out, params = converted
    cls, cfg = FAMILIES[family][2:4]
    model = cls(cfg(**config_kw(family)))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model.config))
    with torch.no_grad():
        soft = model(*[torch.from_numpy(batch[k]) for k in ORDER],
                     compute_hard=False)
    assert set(out) - set(soft) == {"hard_durations", "hard_path"}
    assert torch.equal(soft["soft_alignment"], out["soft_alignment"])


def test_convert_rejects_trees_of_another_configuration(converted):
    family, _, _, _, params = converted
    cfg = FAMILIES[family][3]
    flat = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(KeyError, match="unknown.*mel_decoder"):
        flax_to_state_dict(flat, cfg(**config_kw(family, use_recon=False)))
    with pytest.raises(KeyError, match="unknown.*pause_key"):
        flax_to_state_dict({**flat, "pause_key": np.zeros(DIM)},
                           cfg(**config_kw(family)))
    with pytest.raises(KeyError, match="missing.*pause_key"):
        flax_to_state_dict(flat, OTAConfig(
            vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
            use_recon=True, model_pauses=True))
    with pytest.raises(TypeError, match="MoBoConfig"):
        flax_to_state_dict(flat, dict(config_kw(family)))


def test_romo_gates_infeasible_items_out():
    """With a window too narrow for the random anchors no boundary
    sequence fits some items: they leave loss_refine and loss_recon, as in
    the JAX model, and every output stays finite."""
    kw = {**config_kw("romo"), "window": 0, "max_duration": 2}
    jax_model = JaxRoMo(JaxRoMoConfig(**kw))
    batch = make_batch(2)
    jbatch = [jnp.asarray(batch[k]) for k in ORDER]
    params = jax_model.init(jax.random.PRNGKey(1), *jbatch)["params"]
    want = jax_model.apply({"params": params}, *jbatch, compute_hard=False)
    model = RoMoAligner(RoMoConfig(**kw))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model.config))
    out = model(*[torch.from_numpy(batch[k]) for k in ORDER],
                compute_hard=False)
    feasible = np.asarray(want["refine_feasible"])
    assert not feasible.all()
    np.testing.assert_array_equal(out["refine_feasible"].numpy(), feasible)
    for key in ("loss_rough", "loss_refine", "loss", "loss_recon"):
        np.testing.assert_allclose(out[key].item(), float(want[key]),
                                   rtol=1e-4, atol=1e-6, err_msg=key)
    (out["loss_recon"] + 0.1 * out["loss"]).backward()
    assert all(torch.isfinite(p.grad).all() for p in model.parameters())


def mobo_objective(out, step_no):
    loss = out["loss_recon"] + 0.1 * out["loss_mobo"]
    return loss, {"loss_mobo": out["loss_mobo"],
                  "loss_recon": out["loss_recon"]}


def romo_objective(mean):
    def objective(out, step_no):
        loss = out["loss_recon"] + 0.1 * out["loss"]
        return loss, {"loss_rough": out["loss_rough"],
                      "loss_refine": out["loss_refine"],
                      "loss_recon": out["loss_recon"],
                      "refine_feasible": mean(out["refine_feasible"])}
    return objective


OBJECTIVES = {
    # (the JAX side's, the port's): the train command's objectives
    "mobo": (mobo_objective, mobo_objective),
    "romo": (romo_objective(lambda f: jnp.mean(f.astype(jnp.float32))),
             romo_objective(lambda f: f.float().mean())),
}


def no_hard_decode(step_no):
    return {"compute_hard": False}


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_steps_match_jax(family):
    """Three steps from one JAX init on the same batches with the train
    command's objective and compute_hard=False: metrics at rtol 1e-4 each
    step, parameters at atol 2e-5 after the last (an Adam step moves a
    parameter by about the learning rate, 1e-3, whatever its gradient's
    size, so float32 noise on a near-zero gradient is a sign-sized share
    of a step; 2e-5 is 2% of one)."""
    jax_cls, jax_cfg, cls, cfg, _ = FAMILIES[family]
    jax_objective, objective = OBJECTIVES[family]
    batches = [make_batch(s) for s in (3, 4, 5)]
    jax_model = jax_cls(jax_cfg(**config_kw(family)))
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    jstate = jax_step.create_train_state(jax.random.PRNGKey(0), jax_model,
                                         jb0, learning_rate=1e-3)
    model = cls(cfg(**config_kw(family)))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), model.config))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = step.create_train_state(model, learning_rate=1e-3)
    jstep = jax_step.make_train_step(jax_model, donate=False,
                                     objective=jax_objective,
                                     apply_extra=no_hard_decode)
    tstep = step.make_train_step(model, objective=objective,
                                 apply_extra=no_hard_decode)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = tstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        assert set(m) == set(jm)
        for key in m:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params),
                              model.config)
    got = model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=2e-5,
                                   rtol=0, err_msg=key)
    assert max(float((got[k] - init[k]).abs().max()) for k in got) > 1e-4


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_loop_trains_and_checkpoints(family, tmp_path):
    """train_aligner with the family's objective: finite metrics, a
    config.json that names the family, and a restore into a fresh model;
    a checkpoint of one configuration does not load into another."""
    cls, cfg = FAMILIES[family][2:4]
    ckpt = str(tmp_path / "ckpt")
    model = cls(cfg(**config_kw(family)))
    state, history = train_aligner(
        model, [make_batch(6), make_batch(7)], steps=3, device="cpu",
        learning_rate=1e-3, log_every=1, log_fn=lambda s: None,
        checkpoint_dir=ckpt, eval_batches=[make_batch(8)], eval_every=3,
        objective=OBJECTIVES[family][1], apply_extra=no_hard_decode)
    assert state.step == 3 and len(history) == 4
    assert all(np.isfinite(v) for r in history for v in r.values())
    assert "val_loss_recon" in history[-1]
    rec = checkpoint.load_run_config(ckpt)
    assert rec["model_class"] == {"mobo": "MoBo", "romo": "RoMo"}[family]
    assert rec["model_config"] == config_kw(family) | {
        k: v for k, v in rec["model_config"].items()
        if k not in config_kw(family)}
    fresh = cls(cfg(**rec["model_config"]),
                generator=torch.Generator().manual_seed(9))
    restored = checkpoint.restore_checkpoint(
        ckpt, step.create_train_state(fresh, learning_rate=1e-3))
    assert restored.step == 3
    for k, v in model.state_dict().items():
        assert torch.equal(v, fresh.state_dict()[k]), k
    with pytest.raises(RuntimeError, match="mel_decoder"):
        checkpoint.restore_params(ckpt, cls(cfg(
            **config_kw(family, use_recon=False))))


def test_seeded_init_is_reproducible_and_reset_redraws():
    cfg = MoBoConfig(**config_kw("mobo"))
    a = MoBoAligner(cfg, generator=torch.Generator().manual_seed(3))
    b = RoMoAligner(RoMoConfig(**config_kw("romo")),
                    generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
        assert name.endswith("bias") == (not p.any()), name
    before = a.mel_decoder.weight.clone()
    a.reset_parameters(torch.Generator().manual_seed(4))
    assert not torch.equal(a.mel_decoder.weight, before)


DEMO_KEYS = {"demo-mobo": {"demo", "duration_exact", "duration_mae",
                           "boundary_f1_tol2"},
             "demo-romo": {"demo", "refine_feasible", "rough", "refined"}}


@pytest.mark.parametrize("cmd", sorted(DEMO_KEYS))
def test_demo_prints_the_jax_demos_keys(capsys, cmd):
    argv = [cmd, "--steps", "5", "--batch-size", "4"]
    cli.main(argv + ["--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    jax_cli.main(argv)
    jax_lines = capsys.readouterr().out.strip().splitlines()
    want = json.loads(jax_lines[-1])
    assert set(rec) == set(want) == DEMO_KEYS[cmd]
    assert rec["demo"] == want["demo"] == cmd.removeprefix("demo-")
    # the 100-step log line of the JAX demo, at step 0
    assert lines[0].split()[:3] == jax_lines[0].split()[:3]
    stages = [rec] if cmd == "demo-mobo" else [rec["rough"], rec["refined"]]
    for stage, jax_stage in zip(stages, [want] if cmd == "demo-mobo"
                                else [want["rough"], want["refined"]]):
        assert set(stage) - {"demo"} == set(jax_stage) - {"demo"}
        assert 0.0 <= stage["boundary_f1_tol2"] <= 1.0


@pytest.mark.parametrize("cmd", sorted(DEMO_KEYS))
def test_demo_flags_match_the_jax_cli(cmd):
    argv = [cmd, "--steps", "7", "--max-duration", "6", "--hard", "--lr",
            "1e-3"] + (["--window", "5"] if cmd == "demo-romo" else [])
    want = vars(jax_cli.build_parser().parse_args(argv))
    got = vars(cli.build_parser().parse_args(argv))
    assert got.pop("device") == "cuda"
    assert got == want
    assert vars(cli.build_parser().parse_args([cmd]))["max_duration"] == 10


def test_demos_refuse_a_missing_gpu_and_a_short_window(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for cmd in sorted(DEMO_KEYS):
        with pytest.raises(SystemExit, match="no CUDA device"):
            cli.main([cmd, "--steps", "1"])
        with pytest.raises(SystemExit, match="max-duration must be >= 3"):
            cli.main([cmd, "--steps", "1", "--max-duration", "2",
                      "--device", "cpu"])
