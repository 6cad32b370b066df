"""aligner_tpu_torch training path against the JAX package (CPU route, the
kernels' plain versions): train steps from one JAX init, the LR schedule,
the loop (resume, seed, validation, config.json) and `demo-ota`."""
import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.models import OTAAligner as JaxOTA
from aligner_tpu.models import OTAConfig as JaxConfig
from aligner_tpu.train import checkpoint as jax_ckpt
from aligner_tpu.train import step as jax_step
from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch import cli
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.train import checkpoint, step
from aligner_tpu_torch.train.loop import train_aligner

VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 16, 16
B, T_X, T_Y = 4, 12, 40
METRICS = ("loss", "loss_forward_sum", "loss_bin", "bin_weight",
           "mean_max_attn")


def make_batch(seed):
    rng = np.random.default_rng(seed)
    text_lengths = rng.integers(T_X // 2, T_X + 1, B).astype(np.int32)
    text_lengths[0] = T_X
    mel_lengths = np.maximum(text_lengths,
                             rng.integers(T_Y // 2, T_Y + 1, B)).astype(
                                 np.int32)
    mel_lengths[0] = T_Y
    return {"tokens": rng.integers(0, VOCAB, (B, T_X)).astype(np.int32),
            "mel": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
            "text_lengths": text_lengths, "mel_lengths": mel_lengths}


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def config_kw(use_recon):
    return dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                use_recon=use_recon)


STEP_CASES = {
    # use_recon, learning rate, schedule kwargs, grad_clip_norm, bin_start
    "constant": (True, 1e-3, None, None, 0),
    # the global gradient norm here is about 0.06, so 0.02 clips
    "cosine_clip": (False, 1e-3, dict(warmup_steps=2, decay_steps=6,
                                      schedule="cosine"), 0.02, 1),
}


@pytest.mark.parametrize("case", sorted(STEP_CASES))
def test_train_steps_match_jax(case):
    """Three steps from one JAX init on the same batches: metrics at
    rtol 1e-4 each step, parameters at atol 1e-5 after the last."""
    use_recon, lr, sched_kw, clip, bin_start = STEP_CASES[case]
    batches = [make_batch(s) for s in (1, 2, 3)]
    jax_model = JaxOTA(JaxConfig(**config_kw(use_recon)))
    jb0 = {k: jnp.asarray(v) for k, v in batches[0].items()}
    if sched_kw is None:
        jax_lr, lr_arg = lr, lr
    else:
        jax_lr = jax_step.make_lr_schedule(lr, **sched_kw)
        lr_arg = step.make_lr_schedule(lr, **sched_kw)
    jstate = jax_step.create_train_state(jax.random.PRNGKey(0), jax_model,
                                         jb0, learning_rate=jax_lr,
                                         grad_clip_norm=clip)
    model = OTAAligner(OTAConfig(**config_kw(use_recon)))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, jstate.params), model.config))
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = step.create_train_state(model, learning_rate=lr_arg,
                                    grad_clip_norm=clip)
    jstep = jax_step.make_train_step(jax_model, bin_start=bin_start,
                                     bin_ramp=2, donate=False)
    tstep = step.make_train_step(model, bin_start=bin_start, bin_ramp=2)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = tstep(state, torch_batch(batch))
        for key in METRICS:
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-4, atol=1e-7,
                                       err_msg=f"step {i} {key}")
    assert state.step == int(jstate.step) == 3
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params),
                              model.config)
    got = model.state_dict()
    for key, w in want.items():
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=1e-5,
                                   rtol=0, err_msg=key)
    # the steps really moved the parameters
    assert max(float((got[k] - init[k]).abs().max()) for k in got) > 1e-4


def test_lr_schedule_values_match_optax():
    cases = [dict(), dict(warmup_steps=5),
             dict(warmup_steps=3, decay_steps=12, schedule="cosine"),
             dict(warmup_steps=0, decay_steps=7, schedule="cosine",
                  final_scale=0.3)]
    for kw in cases:
        want = jax_step.make_lr_schedule(2e-3, **kw)
        got = step.make_lr_schedule(2e-3, **kw)
        for s in range(16):
            np.testing.assert_allclose(got(s), float(want(s)), rtol=1e-6,
                                       atol=1e-12, err_msg=f"{kw} step {s}")
    for kw, match in [(dict(schedule="cosine"), "decay_steps"),
                      (dict(schedule="sawtooth"), "unknown schedule")]:
        with pytest.raises(ValueError, match=match):
            step.make_lr_schedule(1e-3, **kw)


def test_clip_is_optax_formula():
    """g * max_norm / |g| above the norm, untouched below it, with no
    epsilon (torch's clip_grad_norm_ adds 1e-6)."""
    import optax
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal(s).astype(np.float32) for s in
             [(3, 4), (5,)]]
    for max_norm in (0.5, 100.0):
        want, _ = optax.clip_by_global_norm(max_norm).update(
            [jnp.asarray(g) for g in grads], None)
        got = [torch.from_numpy(g.copy()) for g in grads]
        step.clip_by_global_norm_(got, max_norm)
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


@pytest.mark.parametrize("s", [0, 999, 1000, 1500, 11000, 20000])
def test_bin_loss_weight_matches_jax(s):
    np.testing.assert_allclose(step.bin_loss_weight(s),
                               float(jax_step.bin_loss_weight(s)),
                               rtol=1e-6)


def test_eval_step_has_no_side_effects():
    model = OTAAligner(OTAConfig(**config_kw(True)))
    state = step.create_train_state(model, learning_rate=1e-3)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    m = step.make_eval_step(model, bin_start=-1, bin_ramp=1)(
        state, torch_batch(make_batch(4)))
    assert set(METRICS) <= set(m) and np.isfinite(float(m["loss"]))
    assert state.step == 0
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k
    other = OTAAligner(OTAConfig(**config_kw(True)))
    with pytest.raises(ValueError, match="another model"):
        step.make_eval_step(other)(state, torch_batch(make_batch(4)))


def loop_kw(**kw):
    return {**dict(steps=3, learning_rate=1e-3, log_every=1,
                   log_fn=lambda s: None, device="cpu"), **kw}


def test_loop_validation_records():
    model = OTAAligner(OTAConfig(**config_kw(False)))
    _, history = train_aligner(model, [make_batch(1)], eval_every=2,
                               eval_batches=[make_batch(2)],
                               **loop_kw(bin_start=-1, bin_ramp=1))
    val = [r for r in history if "val_loss" in r]
    assert [r["step"] for r in val] == [2, 3]
    assert all(np.isfinite(r["val_loss"]) for r in val)
    assert {"val_" + k for k in METRICS} <= set(val[0])
    train = [r for r in history if "loss" in r]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert train[0]["lr"] == pytest.approx(1e-3)
    assert set(METRICS) | {"step", "wall_s", "lr"} == set(train[0])


def test_loop_lr_records_read_the_pre_update_count():
    model = OTAAligner(OTAConfig(**config_kw(False)))
    _, history = train_aligner(model, [make_batch(1)], warmup_steps=4,
                               **loop_kw())
    want = jax_step.make_lr_schedule(1e-3, warmup_steps=4, decay_steps=3)
    assert [r["lr"] for r in history] == pytest.approx(
        [float(want(i)) for i in range(3)])


def test_loop_seed_determinism(tmp_path):
    bs = [make_batch(s) for s in (1, 2, 3)]
    model = OTAAligner(OTAConfig(**config_kw(False)))
    _, h1 = train_aligner(model, bs, seed=7, **loop_kw())
    _, h2 = train_aligner(model, bs, seed=7, **loop_kw())
    assert [r["loss"] for r in h1] == [r["loss"] for r in h2]
    _, h3 = train_aligner(model, bs, seed=8, **loop_kw())
    assert [r["loss"] for r in h1] != [r["loss"] for r in h3]


def test_loop_batch_order_matches_jax():
    """The shuffled stream visits batches in the JAX loop's order: with
    the learning rate 0 every step's loss is its batch's loss at init."""
    bs = [make_batch(s) for s in (1, 2, 3)]
    model = OTAAligner(OTAConfig(**config_kw(False)))
    _, hist = train_aligner(model, bs, **loop_kw(
        seed=5, bin_start=-1, bin_ramp=1, learning_rate=0.0, steps=7))
    state = step.create_train_state(model, learning_rate=0.0)
    ev = step.make_eval_step(model, bin_start=-1, bin_ramp=1)
    per_batch = [float(ev(state, torch_batch(b))["loss"]) for b in bs]
    rng = np.random.default_rng(5)
    order = np.concatenate([rng.permutation(3) for _ in range(3)])[:7]
    np.testing.assert_allclose([r["loss"] for r in hist],
                               [per_batch[j] for j in order], rtol=1e-5)


def test_loop_resume_and_config(tmp_path):
    b = make_batch(1)
    ckpt = str(tmp_path / "ckpt")
    model = OTAAligner(OTAConfig(**config_kw(True)))
    state1, _ = train_aligner(model, [b], checkpoint_dir=ckpt,
                              checkpoint_every=2, seed=3,
                              config_extra={"tokenizer": "CharTokenizer"},
                              **loop_kw())
    assert state1.step == 3
    assert checkpoint.latest_step(ckpt) == 3
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == \
        ["2", "3", "config.json"]
    params1 = {k: v.clone() for k, v in model.state_dict().items()}

    # config.json: the JAX package's keys and values for the same config
    jax_dir = str(tmp_path / "jax")
    jax_ckpt.save_run_config(jax_dir, JaxConfig(**config_kw(True)),
                             {"tokenizer": "CharTokenizer",
                              "train_seed": 3, "shuffle": True})
    assert (tmp_path / "ckpt" / "config.json").read_text() == \
        (tmp_path / "jax" / "config.json").read_text()
    assert checkpoint.load_run_config(ckpt) == \
        jax_ckpt.load_run_config(jax_dir)

    # restore: params, optimizer moments and step equal the live state
    fresh = OTAAligner(OTAConfig(**config_kw(True)),
                       generator=torch.Generator().manual_seed(9))
    restored = checkpoint.restore_checkpoint(
        ckpt, step.create_train_state(fresh, learning_rate=1e-3))
    assert restored.step == 3
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, params1[k]), k
    opt1 = state1.optimizer.state_dict()["state"]
    opt2 = restored.optimizer.state_dict()["state"]
    for i in opt1:
        for k in opt1[i]:
            assert torch.equal(opt1[i][k], opt2[i][k])
    only = checkpoint.restore_params(ckpt, OTAAligner(
        OTAConfig(**config_kw(True))), step=2)
    assert not torch.equal(only.mel_decoder.weight,
                           params1["mel_decoder.weight"])

    logs = []
    state2, hist = train_aligner(model, [b], checkpoint_dir=ckpt,
                                 resume=True, seed=3,
                                 **loop_kw(steps=5, log_fn=logs.append))
    assert any("resumed" in s and "step 3" in s for s in logs)
    assert state2.step == 5
    assert [r["step"] for r in hist if "loss" in r] == [4, 5]
    assert any(not torch.equal(v, params1[k])
               for k, v in model.state_dict().items())


def test_resume_mismatch_preserves_config(tmp_path):
    b = make_batch(1)
    ckpt = str(tmp_path / "ckpt")
    train_aligner(OTAAligner(OTAConfig(**config_kw(False))), [b],
                  checkpoint_dir=ckpt, **loop_kw(steps=2))
    wider = OTAAligner(OTAConfig(**{**config_kw(False), "dim": 24}))
    with pytest.raises(RuntimeError, match="size mismatch"):
        train_aligner(wider, [b], checkpoint_dir=ckpt, resume=True,
                      **loop_kw(steps=4))
    cfg = json.load(open(tmp_path / "ckpt" / "config.json"))
    assert cfg["model_config"]["dim"] == DIM
    with pytest.raises(ValueError, match="schedule"):
        train_aligner(OTAAligner(OTAConfig(**config_kw(False))), [b],
                      checkpoint_dir=ckpt, resume=True, warmup_steps=2,
                      **loop_kw(steps=4))


def test_load_run_config_backfills_pause_prior(tmp_path):
    rec = {"model_class": "OTA",
           "model_config": {"dim": 32, "model_pauses": True}}
    (tmp_path / "config.json").write_text(json.dumps(rec))
    assert checkpoint.load_run_config(str(tmp_path))["model_config"][
        "pause_prior"] == "inherit"
    assert checkpoint.load_run_config(str(tmp_path / "none")) is None


def test_demo_ota_prints_its_json_line(capsys, tmp_path):
    cli.main(["demo-ota", "--steps", "4", "--utterances", "12",
              "--batch-size", "6", "--device", "cpu", "--recon",
              "--checkpoint-dir", str(tmp_path / "ckpt")])
    lines = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(lines[-1])
    assert rec["demo"] == "ota"
    assert set(rec) == {"demo", "duration_exact", "duration_mae",
                        "boundary_f1_tol2"}
    assert 0.0 <= rec["boundary_f1_tol2"] <= 1.0
    assert checkpoint.latest_step(str(tmp_path / "ckpt")) == 4


def test_demo_ota_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["demo-ota", "--steps", "1"])
