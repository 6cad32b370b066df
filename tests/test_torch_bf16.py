"""compute_dtype="bfloat16" in the port against the JAX model built with the
same compute dtype, from one converted flax init, on the CPU.

The init's biases and pause key are drawn away from zero (flax starts them
at zero), so that the one place where the two frameworks round differently
shows: flax rounds a bfloat16 convolution to bfloat16 and then adds the
bias in bfloat16 (two roundings); oneDNN and cuDNN add the bias before the
one rounding. Measured here: the encoder outputs differ by at most one
bfloat16 ulp of their largest magnitude (26-37% of the elements by any
amount), `log_attn` by at most 4.6e-3, the losses by at most 1.7e-4
relative. The tolerances below are stated beside each assertion.
"""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from aligner_tpu.models import OTAAligner as JaxOTA
from aligner_tpu.models import OTAConfig as JaxConfig
from aligner_tpu.models.encoders import MelEncoder as JaxMelEncoder
from aligner_tpu.models.encoders import TextEncoder as JaxTextEncoder
from aligner_tpu.train import step as jax_step
from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch import cli as tcli
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.ops.mas_reference import mas_single
from aligner_tpu_torch.ops.skip_dp_reference import mas_skip_single
from aligner_tpu_torch.train import step

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 16, 32
B, T_X, T_Y = 3, 12, 40
ENTER_COST = -0.3


def make_batch(seed):
    rng = np.random.default_rng(seed)
    return {"tokens": rng.integers(0, VOCAB, (B, T_X)).astype(np.int32),
            "mel": rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32),
            "text_lengths": np.array([T_X, 7, 4], np.int32),
            "mel_lengths": np.array([T_Y, 31, 9], np.int32)}


def config_kw(pauses):
    kw = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
              use_recon=True, compute_dtype="bfloat16")
    if pauses:
        kw.update(model_pauses=True, pause_silence_anchor=0.5,
                  pause_enter_cost=ENTER_COST)
    return kw


def jax_init(jax_model, batch, seed=0):
    """A flax init with its biases and pause key drawn from N(0, 0.3^2)."""
    jb = [jnp.asarray(batch[k]) for k in ("tokens", "mel", "text_lengths",
                                          "mel_lengths")]
    # jitted: one compile costs less than the eager ops' first calls
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), *jb)["params"]
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        leaf = np.asarray(leaf)
        if path[-1].key in ("bias", "pause_key"):
            leaf = leaf + 0.3 * rng.standard_normal(leaf.shape).astype(
                np.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(draw, params)


def port_model(params, kw):
    model = OTAAligner(OTAConfig(**kw))
    model.load_state_dict(flax_to_state_dict(params, model.config))
    return model


def args_of(batch):
    return [batch[k] for k in ("tokens", "mel", "text_lengths",
                               "mel_lengths")]


@pytest.fixture(scope="module", params=[False, True],
                ids=["blind", "pauses"])
def converted(request):
    """(batch, JAX outputs, port outputs, params, port model, pauses)."""
    pauses = request.param
    kw = config_kw(pauses)
    batch = make_batch(1)
    jax_model = JaxOTA(JaxConfig(mas_implementation="lax", **kw))
    params = jax_init(jax_model, batch)
    jax_out = jax.jit(jax_model.apply)({"params": params},
                                       *map(jnp.asarray, args_of(batch)))
    model = port_model(params, kw)
    with torch.no_grad():
        out = model(*map(torch.from_numpy, args_of(batch)))
    return batch, jax_out, out, params, model, pauses


def bf16_ulp(x: float) -> float:
    """The spacing of bfloat16 values at magnitude x (8 bits of
    precision)."""
    return 2.0 ** (np.floor(np.log2(x)) - 7)


@pytest.mark.parametrize("which", ["text", "mel"])
def test_encoders_match_jax_within_a_bf16_ulp(converted, which):
    batch, _, _, params, model, _ = converted
    if which == "text":
        x, lengths, T = batch["tokens"], batch["text_lengths"], T_X
        jax_enc = JaxTextEncoder(VOCAB, DIM, HIDDEN, dtype=jnp.bfloat16)
        enc = model.text_encoder
    else:
        x, lengths, T = batch["mel"], batch["mel_lengths"], T_Y
        jax_enc = JaxMelEncoder(DIM, HIDDEN, dtype=jnp.bfloat16)
        enc = model.mel_encoder
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    want = jax_enc.apply({"params": params[f"{which}_encoder"]},
                         jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(mask))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    want = np.asarray(want.astype(jnp.float32))
    got = got.float().numpy()
    # Two roundings in flax against one here: the encoders differ by one
    # bfloat16 ulp of the output's largest magnitude at most (measured);
    # two ulps leave room for a carry through the three layers.
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=2 * bf16_ulp(np.abs(want).max()))
    assert not np.array_equal(got, want), (
        "the biases were meant to expose the rounding difference")


@pytest.mark.parametrize("key", ["log_attn", "logp_with_prior"])
def test_lattices_are_float32_and_match_jax(converted, key):
    _, jax_out, out, _, _, _ = converted
    assert out[key].dtype == torch.float32
    want = np.asarray(jax_out[key])
    assert want.dtype == np.float32
    # The encoders' ulp, through -temperature * |q - k|^2 and the
    # log-softmax: measured 4.6e-3 at most.
    np.testing.assert_allclose(out[key].numpy(), want, rtol=0, atol=1e-2)


@pytest.mark.parametrize("key", ["loss_forward_sum", "loss_bin",
                                 "loss_recon"])
def test_losses_match_jax(converted, key):
    _, jax_out, out, _, _, _ = converted
    # measured 1.7e-4 relative at most
    np.testing.assert_allclose(float(out[key]), float(jax_out[key]),
                               rtol=1e-3, atol=0)


def test_hard_path_is_the_oracle_on_the_ports_lattice(converted):
    """The port's hard path is the NumPy oracle's on the port's own
    float32 lattice, item by item, bit for bit."""
    batch, _, out, _, _, pauses = converted
    logp = out["logp_with_prior"].numpy()
    hard = out["hard_path"].numpy()
    for i in range(B):
        tx, ty = int(batch["text_lengths"][i]), int(batch["mel_lengths"][i])
        value = logp[i].T.copy()                   # [T_x or T_s, T_y]
        if pauses:
            want = mas_skip_single(value, tx, ty, enter_cost=ENTER_COST)
        else:
            want = mas_single(value, tx, ty)
        np.testing.assert_array_equal(hard[i].T, want, err_msg=f"item {i}")


def test_hard_path_matches_jax(converted):
    """The paths agree on every item: no lattice decision here lies within
    the encoders' one-ulp difference."""
    _, jax_out, out, _, _, pauses = converted
    np.testing.assert_array_equal(out["hard_path"].numpy(),
                                  np.asarray(jax_out["hard_path"]))
    key = "pause_durations" if pauses else "durations"
    np.testing.assert_array_equal(out[key].numpy(),
                                  np.asarray(jax_out[key]))


def test_parameters_stay_float32(converted):
    *_, model, _ = converted
    assert all(p.dtype == torch.float32 for p in model.parameters())


def test_unknown_compute_dtype_raises():
    with pytest.raises(ValueError, match="compute_dtype"):
        OTAAligner(OTAConfig(vocab_size=VOCAB, dim=DIM, hidden=HIDDEN,
                             compute_dtype="float16"))


@pytest.mark.parametrize("pauses", [False, True], ids=["blind", "pauses"])
def test_bf16_train_steps_match_jax(pauses):
    """Three AdamW steps (learning rate 1e-3) from one JAX init on the same
    batches. The metrics agree at rtol 1e-3 each step (measured 1.0e-4).

    The parameters are held at two tolerances. bfloat16 gradients carry the
    encoders' one-ulp difference, and Adam's step is about the learning
    rate whatever a gradient's size, so an element whose gradient is near
    zero can step the other way: two learning rates a step, 6e-3 over three
    steps, is that distance (measured 4.4e-3 at most). Beyond 1e-4 lie at
    most 10% of all elements (measured 2.3% pause-blind, 6.6% with
    pauses)."""
    kw = config_kw(pauses)
    batches = [make_batch(s) for s in (4, 5, 6)]
    jax_model = JaxOTA(JaxConfig(mas_implementation="lax", **kw))
    params = jax_init(jax_model, batches[0])
    # create_train_state's optimizer, around the drawn parameters
    jstate = jax_step.TrainState.create(
        apply_fn=jax_model.apply,
        params=jax.tree_util.tree_map(jnp.asarray, params),
        tx=optax.adamw(1e-3, weight_decay=1e-6))
    model = port_model(params, kw)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    state = step.create_train_state(model, learning_rate=1e-3)
    jstep = jax_step.make_train_step(jax_model, bin_start=0, bin_ramp=2,
                                     donate=False)
    tstep = step.make_train_step(model, bin_start=0, bin_ramp=2)
    for i, batch in enumerate(batches):
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = tstep(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
        for key in ("loss", "loss_forward_sum", "loss_bin"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-3, atol=0,
                                       err_msg=f"step {i} {key}")
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jstate.params),
                              model.config)
    got = model.state_dict()
    far = n = 0
    for key, w in want.items():
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), w.numpy(), atol=6e-3,
                                   rtol=0, err_msg=key)
        far += int((got[key] - w).abs().gt(1e-4).sum())
        n += w.numel()
    assert far <= 0.1 * n, f"{far} of {n} elements beyond 1e-4"
    assert max(float((got[k] - init[k]).abs().max()) for k in got) > 1e-3


def test_bf16_trains():
    """JAX's test_bfloat16_compute_dtype_trains on the port: parameters
    float32, the lattice and losses float32, one state per live frame, and
    the loss falls over six steps."""
    rng = np.random.default_rng(0)
    Bt, Tx, Ty = 4, 12, 48
    text_lengths = np.array([12, 9, 7, 5], np.int32)
    mel_lengths = np.array([48, 40, 30, 21], np.int32)
    batch = {"tokens": torch.from_numpy(
                 rng.integers(0, 50, (Bt, Tx)).astype(np.int64)),
             "mel": torch.from_numpy(
                 rng.standard_normal((Bt, Ty, 80)).astype(np.float32)),
             "text_lengths": torch.from_numpy(text_lengths),
             "mel_lengths": torch.from_numpy(mel_lengths)}
    model = OTAAligner(OTAConfig(vocab_size=50, dim=32, hidden=48,
                                 compute_dtype="bfloat16"))
    assert all(p.dtype == torch.float32 for p in model.parameters())
    with torch.no_grad():
        out = model(batch["tokens"], batch["mel"], batch["text_lengths"],
                    batch["mel_lengths"])
    assert out["log_attn"].dtype == torch.float32
    assert np.isfinite(float(out["loss_forward_sum"]))
    per_frame = out["hard_path"].sum(-1).numpy()
    for i in range(Bt):
        assert (per_frame[i, :mel_lengths[i]] == 1).all()
        assert (per_frame[i, mel_lengths[i]:] == 0).all()
    state = step.create_train_state(model, learning_rate=1e-3)
    tstep = step.make_train_step(model, bin_start=-1, bin_ramp=1)
    losses = []
    for _ in range(6):
        state, m = tstep(state, batch)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and losses[-1] < losses[0]
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wav") / "c"
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_wav_corpus.py"),
                    str(root), "--utterances", "4", "--seed", "0"],
                   check=True, capture_output=True, timeout=120)
    return str(root)


@pytest.mark.parametrize("pauses", [False, True], ids=["blind", "pauses"])
def test_cli_train_bf16_then_align(tmp_path, corpus, pauses):
    """`train --compute-dtype bfloat16` writes compute_dtype into
    config.json, as the JAX CLI does, and `align` rebuilds that model: one
    record an utterance, its durations covering its frames."""
    ckpt = str(tmp_path / "ckpt")
    out = str(tmp_path / "durations.jsonl")
    flags = ["--model-pauses"] if pauses else []
    tcli.main(["train", corpus, "--steps", "3", "--batch-size", "4",
               "--checkpoint-dir", ckpt, "--dim", "16", "--hidden", "24",
               "--compute-dtype", "bfloat16", "--device", "cpu", *flags])
    with open(os.path.join(ckpt, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model_config"]["compute_dtype"] == "bfloat16"
    assert cfg["model_config"]["model_pauses"] is pauses
    tcli.main(["align", corpus, "--checkpoint-dir", ckpt, "--output", out,
               "--batch-size", "4", "--textgrid-dir", str(tmp_path / "tg"),
               "--device", "cpu"])
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    assert len(recs) == 4
    for r in recs:
        total = sum(r["durations"]) + sum(r.get("pauses", []))
        assert total == r["n_frames"]
        assert ("pauses" in r) is pauses
    assert len(os.listdir(tmp_path / "tg")) == 4
