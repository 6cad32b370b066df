"""aligner_tpu_torch OTA aligner against the JAX model: one JAX init,
converted with `models.convert`, must give the same attention, prior-added
lattice and losses (CPU route), and the port's MAS on JAX's lattice must
give JAX's hard path exactly."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.models import OTAAligner as JaxOTA
from aligner_tpu.models import OTAConfig as JaxConfig
from aligner_tpu.models.encoders import MelEncoder as JaxMelEncoder
from aligner_tpu.models.encoders import TextEncoder as JaxTextEncoder
from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.ops.mas import mas_path_frame_major

VOCAB, N_MELS, DIM, HIDDEN = 20, 80, 16, 32
B, T_X, T_Y = 3, 12, 40


def make_batch(seed):
    rng = np.random.default_rng(seed)
    text_lengths = np.array([T_X, 7, 4], np.int32)
    mel_lengths = np.array([T_Y, 31, 9], np.int32)
    tokens = rng.integers(0, VOCAB, (B, T_X)).astype(np.int32)
    mel = rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32)
    return tokens, mel, text_lengths, mel_lengths


@pytest.fixture(scope="module", params=[False, True], ids=["plain", "recon"])
def converted(request):
    """(batch, JAX outputs, port outputs, JAX params, port model)."""
    use_recon = request.param
    kw = dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
              use_recon=use_recon)
    jax_model = JaxOTA(JaxConfig(mas_implementation="lax", **kw))
    batch = make_batch(1)
    jbatch = [jnp.asarray(a) for a in batch]
    params = jax_model.init(jax.random.PRNGKey(0), *jbatch)["params"]
    jax_out = jax_model.apply({"params": params}, *jbatch)
    model = OTAAligner(OTAConfig(**kw))
    model.load_state_dict(flax_to_state_dict(
        jax.tree_util.tree_map(np.asarray, params), model.config))
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch])
    return batch, jax_out, out, params, model


@pytest.mark.parametrize("key", ["log_attn", "logp_with_prior"])
def test_lattices_match_jax(converted, key):
    _, jax_out, out, _, _ = converted
    want = np.asarray(jax_out[key])
    got = out[key].numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("key", ["loss_forward_sum", "loss_bin",
                                 "loss_recon"])
def test_losses_match_jax(converted, key):
    _, jax_out, out, _, _ = converted
    np.testing.assert_allclose(float(out[key]), float(jax_out[key]),
                               rtol=1e-4, atol=1e-7)


def test_hard_path_on_jax_lattice_is_exact(converted):
    batch, jax_out, _, _, _ = converted
    _, _, text_lengths, mel_lengths = batch
    got = mas_path_frame_major(
        torch.from_numpy(np.array(jax_out["logp_with_prior"])),
        torch.from_numpy(text_lengths), torch.from_numpy(mel_lengths))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_out["hard_path"]))


def test_durations_sum_to_mel_lengths(converted):
    batch, _, out, _, _ = converted
    np.testing.assert_array_equal(out["durations"].sum(-1).numpy(),
                                  batch[3].astype(np.float32))
    torch.testing.assert_close(out["durations"], out["hard_path"].sum(1))


@pytest.mark.parametrize("which", ["text", "mel"])
def test_encoders_match_jax(converted, which):
    batch, _, _, params, model = converted
    tokens, mel, text_lengths, mel_lengths = batch
    if which == "text":
        x, lengths, T = tokens, text_lengths, T_X
        jax_enc = JaxTextEncoder(VOCAB, DIM, HIDDEN)
        enc = model.text_encoder
    else:
        x, lengths, T = mel, mel_lengths, T_Y
        jax_enc = JaxMelEncoder(DIM, HIDDEN)
        enc = model.mel_encoder
    mask = (np.arange(T)[None, :] < lengths[:, None]).astype(np.float32)
    want = jax_enc.apply({"params": params[f"{which}_encoder"]},
                         jnp.asarray(x), jnp.asarray(mask))
    with torch.no_grad():
        got = enc(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_convert_rejects_mismatched_trees(converted):
    _, _, _, params, _ = converted
    flat = jax.tree_util.tree_map(np.asarray, params)
    with pytest.raises(KeyError, match="missing"):
        flax_to_state_dict({"text_encoder": flat["text_encoder"]},
                           OTAConfig(vocab_size=VOCAB, dim=DIM,
                                     hidden=HIDDEN))
    with pytest.raises(KeyError, match="unknown"):
        flax_to_state_dict({**flat, "pause_key": np.zeros(DIM)},
                           OTAConfig(vocab_size=VOCAB, dim=DIM,
                                     hidden=HIDDEN,
                                     use_recon="mel_decoder" in flat))


def test_seeded_init_is_reproducible():
    cfg = OTAConfig(vocab_size=VOCAB, dim=DIM, hidden=HIDDEN)
    a = OTAAligner(cfg, generator=torch.Generator().manual_seed(3))
    b = OTAAligner(cfg, generator=torch.Generator().manual_seed(3))
    for (name, p), q in zip(a.named_parameters(), b.parameters()):
        assert torch.equal(p, q), name
