"""aligner_tpu_torch pause-aware OTA aligner (`model_pauses=True`) against
the JAX model: one flax init (with a non-zero pause key), converted with
`models.convert`, must give the same state lattices and losses (CPU
route, the plain versions of kernels H4-H6), with `pause_bias` passed and
with the silence anchor on; the port's skip Viterbi on JAX's lattice must
give JAX's hard path exactly. Tolerances are those of
tests/test_torch_ota.py: lattices atol 1e-4, losses rtol 1e-4."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aligner_tpu.models import OTAAligner as JaxOTA
from aligner_tpu.models import OTAConfig as JaxConfig
from aligner_tpu_torch import OTAAligner, OTAConfig
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.ops.skip_dp import mas_skip_path_frame_major

VOCAB, N_MELS, DIM, HIDDEN = 20, 16, 16, 32
B, T_X, T_Y = 3, 8, 40

# config overrides, and the pause_bias handed to the forward
CASES = {
    "bridge": (dict(), None),
    "inherit_costs": (dict(pause_prior="inherit", pause_bias=-0.7,
                           pause_enter_cost=-0.5), None),
    "bias_passed": (dict(pause_bias=-0.7), -1.5),
    "recon_anchor": (dict(use_recon=True, pause_silence_anchor=0.5), 0.4),
}


def config_kw(**overrides):
    return dict(vocab_size=VOCAB, n_mels=N_MELS, dim=DIM, hidden=HIDDEN,
                model_pauses=True, **overrides)


def make_batch(seed):
    rng = np.random.default_rng(seed)
    text_lengths = np.array([T_X, 5, 2], np.int32)
    mel_lengths = np.array([T_Y, 27, 6], np.int32)
    tokens = rng.integers(0, VOCAB, (B, T_X)).astype(np.int32)
    mel = rng.standard_normal((B, T_Y, N_MELS)).astype(np.float32)
    # Two frames tie for the lowest mean energy with different spectra:
    # the silence anchor must take the first, as jnp.argmin does.
    mel[0, 3] = -3.0
    mel[0, 9] = np.tile([-4.0, -2.0], N_MELS // 2)
    return tokens, mel, text_lengths, mel_lengths


def jax_init(overrides, batch):
    """(JAX model, params as numpy with a non-zero pause key)."""
    model = JaxOTA(JaxConfig(mas_implementation="lax",
                             **config_kw(**overrides)))
    params = model.init(jax.random.PRNGKey(0),
                        *[jnp.asarray(a) for a in batch])["params"]
    params = jax.tree_util.tree_map(np.asarray, dict(params))
    assert not params["pause_key"].any()        # flax inits it to zero
    params["pause_key"] = (np.random.default_rng(2).standard_normal(DIM)
                           * 0.3).astype(np.float32)
    return model, params


@pytest.fixture(scope="module", params=sorted(CASES))
def converted(request):
    """(batch, config overrides, JAX outputs, port outputs)."""
    overrides, bias = CASES[request.param]
    batch = make_batch(1)
    jax_model, params = jax_init(overrides, batch)
    jax_out = jax_model.apply({"params": params},
                              *[jnp.asarray(a) for a in batch],
                              pause_bias=bias)
    model = OTAAligner(OTAConfig(**config_kw(**overrides)))
    model.load_state_dict(flax_to_state_dict(params, model.config))
    with torch.no_grad():
        out = model(*[torch.from_numpy(a) for a in batch], pause_bias=bias)
    return batch, overrides, jax_out, out


@pytest.mark.parametrize("key", ["log_attn", "logp_with_prior"])
def test_state_lattices_match_jax(converted, key):
    _, _, jax_out, out = converted
    want = np.asarray(jax_out[key])
    assert out[key].shape == want.shape == (B, T_Y, 2 * T_X + 1)
    np.testing.assert_allclose(out[key].numpy(), want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("key", ["loss_forward_sum", "loss_bin",
                                 "loss_recon"])
def test_losses_match_jax(converted, key):
    _, _, jax_out, out = converted
    np.testing.assert_allclose(float(out[key]), float(jax_out[key]),
                               rtol=1e-4, atol=1e-7)


def test_hard_path_on_jax_lattice_is_exact(converted):
    batch, overrides, jax_out, _ = converted
    got = mas_skip_path_frame_major(
        torch.from_numpy(np.array(jax_out["logp_with_prior"])),
        torch.from_numpy(batch[2]), torch.from_numpy(batch[3]),
        enter_cost=overrides.get("pause_enter_cost", 0.0))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jax_out["hard_path"]))


def test_durations_match_jax(converted):
    batch, _, jax_out, out = converted
    for key, width in (("durations", T_X), ("pause_durations", T_X + 1)):
        assert out[key].shape == (B, width)
        np.testing.assert_array_equal(out[key].numpy(),
                                      np.asarray(jax_out[key]))
    np.testing.assert_array_equal(
        (out["durations"].sum(-1) + out["pause_durations"].sum(-1)).numpy(),
        batch[3].astype(np.float32))
    states = out["hard_path"].sum(1)
    torch.testing.assert_close(out["durations"], states[:, 1::2])
    torch.testing.assert_close(out["pause_durations"], states[:, 0::2])
    for i, t_x in enumerate(batch[2]):           # padded slots stay empty
        assert not out["durations"][i, t_x:].any()
        assert not out["pause_durations"][i, t_x + 1:].any()


def test_pause_bias_float_tensor_and_config_agree():
    batch = [torch.from_numpy(a) for a in make_batch(3)]
    gen = torch.Generator().manual_seed(4)
    by_config = OTAAligner(OTAConfig(**config_kw(pause_bias=-1.25)),
                           generator=gen)
    by_arg = OTAAligner(OTAConfig(**config_kw()))
    with torch.no_grad():
        by_config.pause_key.normal_(generator=gen)
        by_arg.load_state_dict(by_config.state_dict())
        want = by_config(*batch)
        neutral = by_arg(*batch)
        for bias in (-1.25, torch.tensor(-1.25)):
            got = by_arg(*batch, pause_bias=bias)
            torch.testing.assert_close(got["log_attn"], want["log_attn"],
                                       rtol=0, atol=0)
    assert not torch.equal(neutral["log_attn"], want["log_attn"])
    # the bias moves the pause class only against the tokens
    assert want["log_attn"][0, 0, 0] < neutral["log_attn"][0, 0, 0]


def test_pause_key_gets_gradients_from_every_loss():
    model = OTAAligner(OTAConfig(**config_kw(use_recon=True,
                                             pause_silence_anchor=0.5)))
    batch = [torch.from_numpy(a) for a in make_batch(5)]
    for key in ("loss_forward_sum", "loss_bin", "loss_recon"):
        model.zero_grad(set_to_none=True)
        model(*batch)[key].backward()
        assert torch.isfinite(model.pause_key.grad).all()
        assert model.pause_key.grad.abs().max() > 0, key


def test_init_keeps_the_pause_key_zero_and_the_other_draws():
    gen = lambda: torch.Generator().manual_seed(3)
    pause = OTAAligner(OTAConfig(**config_kw()), generator=gen())
    blind = OTAAligner(OTAConfig(**{**config_kw(), "model_pauses": False}),
                       generator=gen())
    assert pause.pause_key.shape == (DIM,) and not pause.pause_key.any()
    with torch.no_grad():
        pause.pause_key.fill_(1.0)
    pause.reset_parameters(gen())
    assert not pause.pause_key.any()
    for name, p in blind.named_parameters():
        assert torch.equal(p, pause.get_parameter(name)), name


def test_convert_keeps_pause_and_plain_trees_apart():
    batch = make_batch(1)
    _, params = jax_init({}, batch)
    plain = {k: v for k, v in params.items() if k != "pause_key"}
    blind_config = OTAConfig(**{**config_kw(), "model_pauses": False})
    with pytest.raises(KeyError, match="unknown.*pause_key"):
        flax_to_state_dict(params, blind_config)
    with pytest.raises(KeyError, match="missing.*pause_key"):
        flax_to_state_dict(plain, OTAConfig(**config_kw()))
    state = flax_to_state_dict(params, OTAConfig(**config_kw()))
    np.testing.assert_array_equal(state["pause_key"].numpy(),
                                  params["pause_key"])
