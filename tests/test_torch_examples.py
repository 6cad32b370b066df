"""The port's two examples (examples/*_torch.py) on the CPU, with
`--device cpu` at a reduced size; the VITS-style step held against the
JAX example's on the same numpy inputs."""
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load(name):
    path = os.path.join(REPO, "examples", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_batch_serving_on_the_cpu(capsys):
    example = load("batch_serving_torch")
    assert example.main(["--device", "cpu", "--batch", "4", "--t-text", "8",
                         "--t-mel", "40", "--iters", "2"]) == 0
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert re.fullmatch(r"B=4 T_text=8 T_mel=40: [0-9.]+ ms/batch, [0-9,]+ "
                        r"paths/s \(host time of the plain version on the "
                        r"CPU\)", line), line


@pytest.mark.parametrize("name", ["batch_serving_torch",
                                  "vits_style_integration_torch"])
def test_examples_refuse_a_missing_card(name, monkeypatch):
    """The default device is the card; without one the example stops and
    names the way to run on the CPU, running nothing there."""
    example = load(name)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        example.main([])


def test_vits_step_matches_the_jax_example(capsys):
    """Three steps of the port's example against the JAX example's
    train_step on the same inputs: the losses at rtol 1e-5 (float32 sums
    in another order) and the hard durations equal."""
    tex = load("vits_style_integration_torch")
    jex = load("vits_style_integration")
    rng = np.random.default_rng(3)
    B, T_x, T_y, C = 3, 10, 32, 6
    emb = rng.standard_normal((B, T_x, 16)).astype(np.float32)
    mel = rng.standard_normal((B, T_y, C)).astype(np.float32)
    t_x = np.array([10, 7, 4], np.int32)
    t_y = np.array([32, 20, 9], np.int32)
    mask = ((np.arange(T_x)[None, :, None] < t_x[:, None, None])
            & (np.arange(T_y)[None, None, :] < t_y[:, None, None])
            ).astype(np.float32)
    init = {"w_mu": rng.standard_normal((16, C)).astype(np.float32) * 0.1,
            "w_logs": np.zeros((16, C), np.float32),
            "w_dur": rng.standard_normal((16, 1)).astype(np.float32) * 0.1}
    jparams = {k: jnp.asarray(v) for k, v in init.items()}
    tparams = {k: torch.from_numpy(v.copy()).requires_grad_()
               for k, v in init.items()}
    jstep = jax.jit(jex.train_step)
    for i in range(3):
        jparams, jloss, jmle, jdur = jstep(
            jparams, jnp.asarray(mel), jnp.asarray(emb), jnp.asarray(mask),
            jnp.asarray(t_x))
        loss, mle, dur = tex.train_step(
            tparams, torch.from_numpy(mel), torch.from_numpy(emb),
            torch.from_numpy(mask), torch.from_numpy(t_x))
        for got, want in ((loss, jloss), (mle, jmle), (dur, jdur)):
            np.testing.assert_allclose(float(got), float(want), rtol=1e-5,
                                       err_msg=f"step {i}")
    for k in init:
        np.testing.assert_allclose(tparams[k].detach().numpy(),
                                   np.asarray(jparams[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert tex.main(["--device", "cpu", "--steps", "3"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert [line.split()[1] for line in out[:-1]] == ["0", "2"]
    assert out[-1] == "done - MAS ran inside the step on cpu"
