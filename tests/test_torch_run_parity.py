"""Whole `train` runs of the port held against the JAX package's, step for
step on the CPU, from one init (the demos: test_torch_demo_parity.py).

Each case runs a command in process through both packages' `cli.main`:
`train` (corpus from scripts/make_wav_corpus.py, bucketing, the loop with
the CLI's defaults for lr, warmup, schedule, clip and decay, the
campaigns' `--recon --temperature 0.15` and a binarisation ramp inside the
run) then `align`. The port's models load, strictly, the JAX
loop's init for the same seed in place of their own draw
(`reference_runs.from_jax_inits`), so the runs differ only in their
pipelines. Neither CLI has a flag for the log interval, so both loops run
with `log_every=1` and return every step's metrics.

Held, each at the tolerance stated beside it: every metric at every step,
the final parameters, and `align`'s durations on every item.
"""
import contextlib
import io
import json
import os
import subprocess
import sys
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import reference_runs as rr
from aligner_tpu import cli as jcli
from aligner_tpu.train import loop as jloop
from aligner_tpu_torch import cli as tcli
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.train import loop as tloop

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRAIN = ["--dim", "16", "--hidden", "16", "--batch-size", "4", "--steps",
         "12", "--recon", "--temperature", "0.15", "--bin-start", "4",
         "--bin-ramp", "4"]
# every metric at every step, relative; float32 runs. The AdamW elements
# of PARAM_ATOL's note move the model by up to a learning rate from the
# first step, which reaches the metrics late in a run. The largest gap
# measured in each case (metric, step): romo 1.49e-4 (loss_refine, 12),
# demo-pauses --hard 1.32e-4 (mean_max_attn, 22), phone 1.11e-4 (loss_bin,
# 12: it reads log_attn on the hard path, where the attention is
# smallest), demo-ota 9.2e-5 (mean_max_attn, 24), demo-mobo 1.4e-5 (loss),
# mel levers 8.7e-6, ota 7.8e-6, pauses 7.4e-6 (loss_forward_sum), mobo
# 7.0e-7 (loss_mobo), the untied demo-romo step 1.7e-6 (loss).
METRIC_RTOL = 5e-4
# the final parameters, absolute, on all but a share of the elements.
# AdamW (eps 1e-8) steps an element whose gradient sits near eps by up to a
# learning rate on float noise alone, whichever package computes it: such
# elements appear from the first step (measured gradients 3e-9 to 1.5e-8
# there, 1.1e-4 to 2.6e-4 apart after it at lr 3e-4), and a parameter that
# no objective reaches (MoBo's last mel-encoder bias: a constant added to
# a token's energies leaves every boundary sequence's share alike) is all
# such elements. Each stays within two learning rates a step of JAX's, the
# most that Adam's steps can part; under 1% of the model's elements lie
# beyond PARAM_ATOL.
PARAM_ATOL, ADAM_NOISE_SHARE = 1e-4, 0.01
# bfloat16 compute: the encoders differ from flax's by one bf16 rounding
# of the bias (tests/test_torch_bf16.py: metrics rtol 1e-3 over three
# steps, each parameter within 6e-3, at most 10% of the elements beyond
# 1e-4); over twelve steps the metrics part by up to 1.64e-3 (measured:
# mean_max_attn at step 11, loss_bin 1.06e-3 at step 5)
BF16_METRIC_RTOL, BF16_PARAM_ATOL, BF16_FAR_SHARE = 3e-3, 6e-3, 0.1

FAMILIES = {
    "ota": ("corpus", []),
    "mel_levers": ("corpus", ["--mel-hop", "128", "--mel-win", "512",
                              "--no-mel-center"]),
    "phone": ("phone_corpus", ["--tokenizer", "phone"]),
    "pauses": ("pause_corpus", ["--model-pauses"]),
    "mobo": ("corpus", ["--model", "mobo"]),
    "romo": ("corpus", ["--model", "romo"]),
    "bf16": ("corpus", ["--compute-dtype", "bfloat16"]),
}
def make_corpus(root, *flags):
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_wav_corpus.py"),
                    str(root), "--utterances", "8", "--seed", "0", *flags],
                   check=True, capture_output=True, timeout=120)
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("wav") / "c")


@pytest.fixture(scope="module")
def pause_corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("wav") / "p",
                       "--pause-prob", "0.4")


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("wav") / "ph",
                       "--transcripts", "phone")


def run_jax(argv):
    """JAX's `cli.main(argv)` with its loop logging every step. Returns
    the inits, [(history, final params)] of each loop, and stdout."""
    runs, real = [], jloop.train_aligner

    def train(model, batches, **kwargs):
        state, history = real(model, batches, **{**kwargs, "log_every": 1})
        runs.append((history, jax.tree.map(np.asarray, state.params)))
        return state, history

    out = io.StringIO()
    with rr.recording_jax_inits() as inits, \
            mock.patch.object(jloop, "train_aligner", train), \
            contextlib.redirect_stdout(out):
        jcli.main(argv)
    return inits, runs, out.getvalue()


def run_port(argv, inits):
    """The port's `cli.main(argv + --device cpu)` from JAX's `inits`, its
    loop logging every step. Returns [(history, final state_dict)] of each
    loop, the models loaded, and stdout."""
    runs, real = [], tloop.train_aligner

    def train(model, batches, **kwargs):
        state, history = real(model, batches, **{**kwargs, "log_every": 1})
        runs.append((history, state_dict(model)))
        return state, history

    out = io.StringIO()
    with rr.from_jax_inits(inits) as models, \
            mock.patch.object(tloop, "train_aligner", train), \
            contextlib.redirect_stdout(out):
        tcli.main([*argv, "--device", "cpu"])
    return runs, models, out.getvalue()


def state_dict(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def assert_histories_match(got, want, rtol):
    """Every metric of every step; the records' keys equal."""
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g["step"] == w["step"]
        assert set(g) == set(w), (sorted(g), sorted(w))
        for key in sorted(set(w) - {"step", "wall_s"}):
            np.testing.assert_allclose(g[key], w[key], rtol=rtol, atol=0,
                                       err_msg=f"step {w['step']} {key}")


def assert_params_match(got, params, config, lr, steps, bf16=False,
                        far_share=ADAM_NOISE_SHARE):
    """The port's final state_dict against JAX's final params."""
    want = flax_to_state_dict(params, config)
    assert set(got) == set(want)
    far = n = 0
    for key, w in want.items():
        d = (got[key] - w).abs()
        bound = BF16_PARAM_ATOL if bf16 else 2 * lr * steps
        assert float(d.max()) <= bound, (key, float(d.max()), bound)
        far += int(d.gt(PARAM_ATOL).sum())
        n += w.numel()
    share = BF16_FAR_SHARE if bf16 else far_share
    assert far <= share * n, f"{far} of {n} elements beyond {PARAM_ATOL}"


def last_record(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@contextlib.contextmanager
def restore_template(params):
    """JAX's `align` draws an init only as the tree to restore the
    checkpoint into: while open, each JAX model's `init` gives `params`,
    the run's final params (the checkpoint's own tree), instead of
    compiling one more init."""
    from aligner_tpu import models as jmodels
    with contextlib.ExitStack() as stack:
        for cls in (jmodels.OTAAligner, jmodels.MoBoAligner,
                    jmodels.RoMoAligner):
            stack.enter_context(mock.patch.object(
                cls, "init", lambda self, *a, **k: {"params": params}))
        yield


def align_records(cli, corpus, ckpt, out, params=None):
    """`align`'s records by either package; JAX's restores into `params`
    (`restore_template`)."""
    argv = ["align", corpus, "--checkpoint-dir", str(ckpt), "--output",
            str(out), "--batch-size", "4"]
    if cli is tcli:
        argv += ["--device", "cpu"]
    template = (restore_template(params) if cli is jcli else
                contextlib.nullcontext())
    with template, contextlib.redirect_stdout(io.StringIO()):
        cli.main(argv)
    with open(out) as f:
        return [json.loads(line) for line in f]


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_train_run_matches_jax(request, tmp_path, family):
    corpus_name, flags = FAMILIES[family]
    corpus = request.getfixturevalue(corpus_name)
    argv = ["train", corpus, *TRAIN, *flags]
    jck, tck = tmp_path / "jax", tmp_path / "port"
    inits, jruns, _ = run_jax([*argv, "--checkpoint-dir", str(jck)])
    truns, models, _ = run_port([*argv, "--checkpoint-dir", str(tck)],
                                inits)
    assert len(inits) == len(jruns) == len(truns) == len(models) == 1
    bf16 = family == "bf16"
    (want_h, params), (got_h, got_p) = jruns[0], truns[0]
    assert len(want_h) == 12
    assert_histories_match(got_h, want_h,
                           BF16_METRIC_RTOL if bf16 else METRIC_RTOL)
    assert_params_match(got_p, params, models[0].config, want_h[0]["lr"],
                        len(want_h), bf16=bf16)

    want = align_records(jcli, corpus, jck, tmp_path / "jax.jsonl", params)
    got = align_records(tcli, corpus, tck, tmp_path / "port.jsonl")
    assert [r["utt_id"] for r in got] == [r["utt_id"] for r in want]
    differ = [(w["utt_id"], w["durations"], g["durations"],
               w.get("pauses"), g.get("pauses"))
              for g, w in zip(got, want) if g != w]
    if family == "bf16" and differ:
        # bfloat16 lattices differ by the encoders' rounding: an item may
        # decode otherwise where its best paths are that close (measured:
        # two items, gaps 0.0029 and 0.0061 within bounds 0.0087, 0.039)
        ties = tie_gaps(corpus, jck, tck, params, [d[:3] for d in differ])
        assert all(0 <= gap <= bound for _, gap, bound in ties), (differ,
                                                                  ties)
        differ = []
    assert not differ, f"(utt, JAX, port) durations and pauses: {differ}"


def lattices(cli, ckpt, corpus, utts, params=None):
    """`align`'s lattices (`logp_with_prior`) of some utterances under a
    checkpoint, by either package, as [T_y, T_x] numpy arrays, in one
    padded batch; JAX's restores into `params`, the run's final params."""
    argv = ["align", corpus, "--checkpoint-dir", str(ckpt)]
    args = cli.build_parser().parse_args(
        argv if cli is jcli else [*argv, "--device", "cpu"])
    if cli is jcli:
        import jax.numpy as jnp
        from aligner_tpu.data import load_corpus, pad_batch
        from aligner_tpu.train import restore_params
        from aligner_tpu.train.checkpoint import load_run_config
        tok, model = jcli._model_from_checkpoint(args)
    else:
        from aligner_tpu_torch.data import load_corpus, pad_batch
        from aligner_tpu_torch.train import restore_params
        from aligner_tpu_torch.train.checkpoint import load_run_config
        tok, model = tcli._model_from_checkpoint(args, torch.device("cpu"))
    mel_cfg = cli._mel_config_from_record(load_run_config(str(ckpt)))
    device = {} if cli is jcli else {"device": torch.device("cpu")}
    items = {it["utt_id"]: it for it in load_corpus(
        corpus, tokenizer=tok, mel_config=mel_cfg, **device)}
    b = pad_batch([items[u] for u in utts])
    args = [b[k] for k in ("tokens", "mel", "text_lengths", "mel_lengths")]
    if cli is jcli:
        args = [jnp.asarray(a) for a in args]
        lp = np.asarray(jax.jit(lambda p, *a: model.apply(
            {"params": p}, *a)["logp_with_prior"])(
                restore_params(str(ckpt), params), *args))
    else:
        restore_params(str(ckpt), model)
        with torch.no_grad():
            lp = model(*map(torch.as_tensor, args))["logp_with_prior"]
        lp = lp.numpy()
    return [lp[i, :int(t_y), :int(t_x)].astype(np.float64)
            for i, (t_x, t_y) in enumerate(zip(b["text_lengths"],
                                               b["mel_lengths"]))]


def tie_gaps(corpus, jck, tck, params, differ):
    """For each (utt, JAX's durations, the port's) of `differ`: how far
    apart the two paths score on JAX's lattice, and the most that the two
    lattices' difference over the cells where the paths part allows. Each
    decode is the best path of its own lattice, so gap <= bound unless a
    decode is wrong."""
    utts = [utt for utt, *_ in differ]
    out = []
    for want, got, (utt, jax_durs, port_durs) in zip(
            lattices(jcli, jck, corpus, utts, params),
            lattices(tcli, tck, corpus, utts), differ):
        frames = np.arange(want.shape[0])
        pj = np.repeat(np.arange(len(jax_durs)), jax_durs)
        pt = np.repeat(np.arange(len(port_durs)), port_durs)
        gap = want[frames, pj].sum() - want[frames, pt].sum()
        part = pj != pt
        diff = np.abs(want - got)
        bound = diff[frames, pj][part].sum() + diff[frames, pt][part].sum()
        out.append((utt, gap, bound))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2, 7, 2**31 + 5, 2**33 + 5])
def test_prng_key_is_jax_key_data(seed):
    """The key a saved init is checked against where there is no JAX."""
    assert np.array_equal(rr.prng_key(seed), np.asarray(
        jax.random.key_data(jax.random.PRNGKey(seed))))


def test_saved_inits_round_trip(tmp_path):
    params = {"embed": {"embedding": np.arange(6, dtype=np.float32)
                        .reshape(2, 3)}}
    inits = {"row": [rr.Init("OTAConfig", rr.prng_key(3), params)]}
    rr.save_inits(inits, tmp_path / "inits.pt")
    (got,) = rr.load_inits(str(tmp_path / "inits.pt"))["row"]
    assert got.family == "OTAConfig"
    assert np.array_equal(got.key, rr.prng_key(3))
    assert np.array_equal(got.params["embed"]["embedding"],
                          params["embed"]["embedding"])


def test_walk_exits_names_the_items_that_leave_the_grid(tmp_path):
    path = tmp_path / "durations.jsonl"
    recs = [{"utt_id": "in", "durations": [3, 4, 5], "n_frames": 12},
            {"utt_id": "edge", "durations": [9, 6, 6], "n_frames": 12},
            {"utt_id": "out", "durations": [1, 7, 6], "n_frames": 12}]
    path.write_text("".join(json.dumps(r) + "\n" for r in recs))
    assert rr.walk_exits(str(path)) == {"alignments": str(path), "items": 3,
                                        "left_grid": ["out"]}
