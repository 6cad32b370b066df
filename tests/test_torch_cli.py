"""The port's `train` and `align` commands and its wav scorer against
aligner_tpu's, on a 4-utterance corpus from scripts/make_wav_corpus.py at
dim 16, hidden 24 and 3 steps, on the CPU (`--device cpu`).

Parity: a JAX `train` checkpoint, restored with aligner_tpu's
`restore_params` and converted with `models/convert.py`, is written as a
port checkpoint beside JAX's config.json; both `align` commands then write
the same durations.jsonl and TextGrids. Port `train` at the same flags
writes JAX's config.json.
"""
import contextlib
import io
import json
import os
import runpy
import shutil
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.io import wavfile

from aligner_tpu import cli as jcli
from aligner_tpu_torch import cli as tcli
from aligner_tpu_torch import score_wav

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--dim", "16", "--hidden", "24", "--batch-size", "4"]


def make_corpus(root, *flags):
    subprocess.run([sys.executable,
                    os.path.join(REPO, "scripts", "make_wav_corpus.py"),
                    str(root), "--utterances", "4", *flags],
                   check=True, capture_output=True, timeout=120)
    return str(root)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("wav") / "c", "--seed", "0")


@pytest.fixture(scope="module")
def phone_corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("wav") / "p", "--seed", "1",
                       "--pause-prob", "0.4", "--transcripts", "phone")


def train(cli, corpus, ckpt, *flags, steps=3):
    argv = ["train", corpus, "--steps", str(steps), "--checkpoint-dir",
            str(ckpt), *SMALL, *flags]
    if cli is tcli:
        argv += ["--device", "cpu"]
    cli.main(argv)
    return str(ckpt)


def align(cli, corpus, ckpt, out_dir, *flags):
    os.makedirs(out_dir, exist_ok=True)
    out = os.path.join(out_dir, "durations.jsonl")
    argv = ["align", corpus, "--checkpoint-dir", str(ckpt), "--output", out,
            "--textgrid-dir", os.path.join(out_dir, "tg"), "--batch-size",
            "4", *flags]
    if cli is tcli:
        argv += ["--device", "cpu"]
    cli.main(argv)
    return out


def records(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def port_checkpoint_from_jax(jax_ckpt, port_ckpt):
    """Restore the JAX run's parameters, convert them and save them as the
    port's checkpoint of the same step, beside JAX's config.json."""
    from aligner_tpu.train import restore_params
    from aligner_tpu.train.checkpoint import latest_step
    from aligner_tpu_torch.models.convert import flax_to_state_dict

    args = jcli.build_parser().parse_args(
        ["align", "unused", "--checkpoint-dir", jax_ckpt])
    _, model = jcli._model_from_checkpoint(args)
    cfg = model.config
    B, T_x, T_y = 1, 8, 32
    params0 = model.init(jax.random.PRNGKey(0),
                         jnp.ones((B, T_x), jnp.int32),
                         jnp.zeros((B, T_y, cfg.n_mels)),
                         jnp.array([T_x]), jnp.array([T_y]))["params"]
    params = restore_params(jax_ckpt, params0)
    _, port_model = tcli._model_from_checkpoint(args, torch.device("cpu"))
    state = flax_to_state_dict(jax.tree.map(np.asarray, params),
                               port_model.config)
    step = latest_step(jax_ckpt)
    os.makedirs(os.path.join(port_ckpt, str(step)))
    torch.save({"model": state, "optimizer": {}, "step": step,
                "has_schedule": False},
               os.path.join(port_ckpt, str(step), "state.pt"))
    shutil.copy(os.path.join(jax_ckpt, "config.json"), port_ckpt)
    return model, params


def jax_lattice_through_port_mas(model, params, corpus, jax_ckpt, utt_id):
    """JAX's durations of one utterance from JAX's lattice, decoded by the
    port's MAS (the skip Viterbi for a pause model)."""
    from aligner_tpu.data import load_corpus, pad_batch
    from aligner_tpu.train.checkpoint import load_run_config
    from aligner_tpu_torch.ops.mas import mas_path_frame_major
    from aligner_tpu_torch.ops.skip_dp import (mas_skip_path_frame_major,
                                               split_state_durations)

    tok, _ = jcli._model_from_checkpoint(jcli.build_parser().parse_args(
        ["align", corpus, "--checkpoint-dir", jax_ckpt]))
    mel_cfg = jcli._mel_config_from_record(load_run_config(jax_ckpt))
    items = [it for it in load_corpus(corpus, tokenizer=tok,
                                      mel_config=mel_cfg)
             if it["utt_id"] == utt_id]
    b = {k: jnp.asarray(v) for k, v in pad_batch(items).items()}
    out = model.apply({"params": params}, b["tokens"], b["mel"],
                      b["text_lengths"], b["mel_lengths"])
    logp = torch.from_numpy(np.array(out["logp_with_prior"]))
    tl = torch.from_numpy(np.array(b["text_lengths"]))
    ml = torch.from_numpy(np.array(b["mel_lengths"]))
    if model.config.model_pauses:
        path = mas_skip_path_frame_major(
            logp, tl, ml, enter_cost=model.config.pause_enter_cost)
        durs, _ = split_state_durations(path.sum(1))
    else:
        durs = mas_path_frame_major(logp, tl, ml).sum(1)
    return durs[0, :int(tl[0])].to(torch.int64).tolist()


PARITY = {
    "plain": ("corpus", []),
    "pauses": ("corpus", ["--model-pauses", "--pause-bias-anneal", "2"]),
    "phone_levers": ("phone_corpus", ["--tokenizer", "phone", "--recon",
                                      "--mel-hop", "128", "--mel-win", "512",
                                      "--no-mel-center"]),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_align_and_config_match_jax(request, tmp_path, case):
    corpus_name, flags = PARITY[case]
    corpus = request.getfixturevalue(corpus_name)
    jax_ckpt = train(jcli, corpus, tmp_path / "jax", *flags)
    jax_out = align(jcli, corpus, jax_ckpt, tmp_path / "jax_align")
    model, params = port_checkpoint_from_jax(jax_ckpt, tmp_path / "port")
    port_out = align(tcli, corpus, tmp_path / "port", tmp_path / "port_align")

    want, got = records(jax_out), records(port_out)
    assert [r["utt_id"] for r in got] == [r["utt_id"] for r in want]
    assert len(got) == 4
    for g in got:
        assert sum(g["durations"]) + sum(g.get("pauses", [])) == \
            g["n_frames"]
    # The log-mels agree to 1e-4, not bit for bit. Should a record
    # differ, say whether JAX's own lattice through the port's MAS gives
    # JAX's durations (a near-tie moved by the front end) or not (a fault
    # of the decode).
    differ = {w["utt_id"]: jax_lattice_through_port_mas(
                  model, params, corpus, jax_ckpt, w["utt_id"])
              == w["durations"]
              for g, w in zip(got, want) if g != w}
    assert not differ, f"records differ (JAX lattice decoded alike: {differ})"
    for name in sorted(os.listdir(tmp_path / "jax_align" / "tg")):
        assert (tmp_path / "port_align" / "tg" / name).read_bytes() == \
            (tmp_path / "jax_align" / "tg" / name).read_bytes(), name

    # port `train` at the same flags writes the same config.json
    port_ckpt = train(tcli, corpus, tmp_path / "port_train", *flags)
    with open(os.path.join(jax_ckpt, "config.json")) as f:
        want_cfg = json.load(f)
    with open(os.path.join(port_ckpt, "config.json")) as f:
        got_cfg = json.load(f)
    assert got_cfg == want_cfg

    # the port's scorer prints the JAX script's line on the same files
    for out in (jax_out, port_out):
        assert score_line(corpus, out) == script_line(corpus, out)


def score_line(corpus, out, *flags):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        score_wav.main([corpus, out, *flags])
    return buf.getvalue()


def script_line(corpus, out, *flags):
    argv, cwd = sys.argv, os.getcwd()
    buf = io.StringIO()
    try:
        sys.argv = ["score_wav_alignments.py", corpus, out, *flags]
        os.chdir(REPO)
        with contextlib.redirect_stdout(buf):
            runpy.run_path(os.path.join(REPO, "scripts",
                                        "score_wav_alignments.py"),
                           run_name="__main__")
    finally:
        sys.argv = argv
        os.chdir(cwd)
    return buf.getvalue()


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory, corpus):
    return train(tcli, corpus, tmp_path_factory.mktemp("ck") / "ota",
                 steps=2)


@pytest.fixture(scope="module")
def mobo_ckpt(tmp_path_factory, corpus):
    return train(tcli, corpus, tmp_path_factory.mktemp("ck") / "mobo",
                 "--model", "mobo", "--max-duration", "16", steps=2)


def edited_copy(ckpt, tmp_path, edit):
    """A copy of the checkpoint whose config.json `edit` changes (or
    removes, when it returns None)."""
    dst = str(tmp_path / "edited")
    shutil.copytree(ckpt, dst)
    path = os.path.join(dst, "config.json")
    with open(path) as f:
        rec = edit(json.load(f))
    if rec is None:
        os.remove(path)
    else:
        with open(path, "w") as f:
            json.dump(rec, f)
    return dst


def set_model_config(**kw):
    def edit(rec):
        rec["model_config"].update(kw)
        return rec
    return edit


def blank_corpus(tmp_path, texts):
    root = tmp_path / "blank"
    os.makedirs(root / "wavs")
    for i, _ in enumerate(texts):
        wavfile.write(str(root / "wavs" / f"u{i}.wav"), 22050,
                      np.zeros(5512, np.int16))
    (root / "metadata.csv").write_text(
        "".join(f"u{i}|{t}\n" for i, t in enumerate(texts)))
    return str(root)


def error_argv(case, tmp_path, corpus, port_ckpt, mobo_ckpt):
    """(argv, exception, message) of each error path."""
    out = ["--output", str(tmp_path / "d.jsonl"), "--device", "cpu"]
    new = str(tmp_path / "new")
    train_argv = ["train", corpus, "--checkpoint-dir", new, "--steps", "1",
                  *SMALL, "--device", "cpu"]
    if case == "conflict":
        return (["align", corpus, "--checkpoint-dir", port_ckpt, *out,
                 "--dim", "32"], SystemExit, "conflict with the checkpoint")
    if case == "pre_config":
        ckpt = edited_copy(port_ckpt, tmp_path, lambda rec: None)
        return (["align", corpus, "--checkpoint-dir", ckpt, *out],
                SystemExit, "no config.json")
    if case == "pause_knobs_without_pauses":
        return (["align", corpus, "--checkpoint-dir", port_ckpt, *out,
                 "--pause-enter-cost", "-5.0"], SystemExit, "--model-pauses")
    if case == "pause_knobs_on_mobo":
        return (["align", corpus, "--checkpoint-dir", mobo_ckpt, *out,
                 "--pause-bias", "-1.0"], SystemExit, "OTA checkpoint")
    if case == "pauses_outside_ota":
        return ([*train_argv, "--model", "mobo", "--model-pauses"], SystemExit,
                "OTA capability")
    if case == "bfloat16_mobo":
        return ([*train_argv, "--model", "mobo", "--compute-dtype",
                 "bfloat16"], SystemExit, "wired for --model ota only")
    if case == "zero_tokens":
        root = blank_corpus(tmp_path, ["aa", "   "])
        return (["train", root, *train_argv[2:], "--tokenizer", "phone"],
                ValueError, "zero tokens")
    if case == "no_phone_symbols":
        root = blank_corpus(tmp_path, ["   "])
        return (["train", root, *train_argv[2:], "--tokenizer", "phone"],
                SystemExit, "no symbols")
    if case == "missing_metadata":
        return (["train", str(tmp_path), "--checkpoint-dir",
                 str(tmp_path / "c"), "--device", "cpu"], SystemExit,
                "metadata.csv")
    if case == "missing_checkpoint":
        return (["align", corpus, "--checkpoint-dir", "/nonexistent", *out],
                SystemExit, "checkpoint dir not found")
    if case == "unknown_family":
        ckpt = edited_copy(port_ckpt, tmp_path,
                           lambda rec: {**rec, "model_class": "Tacotron"})
        return (["align", corpus, "--checkpoint-dir", ckpt, *out],
                SystemExit, "drives the OTA/MoBo/RoMo")
    if case == "phone_vocab_missing":
        ckpt = edited_copy(port_ckpt, tmp_path,
                           lambda rec: {**rec, "tokenizer": "PhoneTokenizer"})
        return (["align", corpus, "--checkpoint-dir", ckpt, *out],
                SystemExit, "records no tokenizer_vocab")
    if case == "vocab_size":
        ckpt = edited_copy(port_ckpt, tmp_path,
                           set_model_config(vocab_size=99))
        return (["align", corpus, "--checkpoint-dir", ckpt, *out],
                SystemExit, "does not match the CharTokenizer")
    if case == "missing_step":
        return (["align", corpus, "--checkpoint-dir", port_ckpt, *out,
                 "--step", "7"], FileNotFoundError, "state.pt")
    if case in ("train_without_cuda", "align_without_cuda"):
        argv = (train_argv[:-2] if case.startswith("train") else
                ["align", corpus, "--checkpoint-dir", port_ckpt, *out[:2]])
        return argv, SystemExit, "no CUDA device"
    raise AssertionError(case)


ERRORS = ["conflict", "pre_config", "pause_knobs_without_pauses",
          "pause_knobs_on_mobo", "pauses_outside_ota", "bfloat16_mobo",
          "zero_tokens",
          "no_phone_symbols", "missing_metadata", "missing_checkpoint",
          "unknown_family", "phone_vocab_missing", "vocab_size",
          "missing_step", "train_without_cuda", "align_without_cuda"]


@pytest.mark.parametrize("case", ERRORS)
def test_cli_error_paths(tmp_path, corpus, port_ckpt, mobo_ckpt, case):
    if case.endswith("without_cuda") and torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    argv, exc, message = error_argv(case, tmp_path, corpus, port_ckpt,
                                    mobo_ckpt)
    with pytest.raises(exc, match=message):
        tcli.main(argv)


def test_resume_keeps_the_phone_vocabulary(tmp_path, phone_corpus):
    """On --resume the phone vocabulary comes from config.json; a corpus
    symbol outside it is a loud error."""
    corpus = str(tmp_path / "c")
    shutil.copytree(phone_corpus, corpus)
    ckpt = train(tcli, corpus, tmp_path / "ck", "--tokenizer", "phone",
                 steps=2)
    with open(os.path.join(ckpt, "config.json")) as f:
        vocab0 = json.load(f)["tokenizer_vocab"]
    train(tcli, corpus, ckpt, "--tokenizer", "phone", "--resume", steps=3)
    with open(os.path.join(ckpt, "config.json")) as f:
        assert json.load(f)["tokenizer_vocab"] == vocab0
    assert sorted(int(d) for d in os.listdir(ckpt) if d.isdigit()) == [2, 3]
    wavfile.write(os.path.join(corpus, "wavs", "u9.wav"), 22050,
                  np.zeros(5512, np.int16))
    with open(os.path.join(corpus, "metadata.csv"), "a") as f:
        f.write("u9|ZZ QQ\n")
    with pytest.raises(SystemExit, match="outside the checkpoint"):
        train(tcli, corpus, ckpt, "--tokenizer", "phone", "--resume",
              steps=4)


def test_phone_vocab_follows_the_loaded_rows(tmp_path):
    root = tmp_path / "corpus"
    os.makedirs(root / "wavs")
    for u in (0, 1):  # u2's wav is missing
        wavfile.write(str(root / "wavs" / f"u{u}.wav"), 22050,
                      np.zeros(5512, np.int16))
    (root / "metadata.csv").write_text("u0|aa bb\nu1|cc dd\nu2|ee ff\n")
    for limit, phones in ((["--limit", "1"], ("aa", "bb")),
                          ([], ("aa", "bb", "cc", "dd"))):
        argv = ["train", str(root), "--tokenizer", "phone",
                "--checkpoint-dir", str(tmp_path / "c"), *limit]
        assert tcli._make_tokenizer(
            tcli.build_parser().parse_args(argv)).phones == phones
        assert jcli._make_tokenizer(
            jcli.build_parser().parse_args(argv)).phones == phones


def test_mel_levers_persist_and_align_step(tmp_path, corpus):
    """--mel-* levers land in config.json and `align` reuses them; `align
    --step` decodes the named saved step."""
    ck = train(tcli, corpus, tmp_path / "ck", "--mel-hop", "128",
               "--mel-win", "512", "--no-mel-center", steps=2)
    train(tcli, corpus, ck, "--mel-hop", "128", "--mel-win", "512",
          "--no-mel-center", "--resume", steps=4)
    with open(os.path.join(ck, "config.json")) as f:
        assert json.load(f)["mel"] == {"hop_length": 128, "n_fft": 512,
                                       "win_length": 512, "center": False}
    assert sorted(int(d) for d in os.listdir(ck) if d.isdigit()) == [2, 4]
    with open(os.path.join(corpus, "durations_truth.json")) as f:
        truth = json.load(f)
    outs = {}
    for step in ("2", "4"):
        outs[step] = records(align(tcli, corpus, ck, tmp_path / step,
                                   "--step", step))
        for r in outs[step]:
            # left-aligned 512-sample windows at hop 128: about twice the
            # hop-256 truth's frames
            want = sum(truth[r["utt_id"]]["durations"]) * 2
            assert abs(r["n_frames"] - want) <= 8
            assert sum(r["durations"]) == r["n_frames"]
    assert [r["n_frames"] for r in outs["2"]] == \
        [r["n_frames"] for r in outs["4"]]


@pytest.mark.parametrize("family", ["mobo", "romo"])
def test_boundary_search_families_train_and_align(tmp_path, phone_corpus,
                                                   family):
    flags = ["--model", family, "--max-duration", "16", "--tokenizer",
             "phone", "--lr-schedule", "cosine", "--warmup-steps", "1",
             "--grad-clip", "1.0", "--eval-split", "0.5"]
    if family == "romo":
        flags += ["--window", "12"]
    ck = train(tcli, phone_corpus, tmp_path / "ck", *flags)
    with open(os.path.join(ck, "config.json")) as f:
        cfg = json.load(f)
    assert cfg["model_class"] == {"mobo": "MoBo", "romo": "RoMo"}[family]
    assert cfg["model_config"]["use_recon"] is True
    recs = records(align(tcli, phone_corpus, ck, tmp_path / "out"))
    with open(os.path.join(phone_corpus, "metadata.csv")) as f:
        n_tokens = {line.split("|")[0]: len(line.split("|")[-1].split())
                    for line in f if line.strip()}
    assert len(recs) == 4
    for r in recs:
        assert "pauses" not in r
        assert len(r["durations"]) == n_tokens[r["utt_id"]]
        if family == "mobo":
            assert sum(r["durations"]) == r["n_frames"]
        else:
            # infeasible items fall back to rounded rough durations
            assert abs(sum(r["durations"]) - r["n_frames"]) <= \
                len(r["durations"])
    assert len(os.listdir(tmp_path / "out" / "tg")) == 4
    out = str(tmp_path / "out" / "durations.jsonl")
    assert json.loads(score_line(phone_corpus, out))["n"] == 4
