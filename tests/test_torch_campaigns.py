"""The port's quality campaigns and pause diagnostics against the JAX
package's scripts and records.

* `wav_rows`' groups equal the `run` lines of the JAX campaign scripts
  (seed, corpus flags, train flags, score flags), parsed from the .sh
  files, and every row finds its JAX row in docs/;
* `demo_rows`' 24 rows equal the `###` lines of
  docs/quality_campaign_tpu.jsonl and parse with the port's CLI;
* `--out` resume skips the rows that are done and writes nothing for a
  row that fails; one wav row runs end to end on the CPU;
* the diagnostics train the scripts' recipe (model config, corpus, step
  count, learning rate, binarisation schedule, pause-bias curriculum), and
  pause_error_diag runs end to end on the CPU with the script's keys;
* the diagnostics' classification equals scripts/pause_error_diag.py's and
  scripts/pause_swap_probe.py's: each script runs (loaded by path) with
  its model, training, decode and posteriors replaced by seeded numpy
  outputs, and the port's functions are given the same outputs.
"""
import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import re
import shlex
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import aligner_tpu.data as jdata
import aligner_tpu.models as jmodels
import aligner_tpu.ops.skip_dp as jskip
import aligner_tpu.train.loop as jloop
import aligner_tpu_torch.models.ota as tota
import aligner_tpu_torch.train.loop as tloop
from aligner_tpu_torch import cli, demo_rows, pause_error_diag, wav_rows
from aligner_tpu_torch import pause_swap_probe as probe

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def script_text(name):
    """A campaign script with its backslash continuations joined."""
    with open(os.path.join(REPO, "scripts", name)) as f:
        return f.read().replace("\\\n", " ")


def flag_map(tokens):
    """{flag: value, or True for a switch} of a flag list."""
    out, i = {}, 0
    while i < len(tokens):
        tok = tokens[i]
        assert tok.startswith("--"), tokens
        if i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            out[tok] = tokens[i + 1]
            i += 2
        else:
            out[tok] = True
            i += 1
    return out


def train_base(text, seed, **subst):
    """The flags of the script's `python -m aligner_tpu train` call, its
    corpus, checkpoint directory, --resume and "$@" left out."""
    call = re.search(r"python -m aligner_tpu train (.*?)\"\$@\"",
                     text).group(1)
    for k, v in subst.items():
        call = call.replace(k, v)
    toks = shlex.split(call.replace('"$seed"', str(seed))
                       .replace('"$SEED"', str(seed)))
    toks = toks[1:]                                  # the corpus
    flags = flag_map(toks)
    flags.pop("--checkpoint-dir")
    flags.pop("--resume")
    return flags


def port_train(row):
    seed = row.seed if row.train_seed is None else row.train_seed
    return flag_map(["--steps", "6000", *wav_rows.RECIPE, "--seed",
                     str(seed), *row.train])


def rows_of(group):
    return {(r.run, r.seed): r for r in wav_rows.ROWS if r.group == group}


def split_run(tokens):
    """score flags, train flags of a `run ... [score flags --] train`."""
    if "--" in tokens:
        i = tokens.index("--")
        return tokens[:i], tokens[i + 1:]
    return [], tokens


def test_round5_rows_are_the_scripts_run_lines():
    text = script_text("round5_campaign.sh")
    corpora = {m.group(1): (int(m.group(2)), tuple(shlex.split(m.group(3))))
               for m in re.finditer(r"^(\w+)=\$\(corpus (\d+)(.*)\)$", text,
                                    re.M)}
    want = {}
    for m in re.finditer(r"^for s in ([\d ]+); do\n\s*(run .*)$", text,
                         re.M):
        for s in m.group(1).split():
            want_line = m.group(2).replace("$s", s).replace(
                '"$(corpus %s)"' % s, f"corpus{s}")
            corpora[f"corpus{s}"] = (int(s), ())
            want[want_line.split()[1]] = want_line
    for m in re.finditer(r"^run (\w+) .*$", text, re.M):
        want[m.group(1)] = m.group(0)
    got = rows_of("round5")
    assert len(want) == 9
    for name, line in want.items():
        toks = shlex.split(line)
        corpus = corpora[toks[2].lstrip("$")]
        seed = int(toks[3])
        score, train = split_run(toks[4:])
        row = got[(name, seed)]
        assert (row.seed, row.corpus) == corpus, name
        assert tuple(score) == row.score, name
        assert port_train(row) == {**train_base(text, seed),
                                   **flag_map(train)}, name
        assert not row.reuses and not row.align and row.train_seed is None
        assert row.cite.startswith("scripts/round5_campaign.sh:")
    # hop128_tight_s0 scores hop128_s0's alignments again
    m = re.search(r"ck_hop128_s0/durations\.jsonl\" (.*?)\)", text)
    tight = got[("hop128_tight_s0", 0)]
    assert tight.reuses == "hop128_s0" and not tight.align
    assert tight.score == tuple(shlex.split(m.group(1)))
    assert len(got) == 10


def pause_corpus_flags(text):
    m = re.search(r"make_wav_corpus\.py \"\$CORPUS\" (.*)$", text, re.M)
    flags = flag_map(shlex.split(m.group(1)))
    flags.pop("--seed")
    return tuple(x for k, v in flags.items() for x in (k, v))


def test_wav_pause_rows_are_the_scripts_run_lines():
    text = script_text("wav_pause_campaign.sh")
    steps = re.search(r"STEPS=\$\{3:-(\d+)\}", text).group(1)
    base = {"$((STEPS / 2))": str(int(steps) // 2),
            "$((STEPS / 3))": str(int(steps) // 3), '"$STEPS"': steps}
    prefix = re.search(r"run=(\w+)\$\{name\}", text).group(1)
    runs = {prefix + m.group(1): shlex.split(m.group(2))
            for m in re.finditer(r"^run (\w+)(.*)$", text, re.M)}
    got = rows_of("wav_pauses")
    seeds = sorted({s for _, s in got})
    assert seeds == [0, 1]
    assert len(got) == len(runs) * len(seeds) == 4
    for (name, seed), row in got.items():
        assert row.corpus == pause_corpus_flags(text)
        assert row.score == () and not row.reuses
        assert port_train(row) == {**train_base(text, seed, **base),
                                   **flag_map(runs[name])}, name


def test_lever_rows_are_the_scripts_run_lines():
    text = script_text("wav_pause_levers.sh")
    runs = {"pa_" + m.group(1): split_run(shlex.split(m.group(2)))
            for m in re.finditer(r"^run (\w+)(.*)$", text, re.M)}
    assert '"pa_$name"' in text
    got = rows_of("wav_pause_levers")
    assert len(got) == len(runs) * 2 == 4
    for (name, seed), row in got.items():
        score, train = runs[name]
        assert row.corpus == pause_corpus_flags(text)
        assert row.score == tuple(score), name
        assert port_train(row) == {**train_base(text, seed),
                                   **flag_map(train)}, name


def test_enter_cost_rows_are_the_sweep():
    text = script_text("enter_cost_sweep.sh")
    costs = re.search(r"for cost in ([-\d. ]+); do", text).group(1).split()
    assert '--pause-enter-cost "$cost"' in text
    got = [r for r in wav_rows.ROWS if r.group == "enter_cost"]
    assert [r.align for r in got] == [("--pause-enter-cost", c)
                                      for c in costs]
    source = rows_of("wav_pauses")[("wav_pauses_pauseaware", 0)]
    for r in got:
        assert (r.reuses, r.seed, r.corpus) == (source.run, 0,
                                                source.corpus)
    # JAX swept the seed-0 pause-aware checkpoint of the pause campaign
    with open(os.path.join(REPO, "docs", "enter_cost_sweep_tpu.jsonl")) as f:
        corpora = {json.loads(line)["corpus"] for line in f}
    with open(os.path.join(REPO, "docs",
                           "wav_pause_campaign_tpu.jsonl")) as f:
        aware = [json.loads(line) for line in f]
    assert corpora == {r["corpus"] for r in aware
                       if r["run"] == source.run and r["seed"] == 0}


def test_seed0_spread_is_baseline_s0_at_three_train_seeds_and_again():
    got = [r for r in wav_rows.ROWS if r.group == "seed0_spread"]
    assert [(r.run, r.seed, r.train_seed) for r in got] == [
        ("baseline_s0", 0, None), ("baseline_s0_init1", 0, 1),
        ("baseline_s0_init2", 0, 2), ("baseline_s0_again", 0, None)]
    for r in got:
        assert (r.corpus, r.train, r.score, r.align, r.reuses) == (
            (), (), (), (), None)
    jax_row = wav_rows.jax_row(got[0])
    assert (jax_row["boundary_f1_tol2"], jax_row["duration_mae"]) == (
        0.905, 2.18)


@pytest.mark.parametrize("row", wav_rows.ROWS, ids=lambda r: "-".join(
    map(str, r.key)))
def test_every_wav_row_finds_its_jax_row(row):
    want = wav_rows.jax_row(row)
    assert "boundary_f1_tol2" in want
    if row.group not in ("seed0_spread", "enter_cost"):
        assert (want["run"], want["seed"]) == (row.run, row.seed)
    flags = dict(zip(row.score[::2], row.score[1::2]))
    assert want.get("truth_scale", 1) == int(flags.get("--truth-scale", 1))
    assert want.get("tolerance", 2) == int(flags.get("--tolerance", 2))


def test_select_and_plan():
    assert [r.run for r in wav_rows.select("baseline_s1,phone_s0")] == [
        "baseline_s1", "phone_s0"]
    assert len(wav_rows.select("wav_pauses")) == 4
    with pytest.raises(SystemExit):
        wav_rows.select("round6")
    # a row that reuses another's checkpoint runs after it, and the
    # source's line is written only if it is not done
    rows = wav_rows.select("sweep_ec4")
    plan = wav_rows.plan(rows, set())
    assert [(r.run, w) for r, w in plan] == [
        ("wav_pauses_pauseaware", True), ("sweep_ec4", True)]
    done = {("wav_pauses", "wav_pauses_pauseaware", 0)}
    plan = wav_rows.plan(wav_rows.select("wav_pauses,enter_cost"), done)
    source = rows_of("wav_pauses")[("wav_pauses_pauseaware", 0)]
    assert [r.run for r, _ in plan[:3]] == ["wav_pauses_pauseblind",
                                            "wav_pauses_pauseaware",
                                            "wav_pauses_pauseblind"]
    assert plan[3] == (source, False)
    assert [r.group for r, w in plan[4:] if w] == ["enter_cost"] * 8
    assert len(plan) == 12
    assert wav_rows.plan(rows, {r.key for r in rows}) == []


def fake_record(row):
    return {"group": row.group, "run": row.run, "seed": row.seed,
            "boundary_f1_tol2": 0.5, "n": 8}


def test_wav_rows_resume_skips_done_rows_and_a_failing_row_writes_nothing(
        tmp_path, monkeypatch):
    out = tmp_path / "rows.jsonl"
    ran = []

    def run(self, row):
        ran.append(row.run)
        if row.run == "baseline_s2":
            raise RuntimeError("boom")
        return fake_record(row)

    monkeypatch.setattr(wav_rows.Runner, "run", run)
    args = ["--rows", "baseline_s1", "--out", str(out), "--device", "cpu"]
    wav_rows.main(args)
    wav_rows.main(args)
    assert ran == ["baseline_s1"]
    lines = out.read_text().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line["jax"] == wav_rows.jax_row(wav_rows.select("baseline_s1")[0])
    assert line["f1_diff"] == round(0.5 - 0.963, 3)
    with pytest.raises(RuntimeError, match="boom"):
        wav_rows.main(["--rows", "baseline_s2", "--out", str(out),
                       "--device", "cpu"])
    assert out.read_text().splitlines() == lines


def test_one_wav_row_end_to_end_on_the_cpu(tmp_path):
    out = tmp_path / "rows.jsonl"
    wav_rows.main(["--rows", "win512_s0", "--steps", "3", "--utterances",
                   "8", "--device", "cpu", "--out", str(out)])
    (line,) = [json.loads(x) for x in out.read_text().splitlines()]
    assert (line["group"], line["run"], line["seed"], line["steps"]) == (
        "round5", "win512_s0", 0, 3)
    assert line["n"] == 8 and line["device"] == "cpu"
    for key in ("boundary_f1_tol2", "duration_mae", "duration_exact",
                "load_s", "train_s", "align_s", "train_seed"):
        assert key in line, key
    assert line["jax"]["boundary_f1_tol2"] == 0.888


def test_demo_rows_are_the_jax_records_lines():
    with open(os.path.join(REPO, demo_rows.JAX_ROWS)) as f:
        runs = [line[4:].strip() for line in f if line.startswith("### ")]
    assert list(demo_rows.DEMOS) == runs
    assert len(runs) == 24
    assert set(demo_rows.jax_rows()) == set(runs)


def test_quality_campaign2_runs_are_demo_rows():
    text = script_text("quality_campaign2.sh")
    body = text[text.index("for s in 0 1 2; do"):]
    runs = []
    for m in re.finditer(r"^for s in ([\d ]+); do\n\s*run (.*)\ndone", body,
                         re.M):
        runs += [m.group(2).replace('"$s"', s) for s in m.group(1).split()]
    runs += [m.group(1) for m in re.finditer(r"^run (.*)$", body, re.M)]
    assert len(runs) == 15
    assert set(runs) <= set(demo_rows.DEMOS)


@pytest.mark.parametrize("run", demo_rows.DEMOS)
def test_demo_row_parses_with_the_port_cli(run):
    argv = demo_rows.demo_argv(run)
    args = cli.build_parser().parse_args([*argv, "--device", "cpu"])
    assert args.cmd == argv[0]
    assert args.seed == demo_rows.seed_of(run)
    assert args.steps == int(argv[argv.index("--steps") + 1])
    assert demo_rows.demo_argv(run, 20)[argv.index("--steps") + 1] == "20"


def test_demo_rows_resume_and_jax_comparison(tmp_path, monkeypatch):
    out = tmp_path / "demos.jsonl"
    jax_rows = demo_rows.jax_rows()
    ran = []

    def run_demo(argv, device):
        ran.append(" ".join(argv))
        if argv[0] == "demo-mobo":
            raise RuntimeError("boom")
        run = demo_rows.DEMOS[[demo_rows.demo_argv(r) for r in
                               demo_rows.DEMOS].index(argv)]
        return jax_rows[run], 1.0

    monkeypatch.setattr(demo_rows, "run_demo", run_demo)
    demo_rows.main(["--rows", "0,2", "--out", str(out), "--device", "cpu"])
    demo_rows.main(["--rows", "0-2", "--out", str(out), "--device", "cpu"])
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert [x["run"] for x in lines] == [demo_rows.DEMOS[i]
                                         for i in (0, 2, 1)]
    assert ran == [demo_rows.DEMOS[i] for i in (0, 2, 1)]
    assert lines[0]["f1_diff"] == 0.0
    assert lines[0]["jax_seed_range"] == [0.958, 0.972]
    assert lines[1]["jax_f1"] == 0.996 and lines[1]["steps"] == 600
    before = out.read_text()
    with pytest.raises(RuntimeError, match="boom"):
        demo_rows.main(["--rows", "5", "--out", str(out), "--device",
                        "cpu"])
    assert out.read_text() == before


def test_a_jax_record_of_another_demo_is_not_compared():
    run = "demo-romo --steps 600 --hard --seed 0"
    jax_rows = demo_rows.jax_rows()
    assert jax_rows[run]["demo"] == "pauses"
    line = demo_rows.line_of(run, 600, jax_rows["demo-romo --steps 600 "
                                                "--seed 0"], 1.0, "cpu",
                             jax_rows)
    assert line["jax_demo_differs"] and "f1_diff" not in line
    assert line["jax_seed_range"] == []


# ---------------------------------------------------------------- diagnostics


def load_script(name):
    spec = importlib.util.spec_from_file_location(
        f"_script_{name}", os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def perturbed(item, rng):
    """Seeded predictions near an item's truth: pauses moved one gap over,
    dropped, lengthened or made up, durations off by a frame."""
    td = np.asarray(item["durations"])
    tp = np.asarray(item["pause_durations"])
    pp = tp.copy()
    for g in range(len(tp)):
        r = rng.random()
        h = g + 1 if g + 1 < len(tp) else g - 1
        if r < 0.3 and tp[g] >= 2 and tp[h] < 2 and pp[h] < 2:
            pp[h], pp[g] = pp[g], rng.integers(0, 2)
        elif r < 0.45:
            pp[g] = rng.integers(0, 7)
    pd = np.maximum(td + rng.integers(-1, 2, len(td)), 1)
    return pd, pp


class FakeOutputs:
    """Seeded per-batch outputs of the model, the decode sweep and the
    posteriors, shared by the JAX script (through its fakes) and the
    port's functions."""

    def __init__(self, corpus, batches, enter_costs=(0.0,)):
        self.corpus, self.batches = corpus, batches
        self.per_batch = []
        rng = np.random.default_rng(7)
        for k, b in enumerate(batches):
            B, T_x = b["tokens"].shape
            T_y = b["mel"].shape[1]
            d = np.zeros((B, T_x), np.int32)
            p = np.zeros((B, T_x + 1), np.int32)
            dec = {c: (np.zeros((B, T_x), np.float32),
                       np.zeros((B, T_x + 1), np.float32))
                   for c in enter_costs}
            gamma = np.zeros((B, T_y, 2 * T_x + 1), np.float32)
            for i, item in pause_error_diag.batch_rows(corpus, b):
                t_x = len(item["tokens"])
                d[i, :t_x], p[i, :t_x + 1] = perturbed(item, rng)
                for c in enter_costs:
                    dd, pp = perturbed(item, rng)
                    dec[c][0][i, :t_x], dec[c][1][i, :t_x + 1] = dd, pp
                gamma[i, 0, :2 * t_x + 1] = rng.exponential(
                    2.0, 2 * t_x + 1)
            self.per_batch.append((d, p, dec, gamma, T_y))

    def apply(self, variables, tokens, mel, tl, ml):
        k = self.index(tokens)
        d, p, _, _, T_y = self.per_batch[k]
        B, T_x = d.shape
        return {"durations": jnp.asarray(d),
                "pause_durations": jnp.asarray(p),
                "logp_with_prior": jnp.full((B, T_y, 2 * T_x + 1),
                                            float(k))}

    def index(self, tokens):
        tokens = np.asarray(tokens)
        return next(k for k, b in enumerate(self.batches)
                    if b["tokens"].shape == tokens.shape
                    and (b["tokens"] == tokens).all())

    def decode(self, lp, tx, ty, enter_cost=0.0):
        _, _, dec, _, _ = self.per_batch[int(np.asarray(lp)[0, 0, 0])]
        d, p = dec[enter_cost]
        states = np.zeros((d.shape[0], 2 * d.shape[1] + 1), np.float32)
        states[:, 1::2], states[:, 0::2] = d, p
        hard = np.zeros((*lp.shape[:2], states.shape[1]), np.float32)
        hard[:, 0] = states
        return jnp.asarray(hard)

    def posteriors(self, lp, tx, ty):
        gamma = self.per_batch[int(np.asarray(lp)[0, 0, 0])][3]
        return jnp.asarray(gamma), jnp.zeros(gamma.shape[0])


def jax_corpus(seed, hard):
    synth = dict(coarticulation=0.3, proto_overlap=0.5,
                 gain_var=0.3) if hard else {}
    cfg = jdata.SyntheticConfig(seed=seed, max_tokens=16, max_duration=7,
                                pause_prob=0.4, **synth)
    corpus = jdata.make_corpus(64, cfg)
    return corpus, list(jdata.bucket_batches(corpus, 16,
                                             shuffle_seed=seed))


def run_script(monkeypatch, name, argv, fakes):
    """The script's main under `argv` with its model, training and (for
    the probe) decode and posteriors replaced; its stdout lines."""
    class Model:
        def __init__(self, config):
            self.config = config

        apply = staticmethod(fakes.apply)

    monkeypatch.setattr(jmodels, "OTAAligner", Model)
    monkeypatch.setattr(jloop, "train_aligner", lambda *a, **k: (
        types.SimpleNamespace(params={}), []))
    monkeypatch.setattr(jskip, "mas_skip_path_frame_major", fakes.decode)
    monkeypatch.setattr(jskip, "skip_posteriors", fakes.posteriors)
    monkeypatch.setattr(jax, "jit", lambda f, **kw: f)
    monkeypatch.setattr(sys, "argv", [name, *argv])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        load_script(name).main()
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("seed,hard", [(0, True), (1, False)])
def test_error_classification_matches_the_script(monkeypatch, seed, hard):
    corpus, batches = jax_corpus(seed, hard)
    fakes = FakeOutputs(corpus, batches)
    argv = ["--steps", "30", "--seed", str(seed)] + (["--hard"] if hard
                                                     else [])
    (line,) = run_script(monkeypatch, "pause_error_diag", argv, fakes)
    want = json.loads(line)
    items = []
    for k, b in enumerate(batches[:2]):
        d, p = fakes.per_batch[k][:2]
        for i, item in pause_error_diag.batch_rows(corpus, b):
            t_x = len(item["tokens"])
            items.append((d[i][:t_x], p[i][:t_x + 1], item["durations"],
                          np.asarray(item["pause_durations"])))
    got = json.loads(json.dumps(pause_error_diag.classify(items)))
    assert got == {k: want[k] for k in got}
    assert got["n_swaps"] > 0 and got["matched_n"] > 0
    assert got["spurious_by_pred_len"] and got["missed_by_true_len"]


@pytest.mark.parametrize("seed", [0, 1])
def test_swap_probe_matches_the_script(monkeypatch, seed):
    costs, min_lens = [0.0, -0.5, -1.0, -2.0], [1, 2, 3]
    corpus, batches = jax_corpus(seed, True)
    fakes = FakeOutputs(corpus, batches, costs)
    want = run_script(monkeypatch, "pause_swap_probe",
                      ["--steps", "30", "--seed", str(seed), "--hard"],
                      fakes)
    per_setting, swaps = {}, []
    for k, b in enumerate(batches[:2]):
        _, p, dec, gamma, _ = fakes.per_batch[k]
        for i, item in pause_error_diag.batch_rows(corpus, b):
            t_x = len(item["tokens"])
            tp = np.asarray(item["pause_durations"])
            swaps += probe.swap_rows(tp, p[i][:t_x + 1],
                                     probe.pause_occupancy(gamma[i], t_x))
            scores = probe.lever_scores(
                {c: (d[i][:t_x], pp[i][:t_x + 1])
                 for c, (d, pp) in dec.items()},
                item["durations"], tp, min_lens)
            for key, s in scores.items():
                per_setting.setdefault(key, []).append(s)
    got = probe.report(probe.grid_means(per_setting), swaps, 30, seed, True)
    assert got == want
    assert len(swaps) > 0
    assert any(r["swap_gap_mass"] > r["true_gap_mass"] for r in swaps)
    assert any(r["swap_gap_mass"] < r["true_gap_mass"] for r in swaps)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_minlen_filter_matches_the_script(k):
    script = load_script("pause_swap_probe")
    rng = np.random.default_rng(k)
    for _ in range(20):
        t_x = int(rng.integers(1, 12))
        d = rng.integers(1, 8, t_x)
        p = rng.integers(0, 6, t_x + 1)
        want = script.minlen_filter(d, p, k)
        got = probe.minlen_filter(d, p, k)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


class Trained(Exception):
    """Raised by a recording train_aligner: the recipe is all a test needs."""


def recorded_recipe(monkeypatch, models, loop, run):
    """(model config, train_aligner's batches and keywords) that `run`
    builds, with `models.OTAAligner` and `loop.train_aligner` recording."""
    seen = {}

    class Model:
        def __init__(self, config, **kw):
            seen["config"] = config

    def train(model, batches, **kw):
        seen["batches"], seen["kw"] = batches, kw
        raise Trained

    monkeypatch.setattr(models, "OTAAligner", Model)
    monkeypatch.setattr(loop, "train_aligner", train)
    with pytest.raises(Trained):
        run()
    return seen


@pytest.mark.parametrize("name,argv", [
    ("pause_error_diag", ["--steps", "3000"]),
    ("pause_error_diag", ["--steps", "600", "--seed", "1", "--hard",
                          "--pause-prob", "0.3", "--enter-cost", "-1",
                          "--silence-anchor", "0.5", "--bin-start", "50",
                          "--bin-ramp", "70", "--anneal", "90"]),
    ("pause_swap_probe", ["--steps", "3000", "--seed", "1", "--hard"]),
])
def test_diagnostics_train_the_scripts_recipe(monkeypatch, name, argv):
    monkeypatch.setattr(sys, "argv", [name, *argv])
    want = recorded_recipe(monkeypatch, jmodels, jloop,
                           lambda: load_script(name).main())
    port = {"pause_error_diag": pause_error_diag, "pause_swap_probe": probe}
    got = recorded_recipe(monkeypatch, tota, tloop, lambda: port[name].main(
        [*argv, "--device", "cpu"]))
    assert dataclasses.asdict(got["config"]) == dataclasses.asdict(
        want["config"])
    assert len(got["batches"]) == len(want["batches"])
    for g, w in zip(got["batches"], want["batches"]):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(np.asarray(g[k]), np.asarray(w[k]))
    kw, jkw = dict(got["kw"]), dict(want["kw"])
    assert str(kw.pop("device")) == "cpu"
    assert kw.keys() == jkw.keys()
    steps = kw["steps"]
    for k in ("steps", "learning_rate", "bin_start", "bin_ramp", "seed"):
        assert kw[k] == jkw[k], k
    for step in range(0, steps + 2, max(steps // 40, 1)):
        assert kw["apply_extra"](step)["pause_bias"] == pytest.approx(
            float(jkw["apply_extra"](step)["pause_bias"]), abs=1e-6), step


def test_pause_error_diag_runs_on_the_cpu_with_the_scripts_keys(
        monkeypatch, capsys):
    corpus, batches = jax_corpus(0, False)
    (line,) = run_script(monkeypatch, "pause_error_diag", ["--steps", "3"],
                         FakeOutputs(corpus, batches))
    want = json.loads(line)
    monkeypatch.undo()
    pause_error_diag.main(["--steps", "3", "--device", "cpu"])
    (out,) = capsys.readouterr().out.splitlines()
    got = json.loads(out)
    assert got.keys() == want.keys() | {"device"}
    assert got["device"] == "cpu"
    for k in ("steps", "seed", "hard", "enter_cost", "silence_anchor",
              "bin_start", "bin_ramp", "anneal"):
        assert got[k] == want[k], k
    assert 0.0 <= got["token_boundary_f1_tol2"] <= 1.0
