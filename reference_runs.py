"""Quality rows on the CPU, run two ways, to tell a fault of the port from
an init draw: the JAX package's own recipe (`--by jax`), and the port's
pipeline started from the JAX package's init for the same seed (`--by
port`). Both take the same corpus, flags and batch order.

    JAX_PLATFORMS=cpu python reference_runs.py wav --rows mobo_s0 --by jax \
        [--train-seed 1] [--out rows.jsonl]
    JAX_PLATFORMS=cpu python reference_runs.py demo --rows 5 --by port \
        [--init-seed 1] [--out rows.jsonl]

`wav` rows are `aligner_tpu_torch.wav_rows.ROWS` (names or groups, as
there, at the recipe's `wav_rows.STEPS` steps on `wav_rows.UTTERANCES`
utterances): `--by jax` runs `python -m aligner_tpu train` and `align` in
this process and scores with scripts/score_wav_alignments.py; `--by port`
runs the port's `train` and `align` (`wav_rows.Runner`, `--device cpu`).
`demo` rows are `aligner_tpu_torch.demo_rows.DEMOS` indices, each at its
own `--steps`: `--by jax` runs `python -m aligner_tpu <demo>`, `--by port`
the port's demo on the CPU. `--train-seed` (wav) and `--init-seed` (demo) replace the run's
training seed (init and batch order) on the same corpus.

The port's init: `from_jax_inits` replaces `reset_parameters` of
`OTAAligner`, `MoBoAligner` and `RoMoAligner` while the port runs, so
that each call from `train_aligner` loads, strictly, the params that the
JAX package's loop makes for the same invocation (`model.init` under
`PRNGKey(seed)` on the first batch, aligner_tpu/train/loop.py:74-77),
converted by `models.convert.flax_to_state_dict`. `jax_inits` records
those params by running the JAX CLI with its loop cut to no step. Nothing
in either package changes.

Each row prints one JSON line (appended to --out): the row, `by`, the
training seed, the scores and the seconds it took. `--by port --export
FILE` writes JAX's inits of the rows to FILE and runs nothing; `--by port
--inits FILE --device cuda` then runs the port from them where there is
no JAX (jax and the JAX package are imported only where a JAX run needs
them).

    python reference_runs.py walk durations.jsonl ...

counts the items of a MoBo `align` output whose boundary walk left the
grid, where the JAX package's index wraps and the port's clamps.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

from aligner_tpu_torch import cli as tcli
from aligner_tpu_torch import demo_rows, wav_rows
from aligner_tpu_torch.models.convert import flax_to_state_dict
from aligner_tpu_torch.models.mobo import MoBoAligner
from aligner_tpu_torch.models.ota import OTAAligner
from aligner_tpu_torch.models.romo import RoMoAligner

REPO = os.path.dirname(os.path.abspath(__file__))
PORT_MODELS = (OTAAligner, MoBoAligner, RoMoAligner)


def _jax():
    """jax and the JAX package's cli, models and train loop, imported on
    first use: a run of the port from saved inits needs neither."""
    import jax

    from aligner_tpu import cli, models
    from aligner_tpu.train import loop
    return jax, cli, models, loop


def prng_key(seed: int) -> np.ndarray:
    """The data of jax.random.PRNGKey(seed): threefry's two words, 0 and
    the seed's low 32 bits (jax's default, without 64-bit types)."""
    return np.array([0, seed & 0xFFFFFFFF], np.uint32)


@dataclasses.dataclass
class Init:
    """One init the JAX loop made: the model family, the PRNG key's data
    and the params as numpy arrays."""
    family: str
    key: np.ndarray
    params: dict


@contextlib.contextmanager
def recording_jax_inits():
    """Record the params of every `init` of the JAX package's
    OTAAligner, MoBoAligner and RoMoAligner, in call order: the train
    loop's (`create_train_state`) and the MoBo and RoMo demos' own. Each
    init runs under `jax.jit`: the same params bit for bit, in a fraction
    of the eager time (5.8 s against 20.4 s for a MoBo init on one CPU
    core)."""
    jax, _, jmodels, _ = _jax()
    inits: list[Init] = []
    reals = {cls: cls.init for cls in (jmodels.OTAAligner,
                                       jmodels.MoBoAligner,
                                       jmodels.RoMoAligner)}

    def record(real):
        def init(self, rngs, *args, **kwargs):
            variables = jax.jit(lambda r, *a: real(self, r, *a, **kwargs))(
                rngs, *args)
            inits.append(Init(type(self.config).__name__,
                              np.asarray(jax.random.key_data(rngs)),
                              jax.tree.map(np.asarray,
                                           variables["params"])))
            return variables
        return init

    for cls, real in reals.items():
        cls.init = record(real)
    try:
        yield inits
    finally:
        for cls, real in reals.items():
            cls.init = real


def jax_inits(argv: list[str]) -> list[Init]:
    """The inits of JAX's `cli.main(argv)`, its training loop cut to no
    step and no checkpoint (a demo then evaluates the init; its output is
    dropped). The MoBo and RoMo demos have a loop of their own, which
    runs."""
    _, jcli, _, jloop = _jax()
    real = jloop.train_aligner

    def no_step(model, batches, **kwargs):
        kwargs.update(steps=0, checkpoint_dir=None, eval_batches=None)
        return real(model, batches, **kwargs)

    with recording_jax_inits() as inits, \
            mock.patch.object(jloop, "train_aligner", no_step), \
            contextlib.redirect_stdout(io.StringIO()):
        jcli.main(argv)
    return inits


@contextlib.contextmanager
def from_jax_inits(inits: list[Init]):
    """While open, `reset_parameters(generator)` of the port's models
    loads the next of `inits` strictly instead of drawing: its family
    must be the model's and its key PRNGKey(generator's seed). A call
    without a generator (a model's construction) draws as before. Every
    init must be used by the end. Yields the list of the models loaded,
    in order."""
    queue, loaded = list(inits), []
    reals = {cls: cls.reset_parameters for cls in PORT_MODELS}

    def reset(self, generator=None):
        if generator is None:
            return reals[type(self)](self, None)
        if not queue:
            raise RuntimeError("no JAX init left for this model")
        init = queue.pop(0)
        family = type(self.config).__name__
        key = prng_key(generator.initial_seed())
        if init.family != family or not np.array_equal(init.key, key):
            raise RuntimeError(f"JAX init of {init.family} key {init.key} "
                               f"given to {family} key {key}")
        self.load_state_dict(flax_to_state_dict(init.params, self.config),
                             strict=True)
        loaded.append(self)

    for cls in PORT_MODELS:
        cls.reset_parameters = reset
    try:
        yield loaded
    finally:
        for cls, real in reals.items():
            cls.reset_parameters = real
    if queue:
        raise RuntimeError(f"{len(queue)} JAX inits were not used")


def jax_train_argv(row: wav_rows.Row, corpus: str, ckpt: str,
                   seed: int) -> list[str]:
    """The campaigns' `train` line of `row`, as wav_rows.Runner runs it
    (without --device)."""
    return ["train", corpus, "--checkpoint-dir", ckpt, "--steps",
            str(wav_rows.STEPS), *wav_rows.RECIPE, "--seed", str(seed),
            *row.train]


def score_script(corpus: str, out: str, flags) -> dict:
    """scripts/score_wav_alignments.py's line for the alignments."""
    proc = subprocess.run(
        [sys.executable, os.path.join("scripts", "score_wav_alignments.py"),
         corpus, out, *flags], cwd=REPO, check=True, capture_output=True,
        text=True, timeout=600)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec.pop("corpus", None)
    return rec


class JaxRunner(wav_rows.Runner):
    """wav_rows.Runner with the JAX package's `train` and `align`."""

    def run(self, row: wav_rows.Row) -> dict:
        jcli = _jax()[1]
        corpus = self.corpus(row)
        rec = {"group": row.group, "run": row.run, "seed": row.seed}
        if row.reuses:
            ckpt, out = self.made[(row.reuses, row.seed)]
        else:
            ckpt = os.path.join(self.work, f"ck_{row.run}_s{row.seed}")
            seed = row.seed if row.train_seed is None else row.train_seed
            t0 = time.perf_counter()
            jcli.main(jax_train_argv(row, corpus, ckpt, seed))
            rec.update(train_seed=seed, train_s=time.perf_counter() - t0)
            out = None
        if out is None or row.align:
            out = os.path.join(ckpt, f"durations_{row.run}.jsonl")
            jcli.main(["align", corpus, "--checkpoint-dir", ckpt, "--output",
                       out, *row.align])
        self.made[(row.run, row.seed)] = (ckpt, out)
        rec.update(score_script(corpus, out, row.score))
        return rec


def row_inits(row: wav_rows.Row, corpus: str) -> list[Init]:
    """JAX's inits for the row's `train` invocation."""
    seed = row.seed if row.train_seed is None else row.train_seed
    with tempfile.TemporaryDirectory() as ck:
        return jax_inits(jax_train_argv(row, corpus, ck, seed))


def row_name(row: wav_rows.Row) -> str:
    seed = row.seed if row.train_seed is None else row.train_seed
    return f"{row.run} s{row.seed} train {seed}"


class PortRunner(wav_rows.Runner):
    """wav_rows.Runner, each trained row from JAX's init for its
    invocation: made by the JAX package in this process, or read from
    `saved` ({row_name: inits}, `--inits`)."""

    def __init__(self, *args, saved: dict | None = None):
        super().__init__(*args)
        self.saved = saved

    def run(self, row: wav_rows.Row) -> dict:
        t0 = time.perf_counter()
        if row.reuses:
            return wav_rows.Runner.run(self, row)
        inits = (self.saved[row_name(row)] if self.saved is not None else
                 row_inits(row, self.corpus(row)))
        with from_jax_inits(inits):
            rec = wav_rows.Runner.run(self, row)
        rec["total_s"] = time.perf_counter() - t0
        return rec


def wav_main(args) -> None:
    rows = wav_rows.select(args.rows)
    if args.seeds is not None:
        keep = {int(x) for x in args.seeds.split(",")}
        rows = [r for r in rows if r.seed in keep]
    if args.train_seed is not None:
        rows = [r if r.reuses else
                dataclasses.replace(r, train_seed=args.train_seed)
                for r in rows]
    sizes = wav_rows.STEPS, wav_rows.UTTERANCES
    with tempfile.TemporaryDirectory() as work:
        if args.export:
            runner = wav_rows.Runner(work, *sizes, "cpu")
            save_inits({row_name(r): row_inits(r, runner.corpus(r))
                        for r in rows if not r.reuses}, args.export)
            return
        if args.by == "jax":
            runner = JaxRunner(work, *sizes, "cpu")
        else:
            runner = PortRunner(work, *sizes, args.device,
                                saved=load_inits(args.inits))
        for row in rows:
            if row.reuses and (row.reuses, row.seed) not in runner.made:
                raise SystemExit(f"{row.run} reuses {row.reuses}: name "
                                 f"both, {row.reuses} first")
            t0 = time.perf_counter()
            rec = runner.run(row)
            rec.update(by=args.by, wall_s=time.perf_counter() - t0,
                       jax_tpu=wav_rows.jax_row(row))
            if args.by == "port":
                rec["device"] = args.device
            wav_rows.append(args.out, rec)


def save_inits(inits: dict[str, list[Init]], path: str) -> None:
    torch.save({k: [dataclasses.asdict(i) for i in v]
                for k, v in inits.items()}, path)


def load_inits(path: str | None) -> dict[str, list[Init]] | None:
    if path is None:
        return None
    return {k: [Init(**i) for i in v]
            for k, v in torch.load(path, weights_only=False).items()}


def demo_main(args) -> None:
    saved, exported = load_inits(args.inits), {}
    for i in demo_rows.parse_rows(args.rows):
        run = demo_rows.DEMOS[i]
        argv = demo_rows.demo_argv(run)
        if args.init_seed is not None:
            argv += ["--init-seed", str(args.init_seed)]
        if args.export:
            exported[" ".join(argv)] = jax_inits(argv)
            continue
        t0 = time.perf_counter()
        if args.by == "jax":
            proc = subprocess.run([sys.executable, "-m", "aligner_tpu", *argv],
                                  cwd=REPO, check=True, capture_output=True,
                                  text=True, timeout=6 * 3600)
            text = proc.stdout
        else:
            inits = (saved[" ".join(argv)] if saved is not None else
                     jax_inits(argv))
            buf = io.StringIO()
            with from_jax_inits(inits), contextlib.redirect_stdout(buf):
                tcli.main([*argv, "--device", args.device])
            text = buf.getvalue()
        result = json.loads(text.strip().splitlines()[-1])
        wav_rows.append(args.out, {
            "group": "demo", "run": run, "by": args.by,
            "init_seed": (demo_rows.seed_of(run) if args.init_seed is None
                          else args.init_seed),
            "steps": int(argv[argv.index("--steps") + 1]),
            "result": result, "f1": demo_rows.f1_of(result),
            "wall_s": time.perf_counter() - t0,
            "jax_tpu_f1": demo_rows.f1_of(demo_rows.jax_rows()[run]),
            **({"device": args.device} if args.by == "port" else {})})
    if args.export:
        save_inits(exported, args.export)


def walk_exits(path: str) -> dict:
    """The items of a MoBo `align` output whose boundary walk left the
    grid: the walk reads token i's duration at frame n_frames minus the
    durations of the tokens after it, so it leaves where the durations
    of tokens 1.. sum past n_frames (the JAX package's index wraps there,
    the port's clamps; before it both read the same cells)."""
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    out = [r["utt_id"] for r in recs
           if sum(r["durations"][1:]) > r["n_frames"]]
    return {"alignments": path, "items": len(recs), "left_grid": out}


def main(argv=None):
    ap = argparse.ArgumentParser("reference_runs")
    sub = ap.add_subparsers(dest="kind", required=True)
    for kind in ("wav", "demo"):
        p = sub.add_parser(kind)
        p.add_argument("--rows", required=True,
                       help="wav: wav_rows groups or run names; demo: "
                            "demo_rows indices, as 0,5-7")
        p.add_argument("--by", choices=("jax", "port"), required=True)
        p.add_argument("--out", default=None)
        p.add_argument("--device", default="cpu",
                       help="--by port: the port's device")
        p.add_argument("--export", default=None,
                       help="--by port: write JAX's inits of the rows to "
                            "this file and run nothing")
        p.add_argument("--inits", default=None,
                       help="--by port: take JAX's inits from this file "
                            "(written by --export; no JAX needed)")
        if kind == "wav":
            p.add_argument("--train-seed", type=int, default=None,
                           help="`train --seed` on the row's corpus")
            p.add_argument("--seeds", default=None,
                           help="only the rows of these corpus seeds, as "
                                "0,1")
        else:
            p.add_argument("--init-seed", type=int, default=None,
                           help="`--init-seed` on the row's corpus")
    p = sub.add_parser("walk", help="count the items of MoBo alignments "
                                    "whose boundary walk left the grid")
    p.add_argument("alignments", nargs="+")
    args = ap.parse_args(argv)
    if args.kind == "wav":
        wav_main(args)
    elif args.kind == "demo":
        demo_main(args)
    else:
        for path in args.alignments:
            print(json.dumps(walk_exits(path)))


if __name__ == "__main__":
    main()
