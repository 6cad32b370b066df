"""Command-line interface of the port (`aligner-tpu-torch`).

    python -m aligner_tpu_torch train <corpus> --checkpoint-dir DIR
                                      [--model ota|mobo|romo] [--steps N]
                                      [--tokenizer char|phone] ...
                                      [--device cuda|cpu]
    python -m aligner_tpu_torch align <corpus> --checkpoint-dir DIR
                                      [--output durations.jsonl]
                                      [--textgrid-dir DIR] [--step N] ...
    python -m aligner_tpu_torch demo-ota [--steps N] [--batch-size B] ...
    python -m aligner_tpu_torch demo-pauses [--steps N] [--skip-blind] ...
    python -m aligner_tpu_torch demo-mobo [--steps N] [--max-duration D] ...
    python -m aligner_tpu_torch demo-romo [--steps N] [--window W] ...
    python -m aligner_tpu_torch bench-mas [--batch B] [--t-text N]
                                          [--t-mel N] [--route R|all]

`train` trains an aligner on an LJSpeech-layout wav corpus
(`metadata.csv` + `wavs/`): log-mels from `ops/mel.py`, the char or phone
tokenizer, bucketed batches, checkpoints and `config.json` in the JAX
package's schema. `align` rebuilds the model from a checkpoint's
`config.json` and writes one `durations.jsonl` record per utterance, and
Praat TextGrids on request. `demo-ota` trains the OTA aligner on the
synthetic corpus (known ground-truth durations) and prints duration
accuracy and boundary F1 as one JSON line. `demo-pauses` trains the
pause-aware aligner and the pause-blind one on a corpus with
un-transcribed silences and prints their boundary and pause metrics as
one JSON line. `demo-mobo` trains the MoBo boundary-search aligner on one
synthetic batch with the reconstruction objective and prints the quality
of its hard boundaries; `demo-romo` trains the RoMo aligner (rough OTA
anchors, then a windowed MoBo refinement) and prints the rough and the
refined stage's duration quality. `bench-mas` gates and times the batched
MAS routes and prints one JSON line per route (`bench_mas.py`). All have
the flags and the flow of aligner_tpu's subcommands of the same names,
and run on `--device` (default `cuda`, which raises where no GPU is
present; `--device cpu` runs every kernel's plain version).
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch


def _common(p):
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--utterances", type=int, default=64)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--checkpoint-dir", default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--init-seed", type=int, default=None,
                   help="training init/shuffle seed (default: --seed); "
                        "decouples optimisation variance from the "
                        "corpus draw")
    # hard-corpus knobs (see data.SyntheticConfig): coarticulated
    # boundaries, confusable prototype families, speaker gain/offset
    p.add_argument("--hard", action="store_true",
                   help="hard-corpus preset (coarticulation 0.3, "
                        "proto-overlap 0.5, gain-var 0.3)")
    p.add_argument("--coarticulation", type=float, default=None)
    p.add_argument("--proto-overlap", type=float, default=None)
    p.add_argument("--gain-var", type=float, default=None)
    p.add_argument("--max-tokens", type=int, default=None,
                   help="override the demo's max tokens per utterance "
                        "(longer utterances)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; there "
                        "is no fallback to the CPU)")


def _recon_mse(soft_alignment, protos, b, n_mels, feasible=None):
    """Per-frame mel reconstruction MSE through alignment posteriors, the
    auxiliary that pins boundaries in the MoBo-family demos (marginal
    NLLs alone only shape energies). `feasible` ([B] bool) gates items
    whose posteriors are sentinels (RoMo: no boundary sequence fits the
    refinement window)."""
    T_y = b["mel"].shape[1]
    recon = torch.bmm(soft_alignment, protos[b["tokens"]])
    m = (torch.arange(T_y, device=recon.device)[None, :, None]
         < b["mel_lengths"][:, None, None])
    if feasible is not None:
        m = m & feasible[:, None, None]
    return (torch.sum(torch.where(m, (recon - b["mel"]) ** 2, 0.0))
            / m.sum().clamp(min=1) / n_mels)


def _init_seed(args):
    return args.seed if args.init_seed is None else args.init_seed


def _synth_kwargs(args):
    kw = {}
    if getattr(args, "hard", False):
        kw.update(coarticulation=0.3, proto_overlap=0.5, gain_var=0.3)
    for name in ("coarticulation", "proto_overlap", "gain_var"):
        v = getattr(args, name, None)
        if v is not None:
            kw[name] = v
    return kw


def _device(args) -> torch.device:
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"--device {args.device}: no CUDA device is "
                         "available (pass --device cpu to run the plain "
                         "versions of the kernels on the CPU)")
    return device


def build_parser():
    ap = argparse.ArgumentParser("aligner_tpu_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("demo-ota", help="train the OTA aligner on the "
                                        "synthetic corpus")
    _common(p)
    p.add_argument("--temperature", type=float, default=0.15)
    p.add_argument("--recon", action="store_true",
                   help="enable the per-frame reconstruction auxiliary")
    p = sub.add_parser("demo-mobo", help="train the MoBo aligner "
                                         "(reconstruction objective)")
    _common(p)
    p.add_argument("--max-duration", type=int, default=10)
    p = sub.add_parser(
        "demo-romo",
        help="train the RoMo aligner (rough OTA anchors + windowed MoBo "
             "refinement) and report rough vs refined duration quality")
    _common(p)
    p.add_argument("--max-duration", type=int, default=10)
    p.add_argument("--window", type=int, default=8,
                   help="refinement half-window around the rough anchors")
    p = sub.add_parser(
        "demo-pauses",
        help="implicit pause modeling on a silence-bearing corpus: "
             "train the pause-aware OTA aligner vs the pause-blind one "
             "and compare boundary/pause metrics")
    _common(p)
    p.add_argument("--temperature", type=float, default=0.15)
    p.add_argument("--pause-prob", type=float, default=0.4)
    p.add_argument("--skip-blind", action="store_true",
                   help="train only the pause-aware model")
    p.add_argument("--pause-prior", choices=("bridge", "inherit"),
                   default="bridge",
                   help="pause-state prior shape (see OTAConfig)")
    p.add_argument("--pause-bias", type=float, default=0.0,
                   help="per-frame pause occupancy cost (log-odds; "
                        "negative discourages pauses)")
    p.add_argument("--pause-bias-start", type=float, default=-3.0,
                   help="curriculum: initial pause bias, annealed "
                        "linearly to --pause-bias over "
                        "--pause-bias-anneal steps. Strongly negative "
                        "starts let tokens claim their frames before "
                        "pauses compete; set equal to --pause-bias to "
                        "disable the curriculum")
    p.add_argument("--pause-bias-anneal", type=int, default=None,
                   help="curriculum length in steps (default: "
                        "steps // 2)")
    p.add_argument("--bin-start", type=int, default=None,
                   help="binarisation CE start step (default steps//6)")
    p.add_argument("--bin-ramp", type=int, default=None,
                   help="binarisation CE ramp length (default steps//3)")
    p.add_argument("--pause-enter-cost", type=float, default=0.0,
                   help="log-cost per pause entered (a pause-count "
                        "prior; prefer it at serving time, see "
                        "SkipBatchAligner)")
    p = sub.add_parser(
        "bench-mas",
        help="MAS paths/s on one GPU, each route behind a bit-identity "
             "gate against the numpy oracle; one JSON line per route")
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--t-text", type=int, default=128)
    p.add_argument("--t-mel", type=int, default=1024)
    p.add_argument("--route", default="fused",
                   choices=("fused", "two_pass", "stage", "split", "chains2",
                            "chains4", "all"),
                   help="fused: the default single launch; two_pass: bits, "
                        "then the walk alone; stage, split, chainsK: the "
                        "two-pass variants (mas_path's form and chains); "
                        "all: every route, the default one last")
    p.add_argument("--device", default="cuda",
                   help="cuda (default; an error line and exit 1 where "
                        "there is no GPU) or cpu (the plain versions)")
    _train_parser(sub)
    _align_parser(sub)
    return ap


def _device_flag(p):
    p.add_argument("--device", default="cuda",
                   help="torch device for the mel front end and the model "
                        "(default cuda; there is no fallback to the CPU)")


def _train_parser(sub):
    p = sub.add_parser("train", help="train an aligner on a wav "
                                     "corpus (metadata.csv + wavs/)")
    p.add_argument("corpus", help="corpus root directory")
    p.add_argument("--model", choices=("ota", "mobo", "romo"),
                   default="ota",
                   help="alignment model family: 'ota' (forward-sum + "
                        "MAS binarisation; the default), 'mobo' "
                        "(monotonic boundary search under the "
                        "max-duration constraint), 'romo' (rough OTA "
                        "anchors + windowed MoBo refinement). Recorded in "
                        "config.json; `align` decodes whichever family "
                        "the checkpoint holds")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--limit", type=int, default=None,
                   help="max utterances to load")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--dim", type=int, default=192)
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--temperature", type=float, default=0.05)
    p.add_argument("--max-duration", type=int, default=32,
                   help="MoBo/RoMo boundary-search window D in frames; "
                        "ignored for --model ota")
    p.add_argument("--window", type=int, default=16,
                   help="RoMo refinement half-window around the rough "
                        "anchors; ignored for other models")
    p.add_argument("--compute-dtype", choices=("float32", "bfloat16"),
                   default="float32",
                   help="encoder/energy matmul precision (OTA only). "
                        "bfloat16 runs the encoders, the pairwise energy "
                        "product's inputs and the decoder in bfloat16; "
                        "the parameters, losses and DP lattices stay "
                        "float32. Persisted in config.json")
    p.add_argument("--tokenizer", choices=("char", "phone"),
                   default="char",
                   help="'phone' treats transcripts as space-separated "
                        "symbol sequences (ARPAbet/IPA phone corpora) "
                        "with a corpus-derived vocabulary persisted in "
                        "config.json; 'char' (default) aligns raw "
                        "characters")
    p.add_argument("--mel-hop", type=int, default=None,
                   help="mel hop length in samples (default 256 = "
                        "11.6 ms at 22.05 kHz). Persisted in config.json; "
                        "`align` reuses it")
    p.add_argument("--mel-win", type=int, default=None,
                   help="mel analysis window (= n_fft) in samples "
                        "(default 1024). Persisted in config.json")
    p.add_argument("--no-mel-center", action="store_true",
                   help="left-align analysis windows instead of "
                        "centering them. Persisted in config.json")
    p.add_argument("--recon", action="store_true",
                   help="enable the per-frame reconstruction auxiliary "
                        "(the flagship recipe pairs it with "
                        "--temperature 0.15)")
    p.add_argument("--warmup-steps", type=int, default=0)
    p.add_argument("--lr-schedule", choices=("constant", "cosine"),
                   default="constant")
    p.add_argument("--grad-clip", type=float, default=None,
                   help="clip gradients by global norm")
    p.add_argument("--eval-split", type=float, default=0.0,
                   help="fraction of batches held out for validation "
                        "(logged as val_* metrics)")
    p.add_argument("--resume", action="store_true",
                   help="continue from the latest checkpoint in "
                        "--checkpoint-dir (same model/optimizer flags "
                        "required)")
    p.add_argument("--seed", type=int, default=0,
                   help="init + batch-shuffle seed (recorded in "
                        "config.json)")
    p.add_argument("--bin-start", type=int, default=None,
                   help="binarisation CE start step (default steps//6)")
    p.add_argument("--bin-ramp", type=int, default=None,
                   help="binarisation CE ramp length (default steps//3)")
    p.add_argument("--model-pauses", action="store_true",
                   help="train the pause-aware aligner: silences are "
                        "absorbed by implicit pause states between "
                        "tokens. Enables the reconstruction auxiliary "
                        "and the pause-bias curriculum; `align` then "
                        "also emits per-gap pause durations")
    p.add_argument("--pause-prior", choices=("bridge", "inherit"),
                   default="bridge",
                   help="pause-state prior shape (see OTAConfig)")
    p.add_argument("--pause-bias", type=float, default=0.0,
                   help="final per-frame pause occupancy cost (log-odds)")
    p.add_argument("--pause-bias-start", type=float, default=-3.0,
                   help="curriculum start value for the pause bias (set "
                        "equal to --pause-bias to disable the "
                        "curriculum; see demo-pauses)")
    p.add_argument("--pause-bias-anneal", type=int, default=None,
                   help="curriculum length in steps (default steps//2)")
    p.add_argument("--pause-enter-cost", type=float, default=0.0,
                   help="log-cost per pause entered (a serving-time "
                        "precision knob)")
    _device_flag(p)


def _align_parser(sub):
    p = sub.add_parser("align", help="emit durations for a wav corpus "
                                     "using a trained checkpoint")
    p.add_argument("corpus", help="corpus root directory")
    p.add_argument("--checkpoint-dir", required=True)
    p.add_argument("--output", default="durations.jsonl")
    p.add_argument("--textgrid-dir", default=None,
                   help="also write one Praat TextGrid per utterance")
    p.add_argument("--batch-size", type=int, default=16)
    p.add_argument("--limit", type=int, default=None)
    p.add_argument("--step", type=int, default=None,
                   help="decode from this checkpoint step instead of "
                        "the latest")
    # Model shape comes from the checkpoint's config.json (written at
    # train time); explicit flags are only needed for pre-config
    # checkpoints, and conflicting with config.json is an error.
    p.add_argument("--dim", type=int, default=None)
    p.add_argument("--hidden", type=int, default=None)
    p.add_argument("--temperature", type=float, default=None)
    # Decode-time pause knobs (pause-aware checkpoints only): static
    # lattice costs, not parameters, so overriding them re-runs the skip
    # DP under another precision/recall trade-off with the same weights.
    p.add_argument("--pause-enter-cost", type=float, default=None,
                   help="override the per-pause-entered log-cost for "
                        "this decode (the checkpoint's trained value is "
                        "the default)")
    p.add_argument("--pause-bias", type=float, default=None,
                   help="override the per-frame pause occupancy "
                        "log-odds for this decode (negative shortens "
                        "pauses; the checkpoint's value is the default)")
    _device_flag(p)


def _corpus_batches(args, max_tokens=24, max_dur=7, **synth):
    from .data import SyntheticConfig, bucket_batches, make_corpus
    cfg = SyntheticConfig(seed=args.seed,
                          max_tokens=args.max_tokens or max_tokens,
                          max_duration=max_dur, **synth,
                          **_synth_kwargs(args))
    corpus = make_corpus(args.utterances, cfg)
    batches = list(bucket_batches(corpus, args.batch_size,
                                  shuffle_seed=args.seed))
    return cfg, corpus, batches


def _match_item(corpus, tokens, t_x):
    for item in corpus:
        if len(item["tokens"]) == t_x and \
                (item["tokens"] == tokens[:t_x]).all():
            return item
    return None


def cmd_demo_ota(args):
    from .data import duration_accuracy
    from .models.ota import OTAAligner, OTAConfig
    from .train.loop import train_aligner
    from .utils.eval import boundary_f1

    device = _device(args)
    cfg, corpus, batches = _corpus_batches(args)
    model = OTAAligner(OTAConfig(vocab_size=cfg.vocab_size, dim=96,
                                 hidden=128, temperature=args.temperature,
                                 use_recon=args.recon), device=device)
    train_aligner(model, batches, steps=args.steps, device=device,
                  learning_rate=args.lr, bin_start=args.steps // 6,
                  bin_ramp=args.steps // 3,
                  checkpoint_dir=args.checkpoint_dir,
                  seed=_init_seed(args))
    # evaluate duration accuracy on the first batch's items
    b = batches[0]
    with torch.no_grad():
        out = model(*[torch.as_tensor(b[k]).to(device) for k in
                      ("tokens", "mel", "text_lengths", "mel_lengths")])
    durations = out["durations"].cpu().numpy()
    accs = []
    for i in range(min(8, b["tokens"].shape[0])):
        item = _match_item(corpus, b["tokens"][i], int(b["text_lengths"][i]))
        if item is not None:
            t_xi = len(item["tokens"])
            rec = duration_accuracy(durations[i], item)
            rec["f1"] = boundary_f1(durations[i][:t_xi], item["durations"],
                                    tolerance_frames=2)["f1"]
            accs.append(rec)
    if accs:
        print(json.dumps({
            "demo": "ota",
            "duration_exact": round(float(np.mean([a["exact"] for a in accs])), 3),
            "duration_mae": round(float(np.mean([a["mae"] for a in accs])), 3),
            "boundary_f1_tol2": round(float(np.mean([a["f1"] for a in accs])), 3),
        }), flush=True)


def cmd_demo_pauses(args):
    """On utterances with un-transcribed silences, the skip-state model
    recovers token boundaries and pause slots that a pause-blind aligner
    must absorb into neighbouring tokens."""
    from .models.ota import OTAAligner, OTAConfig
    from .train.loop import train_aligner
    from .utils.eval import pause_detection, token_boundary_f1

    device = _device(args)
    cfg, corpus, batches = _corpus_batches(args, max_tokens=16,
                                           pause_prob=args.pause_prob)

    def train_and_eval(model_pauses: bool):
        # use_recon anchors silence frames to the pause state (the pause
        # key decodes to the silence spectrum; token keys cannot); the
        # forward-sum alone leaves optional states in a collapsed local
        # optimum. Enabled for both models for a fair comparison.
        model = OTAAligner(OTAConfig(
            vocab_size=cfg.vocab_size, n_mels=cfg.n_mels, dim=96,
            hidden=128, temperature=args.temperature,
            model_pauses=model_pauses, use_recon=True,
            pause_prior=args.pause_prior, pause_bias=args.pause_bias,
            pause_enter_cost=(args.pause_enter_cost if model_pauses
                              else 0.0)), device=device)
        apply_extra = None
        if model_pauses and args.pause_bias_start is not None \
                and args.pause_bias_start != args.pause_bias:
            # Curriculum: anneal the pause occupancy cost from a strongly
            # discouraging start to the configured final value, so tokens
            # claim their frames before pauses compete.
            anneal = args.pause_bias_anneal or args.steps // 2
            start, final = args.pause_bias_start, args.pause_bias

            def apply_extra(step_no):
                frac = min(max(step_no / max(anneal, 1), 0.0), 1.0)
                return {"pause_bias": start + (final - start) * frac}
        train_aligner(
            model, batches, steps=args.steps, device=device,
            learning_rate=args.lr,
            bin_start=args.bin_start or args.steps // 6,
            bin_ramp=args.bin_ramp or args.steps // 3,
            log_fn=lambda s: None, seed=_init_seed(args),
            apply_extra=apply_extra)
        f1s, pauses = [], []
        for b in batches[:2]:
            with torch.no_grad():
                out = model(*[torch.as_tensor(b[k]).to(device) for k in
                              ("tokens", "mel", "text_lengths",
                               "mel_lengths")])
            durations = out["durations"].cpu().numpy()
            pause_durations = (out["pause_durations"].cpu().numpy()
                               if model_pauses else None)
            for i in range(b["tokens"].shape[0]):
                item = _match_item(corpus, b["tokens"][i],
                                   int(b["text_lengths"][i]))
                if item is None:
                    continue
                t_xi = len(item["tokens"])
                pp = (pause_durations[i][:t_xi + 1] if model_pauses
                      else None)
                f1s.append(token_boundary_f1(
                    durations[i][:t_xi], item["durations"], pred_pauses=pp,
                    true_pauses=item["pause_durations"],
                    tolerance_frames=2)["f1"])
                if model_pauses:
                    pauses.append(pause_detection(
                        pp, item["pause_durations"]))
        rec = {"token_boundary_f1_tol2": round(float(np.mean(f1s)), 3)}
        if pauses:
            rec["pause_precision"] = round(float(np.mean(
                [p["precision"] for p in pauses])), 3)
            with_true = [p for p in pauses if p["n_true"]]
            if with_true:  # else no evaluated item had a true pause
                rec["pause_recall"] = round(float(np.mean(
                    [p["recall"] for p in with_true])), 3)
                rec["pause_length_mae"] = round(float(np.mean(
                    [p["length_mae"] for p in with_true])), 3)
        return rec

    result = {"demo": "pauses", "pause_prob": args.pause_prob,
              "steps": args.steps,
              "pause_aware": train_and_eval(True)}
    if not args.skip_blind:
        result["pause_blind"] = train_and_eval(False)
    print(json.dumps(result), flush=True)


def _one_batch_demo(args, make_model, loss_fn, label):
    """The flow the MoBo and RoMo demos share: one padded synthetic batch,
    Adam at 3 * --lr on `loss_fn(out, batch, prototypes)` of the model's
    forward without the hard decode, a log line every 100 steps, then one
    forward with it. Returns (corpus, final outputs)."""
    from .data import SyntheticConfig, make_corpus, pad_batch, prototypes

    if args.max_duration < 3:
        raise SystemExit("--max-duration must be >= 3 (the synthetic "
                         "corpus draws durations in [2, max_duration-1])")
    device = _device(args)
    cfg = SyntheticConfig(seed=args.seed,
                          max_tokens=args.max_tokens or 16,
                          max_duration=min(7, args.max_duration - 1),
                          **_synth_kwargs(args))
    corpus = make_corpus(args.batch_size, cfg)
    b = {k: torch.as_tensor(v).to(device)
         for k, v in pad_batch(corpus).items()}
    protos = torch.as_tensor(prototypes(cfg)).to(device)
    model = make_model(cfg, device, torch.Generator().manual_seed(
        _init_seed(args)))
    inputs = (b["tokens"], b["mel"], b["text_lengths"], b["mel_lengths"])
    opt = torch.optim.Adam(model.parameters(), lr=args.lr * 3)
    for i in range(args.steps):
        loss = loss_fn(model(*inputs, compute_hard=False), b, protos,
                       cfg.n_mels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        if i % 100 == 0:
            print(f"step {i:5d}  {label} {loss.item():.4f}", flush=True)
    with torch.no_grad():
        out = model(*inputs)
    return corpus, out


def _stage_metrics(corpus, durs, keep=None):
    """Mean duration accuracy and boundary F1 of `durs` [B, T_x] over the
    corpus; keep: optional [B] bool, the items to include."""
    from .data import duration_accuracy
    from .utils.eval import boundary_f1
    accs = []
    for i, item in enumerate(corpus):
        if keep is not None and not bool(keep[i]):
            continue
        t_xi = len(item["tokens"])
        d = np.rint(np.asarray(durs[i])).astype(int)
        rec = duration_accuracy(d, item)
        rec["f1"] = boundary_f1(d[:t_xi], item["durations"],
                                tolerance_frames=2)["f1"]
        accs.append(rec)
    if not accs:
        return None
    return {
        "duration_exact": round(float(np.mean([a["exact"] for a in accs])), 3),
        "duration_mae": round(float(np.mean([a["mae"] for a in accs])), 3),
        "boundary_f1_tol2": round(float(np.mean([a["f1"] for a in accs])), 3),
    }


def cmd_demo_mobo(args):
    from .models.mobo import MoBoAligner, MoBoConfig

    def make_model(cfg, device, generator):
        return MoBoAligner(MoBoConfig(
            vocab_size=cfg.vocab_size, dim=64, hidden=96,
            max_duration=args.max_duration), device=device,
            generator=generator)

    def loss_fn(out, b, protos, n_mels):
        rec = _recon_mse(out["soft_alignment"], protos, b, n_mels)
        return rec + 0.1 * out["loss_mobo"]

    corpus, out = _one_batch_demo(args, make_model, loss_fn, "recon+nll")
    print(json.dumps({"demo": "mobo", **_stage_metrics(
        corpus, out["hard_durations"].cpu().numpy())}), flush=True)


def cmd_demo_romo(args):
    """RoMoAligner end to end: the rough OTA stage learns soft posteriors
    whose expected durations anchor the windowed MoBo refinement; reports
    both stages' duration quality so the refinement's contribution is
    visible."""
    from .models.romo import RoMoAligner, RoMoConfig

    def make_model(cfg, device, generator):
        return RoMoAligner(RoMoConfig(
            vocab_size=cfg.vocab_size, n_mels=cfg.n_mels, dim=64, hidden=96,
            max_duration=args.max_duration, window=args.window),
            device=device, generator=generator)

    def loss_fn(out, b, protos, n_mels):
        # Reconstruction through the refinement posteriors (the objective
        # that gives demo-mobo its quality): the marginal NLLs alone only
        # shape energies, and within the anchor window the refined
        # boundaries are otherwise unpinned.
        rec = _recon_mse(out["soft_alignment"], protos, b, n_mels,
                         feasible=out["refine_feasible"])
        return rec + 0.1 * out["loss"]

    corpus, out = _one_batch_demo(args, make_model, loss_fn,
                                  "recon+rough+refine")
    # hard_durations mean nothing where refine_feasible is False, so
    # infeasible items must not pollute the refined row.
    feas = out["refine_feasible"].cpu().numpy()
    print(json.dumps({
        "demo": "romo",
        "refine_feasible": round(float(np.mean(feas)), 3),
        "rough": _stage_metrics(corpus,
                                out["rough_durations"].cpu().numpy()),
        "refined": _stage_metrics(corpus,
                                  out["hard_durations"].cpu().numpy(),
                                  keep=feas),
    }), flush=True)


def _mel_config_from_args(args):
    """MelConfig for a `train` run from the --mel-* lever flags.

    Returns (mel_cfg, extra) where `extra` is the config.json payload:
    only non-default levers are recorded, so default runs keep a
    `mel`-free config.json."""
    from .ops.mel import MelConfig

    overrides = {}
    if getattr(args, "mel_hop", None) is not None:
        overrides["hop_length"] = args.mel_hop
    if getattr(args, "mel_win", None) is not None:
        overrides["n_fft"] = args.mel_win
        overrides["win_length"] = args.mel_win
    if getattr(args, "no_mel_center", False):
        overrides["center"] = False
    cfg = MelConfig(**overrides)
    return cfg, ({"mel": overrides} if overrides else {})


def _mel_config_from_record(rec):
    """MelConfig for `align` from a checkpoint's config.json. Checkpoints
    without a `mel` key trained with the defaults."""
    from .ops.mel import MelConfig

    if rec is None:
        return MelConfig()
    return MelConfig(**rec.get("mel", {}))


def _make_tokenizer(args):
    """Tokenizer for a file-corpus run. `--tokenizer phone` derives the
    vocabulary from the corpus rows that will actually be loaded (wav
    present, within --limit) and persists it in config.json so `align`
    rebuilds the exact id mapping.

    On `--resume`, an existing config.json's vocabulary wins: the
    restored embedding rows only mean something under the original id
    mapping. Out-of-vocabulary symbols in the current corpus are a loud
    error.
    """
    import os

    from .data import CharTokenizer, PhoneTokenizer, load_metadata

    if getattr(args, "tokenizer", "char") != "phone":
        return CharTokenizer()

    def corpus_texts():
        # Mirror load_corpus's row filter (wav exists, --limit) so the
        # vocabulary covers exactly the trained rows.
        limit = getattr(args, "limit", None)
        n = 0
        for utt_id, text in load_metadata(args.corpus):
            if limit is not None and n >= limit:
                return
            if not os.path.exists(os.path.join(
                    args.corpus, "wavs", f"{utt_id}.wav")):
                continue
            yield text
            n += 1

    if getattr(args, "resume", False) and \
            getattr(args, "checkpoint_dir", None):
        from .train.checkpoint import load_run_config
        rec = load_run_config(args.checkpoint_dir)
        if rec is not None and rec.get("tokenizer_vocab") is not None:
            tok = PhoneTokenizer(phones=tuple(rec["tokenizer_vocab"]))
            unknown = sorted(
                {p for t in corpus_texts() for p in t.split()}
                - set(tok.phones))
            if unknown:
                raise SystemExit(
                    "--resume: corpus contains symbols outside the "
                    "checkpoint's vocabulary "
                    f"({', '.join(unknown[:10])}"
                    f"{', ...' if len(unknown) > 10 else ''}); the "
                    "embedding ids are fixed at first training — "
                    "retrain from scratch for a new vocabulary")
            return tok
    tok = PhoneTokenizer.from_corpus(corpus_texts())
    if not tok.phones:
        raise SystemExit("--tokenizer phone: corpus metadata has no "
                         "symbols to build a vocabulary from")
    return tok


def _file_model(args, device):
    """The model family selected by `train --model` on `device`, with its
    tokenizer. MoBo and RoMo always train with the learned reconstruction
    decoder: their marginal NLLs alone only shape energies and leave
    boundaries unpinned."""
    from .models import (MoBoAligner, MoBoConfig, OTAAligner, OTAConfig,
                         RoMoAligner, RoMoConfig)

    family = getattr(args, "model", "ota")
    model_pauses = getattr(args, "model_pauses", False)
    compute_dtype = getattr(args, "compute_dtype", "float32")
    if family != "ota":
        if model_pauses:
            raise SystemExit("--model-pauses is an OTA capability "
                             "(skip-state DP); drop it or use "
                             "--model ota")
        if compute_dtype != "float32":
            raise SystemExit("--compute-dtype is currently wired for "
                             "--model ota only")
    tok = _make_tokenizer(args)
    if family == "mobo":
        return tok, MoBoAligner(MoBoConfig(
            vocab_size=tok.vocab_size, dim=args.dim, hidden=args.hidden,
            max_duration=args.max_duration, use_recon=True), device=device)
    if family == "romo":
        return tok, RoMoAligner(RoMoConfig(
            vocab_size=tok.vocab_size, dim=args.dim, hidden=args.hidden,
            temperature=args.temperature,
            max_duration=args.max_duration, window=args.window,
            use_recon=True), device=device)
    use_recon = getattr(args, "recon", False)
    if model_pauses and not use_recon:
        # The pause key only learns the silence spectrum through the
        # reconstruction auxiliary; without it the optional states
        # collapse.
        print("note: --model-pauses enables --recon")
        use_recon = True
    model = OTAAligner(OTAConfig(
        vocab_size=tok.vocab_size, dim=args.dim, hidden=args.hidden,
        temperature=args.temperature, use_recon=use_recon,
        model_pauses=model_pauses,
        pause_prior=getattr(args, "pause_prior", "bridge"),
        pause_bias=getattr(args, "pause_bias", 0.0),
        pause_enter_cost=getattr(args, "pause_enter_cost", 0.0),
        compute_dtype=compute_dtype), device=device)
    return tok, model


def _decode_pause_overrides(args, cfg):
    """Overlay align's decode-time pause knobs on the checkpoint config.

    `pause_enter_cost` and `pause_bias` are static costs in the skip-DP
    lattice, not trained parameters, so overriding them at decode time is
    well defined: the same weights at another pause precision/recall
    operating point."""
    import dataclasses
    knobs = {k: getattr(args, k) for k in ("pause_enter_cost",
                                           "pause_bias")
             if getattr(args, k, None) is not None}
    if not knobs:
        return cfg
    if not cfg.model_pauses:
        names = "/".join("--" + k.replace("_", "-") for k in knobs)
        raise SystemExit(
            f"{names} requires a checkpoint trained with "
            "--model-pauses (this one has no pause states to decode)")
    return dataclasses.replace(cfg, **knobs)


def _model_from_checkpoint(args, device):
    """Rebuild the trained model (on `device`) and its tokenizer from the
    checkpoint's config.json.

    Explicit --dim/--hidden/--temperature flags must match config.json
    when both are given (loud error on mismatch); for pre-config
    checkpoints (no config.json) they are required."""
    from .data import CharTokenizer, PhoneTokenizer
    from .models import (MoBoAligner, MoBoConfig, OTAAligner, OTAConfig,
                         RoMoAligner, RoMoConfig)
    from .train.checkpoint import load_run_config

    rec = load_run_config(args.checkpoint_dir)
    overrides = {k: getattr(args, k) for k in
                 ("dim", "hidden", "temperature")
                 if getattr(args, k) is not None}
    if rec is None:
        missing = [k for k in ("dim", "hidden", "temperature")
                   if getattr(args, k) is None]
        if missing:
            raise SystemExit(
                f"{args.checkpoint_dir} has no config.json (pre-config "
                f"checkpoint); pass --{' --'.join(missing)} matching the "
                "training run")
        tok = CharTokenizer()
        return tok, OTAAligner(_decode_pause_overrides(args, OTAConfig(
            vocab_size=tok.vocab_size, dim=args.dim, hidden=args.hidden,
            temperature=args.temperature)), device=device)
    cfg_dict = rec["model_config"]
    conflicts = {k: (v, cfg_dict.get(k)) for k, v in overrides.items()
                 if cfg_dict.get(k) != v}
    if conflicts:
        detail = ", ".join(f"--{k}={v} vs config.json {c}"
                           for k, (v, c) in conflicts.items())
        raise SystemExit(
            f"flags conflict with the checkpoint's saved config "
            f"({detail}); drop the flags — the checkpoint is "
            "self-describing")
    family = rec.get("model_class", "OTA").removesuffix("Aligner")
    if family not in ("OTA", "MoBo", "RoMo"):
        raise SystemExit(
            f"checkpoint holds a {rec['model_class']} model; `align` "
            "drives the OTA/MoBo/RoMo aligners")
    if rec.get("tokenizer") == "PhoneTokenizer":
        vocab = rec.get("tokenizer_vocab")
        if vocab is None:
            raise SystemExit(
                "checkpoint was trained with a PhoneTokenizer but its "
                "config.json records no tokenizer_vocab; retrain (the "
                "vocab is corpus-derived and cannot be reconstructed)")
        tok = PhoneTokenizer(phones=tuple(vocab))
    else:
        tok = CharTokenizer()
    if family == "MoBo":
        cfg = MoBoConfig(**cfg_dict)
    elif family == "RoMo":
        cfg = RoMoConfig(**cfg_dict)
    else:
        cfg = _decode_pause_overrides(args, OTAConfig(**cfg_dict))
    if family != "OTA" and any(
            getattr(args, k, None) is not None
            for k in ("pause_enter_cost", "pause_bias")):
        raise SystemExit("--pause-enter-cost/--pause-bias require an "
                         "OTA checkpoint trained with --model-pauses")
    if cfg.vocab_size != tok.vocab_size:
        raise SystemExit(
            f"checkpoint vocab_size {cfg.vocab_size} does not match the "
            f"{type(tok).__name__} ({tok.vocab_size}); was it trained "
            "with a different tokenizer?")
    model_class = {"OTA": OTAAligner, "MoBo": MoBoAligner,
                   "RoMo": RoMoAligner}[family]
    return tok, model_class(cfg, device=device)


def _no_hard_decode(step_no):
    """MoBo and RoMo train without the hard Viterbi decode (align only)."""
    return {"compute_hard": False}


def _mobo_objective(out, step_no):
    # Reconstruction pins boundaries, the boundary NLL shapes energies.
    loss = out["loss_recon"] + 0.1 * out["loss_mobo"]
    return loss, {"loss_mobo": out["loss_mobo"],
                  "loss_recon": out["loss_recon"]}


def _romo_objective(out, step_no):
    loss = out["loss_recon"] + 0.1 * out["loss"]
    return loss, {"loss_rough": out["loss_rough"],
                  "loss_refine": out["loss_refine"],
                  "loss_recon": out["loss_recon"],
                  "refine_feasible": torch.mean(
                      out["refine_feasible"].to(torch.float32))}


def _float32_on(device):
    """--compute-dtype float32 means float32 on the card too: no TF32 in
    cuBLAS or cuDNN (PyTorch lets cuDNN's convolutions use TF32 by
    default)."""
    if device.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False


def cmd_train(args):
    """Returns the run's host-clock times: corpus load and training (with
    checkpoint writes) in seconds, the steady-state wall a step in ms
    (None with fewer than two log points), and the steps taken."""
    import os
    import time

    from .data import bucket_batches, load_corpus
    from .train.loop import train_aligner

    device = _device(args)
    if not os.path.exists(os.path.join(args.corpus, "metadata.csv")):
        raise SystemExit(f"no metadata.csv under {args.corpus}")
    tok, model = _file_model(args, device)
    _float32_on(device)
    mel_cfg, mel_extra = _mel_config_from_args(args)
    t0 = time.perf_counter()
    items = list(load_corpus(args.corpus, tokenizer=tok,
                             mel_config=mel_cfg, limit=args.limit,
                             device=device))
    load_s = time.perf_counter() - t0
    if not items:
        raise SystemExit(f"no usable utterances under {args.corpus}")
    print(f"loaded {len(items)} utterances in {load_s:.3f} s", flush=True)
    batches = list(bucket_batches(items, args.batch_size,
                                  shuffle_seed=args.seed))
    eval_batches = None
    if args.eval_split > 0 and len(batches) > 1:
        n_eval = max(1, int(round(args.eval_split * len(batches))))
        n_eval = min(n_eval, len(batches) - 1)
        eval_batches, batches = batches[:n_eval], batches[n_eval:]
        print(f"holding out {n_eval} batches for validation")
    apply_extra, objective = None, None
    if args.model == "mobo":
        apply_extra, objective = _no_hard_decode, _mobo_objective
    elif args.model == "romo":
        apply_extra, objective = _no_hard_decode, _romo_objective
    elif args.model_pauses and args.pause_bias_start != args.pause_bias:
        # Pause-bias curriculum: anneal the occupancy cost from a strongly
        # discouraging start so tokens claim their frames first.
        anneal = args.pause_bias_anneal or args.steps // 2
        start, final = args.pause_bias_start, args.pause_bias

        def apply_extra(step_no):
            frac = min(max(step_no / max(anneal, 1), 0.0), 1.0)
            return {"pause_bias": start + (final - start) * frac}

    t0 = time.perf_counter()
    state, history = train_aligner(
        model, batches, steps=args.steps, device=device,
        learning_rate=args.lr,
        bin_start=args.bin_start or args.steps // 6,
        bin_ramp=args.bin_ramp or args.steps // 3,
        checkpoint_dir=args.checkpoint_dir,
        config_extra={"tokenizer": type(tok).__name__,
                      **({"tokenizer_vocab": list(tok.phones)}
                         if hasattr(tok, "phones") else {}),
                      **mel_extra},
        warmup_steps=args.warmup_steps, lr_schedule=args.lr_schedule,
        grad_clip_norm=args.grad_clip, eval_batches=eval_batches,
        resume=args.resume, seed=args.seed,
        apply_extra=apply_extra, objective=objective)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_s = time.perf_counter() - t0
    print(f"checkpoints in {args.checkpoint_dir}", flush=True)
    # Steady-state wall a step: between the first and the last log point
    # (each reads the metrics back, so each waits for the device).
    logged = [r for r in history if "lr" in r]
    step_ms = ((logged[-1]["wall_s"] - logged[0]["wall_s"]) * 1e3
               / (logged[-1]["step"] - logged[0]["step"])
               if len(logged) > 1 else None)
    return {"load_s": load_s, "train_s": train_s, "steps": state.step,
            "step_ms": step_ms, "utterances": len(items)}


def _textgrid_intervals(d, labels, pauses):
    """Token durations and labels with each non-empty pause (pause j
    precedes token j) interleaved as an unlabelled interval, the Praat
    silence convention."""
    if pauses is None:
        return d, labels
    durs, labs = [], []
    for g in range(len(d)):
        if pauses[g] > 0:
            durs.append(pauses[g])
            labs.append("")
        durs.append(d[g])
        labs.append(labels[g])
    if pauses[len(d)] > 0:
        durs.append(pauses[len(d)])
        labs.append("")
    return durs, labs


def cmd_align(args):
    import os

    from .data import bucket_batches, load_corpus, write_textgrid
    from .train import restore_params
    from .train.checkpoint import load_run_config

    device = _device(args)
    if not os.path.isdir(args.checkpoint_dir):
        raise SystemExit(f"checkpoint dir not found: {args.checkpoint_dir}")
    if not os.path.exists(os.path.join(args.corpus, "metadata.csv")):
        raise SystemExit(f"no metadata.csv under {args.corpus}")
    tok, model = _model_from_checkpoint(args, device)
    _float32_on(device)
    mel_cfg = _mel_config_from_record(load_run_config(args.checkpoint_dir))
    items = list(load_corpus(args.corpus, tokenizer=tok,
                             mel_config=mel_cfg, limit=args.limit,
                             device=device))
    if not items:
        raise SystemExit(f"no usable utterances under {args.corpus}")
    batches = list(bucket_batches(items, args.batch_size,
                                  with_items=True))
    # Parameters only: align does not depend on the training run's
    # optimizer or schedule.
    restore_params(args.checkpoint_dir, model, step=args.step)
    model.eval()
    family = type(model.config).__name__.removesuffix("Config")
    with_pauses = family == "OTA" and model.config.model_pauses

    @torch.no_grad()
    def extract(b):
        out = model(*(torch.as_tensor(b[k]).to(device) for k in
                      ("tokens", "mel", "text_lengths", "mel_lengths")))
        if family == "OTA":
            return (out["durations"],
                    out["pause_durations"] if with_pauses else None)
        if family == "RoMo":
            # Refined Viterbi boundaries where the windowed search is
            # feasible; the rough stage's expected durations otherwise
            # (hard_durations mean nothing there).
            feas = out["refine_feasible"][:, None]
            return torch.where(feas, out["hard_durations"].to(torch.float32),
                               torch.round(out["rough_durations"])), None
        return out["hard_durations"], None

    if args.textgrid_dir:
        os.makedirs(args.textgrid_dir, exist_ok=True)
    n = 0
    with open(args.output, "w") as f:
        for b, group in batches:
            durs, pauses = extract(b)
            durs = durs.cpu().numpy()
            pauses = None if pauses is None else pauses.cpu().numpy()
            for i, item in enumerate(group):
                t_x = int(b["text_lengths"][i])
                d = durs[i, :t_x].astype(int).tolist()
                rec = {"utt_id": item["utt_id"], "durations": d,
                       "n_frames": int(b["mel_lengths"][i])}
                pp = None
                if pauses is not None:
                    pp = pauses[i, :t_x + 1].astype(int).tolist()
                    rec["pauses"] = pp  # per-gap silence frames [t_x+1]
                f.write(json.dumps(rec) + "\n")
                if args.textgrid_dir:
                    tg_durs, tg_labels = _textgrid_intervals(
                        d, tok.labels(item["text"])[:t_x], pp)
                    write_textgrid(
                        os.path.join(args.textgrid_dir,
                                     f"{item['utt_id']}.TextGrid"),
                        tg_durs, tg_labels,
                        mel_cfg.hop_length, mel_cfg.sample_rate)
                n += 1
    print(f"wrote {n} alignments to {args.output}", flush=True)


def cmd_bench_mas(args):
    from . import bench_mas
    code = bench_mas.run(batch=args.batch, t_text=args.t_text,
                         t_mel=args.t_mel, route=args.route,
                         device=args.device)
    if code:
        sys.exit(code)


def main(argv=None):
    args = build_parser().parse_args(argv)
    {"demo-ota": cmd_demo_ota, "demo-pauses": cmd_demo_pauses,
     "demo-mobo": cmd_demo_mobo, "demo-romo": cmd_demo_romo,
     "bench-mas": cmd_bench_mas, "train": cmd_train,
     "align": cmd_align}[args.cmd](args)


if __name__ == "__main__":
    main()
