"""Command-line interface of the port (`aligner-tpu-torch`).

    python -m aligner_tpu_torch demo-ota [--steps N] [--batch-size B] ...
                                         [--device cuda|cpu]

`demo-ota` trains the OTA aligner on the synthetic corpus (known
ground-truth durations) and prints duration accuracy and boundary F1 as
one JSON line, with the flags and the flow of aligner_tpu's `demo-ota`.
It runs on `--device` (default `cuda`, which raises where no GPU is
present; `--device cpu` runs every kernel's plain version). The other
subcommands of aligner_tpu's CLI are not ported yet (ROADMAP.md).
"""
from __future__ import annotations

import argparse
import json

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
    return ap


def _corpus_batches(args, max_tokens=24, max_dur=7):
    from .data import SyntheticConfig, bucket_batches, make_corpus
    cfg = SyntheticConfig(seed=args.seed,
                          max_tokens=args.max_tokens or max_tokens,
                          max_duration=max_dur, **_synth_kwargs(args))
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


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.cmd == "demo-ota":
        cmd_demo_ota(args)


if __name__ == "__main__":
    main()
