"""The align path: what the `align` command's `extract` does with each
batch, on batches staged on the card: `model.eval()`, the forward pass
under `no_grad`, and the durations brought to the host, one batch at a
time in a fixed cycle over the corpus' batches (bucketed by the
program's `bucket_batches`, as the command buckets them).

Set-up stages every batch and runs one pass over them (every shape the
cell uses). `align_frames_per_s` is the valid mel frames of every batch
whose durations reached the host in the window over the window's
seconds.

`correct`: every distinct answer of every batch in the window (its
durations, and its forward-sum loss) is held to the reference's forward
pass over the same utterances, batched by the reference itself.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from harness import compare, traffic
from harness import window as win
from reference import batching as ref_batching

METRIC = "align_frames_per_s"


def run(cell, seed: int, seconds: float, trace: bool, device,
        stop_at: int | None = None) -> dict:
    from aligner_tpu_torch.data.batching import BucketSpec, bucket_batches
    cfg, mix = cell.config, cell.traffic
    fam = cell.family()
    t = [time.perf_counter()]
    items = traffic.corpus(cell, seed, device)
    t.append(time.perf_counter())
    spec = BucketSpec(tuple(mix["text_buckets"]), tuple(mix["mel_buckets"]))
    host = list(bucket_batches(items, mix["batch_size"], spec))
    keys = ("tokens", "mel", "text_lengths", "mel_lengths")
    staged = [tuple(torch.as_tensor(b[k]).to(device) for k in keys)
              for b in host]
    t.append(time.perf_counter())
    model = fam.build(cfg, device,
                      generator=torch.Generator().manual_seed(seed))
    fam.set_precision(device)
    t.append(time.perf_counter())
    model.eval()
    n = len(staged)
    clock = win.Window(device, seconds, n, n, trace, stop_at)
    answers: list = [dict() for _ in range(n)]     # batch -> {bytes: answer}
    losses: list = [[] for _ in range(n)]
    sample = sampled(host, seed)
    lattices = {}
    step = 0
    try:
        while True:
            clock.on_step(step)
            i = step % n
            with torch.no_grad():
                out = model(*staged[i])
            if step < n and i in sample:
                lattices[i] = out["log_attn"].cpu()
            answer = fam.answers(out)
            answers[i].setdefault(fam.answer_key(answer), answer)
            losses[i].append(out[fam.ALIGN_LOSS])
            step += 1
    except win.WindowClosed:
        pass
    clock.close()
    frames = [int(b["mel_lengths"].sum()) for b in host]
    done = {"items": items, "attempted": len(clock.issued), "failed": 0,
            "steps_run": step,
            "setup_parts": {"corpus": t[1] - t[0], "batching": t[2] - t[1],
                            "model": t[3] - t[2],
                            "warm_up": (clock.t_start or t[3]) - t[3]},
            "t_start": clock.t_start, "trace_path": clock.trace_path,
            "traced": [host[s % n] for s in clock.traced], "kind": "align",
            "answers": [list(a.values()) for a in answers],
            "lattices": lattices,
            "losses": [torch.stack(v).cpu().numpy() if v else np.zeros(0)
                       for v in losses]}
    if clock.issued:
        done["metrics"] = {METRIC: sum(frames[s % n] for s in clock.issued)
                           / clock.window_s}
    return done


def sampled(batches: list, seed: int) -> set:
    """The batches whose lattices the warm-up pass keeps: the largest, and
    one drawn from the seed."""
    sizes = [b["mel"].shape[0] * b["mel"].shape[1] for b in batches]
    return {int(np.argmax(sizes)),
            int(np.random.default_rng(seed).integers(len(batches)))}


def reference_batches(cell, seed: int, items: list, device,
                      precision: str):
    """Per batch of the reference's own batching: (its forward pass, t_x,
    t_y), under no gradient."""
    cfg, mix = cell.config, cell.traffic
    ref = cell.family().reference
    params = ref.init_params(cfg, seed, device)
    for b in ref_batching.batches(items, mix["batch_size"], None,
                                  mix["text_buckets"], mix["mel_buckets"]):
        tb = {k: torch.as_tensor(v).to(device) for k, v in b.items()}
        with torch.no_grad():
            o = ref.forward(params, cfg, tb, precision)
        yield o, b["text_lengths"], b["mel_lengths"]


def numbers(cell, got_answers, got_losses, got_lattices, ref) -> dict:
    """The compared numbers: the widest loss gap and path gap over every
    batch and every distinct answer of it, and the widest lattice gap
    over the sampled batches (the family's `batch_numbers`)."""
    fam, cfg = cell.family(), cell.config
    out = {"loss": 0.0, "path": 0.0, "lattice": 0.0}
    for i, ((o, tx, ty), ans, ls) in enumerate(
            zip(ref, got_answers, got_losses)):
        fs = float(o[fam.ALIGN_LOSS])
        for v in ls:
            out["loss"] = max(out["loss"], compare.rel_gap(float(v), fs))
        for j, a in enumerate(ans):
            la = got_lattices.get(i) if j == 0 else None
            for k, v in fam.batch_numbers(cfg, o, tx, ty, a, la).items():
                out[k] = max(out[k], v)
    return out


def check(cell, seed: int, done: dict, device) -> dict:
    ref = reference_batches(cell, seed, done["items"], device,
                            cell.config["compute_dtype"])
    return numbers(cell, done["answers"], done["losses"], done["lattices"],
                   ref)


def control(cell, seed: int, device) -> dict:
    """The reference in the precision below the configuration's, put in
    the program's place: its losses and its own best paths."""
    fam, cfg = cell.family(), cell.config
    dt = cfg["compute_dtype"]
    items = traffic.corpus(cell, seed, device)
    mix = cell.traffic
    sample = sampled(ref_batching.batches(items, mix["batch_size"], None,
                                          mix["text_buckets"],
                                          mix["mel_buckets"]), seed)
    answers, losses, lattices = [], [], {}
    for i, (o, tx, ty) in enumerate(reference_batches(
            cell, seed, items, device, fam.CONTROL[dt])):
        answers.append([fam.best_answer(cfg, o, tx, ty)])
        losses.append(np.array([float(o[fam.ALIGN_LOSS])]))
        if i in sample:
            lattices[i] = o["log_attn"].cpu()
    ref = reference_batches(cell, seed, items, device, dt)
    return numbers(cell, answers, losses, lattices, ref)
