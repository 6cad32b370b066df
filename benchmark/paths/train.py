"""The train path: the `train` command's loop, `train_aligner`, over the
corpus bucketed by the program's `bucket_batches`, in a fixed cycle.

Set-up builds the model once and runs one pass over the corpus' batches,
every shape the cell uses (and never fewer than the compared steps);
the window then opens at the next step, inside the same call of
`train_aligner`, and closes after `--seconds`. Every step, from the
first, trains the objective the window times: the binarisation loss is
on at weight 1 throughout. `train_frames_per_s` is the valid mel frames
of every step issued in the window over the window's seconds.

`correct`: the family's plain reference follows the first three steps
from its own weights and its own batches, and is held to the program's
losses, first gradient, change over the three steps, hard paths and
first lattices (`numbers`; the family's `step_numbers`).
"""
from __future__ import annotations

import sys
import time

import torch

from harness import compare, traffic
from harness import window as win
from reference import batching as ref_batching

COMPARED = 3
METRIC = "train_frames_per_s"


class FirstSteps:
    """Records, without touching the loop, the program's first steps: what
    the family keeps of each training forward (a forward hook), and from
    the loop's once-a-step callback, which runs before a step's forward,
    the weights before step 0, the gradients that step 0 left for the
    optimizer (read before step 1) and the weights as step `n` finds
    them."""

    def __init__(self, model, family, config, n: int = COMPARED):
        self.model, self.family, self.config, self.n = (model, family,
                                                        config, n)
        self.steps = []
        self.w0 = self.grad0 = self.wn = None
        self.hook = model.register_forward_hook(self._forward)

    def _forward(self, module, args, out):
        if module.training and len(self.steps) < self.n:
            # the lattices go to the host (this is set-up)
            self.steps.append(self.family.keep(out, self.config,
                                               not self.steps))

    def _weights(self, grad=False):
        return {k: (p.grad if grad else p).detach().clone()
                for k, p in self.model.named_parameters()}

    def on_step(self, step: int) -> None:
        if step == 0:
            self.w0 = self._weights()
        elif step == 1:
            self.grad0 = self._weights(grad=True)
        elif step == self.n:
            self.wn = self._weights()

    def remove(self):
        self.hook.remove()

    def captures(self) -> dict:
        """The compared numbers, in the form `numbers` takes them."""
        if self.wn is None:
            raise RuntimeError(f"the loop stopped before step {self.n}")
        return {"steps": self.steps,
                "grad": {k: float(g.norm()) for k, g in self.grad0.items()},
                "change": {k: float((self.wn[k] - w).norm())
                           for k, w in self.w0.items()}}


def _log(line: str) -> None:
    """The loop's log lines go to standard error: the result line is the
    last of standard output."""
    print(line, file=sys.stderr)


def run(cell, seed: int, seconds: float, trace: bool, device,
        stop_at: int | None = None) -> dict:
    """Set-up, the window, and what the check and the readers need. With
    `stop_at` (at least COMPARED), the loop stops before that step and no
    window opens."""
    from aligner_tpu_torch.data.batching import BucketSpec, bucket_batches
    from aligner_tpu_torch.train.loop import train_aligner
    cfg, mix = cell.config, cell.traffic
    fam = cell.family()
    t = [time.perf_counter()]
    items = traffic.corpus(cell, seed, device)
    t.append(time.perf_counter())
    spec = BucketSpec(tuple(mix["text_buckets"]), tuple(mix["mel_buckets"]))
    # the corpus' batches are made up alike for every seed (the mix's
    # sizes_seed shuffles), so that every seed asks the same work
    batches = list(bucket_batches(items, mix["batch_size"], spec,
                                  shuffle_seed=mix["sizes_seed"]))
    first = max(len(batches), COMPARED)
    t.append(time.perf_counter())
    model = fam.build(cfg, device)
    fam.set_precision(device)
    t.append(time.perf_counter())
    rec = FirstSteps(model, fam, cfg)
    clock = win.Window(device, seconds, first, len(batches), trace,
                       stop_at)

    def each_step(step: int) -> dict:
        rec.on_step(step)
        return clock.on_step(step)

    try:
        train_aligner(model, batches, steps=1 << 62, device=device,
                      learning_rate=cfg["learning_rate"],
                      bin_start=-1, bin_ramp=1,
                      log_every=mix["log_every"], seed=seed, shuffle=False,
                      apply_extra=each_step, log_fn=_log)
    except win.WindowClosed:
        pass
    finally:
        rec.remove()
    clock.close()
    n = len(batches)
    frames = [int(b["mel_lengths"].sum()) for b in batches]
    done = {"items": items, "captures": rec.captures(),
            "attempted": len(clock.issued), "failed": 0,
            "steps_run": (clock.issued[-1] + 1 if clock.issued
                          else len(rec.steps)),
            "setup_parts": {"corpus": t[1] - t[0], "batching": t[2] - t[1],
                            "model": t[3] - t[2],
                            "warm_up": (clock.t_start or t[3]) - t[3]},
            "t_start": clock.t_start, "trace_path": clock.trace_path,
            "traced": [batches[s % n] for s in clock.traced], "kind": "train"}
    if clock.issued:
        done["metrics"] = {METRIC: sum(frames[s % n] for s in clock.issued)
                           / clock.window_s}
    return done


def reference_run(cell, seed: int, items: list, device,
                  precision: str) -> dict:
    """The reference's first steps from its own weights on its own
    batches, in the form of the program's captures."""
    cfg, mix = cell.config, cell.traffic
    fam = cell.family()
    ref = fam.reference
    batches = ref_batching.batches(items, mix["batch_size"],
                                   mix["sizes_seed"], mix["text_buckets"],
                                   mix["mel_buckets"])
    params = ref.init_params(cfg, seed, device)
    w0 = {k: p.clone() for k, p in params.items()}
    state: dict = {}
    out = {"steps": []}
    for k in range(COMPARED):
        b = {key: torch.as_tensor(v).to(device)
             for key, v in batches[k].items()}
        for p in params.values():
            p.requires_grad_(True)
        loss, o = ref.train_loss(params, cfg, b, precision)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        params = {key: p.detach() for key, p in params.items()}
        if k == 0:
            out["grad"] = {key: float(g.norm()) for key, g in grads.items()}
        out["steps"].append(fam.keep(o, cfg, k == 0))
        del o, loss
        ref.adamw_step(params, grads, state, cfg["learning_rate"],
                       cfg["weight_decay"])
    out["change"] = {k: float((params[k] - w).norm()) for k, w in w0.items()}
    out["lengths"] = [(b["text_lengths"], b["mel_lengths"])
                      for b in batches[:COMPARED]]
    return out


def numbers(cell, got: dict, ref: dict, device) -> dict:
    """The compared numbers of one run (`harness.compare`): `loss`, the
    largest relative gap of the family's losses over the compared steps;
    `grad` and `change` by the worst leaf; and the largest of each of the
    family's step numbers (`step_numbers`) over the steps."""
    fam, cfg = cell.family(), cell.config
    loss = max(compare.rel_gap(g[k], r[k]) for g, r in
               zip(got["steps"], ref["steps"]) for k in fam.losses(cfg))
    out = {"loss": loss}
    for g, r, (tx, ty) in zip(got["steps"], ref["steps"], ref["lengths"]):
        for k, v in fam.step_numbers(cfg, g, r, tx, ty, device).items():
            out[k] = max(out.get(k, 0.0), v)
    grad = compare.leaf_gaps(got["grad"], ref["grad"], ref["grad"])
    change = compare.leaf_gaps(got["change"], ref["change"], ref["grad"])
    out.update(grad=max(grad.values()), change=max(change.values()),
               _leaves={"grad": grad, "change": change})
    return out


def check(cell, seed: int, done: dict, device) -> dict:
    ref = reference_run(cell, seed, done["items"], device,
                        cell.config["compute_dtype"])
    return numbers(cell, done["captures"], ref, device)


def control(cell, seed: int, device) -> dict:
    """The control's numbers: the reference in the precision below the
    configuration's, put in the program's place."""
    fam = cell.family()
    items = traffic.corpus(cell, seed, device)
    dt = cell.config["compute_dtype"]
    ref = reference_run(cell, seed, items, device, dt)
    low = reference_run(cell, seed, items, device, fam.CONTROL[dt])
    return numbers(cell, low, ref, device)
