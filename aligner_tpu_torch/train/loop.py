"""Training loop: bucketed batches, metrics, LR schedules, gradient
clipping, periodic validation and checkpointing (port of
aligner_tpu/train/loop.py, driven by the demo CLI)."""
from __future__ import annotations

import time
from collections.abc import Iterable

import numpy as np
import torch

from ..data.prefetch import prefetch_to_device
from .checkpoint import (latest_step, restore_checkpoint, save_checkpoint,
                         save_run_config)
from .step import (create_train_state, make_eval_step, make_lr_schedule,
                   make_train_step)


def train_aligner(model, batches: Iterable[dict], *, steps: int, device,
                  learning_rate: float = 3e-4,
                  bin_start: int = 500, bin_ramp: int = 2000,
                  log_every: int = 50, checkpoint_dir: str | None = None,
                  checkpoint_every: int = 1000, log_fn=print,
                  config_extra: dict | None = None,
                  warmup_steps: int = 0, lr_schedule: str = "constant",
                  grad_clip_norm: float | None = None,
                  eval_batches: Iterable[dict] | None = None,
                  eval_every: int | None = None,
                  resume: bool = False, prefetch: int = 2,
                  seed: int = 0, shuffle: bool = True,
                  apply_extra=None, objective=None):
    """Train on an iterable of padded numpy batch dicts (cycled) on
    `device`. Returns the final TrainState and a list of metric records.
    When checkpointing, the model config (and any `config_extra`) is
    written to config.json beside the checkpoints.

    As in the JAX loop, `seed` seeds the parameter init (the model is
    moved to `device` and redrawn with `model.reset_parameters` from a
    generator seeded with it) and the per-epoch batch shuffle, whose
    order equals the JAX loop's; it is recorded in config.json
    (`train_seed`). shuffle=False keeps the fixed cycle order.

    lr_schedule: "constant" or "cosine" (warmup + cosine decay over
    `steps`); warmup_steps: linear warmup length; grad_clip_norm: global
    gradient-norm clip (None = off). eval_batches: held-out batches; the
    training objective is evaluated on them every `eval_every` steps
    (default: log_every * 4) and logged as val_* metrics. resume=True
    restores the latest checkpoint under checkpoint_dir (if any) and
    continues until `steps` total optimizer steps; the run must use the
    same model/optimizer settings as the original. apply_extra and
    objective: as in train.step.make_train_step. Metrics are read back to
    the host only at log, eval and checkpoint points.
    """
    device = torch.device(device)
    batches = list(batches)
    model.to(device)
    model.reset_parameters(torch.Generator().manual_seed(seed))
    if lr_schedule == "constant" and warmup_steps <= 0:
        schedule = None
        lr_arg = learning_rate
    else:
        schedule = make_lr_schedule(learning_rate,
                                    warmup_steps=warmup_steps,
                                    decay_steps=steps,
                                    schedule=lr_schedule)
        lr_arg = schedule
    state = create_train_state(model, learning_rate=lr_arg,
                               grad_clip_norm=grad_clip_norm)
    start_step = 0
    if resume and checkpoint_dir is not None and \
            latest_step(checkpoint_dir) is not None:
        state = restore_checkpoint(checkpoint_dir, state)
        start_step = state.step
        log_fn(f"resumed from {checkpoint_dir} at step {start_step}")
    # Write config.json only after a successful restore: a mismatched
    # resume must fail before this run's config can overwrite the
    # checkpoint directory's metadata.
    if checkpoint_dir is not None and hasattr(model, "config"):
        extra = dict(config_extra or {})
        extra.setdefault("train_seed", seed)
        extra.setdefault("shuffle", shuffle)
        save_run_config(checkpoint_dir, model.config, extra)
    step_fn = make_train_step(model, bin_start=bin_start, bin_ramp=bin_ramp,
                              apply_extra=apply_extra, objective=objective)
    eval_batches = list(eval_batches) if eval_batches else None
    eval_fn = (make_eval_step(model, bin_start=bin_start, bin_ramp=bin_ramp,
                              apply_extra=apply_extra, objective=objective)
               if eval_batches else None)
    if eval_every is None:
        eval_every = log_every * 4
    history = []
    t0 = time.time()

    # One transfer pipeline over an endless batch cycle, reshuffled each
    # epoch from `seed` (the same permutations as the JAX loop).
    def batch_stream():
        rng = np.random.default_rng(seed)
        while True:
            order = (rng.permutation(len(batches)) if shuffle and
                     len(batches) > 1 else range(len(batches)))
            for j in order:
                yield batches[j]

    stream = prefetch_to_device(batch_stream(), max(prefetch, 1), device)
    i = start_step
    for batch in stream:
        if i >= steps:
            break
        state, metrics = step_fn(state, batch)
        i += 1
        if i % log_every == 0 or i == steps:
            rec = {k: float(v) for k, v in metrics.items()}
            # The update recorded at step i was applied with
            # schedule(i - 1).
            rec.update(step=i, wall_s=time.time() - t0,
                       lr=(float(schedule(i - 1)) if schedule is not None
                           else learning_rate))
            history.append(rec)
            detail = "  ".join(
                f"{k.removeprefix('loss_')} {v:8.4f}"
                for k, v in rec.items()
                if k not in ("loss", "step", "wall_s", "lr"))
            log_fn(f"step {i:6d}  loss {rec['loss']:8.4f}  "
                   f"{detail}  [{rec['wall_s']:.1f}s]")
        if eval_fn and (i % eval_every == 0 or i == steps):
            vals = []
            for eb in eval_batches:
                ebt = {k: torch.as_tensor(v).to(device)
                       for k, v in eb.items()}
                vals.append({k: float(v)
                             for k, v in eval_fn(state, ebt).items()})
            val = {f"val_{k}": float(np.mean([v[k] for v in vals]))
                   for k in vals[0]}
            val["step"] = i
            history.append(val)
            log_fn(f"step {i:6d}  val_loss {val['val_loss']:8.4f}  "
                   f"val_fs {val.get('val_loss_forward_sum', 0.0):8.4f}")
        if checkpoint_dir and i % checkpoint_every == 0:
            save_checkpoint(checkpoint_dir, state)
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, state)
    return state, history
