"""Training step for the OTA aligner (port of aligner_tpu/train/step.py).

One step runs the model forward (encoders, lattice, forward-sum loss,
MAS binarisation, bin loss), the backward (the forward-sum gradient is
kernel H3 on a CUDA device) and the optimizer update, eagerly. The
optimizer is the JAX package's optax chain written out in PyTorch:
global-norm clipping by optax's formula, then `torch.optim.AdamW`, whose
update (decoupled decay applied to the pre-update parameters, then the
bias-corrected moments) is optax's `adamw` with no mask.

Under a ("data", "model") mesh (`parallel.make_mesh`) the step takes the
global batch, as the JAX package's sharded step does, and runs on the
rank's rows of it (`parallel.batch_sharding`): the model's layers are
split over the model axis (`parallel.shard_params`), the model runs inside
`DistributedDataParallel` over the data axis, which averages the ranks'
gradients, and the batch-wide statistics of the losses are reduced over
the data axis (`parallel.data`). The metrics are the ranks' average,
which is the unsharded step's value.
"""
from __future__ import annotations

import dataclasses
import math
from collections.abc import Callable
from typing import Any

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor
from torch.nn.parallel import DistributedDataParallel

from ..parallel.data import batch_group
from ..parallel.mesh import batch_sharding, shard_params
from ..parallel.tensor import param_shards
from ..utils import tracing


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    """Learning rate by optimizer step, with the values of the optax
    schedule that aligner_tpu's make_lr_schedule builds (see there)."""
    learning_rate: float
    warmup_steps: int = 0
    decay_steps: int | None = None
    schedule: str = "constant"
    final_scale: float = 0.1

    def __call__(self, step: int) -> float:
        lr = self.learning_rate
        if self.schedule == "constant":
            if self.warmup_steps <= 0:
                return lr
            return _linear(0.0, lr, self.warmup_steps, step)
        # optax.warmup_cosine_decay_schedule: decay_steps counts the
        # warm-up, and the cosine runs from the end of the warm-up.
        warmup = max(self.warmup_steps, 1)
        decay = max(self.decay_steps, self.warmup_steps + 1) - warmup
        if step < warmup:
            return _linear(0.0, lr, warmup, step)
        end = self.final_scale * lr
        alpha = 0.0 if lr == 0.0 else end / lr
        count = min(step - warmup, decay)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay))
        return lr * ((1.0 - alpha) * cosine + alpha)


def _linear(init: float, end: float, steps: int, step: int) -> float:
    """optax.linear_schedule(init, end, steps) at `step`."""
    frac = 1.0 - min(max(step, 0), steps) / steps
    return (init - end) * frac + end


def make_lr_schedule(learning_rate: float, *, warmup_steps: int = 0,
                     decay_steps: int | None = None,
                     schedule: str = "constant",
                     final_scale: float = 0.1) -> LRSchedule:
    """Learning-rate schedule factory.

    schedule: "constant" (optionally with linear warmup) or "cosine"
    (linear warmup -> cosine decay to final_scale * learning_rate over
    decay_steps, which include the warm-up). Returns a callable
    step -> lr, read at the step count before the update.
    """
    if schedule == "cosine":
        if decay_steps is None:
            raise ValueError("cosine schedule requires decay_steps")
        if max(decay_steps, warmup_steps + 1) - max(warmup_steps, 1) <= 0:
            raise ValueError("cosine schedule requires decay_steps beyond "
                             f"the warm-up, got {decay_steps}")
    elif schedule != "constant":
        raise ValueError(f"unknown schedule: {schedule!r}")
    return LRSchedule(learning_rate, warmup_steps, decay_steps, schedule,
                      final_scale)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float, *,
                         sharded: list[torch.Tensor] = (),
                         group: dist.ProcessGroup | None = None) -> None:
    """optax.clip_by_global_norm in place: g * max_norm / |g| (as
    (g / |g|) * max_norm) when the global norm |g| >= max_norm. Unlike
    torch.nn.utils.clip_grad_norm_ no epsilon is added. Stays on the
    device: nothing is read back to the host.

    sharded: gradients of parameters split over the ranks of `group` (the
    mesh's model axis): their squares are summed over the group, while
    `grads`, the same on every rank, count once."""
    if not grads and not sharded:
        return
    sq = sum(torch.sum(g * g) for g in grads)
    if sharded:
        part = sum(torch.sum(g * g) for g in sharded)
        dist.all_reduce(part, group=group)
        sq = sq + part
    g_norm = torch.sqrt(sq)
    keep = g_norm < max_norm
    for g in (*grads, *sharded):
        g.copy_(torch.where(keep, g, (g / g_norm) * max_norm))


@dataclasses.dataclass
class TrainState:
    """The model, its optimizer, the count of updates applied and an
    optional learning-rate schedule (flax's TrainState, in torch: the
    parameters live in the model and are updated in place). Under a mesh
    also the mesh and the model's DistributedDataParallel wrapper."""
    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0
    schedule: Callable[[int], float] | None = None
    grad_clip_norm: float | None = None
    mesh: DeviceMesh | None = None
    ddp: DistributedDataParallel | None = None

    def apply_gradients(self) -> None:
        """One update from the gradients on the model's parameters: clip,
        AdamW at schedule(step), then step += 1 (optax reads its count
        before incrementing it).

        A parameter the objective left without a gradient takes a zero
        one, as in optax's adamw: its moments and count advance and its
        weight decays. (A sharded step refuses such an objective first:
        DDP cannot average a bucket whose hook never fired.)"""
        for p in self.model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if self.grad_clip_norm is not None:
            shards = param_shards(self.model)
            grads = {n: p.grad for n, p in self.model.named_parameters()}
            clip_by_global_norm_(
                [g for n, g in grads.items() if n not in shards],
                self.grad_clip_norm,
                sharded=[g for n, g in grads.items() if n in shards],
                group=next((s.group for s in shards.values()), None))
        if self.schedule is not None:
            lr = self.schedule(self.step)
            for group in self.optimizer.param_groups:
                group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def create_train_state(model: nn.Module, learning_rate=1e-4,
                       weight_decay: float = 1e-6,
                       grad_clip_norm: float | None = None,
                       mesh: DeviceMesh | None = None) -> TrainState:
    """AdamW over every parameter of `model` (weight decay on all of them,
    as optax's adamw without a mask).

    learning_rate: float (constant) or a schedule from make_lr_schedule.
    grad_clip_norm: clip gradients by global norm before the update
    (None = no clipping). The parameters are the model's own: build it
    from a seeded generator or load converted weights first, the same on
    every rank. mesh: shard the model's layers over its model axis and
    wrap the model in DistributedDataParallel over its data axis. Every
    parameter must then take a gradient in each step (see
    make_train_step).
    """
    ddp = None
    if mesh is not None:
        shard_params(model, mesh)
        device = next(model.parameters()).device
        # find_unused_parameters=False: no walk of the autograd graph on the
        # host each step. The step checks instead that every parameter took
        # a gradient, since DDP would leave a bucket unreduced otherwise.
        ddp = DistributedDataParallel(
            model, device_ids=[device] if device.type == "cuda" else None,
            process_group=mesh.get_group("data"))
    schedule = learning_rate if callable(learning_rate) else None
    lr = schedule(0) if schedule is not None else learning_rate
    optimizer = torch.optim.AdamW(model.parameters(), lr=lr,
                                  betas=(0.9, 0.999), eps=1e-8,
                                  weight_decay=weight_decay)
    return TrainState(model, optimizer, 0, schedule, grad_clip_norm, mesh,
                      ddp)


def bin_loss_weight(step: int, start: int = 1000, ramp: int = 10000,
                    max_weight: float = 1.0) -> float:
    """OTA-style annealing: binarisation loss off until `start`, then
    linear ramp to `max_weight` over `ramp` steps."""
    w = (step - start) / max(ramp, 1)
    return min(max(w, 0.0), 1.0) * max_weight


def make_default_objective(bin_start: int = 1000, bin_ramp: int = 10000,
                           recon_weight: float = 1.0):
    """The OTA loss schedule as a standalone objective(out, step) — shared
    by make_train_step and make_eval_step so validation uses the same
    weighting as training at the current step."""

    def objective(out, step_no):
        w_bin = bin_loss_weight(step_no, bin_start, bin_ramp)
        loss = (out["loss_forward_sum"] + w_bin * out["loss_bin"]
                + recon_weight * out.get("loss_recon", 0.0))
        return loss, {
            "loss_forward_sum": out["loss_forward_sum"],
            "loss_bin": out["loss_bin"],
            "bin_weight": w_bin,
            "mean_max_attn": torch.mean(
                torch.amax(torch.exp(out["log_attn"]), dim=-1)),
        }

    return objective


def _metrics(loss, extra: dict,
             group: dist.ProcessGroup | None = None) -> dict[str, Any]:
    """Metrics stay on the device (detached); the caller reads them back
    only where it needs them. With a group (a sharded step's data axis)
    the tensor metrics are the ranks' average, in one all-reduce."""
    metrics = {k: v.detach() if torch.is_tensor(v) else v
               for k, v in {"loss": loss, **extra}.items()}
    keys = [k for k, v in metrics.items() if torch.is_tensor(v)]
    if group is None or not keys:
        return metrics
    flat = torch.stack([metrics[k].float() for k in keys])
    dist.all_reduce(flat, group=group)
    flat = flat / dist.get_world_size(group)
    return {**metrics, **dict(zip(keys, flat.unbind()))}


def _local_batch(batch: dict, mesh: DeviceMesh, device) -> dict:
    """This rank's rows of a global batch: a DTensor's local slice (from
    `prefetch_to_device(sharding=)`), or the rank's rows of a tensor or
    array (`batch_sharding`), copied to `device`."""
    rows = batch_sharding(mesh)
    return {k: v.to_local() if isinstance(v, DTensor)
            else torch.as_tensor(rows.local(v)).to(device)
            for k, v in batch.items()}


def _check_state(model, mesh, state: TrainState) -> None:
    """Refuse a state built for another model or another mesh: an
    unsharded state under a sharded step would apply each rank's own
    gradient, and a sharded one under an unsharded step would run the
    whole batch on every data rank."""
    if state.model is not model:
        raise ValueError("the train state holds another model than the "
                         "one this step was made for")
    if state.mesh is not mesh:
        raise ValueError("the train state was built for another mesh than "
                         "the one this step was made for: pass the same "
                         "mesh (or None) to create_train_state and the step")


def _forward(model, state: TrainState, batch: dict, apply_extra, obj,
             module=None):
    """The model's forward and the objective at the state's step; the
    callback `apply_extra` runs first, outside the `step.forward` span."""
    extra_kw = apply_extra(state.step) if apply_extra else {}
    with tracing.span("step.forward"):
        out = (module or model)(batch["tokens"], batch["mel"],
                                batch["text_lengths"], batch["mel_lengths"],
                                **extra_kw)
        return obj(out, state.step)


def _require_gradients(model: nn.Module) -> None:
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    if missing:
        raise ValueError(
            f"the objective leaves {missing} without a gradient; a sharded "
            "step averages every parameter's gradient over the data axis, "
            "so build the model without them or reach them in the loss")


def make_train_step(model: nn.Module, mesh: DeviceMesh | None = None, *,
                    bin_start: int = 1000, bin_ramp: int = 10000,
                    recon_weight: float = 1.0, objective=None,
                    apply_extra=None):
    """Returns step(state, batch) -> (state, metrics); the state is
    updated in place and returned.

    The default objective is the OTA schedule (forward-sum + annealed bin
    loss + optional reconstruction), evaluated at the step count before
    the update. Other model families pass `objective(out, step) ->
    (loss, extra_metrics)`. apply_extra: optional `fn(step_no) -> dict`
    of extra keyword arguments for the model's forward.

    mesh: the state's mesh (create_train_state(mesh=)). The step takes the
    global batch, the same on every rank (or the DTensors of
    `prefetch_to_device(sharding=)`), runs on the rank's rows and returns
    the unsharded step's metrics on every rank. Every parameter must take
    a gradient: a parameter the objective leaves out raises ValueError at
    the first step.
    """
    obj = objective or make_default_objective(bin_start, bin_ramp,
                                              recon_weight)
    group = None if mesh is None else mesh.get_group("data")

    def step(state: TrainState, batch: dict[str, Any]):
        _check_state(model, mesh, state)
        if mesh is not None:
            batch = _local_batch(batch, mesh,
                                 next(model.parameters()).device)
        with batch_group(group):
            loss, extra = _forward(model, state, batch, apply_extra, obj,
                                   state.ddp)
        with tracing.span("step.backward"):
            state.optimizer.zero_grad(set_to_none=True)
            loss.backward()
            if mesh is not None:
                _require_gradients(model)
        with tracing.span("step.update"):
            state.apply_gradients()
        return state, _metrics(loss, extra, group)

    return step


def make_eval_step(model: nn.Module, mesh: DeviceMesh | None = None, *,
                   bin_start: int = 1000, bin_ramp: int = 10000,
                   recon_weight: float = 1.0, objective=None,
                   apply_extra=None):
    """Returns eval(state, batch) -> metrics: the training objective
    evaluated at the state's current step, no gradient, no update.
    apply_extra and mesh: as in make_train_step."""
    obj = objective or make_default_objective(bin_start, bin_ramp,
                                              recon_weight)
    group = None if mesh is None else mesh.get_group("data")

    @torch.no_grad()
    def evaluate(state: TrainState, batch: dict[str, Any]):
        _check_state(model, mesh, state)
        if mesh is not None:
            batch = _local_batch(batch, mesh,
                                 next(model.parameters()).device)
        with batch_group(group):
            loss, extra = _forward(model, state, batch, apply_extra, obj)
        return _metrics(loss, extra, group)

    return evaluate
