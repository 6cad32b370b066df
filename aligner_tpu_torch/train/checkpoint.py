"""Checkpoint / resume for aligner training (port of
aligner_tpu/train/checkpoint.py, with torch.save in place of Orbax).

A checkpoint is `directory/<step>/state.pt`: the model's state_dict, the
optimizer's, the step count and whether the run had a learning-rate
schedule (a restore needs the same kind, as the JAX package's optimizer
state must match).
`config.json` beside the step directories has the JAX package's schema,
so a run directory says which model it holds. Reading a JAX (Orbax)
checkpoint is not supported.

A checkpoint always holds whole tensors. Under a mesh, save gathers the
parameters and Adam moments split over the model axis, global rank 0
writes and every rank waits at a barrier; restore loads the whole tensors
and keeps each rank's rows. So a sharded run's checkpoint restores into an
unsharded model, and the other way round.
"""
from __future__ import annotations

import dataclasses
import json
import os

import torch
import torch.distributed as dist

from ..parallel.tensor import (gather_shards, gathered_state_dict,
                               param_shards)
from .step import TrainState

CONFIG_FILENAME = "config.json"
STATE_FILENAME = "state.pt"


def save_run_config(directory: str, model_config, extra: dict | None = None):
    """Persist the model config (a dataclass) next to the checkpoints so
    restore is self-contained."""
    os.makedirs(os.path.abspath(directory), exist_ok=True)
    rec = {
        "model_class": type(model_config).__name__.removesuffix("Config"),
        "model_config": dataclasses.asdict(model_config),
    }
    if extra:
        rec.update(extra)
    path = os.path.join(os.path.abspath(directory), CONFIG_FILENAME)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, sort_keys=True)
    return path


def load_run_config(directory: str) -> dict | None:
    """The dict written by `save_run_config`, or None for pre-config
    checkpoints."""
    path = os.path.join(os.path.abspath(directory), CONFIG_FILENAME)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        rec = json.load(f)
    mc = rec.get("model_config")
    if (rec.get("model_class") == "OTA" and isinstance(mc, dict)
            and mc.get("model_pauses") and "pause_prior" not in mc):
        # Pause-aware checkpoints saved before the pause_prior knob
        # existed were trained under the then-only "inherit" prior;
        # letting OTAConfig's default ("bridge") fill the gap would
        # silently change the prior lattice the restored params see.
        mc["pause_prior"] = "inherit"
    return rec


def latest_step(directory: str) -> int | None:
    """The newest checkpoint step under `directory`, or None if the
    directory holds no checkpoints. The single source of truth for what
    counts as a checkpoint entry (a digit-named subdirectory)."""
    directory = os.path.abspath(directory)
    if not os.path.isdir(directory):
        return None
    steps = [int(d) for d in os.listdir(directory) if d.isdigit()]
    return max(steps) if steps else None


def _moments(model, optimizer_state: dict):
    """(parameter index, its shard, its optimizer state) of each sharded
    parameter; indices as in the optimizer's state_dict, which lists the
    model's parameters in order."""
    shards = param_shards(model)
    for i, (name, p) in enumerate(model.named_parameters()):
        if name in shards and i in optimizer_state:
            yield i, shards[name], optimizer_state[i]


def _whole(state: TrainState) -> tuple[dict, dict]:
    """The model's and the optimizer's state_dicts with every tensor split
    over the model axis gathered whole (a collective on every rank)."""
    model_state = gathered_state_dict(state.model)
    optim_state = state.optimizer.state_dict()
    # the entries are the optimizer's own dicts: replace them, never write
    # into them
    per_param = dict(optim_state["state"])
    for i, shard, st in _moments(state.model, per_param):
        per_param[i] = {k: gather_shards(v, shard, shard.dim)
                        if torch.is_tensor(v) and v.ndim else v
                        for k, v in st.items()}
    return model_state, {**optim_state, "state": per_param}


def _rows(model, model_state: dict, optim_state: dict | None) -> None:
    """Keep this rank's rows of each whole tensor that the model splits
    over its model axis, in place in the loaded dicts."""
    for name, shard in param_shards(model).items():
        model_state[name] = model_state[name].chunk(
            shard.size, shard.dim)[shard.rank]
    if optim_state is not None:
        per_param = optim_state["state"]
        for i, shard, st in _moments(model, per_param):
            per_param[i] = {k: v.chunk(shard.size, shard.dim)[shard.rank]
                            if torch.is_tensor(v) and v.ndim else v
                            for k, v in st.items()}


def save_checkpoint(directory: str, state: TrainState,
                    step: int | None = None) -> str:
    """Save a TrainState under `directory/<step>` (written to a temporary
    file first, then renamed, so a step directory never holds half a
    checkpoint). Under a mesh every rank calls it: the split tensors are
    gathered, global rank 0 writes, and all ranks return after it has."""
    step = state.step if step is None else step
    path = os.path.join(os.path.abspath(directory), str(step))
    model_state, optim_state = _whole(state)
    if state.mesh is None or dist.get_rank() == 0:
        os.makedirs(path, exist_ok=True)
        target = os.path.join(path, STATE_FILENAME)
        torch.save({"model": model_state, "optimizer": optim_state,
                    "step": state.step,
                    "has_schedule": state.schedule is not None},
                   target + ".tmp")
        os.replace(target + ".tmp", target)
    if state.mesh is not None:
        dist.barrier()
    return path


def _load(directory: str, step: int | None, device) -> dict:
    directory = os.path.abspath(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {directory}")
    return torch.load(os.path.join(directory, str(step), STATE_FILENAME),
                      map_location=device, weights_only=True)


def _device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def restore_checkpoint(directory: str, target: TrainState,
                       step: int | None = None) -> TrainState:
    """Restore into `target` (a TrainState built like the saved one: same
    model configuration, optimizer and schedule kind, sharded or not) and
    return it. If step is None, restores the latest. A mismatched model or
    optimizer raises."""
    rec = _load(directory, step, _device(target.model))
    if rec["has_schedule"] != (target.schedule is not None):
        raise ValueError(
            "the checkpoint's learning-rate schedule does not match the "
            f"target's: saved with a schedule: {rec['has_schedule']}, "
            f"target {target.schedule}")
    _rows(target.model, rec["model"], rec["optimizer"])
    target.model.load_state_dict(rec["model"])
    target.optimizer.load_state_dict(rec["optimizer"])
    target.step = rec["step"]
    return target


def restore_params(directory: str, model: torch.nn.Module,
                   step: int | None = None) -> torch.nn.Module:
    """Restore only the model's parameters, whatever optimizer or
    schedule the run used, and return the model."""
    rec = _load(directory, step, _device(model))
    _rows(model, rec["model"], None)
    model.load_state_dict(rec["model"])
    return model
