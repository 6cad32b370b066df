"""What each rank of a spawned CPU mesh runs for the parallel checks.

`parallel.launch.spawn` runs these in fresh processes, which import this
package and nothing of the caller (neither a test module nor JAX), so the
callers compare the results with their references in their own process.
Global rank 0 writes its results with `torch.save` to `out`; every rank
raises on a failure.

* `train_ranks`: sharded train steps of the OTA, pause-aware OTA, MoBo and
  RoMo families (their metrics and gathered parameters), a step whose
  objective leaves a parameter out (refused), states and steps built for
  different meshes (refused), `train_aligner(mesh=)` with
  a checkpoint, and a step from an unsharded run's checkpoint.
* `sequence_ranks`: `mas_sequence_parallel` gated and pipelined, its two
  errors, and per-rank `maximum_path` on batch slices, gathered.
"""
from __future__ import annotations

import os

import torch
import torch.distributed as dist

from .cli import _mobo_objective, _no_hard_decode, _romo_objective
from .models import (MoBoAligner, MoBoConfig, OTAAligner, OTAConfig,
                      RoMoAligner, RoMoConfig)
from .ops.mas import maximum_path
from .train.checkpoint import restore_checkpoint
from .train.loop import train_aligner
from .train.step import (create_train_state, make_eval_step,
                         make_train_step)
from .parallel.mesh import batch_sharding, make_mesh
from .parallel.sequence import mas_sequence_parallel
from .parallel.tensor import gathered_state_dict, param_shards

# family -> (model, config, objective, apply_extra) as the train command
# trains it
FAMILIES = {
    "ota": (OTAAligner, OTAConfig, None, None),
    "mobo": (MoBoAligner, MoBoConfig, _mobo_objective, _no_hard_decode),
    "romo": (RoMoAligner, RoMoConfig, _romo_objective, _no_hard_decode),
}


def build(family: str, config: dict):
    """(model, objective, apply_extra) of a family at `config` (the
    config's fields as a dict), on the CPU."""
    model_cls, config_cls, objective, apply_extra = FAMILIES[family]
    return model_cls(config_cls(**config)), objective, apply_extra


def sharded_steps(mesh, case: dict) -> dict:
    """One sharded step on each of `case["batches"]` from `case["init"]`:
    the metrics of each step, the gathered parameters after the last and
    the names of the sharded parameters."""
    model, objective, apply_extra = build(case["family"], case["config"])
    model.load_state_dict(case["init"])
    state = create_train_state(model, learning_rate=case["lr"],
                               grad_clip_norm=case["clip"], mesh=mesh)
    step = make_train_step(model, mesh, bin_start=case["bin_start"],
                           bin_ramp=case["bin_ramp"], objective=objective,
                           apply_extra=apply_extra)
    metrics = []
    for batch in case["batches"]:
        state, m = step(state, batch)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": gathered_state_dict(model),
            "sharded": sorted(param_shards(model))}


def unused_parameter(mesh, case: dict) -> str:
    """The ValueError of a sharded step whose objective leaves the
    reconstruction decoder of `case`'s model without a gradient."""
    model, _, _ = build(case["family"], case["config"])
    state = create_train_state(model, learning_rate=case["lr"], mesh=mesh)
    step = make_train_step(
        model, mesh, objective=lambda out, _: (out["loss_forward_sum"], {}))
    try:
        step(state, case["batches"][0])
    except ValueError as e:
        return str(e)
    raise AssertionError("a parameter without a gradient went through")


def mesh_mismatch(mesh, case: dict) -> list[str]:
    """The ValueErrors of an unsharded state under a sharded step and of a
    sharded state under an unsharded step, train and eval."""
    errors = []
    for state_mesh, step_mesh in ((None, mesh), (mesh, None)):
        model, _, _ = build(case["family"], case["config"])
        state = create_train_state(model, learning_rate=case["lr"],
                                   mesh=state_mesh)
        for make in (make_train_step, make_eval_step):
            try:
                make(model, step_mesh)(state, case["batches"][0])
            except ValueError as e:
                errors.append(str(e))
    return errors


def train_ranks(rank: int, out: str, n_data: int, n_model: int,
                cases: list[dict], loop: dict) -> None:
    """Every case's sharded steps on an n_data x n_model mesh, then
    `train_aligner(mesh=)` on `loop` with a checkpoint under out/ckpt,
    then one sharded step from `loop["unsharded_checkpoint"]`; rank 0
    writes out/train.pt."""
    mesh = make_mesh(n_data, n_model, device_type="cpu")
    results = {case["name"]: sharded_steps(mesh, case) for case in cases}
    results["unused"] = unused_parameter(mesh, cases[0])
    results["mesh_mismatch"] = mesh_mismatch(mesh, cases[0])
    model, objective, apply_extra = build(loop["family"], loop["config"])
    state, history = train_aligner(
        model, loop["batches"], steps=loop["steps"], device="cpu",
        learning_rate=loop["lr"], mesh=mesh, log_every=1,
        checkpoint_dir=os.path.join(out, "ckpt"), seed=loop["seed"],
        objective=objective, apply_extra=apply_extra)
    results["loop"] = {"history": history,
                       "params": gathered_state_dict(model),
                       "step": state.step}
    # the other way: an unsharded run's checkpoint into a sharded model
    model, _, _ = build(loop["family"], loop["config"])
    state = restore_checkpoint(loop["unsharded_checkpoint"],
                               create_train_state(model, learning_rate=
                                                  loop["lr"], mesh=mesh))
    _, metrics = make_train_step(model, mesh)(state, loop["batches"][0])
    results["restored"] = {"loss": float(metrics["loss"]),
                           "params": gathered_state_dict(model)}
    if rank == 0:
        torch.save(results, os.path.join(out, "train.pt"))


def sequence_ranks(rank: int, out: str, cases: list[tuple],
                   batch: tuple) -> None:
    """On a (world, 1) mesh: `mas_sequence_parallel` on each (value, t_x,
    t_y, microbatch) case; its two errors (T_y not divisible by the ranks,
    B not divisible by the microbatches), which raise on every rank before
    any message, then a batch the data axis does not divide, a CUDA mesh
    over this gloo group and a mesh of half the ranks, which raise too;
    and `maximum_path` on each rank's rows of `batch` (value, mask),
    gathered over the data axis. Each rank writes out/sp<rank>.pt."""
    mesh = make_mesh(dist.get_world_size(), 1, device_type="cpu")
    paths = [mas_sequence_parallel(torch.from_numpy(v), torch.from_numpy(tx),
                                   torch.from_numpy(ty), mesh, microbatch=m)
             for v, tx, ty, m in cases]
    errors = []
    n = dist.get_world_size()
    for shape, microbatch in (((1, 4, 4 * n + 1), None), ((6, 4, 2 * n), 4)):
        try:
            mas_sequence_parallel(torch.zeros(shape),
                                  torch.full(shape[:1], 4),
                                  torch.full(shape[:1], shape[2]), mesh,
                                  microbatch=microbatch)
        except ValueError as e:
            errors.append(str(e))
    rows = batch_sharding(mesh)
    try:
        rows.local(torch.zeros(n + 2, 2))
    except ValueError as e:
        errors.append(str(e))
    try:
        make_mesh(n, 1, device_type="cuda")
    except RuntimeError as e:
        errors.append(str(e))
    try:
        make_mesh(n // 2, 1, device_type="cpu")
    except ValueError as e:
        errors.append(str(e))
    # every rank reaches this collective: none waits on a message
    dist.barrier()
    value, mask = (torch.from_numpy(a) for a in batch)
    local = maximum_path(rows.local(value), rows.local(mask))
    parts = [torch.empty_like(local) for _ in range(n)]
    dist.all_gather(parts, local, group=mesh.get_group("data"))
    torch.save({"paths": paths, "errors": errors,
                "batch_sharded": torch.cat(parts)},
               os.path.join(out, f"sp{rank}.pt"))
