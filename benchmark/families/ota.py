"""The OTA aligner family: how the program builds a configuration, its
FLOPs, its control's precision, its plain reference (`reference/ota.py`),
what the paths keep of a forward pass and the numbers they compare, and
the faults that only this family's program can have.

A configuration file of this family holds `OTAConfig`'s fields at its top
level, and the optimizer's `learning_rate` and `weight_decay`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from unittest import mock

import numpy as np
import torch

from harness import compare
from reference import ota as reference
from reference import viterbi

# The control's arithmetic: the nearest precision below the one the
# configuration states (its compute_dtype, which `reference.ota` takes).
CONTROL = {"float32": "tf32", "bfloat16": "fp8"}


def model_class():
    from aligner_tpu_torch.models.ota import OTAAligner
    return OTAAligner


def build(config: dict, device, generator=None):
    """The program's model of this configuration on `device` (drawn from
    `generator`; the train path redraws it from the seed)."""
    from aligner_tpu_torch.models.ota import OTAAligner, OTAConfig
    fields = {f.name: config[f.name]
              for f in dataclasses.fields(OTAConfig) if f.name in config}
    return OTAAligner(OTAConfig(**fields), device=device,
                      generator=generator)


def set_precision(device) -> None:
    """The program's float32 setting, as the train and align commands
    make it (no TF32 in cuBLAS or cuDNN)."""
    import torch
    from aligner_tpu_torch.cli import _float32_on
    _float32_on(torch.device(device))


def flops(config: dict, batch: dict) -> float:
    """Forward FLOPs of one batch on its valid lengths: the encoders'
    convolutions, the energy product, and with `use_recon` the decoder
    and the reconstruction's product; 2 a multiply-add. The DP sweeps,
    the softmax and the elementwise work count nothing.

        text:   t_x (2 (3 H H + 3 H H + H D))
        mel:    t_y (2 (3 M H + 3 H H + H D))
        energy: t_y L 2 D,   L = t_x (+ 1 pause label)
        recon:  L 2 D M + t_y L 2 M
    """
    H, D, M = config["hidden"], config["dim"], config["n_mels"]
    t_x = np.asarray(batch["text_lengths"], np.float64)
    t_y = np.asarray(batch["mel_lengths"], np.float64)
    L = t_x + (1 if config["model_pauses"] else 0)
    f = t_x * 2 * (6 * H * H + H * D)
    f += t_y * 2 * (3 * M * H + 3 * H * H + H * D)
    f += t_y * L * 2 * D
    if config["use_recon"]:
        f += L * 2 * D * M + t_y * L * 2 * M
    return float(f.sum())


def enter_cost(config: dict) -> float:
    return float(config["pause_enter_cost"])


def answers(out: dict):
    """The hard answer of a forward pass (the program's or the
    reference's): durations [B, T_x], and with pauses the pause durations
    [B, T_x + 1], as int64 numpy arrays."""
    d = out["durations"].detach().round().long().cpu().numpy()
    p = out.get("pause_durations")
    return d, (None if p is None else p.detach().round().long().cpu()
               .numpy())


def answer_key(answer) -> bytes:
    d, p = answer
    return d.tobytes() + (b"" if p is None else p.tobytes())


def losses(config: dict) -> tuple:
    """The losses of a training step that the train path compares: the
    objective's terms at the weights the window trains with."""
    keys = ("loss_forward_sum", "loss_bin")
    return keys + (("loss_recon",) if config["use_recon"] else ())


ALIGN_LOSS = "loss_forward_sum"


def keep(out: dict, config: dict, first: bool) -> dict:
    """What the train path keeps of one training forward pass (the
    program's or the reference's): its losses, its hard answer, its
    lattice with the prior, and on the first step its log-attention; the
    lattices on the host."""
    kept = {k: float(out[k].detach()) for k in losses(config)}
    kept["answer"] = answers(out)
    kept["logp_with_prior"] = out["logp_with_prior"].detach().cpu()
    if first:
        kept["log_attn"] = out["log_attn"].detach().cpu()
    return kept


def step_numbers(config: dict, got: dict, ref: dict, t_x, t_y,
                 device) -> dict:
    """One compared training step's numbers (`harness.compare`): `path`,
    the items whose hard path differs from the float32 Viterbi worked out
    on the program's own lattice; `path_nats`, the widest gap by which the
    program's path scores below the reference's best on the reference's
    lattice; and where both kept them, `lattice` and `lattice_prior`, the
    largest gaps of the log-attention and of the lattice with the
    prior."""
    pauses = config["model_pauses"]
    c = enter_cost(config)
    lp = got["logp_with_prior"]
    d, p = got["answer"]
    if not len(d) == len(lp) == len(t_x):
        return {"path": np.inf, "path_nats": np.inf}
    want_d, want_p = viterbi.float32_durations(lp.to(device), t_x, t_y,
                                               pauses, c)
    differ = (d != want_d).any(axis=1)
    if p is not None:
        differ |= (p != want_p).any(axis=1)
    ref_lp = ref["logp_with_prior"].to(device)
    out = {"path": float(differ.sum()),
           "path_nats": compare.path_gap(ref_lp, t_x, t_y, d, p, c)}
    if "log_attn" in got and "log_attn" in ref:
        out["lattice"] = compare.lattice_gap(got["log_attn"],
                                             ref["log_attn"].to(device),
                                             t_x, t_y, pauses)
        out["lattice_prior"] = compare.lattice_gap(lp, ref_lp, t_x, t_y,
                                                   pauses)
    return out


def batch_numbers(config: dict, ref: dict, t_x, t_y, answer,
                  log_attn=None) -> dict:
    """On the align path, one batch's numbers against the reference's
    forward pass `ref`: `path`, the gap in nats of the answer's path below
    the reference's best on the reference's lattice, and with the
    program's log-attention, `lattice`."""
    d, p = answer
    out = {"path": compare.path_gap(ref["logp_with_prior"], t_x, t_y, d, p,
                                    enter_cost(config))}
    if log_attn is not None:
        out["lattice"] = compare.lattice_gap(log_attn, ref["log_attn"], t_x,
                                             t_y, config["model_pauses"])
    return out


def best_answer(config: dict, ref: dict, t_x, t_y):
    """The best path's answer on a reference forward pass's lattice (the
    align path's control answers with it)."""
    _, d, p = viterbi.best_paths(ref["logp_with_prior"], t_x, t_y,
                                 config["model_pauses"], enter_cost(config))
    return d, p


# Faults only this family's program can have (`harness.faults` plants
# them, with the general ones, under the timed path).

def _shift_first_boundary(path: torch.Tensor) -> torch.Tensor:
    """path [B, T_y, T] 0/1: item 0's first frame on a new state is put on
    the state before it."""
    path = path.clone()
    states = path[0].argmax(dim=1)
    moved = (states[1:] != states[:-1]).nonzero()
    if len(moved):
        y = int(moved[0]) + 1
        path[0, y] = 0
        path[0, y, states[0]] = 1
    return path


@contextlib.contextmanager
def answer_altered():
    """The hard path's first item gives one frame of its second segment
    to its first, where the path is produced."""
    import aligner_tpu_torch.models.ota as ota
    plain, skip = ota.mas_path_frame_major, ota.mas_skip_path_frame_major
    with mock.patch.object(ota, "mas_path_frame_major",
                           lambda *a, **k: _shift_first_boundary(
                               plain(*a, **k))), \
            mock.patch.object(ota, "mas_skip_path_frame_major",
                              lambda *a, **k: _shift_first_boundary(
                                  skip(*a, **k))):
        yield


@contextlib.contextmanager
def bin_detached():
    """The binarisation loss reaches the objective with no gradient: its
    cross-entropy no longer trains the encoders."""
    cls = model_class()
    forward = cls.forward

    def detached(self, *args, **kw):
        out = forward(self, *args, **kw)
        out["loss_bin"] = out["loss_bin"].detach()
        return out

    with mock.patch.object(cls, "forward", detached):
        yield


FAULTS = {"answer_altered": answer_altered, "bin_detached": bin_detached}
