"""Batch alignment serving helpers (port of aligner_tpu/serving.py).

Callers hand over ragged per-utterance lattices; the aligner pads them to
one bucket shape, runs MAS on `device` (kernel H1 on a CUDA device, its
plain version on the CPU), and returns per-utterance paths and durations
trimmed back to true lengths. `SkipBatchAligner` does the same for the
pause-aware (skip-state) Viterbi, kernel H4.

    aligner = BatchAligner(max_text=128, max_mel=1024, device="cuda")
    durations = aligner.align_durations(lattices)   # list of [t_x]

* Every call uses the exact (max_batch, max_text, max_mel) bucket shape:
  larger requests are sliced, and the last partial slice is padded with
  t_x = 0 rows, which the kernel's validity gate turns into all-zero
  paths. One shape per bucket is what a captured CUDA graph will need.
* Lattices keep the reference's [t_x, t_y] orientation on the host and
  the kernel reads and writes that layout directly, so no transpose is
  made on either side.
* `align_durations` runs the kernel's durations mode: only [B, T_x]
  counts cross back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.mas_kernel import mas_durations, mas_path
from .ops.skip_dp_kernel import mas_skip_path


class BatchAligner:
    """Padded-bucket MAS serving.

    max_text / max_mel: bucket shape every request is padded to (requests
    beyond it raise). max_batch: slice size per kernel call. device: where
    the lattices are aligned.
    """

    def __init__(self, max_text: int = 128, max_mel: int = 1024,
                 max_batch: int = 64, *, device="cuda"):
        self.max_text = int(max_text)
        self.max_mel = int(max_mel)
        self.max_batch = int(max_batch)
        self.device = torch.device(device)

    def _pad_slice(self, lattices):
        """Pad <= max_batch lattices to the full bucket shape, batch
        included; padded rows get t_x = 0."""
        B = self.max_batch
        v = np.zeros((B, self.max_text, self.max_mel), np.float32)
        t_x = np.zeros((B,), np.int32)
        t_y = np.zeros((B,), np.int32)
        for i, lat in enumerate(lattices):
            lat = np.asarray(lat, np.float32)
            tx, ty = lat.shape
            if tx > self.max_text or ty > self.max_mel:
                raise ValueError(
                    f"lattice {i} is {tx}x{ty}, exceeds the bucket "
                    f"{self.max_text}x{self.max_mel}; build a larger "
                    f"BatchAligner")
            v[i, :tx, :ty] = lat
            t_x[i], t_y[i] = tx, ty
        return (torch.from_numpy(v).to(self.device),
                torch.from_numpy(t_x).to(self.device),
                torch.from_numpy(t_y).to(self.device))

    def _slices(self, lattices):
        for s in range(0, len(lattices), self.max_batch):
            group = lattices[s:s + self.max_batch]
            yield group, self._pad_slice(group)

    def align(self, lattices):
        """lattices: sequence of [t_x_i, t_y_i] log-likelihood arrays.
        Returns a list of (path [t_x_i, t_y_i] int8, durations [t_x_i]
        int32) tuples."""
        out = []
        for group, (v, t_x, t_y) in self._slices(lattices):
            path = mas_path(v, t_x, t_y).to(torch.int8)
            path_np = path.cpu().numpy()
            durs_np = path.sum(-1, dtype=torch.int32).cpu().numpy()
            for i, lat in enumerate(group):
                tx, ty = np.shape(lat)
                out.append((path_np[i, :tx, :ty].copy(),
                            durs_np[i, :tx].copy()))
        return out

    def align_durations(self, lattices):
        """Durations only: a list of int32 arrays [t_x_i], each summing
        to t_y_i."""
        out = []
        for group, (v, t_x, t_y) in self._slices(lattices):
            durs_np = mas_durations(v, t_x, t_y).cpu().numpy()
            for i, lat in enumerate(group):
                out.append(durs_np[i, :np.shape(lat)[0]].copy())
        return out


class SkipBatchAligner:
    """Padded-bucket serving for the pause-aware (skip-state) Viterbi.

    Callers hand over ragged per-utterance state-major lattices
    [T_s_i, t_y_i] with T_s_i = 2*t_x_i + 1 expanded states (the layout
    `OTAAligner(model_pauses=True)` produces, transposed; see
    ops.skip_dp). Same bucket contract as BatchAligner: every kernel call
    has the (max_batch, 2*max_text+1, max_mel) shape, and padded rows are
    gated to all-zero paths.

        aligner = SkipBatchAligner(max_text=128, max_mel=1024)
        results = aligner.align(lattices)
        # each: (path [T_s_i, t_y_i] f32, token durs [t_x_i],
        #        pause durs [t_x_i + 1])

    enter_cost: optional log-cost per pause entered, an operating-point
    knob at serving time (positive finds more pauses, negative drops
    marginal ones; see ops.skip_dp_reference).
    """

    def __init__(self, max_text: int = 128, max_mel: int = 1024,
                 max_batch: int = 16, *, enter_cost: float = 0.0,
                 device="cuda"):
        self.max_text = int(max_text)
        self.max_states = 2 * int(max_text) + 1
        self.max_mel = int(max_mel)
        self.max_batch = int(max_batch)
        self.enter_cost = float(enter_cost)
        self.device = torch.device(device)

    def align(self, lattices, token_counts=None):
        """lattices: sequence of [T_s_i, t_y_i] state-major log-prob
        arrays (T_s_i odd = 2*t_x_i + 1; t_x_i may also be passed
        explicitly via token_counts). Returns a list of (path
        [T_s_i, t_y_i] f32, token_durations [t_x_i] int32,
        pause_durations [t_x_i + 1] int32) tuples."""
        out = []
        B = self.max_batch
        for start in range(0, len(lattices), B):
            group = lattices[start:start + B]
            vs = np.zeros((B, self.max_states, self.max_mel), np.float32)
            t_x = np.zeros((B,), np.int32)
            t_y = np.zeros((B,), np.int32)
            for i, lat in enumerate(group):
                lat = np.asarray(lat, np.float32)
                ts, ty = lat.shape
                tx = (token_counts[start + i] if token_counts is not None
                      else (ts - 1) // 2)
                if 2 * tx + 1 != ts:
                    raise ValueError(
                        f"lattice {i} has {ts} state rows, expected "
                        f"2*t_x+1 = {2 * tx + 1}")
                if tx > self.max_text or ty > self.max_mel:
                    raise ValueError(
                        f"lattice {i} is {ts}x{ty}, exceeds the bucket "
                        f"{self.max_states}x{self.max_mel}")
                vs[i, :ts, :ty] = lat
                t_x[i], t_y[i] = tx, ty
            path = mas_skip_path(torch.from_numpy(vs).to(self.device),
                                 torch.from_numpy(t_x).to(self.device),
                                 torch.from_numpy(t_y).to(self.device),
                                 enter_cost=self.enter_cost)
            path_np = path.cpu().numpy()
            durs_np = path.sum(-1, dtype=torch.int32).cpu().numpy()
            for i, lat in enumerate(group):
                ts, ty = np.shape(lat)
                out.append((path_np[i, :ts, :ty].copy(),
                            durs_np[i, 1:ts:2].copy(),
                            durs_np[i, 0:ts:2].copy()))
        return out
