"""MoBo token sweeps on the card and their plain PyTorch versions
(`csrc/mobo.cu`), counterpart of aligner_tpu/ops/mobo_pallas.py:

* kernel H7, the forward boundary recursion, counterpart of
  mobo_alpha_pallas; plain version `mobo_alpha_plain`, the port of
  `_boundary_scan(use_max=False)` (aligner_tpu/ops/mobo.py);
* kernel H8, the same recursion with max/argmax, its backpointers and, in
  the same launch, the walk over them that the JAX package runs as a scan
  outside its kernel, counterpart of mobo_bp_pallas; plain version
  `mobo_bp_plain`, the port of `_boundary_scan(use_max=True)` and of the
  walk in `mobo_hard_boundaries`;
* kernel H9, the backward recursion, counterpart of mobo_beta_pallas;
  plain version `mobo_beta_plain`, the port of `_beta_scan`.

All take the token-major grid e_tm [T_x, B, T_y1] of
`ops.mobo._prep_energies` (T_y1 = T_y + 1, position 0 = the virtual frame
-1, position 0 and frames >= t_y at NEG), read through its strides, and a
static window D >= 1. The plain versions keep the reference's operation
order (`_window_lse`: max over d ascending, sum of exp over d ascending,
max + log; `_window_max_argmax_back`: a later d replaces only if strictly
greater), so on live cells the kernels agree with them to the last bit;
dead cells hold NEG give or take log(D) and stay below NEG / 2.

What bounds H7 and H9 is the card's special function unit (2*D expf and
two logf per cell) and a chain of t_x dependent token steps per item, not
bytes. Each item runs on a cluster of C blocks that split its T_y1
positions into slices of w (`_cluster_plan`) and push the D-cell halo of
each token's row into their neighbour's shared memory, with one block
barrier per token and no barrier over the cluster; they compute the
normalizer z for every token before the chain and fetch the next token's
row ahead (`csrc/mobo.cu` says why). H8 runs on the same clusters, with
a window of compares in place of the inner LSE, and walks its
backpointers in the same launch across the slices (`_bp_plan`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises. The walk clamps its position into the grid, which only an
item without a boundary sequence needs (the JAX package's index wraps
there; such an item's durations mean nothing either way).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .. import _build
from .mas_kernel import MAX_SMEM

NEG = -1e15
ALPHA_KERNEL = "mobo_alpha_kernel"
BP_KERNEL = "mobo_bp_kernel"
BETA_KERNEL = "mobo_beta_kernel"

SMS = 132            # streaming multiprocessors of the H100
MAX_CLUSTER = 8      # the portable cluster size
MIN_SLICE = 32       # positions a block owns at least when it has neighbours
MAX_SLICE = 4096     # positions whose rows a block keeps in shared memory


def _cluster_plan(B: int, n: int, D: int) -> tuple[int, int]:
    """(C, w) of H7 and H9 for B items of n positions and window D: C
    blocks per item, each owning w consecutive positions (the last block
    what is left, at least one). C <= 8 and falls as B grows, so that B*C
    stays within the card's SMs while B <= 132; with neighbours a block
    owns at least max(D, 32) positions, so that its D-cell halo comes from
    one neighbour and no block is less than a warp; C = 1 is one block per
    item. Beyond MAX_SLICE positions an item takes more blocks, as far as
    the window allows, to keep its rows in shared memory."""
    most = max(1, n // max(D, MIN_SLICE))
    C = max(1, min(MAX_CLUSTER, SMS // max(B, 1), most))
    C = max(C, min(MAX_CLUSTER, most, -(-n // MAX_SLICE)))
    w = -(-n // C)
    return -(-n // w), w


PROLOGUE_GROUPS = 4  # thread groups that compute z (csrc/mobo.cu)


def _slice_floats(w: int, D: int) -> int:
    """Floats of a cluster block's shared rows besides z (csrc/mobo.cu:
    slice_floats): two exchanged rows of w + D, the carried row, two e
    rows and the z prologue's stage of four rows of w + D per group of
    chain threads."""
    k = -(-w // 1024)                     # cells per chain thread
    tc = 32 * -(-(-(-w // k)) // 32)      # chain threads
    groups = max(1, min(1024 // tc, PROLOGUE_GROUPS))
    return (2 + 4 * groups) * (w + D) + 3 * w


def _sweep_smem(T_x: int, w: int, D: int) -> tuple[bool, int]:
    """(z_shared, shared bytes) of a cluster block of H7, H8 or H9
    (csrc/mobo.cu: sweep_smem): the slice's rows and z, T_x rows of w in
    shared memory where they fit, else two rows fetched ahead."""
    rows = _slice_floats(w, D)
    z_shared = 4 * (rows + T_x * w) <= MAX_SMEM
    return z_shared, 4 * (rows + (T_x * w if z_shared else 2 * w))


def _bp_plan(B: int, T_x: int, n: int, D: int
             ) -> tuple[int, int, bool, int]:
    """(C, w, z_shared, shared bytes) of H8 for B items of T_x tokens, n
    positions and window D: H7's clusters (`_cluster_plan`), z in shared
    memory where it fits (else in the bp rows). The wide form, C = 0 (one
    block per item of threads striding the row, `3 n + 4 D` floats of
    shared memory: H8's first design), where the slice's rows do not fit,
    and where there are more items than SMs and it fits: two blocks an
    SM then keep the card busy, and twice the threads a cell's window
    beat the cluster form's (1.22 against 1.48 ms at B=256, 1025
    positions; equal at B=133; PERF.md)."""
    C, w = _cluster_plan(B, n, D)
    z_shared, smem = _sweep_smem(T_x, w, D)
    wide = 4 * (3 * n + 4 * D)
    if smem <= MAX_SMEM and (B <= SMS or wide > MAX_SMEM):
        return C, w, z_shared, smem
    if wide > MAX_SMEM:
        raise ValueError(f"mobo_bp takes 3 * T_y1 + 4 * D <= "
                         f"{MAX_SMEM // 4} floats, got T_y1 = {n}, D = {D}")
    return 0, n, False, wide


def _sb(arr: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., t] = arr[..., t - d], NEG-padded."""
    return F.pad(arr, (d, 0), value=NEG)[..., :arr.shape[-1]]


def _sf(arr: torch.Tensor, d: int) -> torch.Tensor:
    """out[..., t] = arr[..., t + d], NEG-padded."""
    return F.pad(arr, (0, d), value=NEG)[..., d:]


def _window_lse(arr: torch.Tensor, D: int, shift) -> torch.Tensor:
    """logsumexp_{d=1..D} arr(t -/+ d) as a max/sum accumulation, in the
    reference's order."""
    m = shift(arr, 1)
    for d in range(2, D + 1):
        m = torch.maximum(m, shift(arr, d))
    s = torch.zeros_like(arr)
    for d in range(1, D + 1):
        s = s + torch.exp(shift(arr, d) - m)
    return m + torch.log(s)


def _window_max_argmax_back(arr: torch.Tensor, D: int):
    """(max, argmax-d) over d = 1..D of arr(t - d); ties keep the
    smaller d."""
    m = _sb(arr, 1)
    bp = torch.ones(arr.shape, dtype=torch.int32, device=arr.device)
    for d in range(2, D + 1):
        c = _sb(arr, d)
        take = c > m
        m = torch.where(take, c, m)
        bp = torch.where(take, d, bp)
    return m, bp


def _window_normalizer(e_row: torch.Tensor, D: int) -> torch.Tensor:
    """z(t') = logsumexp_{d=1..D} e(t' + d) on the shifted grid."""
    return _window_lse(e_row, D, _sf)


def _check_grid(e_tm: torch.Tensor, D: int, **lengths):
    """Validate a float32 [T_x, B, T_y1] grid on the CPU or CUDA and the
    window; return the per-item lengths as int32 [B] on its device."""
    if e_tm.ndim != 3 or e_tm.dtype != torch.float32:
        raise ValueError(f"expected a float32 [T_x, B, T_y1] grid, got "
                         f"{e_tm.dtype} {tuple(e_tm.shape)}")
    if e_tm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the MoBo sweeps run on a CPU or CUDA tensor, "
                         f"got {e_tm.device}")
    if int(D) != D or D < 1:
        raise ValueError(f"max_duration must be an integer >= 1, got {D}")
    B = e_tm.shape[1]
    out = []
    for name, t in lengths.items():
        t = torch.as_tensor(t).to(device=e_tm.device, dtype=torch.int32)
        if t.shape != (B,):
            raise ValueError(f"{name} must be [{B}], got {tuple(t.shape)}")
        out.append(t.contiguous())
    return out


def _forward_plain(e_tm, t_x, D, use_max: bool):
    T_x, B, n = e_tm.shape
    dev = e_tm.device
    tx = t_x.to(dev)[:, None]
    carry = torch.full((B, n), NEG, dtype=e_tm.dtype, device=dev)
    carry[:, 0] = 0.0
    rows = torch.empty((T_x, B, n), device=dev,
                       dtype=torch.int32 if use_max else e_tm.dtype)
    for i in range(T_x):
        e_i = e_tm[i]
        z = _window_normalizer(e_i, D)
        # A(t') = logB_{i-1}(t') - z(t'); guard fully-dead windows.
        a = torch.where(z > 0.5 * NEG, carry - z, NEG)
        if use_max:
            inner, bp = _window_max_argmax_back(a, D)
        else:
            inner = _window_lse(a, D, _sb)
        new = e_i + inner
        new = torch.where(new > 0.5 * NEG, new, NEG)
        # Ragged freeze: items with i >= t_x keep logB_{t_x-1}.
        live = i < tx
        carry = torch.where(live, new, carry)
        rows[i] = torch.where(live, bp, 0) if use_max else carry
    return rows


def mobo_alpha_plain(e_tm: torch.Tensor, t_x: torch.Tensor,
                     D: int) -> torch.Tensor:
    """Forward boundary recursion in plain PyTorch, on any device: the
    logB stack [T_x, B, T_y1]. Rows of tokens >= t_x repeat the row of
    token t_x - 1 (the virtual start row where t_x = 0)."""
    return _forward_plain(e_tm, t_x, D, use_max=False)


def mobo_bp_plain(e_tm: torch.Tensor, t_x: torch.Tensor, t_y: torch.Tensor,
                  D: int):
    """Hard-mode forward in plain PyTorch and the walk over its
    backpointers: (bp int32 [T_x, B, T_y1], the chosen d per cell and 0 on
    tokens >= t_x; durations int32 [B, T_x])."""
    T_x, B, n = e_tm.shape
    dev = e_tm.device
    bp = _forward_plain(e_tm, t_x, D, use_max=True)
    tx = t_x.to(dev)
    pos = t_y.to(dev).long()
    durs = torch.zeros((B, T_x), dtype=torch.int32, device=dev)
    for i in range(T_x - 1, -1, -1):
        pos = pos.clamp(0, n - 1)
        d = torch.where(i < tx, bp[i].gather(1, pos[:, None])[:, 0], 0)
        durs[:, i] = d
        pos = pos - d
    return bp, durs


def mobo_beta_plain(e_tm: torch.Tensor, t_x: torch.Tensor,
                    t_y: torch.Tensor, D: int) -> torch.Tensor:
    """Backward recursion in plain PyTorch, on any device: the beta stack
    [T_x, B, T_y1], with the pinned end row (0 at position t_y) at token
    t_x - 1 and NEG rows on tokens >= t_x."""
    T_x, B, n = e_tm.shape
    dev = e_tm.device
    tx = t_x.to(dev)[:, None]
    pos = torch.arange(n, device=dev)
    end_row = torch.where(pos[None, :] == t_y.to(dev)[:, None], 0.0, NEG) \
        .to(e_tm.dtype)
    nxt = torch.full((B, n), NEG, dtype=e_tm.dtype, device=dev)
    neg_row = nxt.clone()
    betas = torch.empty_like(e_tm)
    for i in range(T_x - 1, -1, -1):
        e_next = e_tm[i + 1] if i + 1 < T_x else neg_row
        z_next = _window_normalizer(e_next, D)
        inner = _window_lse(
            torch.where(e_next > 0.5 * NEG, e_next, NEG) + nxt, D, _sf)
        beta = torch.where(z_next > 0.5 * NEG, inner - z_next, NEG)
        # i == t_x - 1: the last real token, the pinned boundary.
        beta = torch.where(i == tx - 1, end_row, beta)
        # i >= t_x: dead tokens pass NEG through.
        nxt = torch.where(i < tx, beta, nxt)
        betas[i] = nxt
    return betas


def mobo_alpha(e_tm: torch.Tensor, t_x, D: int) -> torch.Tensor:
    """logB stack [T_x, B, T_y1] of the forward boundary recursion (see
    the module docstring for the grid's contract), on the card in
    clusters of `_cluster_plan(B, T_y1, D)`."""
    t_x, = _check_grid(e_tm, D, t_x=t_x)
    if e_tm.device.type == "cpu":
        return mobo_alpha_plain(e_tm, t_x, D)
    T_x, B, n = e_tm.shape
    logB = torch.empty((T_x, B, n), dtype=torch.float32, device=e_tm.device)
    if logB.numel() == 0:
        return logB
    C, w = _cluster_plan(B, n, int(D))
    lib = _build.load_library()
    with torch.cuda.device(e_tm.device):
        err = lib.mobo_alpha_launch(
            e_tm.data_ptr(), *e_tm.stride(), t_x.data_ptr(),
            logB.data_ptr(), B, T_x, n, int(D), C, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, ALPHA_KERNEL)
    _build.LAUNCHES[ALPHA_KERNEL] += 1
    return logB


def _bp_outs(T_x, B, n, device):
    """H8's outputs, which it writes whole: uninitialised backpointers
    int32 [T_x, B, n] and durations int32 [B, T_x]."""
    return (torch.empty((T_x, B, n), dtype=torch.int32, device=device),
            torch.empty((B, T_x), dtype=torch.int32, device=device))


def mobo_bp(e_tm: torch.Tensor, t_x, t_y, D: int):
    """(backpointers int32 [T_x, B, T_y1], durations int32 [B, T_x]) of
    the hard-mode recursion and its walk from position t_y, on the card
    with `_bp_plan`'s launch; both outputs are written whole."""
    t_x, t_y = _check_grid(e_tm, D, t_x=t_x, t_y=t_y)
    if e_tm.device.type == "cpu":
        return mobo_bp_plain(e_tm, t_x, t_y, D)
    T_x, B, n = e_tm.shape
    bp, durs = _bp_outs(T_x, B, n, e_tm.device)
    if bp.numel() == 0:
        return bp, durs
    C, w, _, _ = _bp_plan(B, T_x, n, int(D))
    lib = _build.load_library()
    with torch.cuda.device(e_tm.device):
        err = lib.mobo_bp_launch(
            e_tm.data_ptr(), *e_tm.stride(), t_x.data_ptr(), t_y.data_ptr(),
            bp.data_ptr(), durs.data_ptr(), B, T_x, n, int(D), C, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, BP_KERNEL)
    _build.LAUNCHES[BP_KERNEL] += 1
    return bp, durs


def mobo_beta(e_tm: torch.Tensor, t_x, t_y, D: int) -> torch.Tensor:
    """Beta stack [T_x, B, T_y1] of the backward recursion, on the card
    in clusters of `_cluster_plan(B, T_y1, D)`."""
    t_x, t_y = _check_grid(e_tm, D, t_x=t_x, t_y=t_y)
    if e_tm.device.type == "cpu":
        return mobo_beta_plain(e_tm, t_x, t_y, D)
    T_x, B, n = e_tm.shape
    betas = torch.empty((T_x, B, n), dtype=torch.float32,
                        device=e_tm.device)
    if betas.numel() == 0:
        return betas
    C, w = _cluster_plan(B, n, int(D))
    lib = _build.load_library()
    with torch.cuda.device(e_tm.device):
        err = lib.mobo_beta_launch(
            e_tm.data_ptr(), *e_tm.stride(), t_x.data_ptr(), t_y.data_ptr(),
            betas.data_ptr(), B, T_x, n, int(D), C, w,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, BETA_KERNEL)
    _build.LAUNCHES[BETA_KERNEL] += 1
    return betas
