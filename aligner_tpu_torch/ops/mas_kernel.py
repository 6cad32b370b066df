"""MAS on the card (kernel H1, `csrc/mas.cu`, and the two-pass kernels
H10-H14, `csrc/mas_two_pass.cu`) and their plain PyTorch versions.

Counterpart of aligner_tpu/ops/mas_pallas.py. The eight main Pallas
routes there (natural and time-major, fused and two-pass, path and
durations) compute one function, forward decision bits followed by a
walk, and differ only in TPU layout, VMEM budget and fusion. Here they
are one kernel that reads the lattice through strides and writes either
a path, in any layout, or per-token durations; it also runs as either
half alone. It launches with `_mas_plan`'s threads, cells per thread,
ring of value rows fetched ahead (in tiles of 8 frames where the
lattice's frames are contiguous) and the place of its bit plane (shared
memory where it fits, else a scratch in device memory). The A/B variants of the two-pass route keep their option
names: `mas_bits(chains=K)` (mas_pallas_bits_nat_multi) and
`mas_backtrack(form="cmp"|"stage"|"split", chains=K)`
(mas_pallas_backtrack_nat, _nat_split, _nat_multi), and
`mas_path(fuse=False, ...)` chains the two as mas_pallas(fuse=False)
does. The TPU's `quad`, `batch_block`, `walk_block`, `expand_block` and
`_chunk` options are tiling devices of that chip and have no counterpart.

A CPU tensor takes the plain versions: `mas_plain`, the batched column
sweep of aligner_tpu/ops/mas.py (`_forward_bits_single`,
`_backtrack_single`), in its halves `_forward_bits` and `_backtrack`,
plus `mas_walk_idx_plain` and `mas_expand_plain` for the split form. A
CUDA tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from .. import _build
from .forward_sum_kernel import MAX_THREADS
from .mas_reference import MAX_NEG_VAL

KERNEL = "mas_kernel"
STAGE_KERNEL = "mas_walk_stage_kernel"
IDX_KERNEL = "mas_walk_idx_kernel"
EXPAND_KERNEL = "mas_expand_kernel"
BITS_CHAINS_KERNEL = "mas_bits_chains_kernel"
WALK_CHAINS_KERNEL = "mas_walk_chains_kernel"
FORMS = ("cmp", "stage", "split")
CHAINS = (1, 2, 4)  # what the chain kernels are tested and measured with

MAX_SMEM = 232448     # a block's opt-in shared memory on the H100
# (cells per thread, ring depth, where the plane lives, how value rows are
# fetched) of H1, the plans `with_mas_plan` in csrc/mas.cu builds, in order
# of preference: as H4's (ops/skip_dp_kernel.py: SKIP_VITERBI_PLANS).
# "tiles" (a ring of 32 frames; each warp copies 8 frames x 4 tokens an
# instruction) serves lattices whose frames are contiguous, such as
# serving's natural [B, T_x, T_y]; "rows" (a ring of 8 or 4 frames; each
# thread copies its own cell of a frame) any other, such as the training
# step's frame-major view. For each cell count: the plane in shared memory,
# behind the deeper ring first, then in device memory. Wider columns take
# the wide kernel (`_mas_plan`).
MAS_PLANS = (
    (1, 32, "shared", "tiles"), (1, 32, "global", "tiles"),
    (1, 8, "shared", "rows"), (1, 4, "shared", "rows"),
    (1, 8, "global", "rows"),
    (2, 8, "shared", "rows"), (2, 4, "shared", "rows"),
    (2, 8, "global", "rows"),
    (4, 8, "shared", "rows"), (4, 4, "shared", "rows"),
    (4, 8, "global", "rows"),
    (8, 4, "shared", "rows"), (8, 4, "global", "rows"))
FETCHES = ("rows", "tiles", "wide")   # the launch's fetch codes
# (frames a chunk F, stages S) of the ring walk (H10, H11, H14), the plans
# `kWalkPlans` in csrc/mas_walk.cuh builds, in order of preference: the
# deepest chunks whose K rings fit a block's shared memory. F = 1 frame
# behind a single stage still takes H1's widest column with 4 chains.
WALK_PLANS = ((128, 4), (64, 4), (32, 4), (16, 4), (8, 4), (4, 4), (2, 4),
              (1, 4), (1, 2), (1, 1))
# How a chunk's bytes reach the ring: one cp.async.bulk ("bulk"), 4-byte
# cp.async a lane ("async"), or byte loads ("bytes"); the launch's codes.
WALK_FETCHES = ("bulk", "async", "bytes")
WALK_THREADS = 256    # a walk group: a walker, a producer, 6 storer warps
IDX_WALK_THREADS = 96  # H11's group: its one storer warp writes 4 B a frame
WALK_MAX_T_X = 32767  # the walk's tokens are int16


def _on_cuda(value: torch.Tensor) -> bool:
    if value.device.type == "cpu":
        return False
    if value.device.type == "cuda":
        return True
    raise ValueError(f"MAS runs on a CPU or CUDA tensor, got {value.device}")


def _check_lattice(value: torch.Tensor, t_x, t_y):
    if value.ndim != 3:
        raise ValueError(f"expected a [B, T_x, T_y] lattice, got "
                         f"shape {tuple(value.shape)}")
    if value.dtype != torch.float32:
        raise TypeError(f"expected a float32 lattice, got {value.dtype}")
    return _check_lengths(value, t_x, t_y)


def _check_lengths(like: torch.Tensor, t_x, t_y):
    B = like.shape[0]
    t_x = torch.as_tensor(t_x).to(device=like.device, dtype=torch.int32)
    t_y = torch.as_tensor(t_y).to(device=like.device, dtype=torch.int32)
    if t_x.shape != (B,) or t_y.shape != (B,):
        raise ValueError(f"t_x and t_y must be [{B}], got "
                         f"{tuple(t_x.shape)} and {tuple(t_y.shape)}")
    return t_x.contiguous(), t_y.contiguous()


def _check_bits(bits: torch.Tensor, t_x, t_y):
    if bits.ndim != 3:
        raise ValueError(f"expected [B, T_y, T_x] decision bits, got "
                         f"shape {tuple(bits.shape)}")
    if bits.dtype != torch.uint8:
        raise TypeError(f"expected uint8 decision bits, got {bits.dtype}")
    if not bits.is_contiguous():
        raise ValueError("the decision bits must be contiguous")
    return _check_lengths(bits, t_x, t_y)


def _check_route(form: str, chains: int, B: int) -> None:
    if form not in FORMS:
        raise ValueError(f"unknown backtrack form {form!r}")
    if not isinstance(chains, int) or chains not in CHAINS:
        raise ValueError(f"chains must be one of {CHAINS}, got {chains!r}")
    if B % chains:
        raise ValueError(f"chains {chains} must divide B = {B}")
    if chains > 1 and form != "cmp":
        raise ValueError(f"chains = {chains} walks in the compare form "
                         f"only, got form {form!r}")


def _valid_items(t_x, t_y, T_x: int, T_y: int):
    """Items that get a path; as in the kernels, lengths beyond the
    lattice also give zero paths."""
    return (t_x >= 1) & (t_x <= t_y) & (t_x <= T_x) & (t_y <= T_y)


def _forward_block(value, t_x, t_y, max_neg_val, y0: int = 0, carry=None):
    """Batched forward band sweep over a block of frames. value: f32 [B,
    T_x, T_yl], the lattice's frames y0 .. y0 + T_yl - 1; carry: the
    cumulative column of frame y0 - 1 (zeros when None, the start at y0 =
    0); t_x, t_y: the global lengths. The band, the diagonal and the
    origin test read the global frame. Returns the decision bits, bool
    [T_yl, B, T_x], and the cumulative column of the block's last frame."""
    B, T_x, T_yl = value.shape
    xs = torch.arange(T_x, device=value.device)
    tx = t_x[:, None].long()
    ty = t_y[:, None].long()
    prev = (torch.zeros((B, T_x), dtype=torch.float32, device=value.device)
            if carry is None else carry)
    bits = torch.empty((T_yl, B, T_x), dtype=torch.bool,
                       device=value.device)
    for j in range(T_yl):
        y = y0 + j
        col = value[:, :, j]
        prev_shift = torch.cat([prev[:, :1], prev[:, :-1]], dim=1)
        v_cur = torch.where(xs == y, max_neg_val, prev)
        v_prev = torch.where(xs == 0, 0.0 if y == 0 else max_neg_val,
                             prev_shift)
        new = torch.maximum(v_cur, v_prev) + col
        in_band = ((xs >= tx + y - ty) & (xs < tx) & (xs <= y) & (y < ty))
        bits[j] = (xs > 0) & ((xs == y) | (prev < prev_shift)) & in_band
        # Out-of-band cells keep the raw value, as the reference's
        # untouched in-place buffer does.
        prev = torch.where(in_band, new, col)
    return bits, prev


def _forward_bits(value, t_x, t_y, max_neg_val):
    """Batched forward band sweep. value: f32 [B, T_x, T_y]; returns the
    decision bits, bool [T_y, B, T_x]."""
    return _forward_block(value, t_x, t_y, max_neg_val)[0]


def _backtrack_block(bits, t_x, t_y, T_y: int, y0: int = 0, index=None):
    """Reverse walk over a block of bits [T_yl, B, T_x], the frames y0 ..
    y0 + T_yl - 1 of a lattice of T_y frames; index: the token index the
    walk holds at frame y0 + T_yl (t_x - 1, clamped into the lattice, when
    None). Items are valid by the global lengths and T_y. Returns the f32
    0/1 path block [B, T_x, T_yl] and the index at frame y0."""
    T_yl, B, T_x = bits.shape
    rows = torch.arange(B, device=bits.device)
    path = torch.zeros((B, T_x, T_yl), dtype=torch.float32,
                       device=bits.device)
    valid = _valid_items(t_x, t_y, T_x, T_y)
    if index is None:
        index = (t_x.long() - 1).clamp(min=0, max=max(T_x - 1, 0))
    for j in range(T_yl - 1, -1, -1):
        active = valid & (t_y > y0 + j)
        path[rows, index, j] = active.float()
        index = index - (active & bits[j, rows, index] & (index > 0)).long()
    return path, index


def _backtrack(bits, t_x, t_y):
    """Reverse walk over the bits; returns the f32 0/1 path [B, T_x, T_y]."""
    return _backtrack_block(bits, t_x, t_y, bits.shape[0])[0]


def mas_plain(value: torch.Tensor, t_x, t_y, *,
              max_neg_val: float = MAX_NEG_VAL) -> torch.Tensor:
    """Batched MAS paths in plain PyTorch, on any device.

    value: f32 [B, T_x, T_y]; t_x, t_y: [B] int. Returns f32 0/1 paths
    [B, T_x, T_y]; items outside 1 <= t_x <= t_y get all zeros.
    """
    t_x, t_y = _check_lattice(value, t_x, t_y)
    bits = _forward_bits(value, t_x, t_y, float(max_neg_val))
    return _backtrack(bits, t_x, t_y)


def mas_walk_idx_plain(bits: torch.Tensor, t_x, t_y) -> torch.Tensor:
    """The walk alone, in plain PyTorch: uint8 bits [B, T_y, T_x] -> int32
    [B, T_y] holding the path's token index + 1 per frame, 0 where the
    frame emits nothing (a frame >= t_y, or any frame of an invalid
    item)."""
    t_x, t_y = _check_bits(bits, t_x, t_y)
    B, T_y, T_x = bits.shape
    rows = torch.arange(B, device=bits.device)
    idx = torch.zeros((B, T_y), dtype=torch.int32, device=bits.device)
    valid = _valid_items(t_x, t_y, T_x, T_y)
    index = (t_x.long() - 1).clamp(min=0, max=max(T_x - 1, 0))
    for y in range(T_y - 1, -1, -1):
        active = valid & (t_y > y)
        idx[:, y] = torch.where(active, index + 1, 0).to(torch.int32)
        index = index - (active & (bits[rows, y, index] != 0)
                         & (index > 0)).long()
    return idx


def mas_expand_plain(idx: torch.Tensor, T_x: int) -> torch.Tensor:
    """Per-frame token index + 1 [B, T_y] -> f32 0/1 path [B, T_x, T_y]."""
    tokens = torch.arange(T_x, device=idx.device)[None, :, None] + 1
    return (tokens == idx[:, None, :]).float()


def _forward_smem(pitch: int, ring: int, plane_frames: int) -> int:
    """Shared-memory bytes of one forward chain (H1's, or one of H13's K)
    whose threads hold `pitch` cells: the plane of `plane_frames` frames
    (one 32-bit word per 32 cells a frame), `ring` value rows of pitch + 4
    floats and two columns behind a pad cell each
    (csrc/mas_forward.cuh: forward_smem)."""
    return (4 * (pitch // 32) * plane_frames
            + 4 * (ring * (pitch + 4) + 2 * (pitch + 1)))


def _mas_smem(pitch: int, ring: int, plane_frames: int) -> int:
    """H1's shared-memory bytes: its forward's and the walk's int16 token
    a frame (csrc/mas.cu: mas_smem)."""
    return _forward_smem(pitch, ring, plane_frames) + 2 * plane_frames


def _mas_plan(T_x: int, T_y: int, frames_contiguous: bool
              ) -> tuple[int, int, int, str, str, int]:
    """(threads, cells per thread, ring depth, planes, fetch,
    shared-memory bytes) of H1 over T_x tokens and T_y frames: the first
    plan of MAS_PLANS whose cells cover the column with at most
    MAX_THREADS threads, whose fetch suits the lattice ("tiles" only where
    its frames are contiguous) and whose layout fits a block's shared
    memory, with the fewest threads, a multiple of 32, that cover the
    column. planes is "shared" or "global" (an int32 scratch
    [B, T_y * pitch / 32 + (T_y + 1) // 2] in device memory). A column
    wider than the widest plan takes fetch "wide" (csrc/mas.cu:
    mas_wide_kernel: the fewest cells a thread that MAX_THREADS threads
    need, values loaded after the barrier, two unpadded columns, the plane
    in device memory), as far as its columns fit. Chosen from the shape
    and strides alone, before the launch."""
    for cells, ring, planes, fetch in MAS_PLANS:
        if cells * MAX_THREADS < T_x or (fetch == "tiles"
                                         and not frames_contiguous):
            continue
        threads = 32 * -(-T_x // (32 * cells))
        smem = _mas_smem(threads * cells, ring,
                         T_y if planes == "shared" else 0)
        if smem <= MAX_SMEM:
            return threads, cells, ring, planes, fetch, smem
    cells = -(-T_x // MAX_THREADS)
    threads = 32 * -(-T_x // (32 * cells))
    smem = 8 * T_x
    if smem > MAX_SMEM:
        raise ValueError(f"MAS takes at most {MAX_SMEM // 8} tokens, got "
                         f"{T_x}")
    return threads, cells, 0, "global", "wide", smem


def _chains_plan(T_x: int, T_y: int, K: int, frames_contiguous: bool
                 ) -> tuple[int, int, int, str, str, int]:
    """(threads a chain, cells per thread, ring depth, planes, fetch,
    shared-memory bytes) of H13 with K chains a block: as `_mas_plan`, the
    first plan of MAS_PLANS (`with_mas_plan` builds them for H13 too) whose
    cells cover the column with at most MAX_THREADS / K threads a chain,
    whose fetch suits the lattice and whose K chains' layouts fit a block's
    shared memory together. A column wider than the widest plan takes
    fetch "wide" (csrc/mas_two_pass.cu: mas_bits_chains_wide_kernel:
    threads stride the column, two unpadded columns a chain), as far as K
    chains' columns fit."""
    most = MAX_THREADS // K
    for cells, ring, planes, fetch in MAS_PLANS:
        if cells * most < T_x or (fetch == "tiles" and not frames_contiguous):
            continue
        threads = 32 * -(-T_x // (32 * cells))
        smem = K * _forward_smem(threads * cells, ring,
                                 T_y if planes == "shared" else 0)
        if smem <= MAX_SMEM:
            return threads, cells, ring, planes, fetch, smem
    cells = -(-T_x // most)
    threads = 32 * -(-T_x // (32 * cells))
    smem = 8 * K * T_x
    if smem > MAX_SMEM:
        raise ValueError(f"MAS with {K} chains takes at most "
                         f"{MAX_SMEM // (8 * K)} tokens, got {T_x}")
    return threads, cells, 0, "global", "wide", smem


def _round16(n: int) -> int:
    return -(-n // 16) * 16


def _walk_smem(T_x: int, frames: int, stages: int) -> int:
    """Shared-memory bytes of one walk group (csrc/mas_walk.cuh:
    walk_smem): 4 S mbarriers, S byte stages of F frames and S token
    stages of F int16."""
    return (32 * stages + stages * _round16(frames * T_x)
            + _round16(2 * stages * frames))


def _walk_plan(T_x: int, T_y: int, K: int, base: int,
               threads: int = WALK_THREADS
               ) -> tuple[int, int, int, str, int]:
    """(threads a chain, frames a chunk F, stages S, fetch, shared-memory
    bytes) of H10 (K = 1), H14 (K chains a block) and H11 (K = 1, threads
    IDX_WALK_THREADS) over uint8 bits [B, T_y, T_x] at address `base`: the
    first plan of WALK_PLANS whose K rings fit a block's shared memory. fetch is "bulk" exactly where every
    chunk's bytes are a 16-byte multiple at a 16-byte aligned address (the
    bits' base, each item's T_y * T_x bytes and each chunk's F * T_x), else
    "async" where they are 4-byte words (T_x % 4 == 0 at a 4-byte aligned
    base), else "bytes". Chosen from the shape and the alignment alone,
    before the launch."""
    for frames, stages in WALK_PLANS:
        smem = K * _walk_smem(T_x, frames, stages)
        if smem <= MAX_SMEM and T_x <= WALK_MAX_T_X:
            break
    else:
        raise ValueError(f"the ring walk with {K} chains takes at most "
                         f"{min(WALK_MAX_T_X, (MAX_SMEM // K - 48) // 16 * 16)}"
                         f" tokens, got {T_x}")
    if base % 16 == 0 and T_x * T_y % 16 == 0 and frames * T_x % 16 == 0:
        fetch = "bulk"
    elif base % 4 == 0 and T_x % 4 == 0:
        fetch = "async"
    else:
        fetch = "bytes"
    return threads, frames, stages, fetch, smem


def _scratch(B, T_y, pitch, planes, device):
    """The device-memory planes of H1 or H13 when `planes` is "global":
    int32 [B, T_y * pitch / 32 + (T_y + 1) // 2] (the plane, then H1's
    walk's tokens); else an empty tensor."""
    return torch.empty((B, T_y * pitch // 32 + (T_y + 1) // 2)
                       if planes == "global" else (0,), dtype=torch.int32,
                       device=device)


def _launch(value, t_x, t_y, bits, path, durations, max_neg_val, shape):
    """One launch of H1 over a [B, T_x, T_y] lattice (`shape`). `value`
    None: the walk alone over `bits`; else the sweep, which writes `bits`
    whole when given (the forward alone). `path` (a [B, T_x, T_y] view)
    or `durations` is written whole."""
    B, T_x, T_y = shape
    device = (value if value is not None else bits).device
    threads, cells, ring, planes, fetch, _ = _mas_plan(
        T_x, T_y, value is not None and value.stride(2) == 1)
    scratch = _scratch(B, T_y, threads * cells, planes, device)
    lib = _build.load_library()
    sv = value.stride() if value is not None else (0, 0, 0)
    sp = path.stride() if path is not None else (0, 0, 0)
    with torch.cuda.device(device):
        err = lib.mas_launch(
            None if value is None else value.data_ptr(), *sv,
            t_x.data_ptr(), t_y.data_ptr(),
            None if bits is None else bits.data_ptr(),
            None if path is None else path.data_ptr(), *sp,
            None if durations is None else durations.data_ptr(),
            scratch.data_ptr(), B, T_x, T_y, threads, cells, ring,
            int(planes == "shared"), FETCHES.index(fetch),
            float(max_neg_val), torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, KERNEL)
    _build.LAUNCHES[KERNEL] += 1


def _bits_out(B, T_y, T_x, device):
    """The decision bits' output, which H1 and H13 write whole:
    uninitialised uint8 [B, T_y, T_x]."""
    return torch.empty((B, T_y, T_x), dtype=torch.uint8, device=device)


def _durations_out(B, T_x, device):
    """H1's durations output, which it writes whole: uninitialised int32
    [B, T_x]."""
    return torch.empty((B, T_x), dtype=torch.int32, device=device)


def _idx_out(B, T_y, device):
    """H11's index output, which it writes whole: uninitialised int32
    [B, T_y]."""
    return torch.empty((B, T_y), dtype=torch.int32, device=device)


def _path_out(B, T_x, T_y, device, frame_major):
    """The path's output, which every kernel writes whole: uninitialised
    f32, and its [B, T_x, T_y] view."""
    shape = (B, T_y, T_x) if frame_major else (B, T_x, T_y)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out, (out.transpose(1, 2) if frame_major else out)


def mas_bits(value: torch.Tensor, t_x, t_y, *, chains: int = 1,
             max_neg_val: float = MAX_NEG_VAL) -> torch.Tensor:
    """The forward half of MAS: the decision bits of the lattice.

    value: f32 [B, T_x, T_y], any strides; t_x, t_y: [B]. Returns uint8
    [B, T_y, T_x]: bit[b, y, x] = (x > 0) & ((x == y) | (cum[x, y-1] <
    cum[x-1, y-1])) on the cells the walk can reach (x < t_x, y < t_y,
    x <= y, x >= t_x - (t_y - y)) of the valid items (1 <= t_x <= t_y,
    both within the lattice), and 0 on every other cell. The same result
    on either device and for any `chains`.

    chains: K > 1 runs the K-chain forward kernel on a CUDA tensor (K of
    H1's forward chains a block, each over its own item; chain c owns items
    [c*B/K, (c+1)*B/K)), with `_chains_plan`'s launch; K must divide B.
    Counterpart of mas_pallas_bits_nat and mas_pallas_bits_nat_multi,
    which take no lengths, fill every cell, and lay the bits out as int8
    [T_y_pad, B, T_x].
    """
    t_x, t_y = _check_lattice(value, t_x, t_y)
    B, T_x, T_y = value.shape
    _check_route("cmp", chains, B)
    if not _on_cuda(value):
        bits = _forward_bits(value, t_x, t_y, float(max_neg_val))
        bits = bits & _valid_items(t_x, t_y, T_x, T_y)[None, :, None]
        return bits.permute(1, 0, 2).to(torch.uint8).contiguous()
    bits = _bits_out(B, T_y, T_x, value.device)
    if not bits.numel():
        return bits
    if chains == 1:
        _launch(value, t_x, t_y, bits, None, None, max_neg_val, value.shape)
        return bits
    threads, cells, ring, planes, fetch, _ = _chains_plan(
        T_x, T_y, chains, value.stride(2) == 1)
    scratch = _scratch(B, T_y, threads * cells, planes, value.device)
    lib = _build.load_library()
    with torch.cuda.device(value.device):
        err = lib.mas_bits_chains_launch(
            value.data_ptr(), *value.stride(), t_x.data_ptr(),
            t_y.data_ptr(), bits.data_ptr(), scratch.data_ptr(), B, T_x, T_y,
            chains, threads, cells, ring, int(planes == "shared"),
            FETCHES.index(fetch), float(max_neg_val),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, BITS_CHAINS_KERNEL)
    _build.LAUNCHES[BITS_CHAINS_KERNEL] += 1
    return bits


def mas_walk_idx(bits: torch.Tensor, t_x, t_y) -> torch.Tensor:
    """The walk half of the split form: uint8 bits [B, T_y, T_x] -> int32
    [B, T_y], token index + 1 per frame and 0 for no emission (see
    `mas_walk_idx_plain`, its version for a CPU tensor). On a CUDA tensor
    H11, the ring walk with `_walk_plan`'s frames, stages and fetch and a
    group of IDX_WALK_THREADS, one item a block; columns past WALK_MAX_T_X
    tokens raise ValueError."""
    if not _on_cuda(bits):
        return mas_walk_idx_plain(bits, t_x, t_y)
    t_x, t_y = _check_bits(bits, t_x, t_y)
    B, T_y, T_x = bits.shape
    idx = _idx_out(B, T_y, bits.device)
    if not bits.numel():
        return idx.zero_()
    threads, frames, stages, fetch, _ = _walk_plan(
        T_x, T_y, 1, bits.data_ptr(), threads=IDX_WALK_THREADS)
    lib = _build.load_library()
    with torch.cuda.device(bits.device):
        err = lib.mas_walk_idx_launch(
            bits.data_ptr(), t_x.data_ptr(), t_y.data_ptr(), idx.data_ptr(),
            B, T_x, T_y, threads, frames, stages, WALK_FETCHES.index(fetch),
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, IDX_KERNEL)
    _build.LAUNCHES[IDX_KERNEL] += 1
    return idx


def mas_expand(idx: torch.Tensor, T_x: int, *,
               frame_major: bool = False) -> torch.Tensor:
    """The expand half of the split form: int32 [B, T_y] token index + 1
    per frame -> f32 0/1 path [B, T_x, T_y] (or [B, T_y, T_x]),
    path[b, x, y] = (x + 1 == idx[b, y])."""
    if idx.ndim != 2 or idx.dtype != torch.int32:
        raise TypeError(f"expected int32 [B, T_y] indices, got {idx.dtype} "
                        f"{tuple(idx.shape)}")
    if not _on_cuda(idx):
        path = mas_expand_plain(idx, T_x)
        return path.transpose(1, 2).contiguous() if frame_major else path
    B, T_y = idx.shape
    out, view = _path_out(B, T_x, T_y, idx.device, frame_major)
    if not out.numel():
        return out
    idx = idx.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(idx.device):
        err = lib.mas_expand_launch(
            idx.data_ptr(), out.data_ptr(), *view.stride(), B, T_x, T_y,
            torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, EXPAND_KERNEL)
    _build.LAUNCHES[EXPAND_KERNEL] += 1
    return out


def mas_backtrack(bits: torch.Tensor, t_x, t_y, *, form: str = "cmp",
                  chains: int = 1, frame_major: bool = False) -> torch.Tensor:
    """The walk half of MAS: decision bits -> path.

    bits: uint8 [B, T_y, T_x], contiguous (as `mas_bits` returns them;
    any non-zero byte counts as a set bit, and token 0 never steps down,
    so bits from elsewhere cannot take the walk out of the lattice);
    t_x, t_y: [B]. Returns the f32 0/1 path [B, T_x, T_y], or [B, T_y,
    T_x] when frame_major; items outside 1 <= t_x <= t_y get zeros. Every
    route gives the same path. On a CUDA tensor:

    form="cmp": the fused kernel's walk alone (mas_pallas_backtrack_nat,
      form="cmp"): each block loads its item's bytes into a bit plane
      (a ballot of byte != 0 a warp), one thread walks it four frames a
      round, and all threads write the whole path, zeros included, into
      an uninitialised output; with chains=K > 1 the K-chain walk, K items
      per block, each the ring walk below (mas_pallas_backtrack_nat_multi).
    form="stage": the staged walk (mas_pallas_backtrack_nat,
      form="stage"), one item a block: a warp streams the bytes, F frames
      a chunk, into a ring in shared memory ahead of the walk, one thread
      walks from there, and the other warps write each walked chunk's
      tile of the path whole, zeros included, into an uninitialised
      output (`_walk_plan`).
    form="split": an index walk (`mas_walk_idx`: the ring walk of
      form="stage" with one storer warp, which writes int32 token + 1 a
      frame instead of the path) and an expand kernel (`mas_expand`), two
      launches (mas_pallas_backtrack_nat_split).
    """
    t_x, t_y = _check_bits(bits, t_x, t_y)
    B, T_y, T_x = bits.shape
    _check_route(form, chains, B)
    if form == "split":
        return mas_expand(mas_walk_idx(bits, t_x, t_y), T_x,
                          frame_major=frame_major)
    if not _on_cuda(bits):
        path = _backtrack(bits.permute(1, 0, 2) != 0, t_x, t_y)
        return path.transpose(1, 2).contiguous() if frame_major else path
    out, view = _path_out(B, T_x, T_y, bits.device, frame_major)
    if not out.numel():
        return out
    if form == "cmp" and chains == 1:
        _launch(None, t_x, t_y, bits, view, None, 0.0, (B, T_x, T_y))
        return out
    threads, frames, stages, fetch, _ = _walk_plan(T_x, T_y, chains,
                                                   bits.data_ptr())
    lib = _build.load_library()
    args = (bits.data_ptr(), t_x.data_ptr(), t_y.data_ptr(), out.data_ptr(),
            *view.stride(), B, T_x, T_y)
    plan = (threads, frames, stages, WALK_FETCHES.index(fetch))
    with torch.cuda.device(bits.device):
        stream = torch.cuda.current_stream().cuda_stream
        if form == "stage":
            name = STAGE_KERNEL
            err = lib.mas_walk_stage_launch(*args, *plan, stream)
        else:
            name = WALK_CHAINS_KERNEL
            err = lib.mas_walk_chains_launch(*args, chains, *plan, stream)
    _build.check(lib, err, name)
    _build.LAUNCHES[name] += 1
    return out


def mas_path(value: torch.Tensor, t_x, t_y, *,
             max_neg_val: float = MAX_NEG_VAL,
             frame_major: bool = False, fuse: bool = True,
             form: str = "cmp", chains: int = 1) -> torch.Tensor:
    """MAS paths for a lattice read as [B, T_x, T_y].

    value: f32 [B, T_x, T_y], any strides (a transposed view of a
    frame-major [B, T_y, T_x] lattice is read in place); t_x, t_y: [B].
    Returns f32 0/1 paths [B, T_x, T_y], or [B, T_y, T_x] when
    frame_major. Bit-identical to aligner_tpu.maximum_path.

    fuse=True (default) is one launch of the fused kernel; `form` and
    `chains` then have nothing to select and must keep their defaults.
    fuse=False is the two-pass route, `mas_backtrack(mas_bits(...))`
    with `form` and `chains` passed to both halves, the counterpart of
    mas_pallas(..., fuse=False) and its A/B variants.
    """
    t_x, t_y = _check_lattice(value, t_x, t_y)
    B, T_x, T_y = value.shape
    _check_route(form, chains, B)
    if fuse and (form != "cmp" or chains != 1):
        raise ValueError(f"form={form!r} and chains={chains} select a "
                         f"two-pass route: pass fuse=False")
    if not fuse:
        bits = mas_bits(value, t_x, t_y, chains=chains,
                        max_neg_val=max_neg_val)
        return mas_backtrack(bits, t_x, t_y, form=form, chains=chains,
                             frame_major=frame_major)
    if not _on_cuda(value):
        path = mas_plain(value, t_x, t_y, max_neg_val=max_neg_val)
        return path.transpose(1, 2).contiguous() if frame_major else path
    out, view = _path_out(B, T_x, T_y, value.device, frame_major)
    if out.numel():
        _launch(value, t_x, t_y, None, view, None, max_neg_val, value.shape)
    return out


def mas_durations(value: torch.Tensor, t_x, t_y, *,
                  max_neg_val: float = MAX_NEG_VAL) -> torch.Tensor:
    """Per-token frame counts of the MAS path, int32 [B, T_x], without
    materialising the path on the card. Same input contract as
    `mas_path`."""
    t_x, t_y = _check_lattice(value, t_x, t_y)
    if not _on_cuda(value):
        path = mas_plain(value, t_x, t_y, max_neg_val=max_neg_val)
        return path.sum(-1).to(torch.int32)
    B, T_x, T_y = value.shape
    out = _durations_out(B, T_x, value.device)
    if not value.numel():
        return out.zero_()
    _launch(value, t_x, t_y, None, None, out, max_neg_val, value.shape)
    return out


def path_from_durations(durs: torch.Tensor, T_y: int) -> torch.Tensor:
    """[B, T_x] durations -> f32 0/1 path [B, T_x, T_y] (exact for
    integer durations below 2^24)."""
    cum = torch.cumsum(durs, dim=1)
    start = cum - durs
    ys = torch.arange(T_y, device=durs.device, dtype=torch.float32)
    return ((ys >= start[..., None]) & (ys < cum[..., None])).float()
