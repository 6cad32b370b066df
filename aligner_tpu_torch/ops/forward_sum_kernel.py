"""Forward-sum sweeps on the card and their plain PyTorch versions
(`csrc/forward_sum.cu`):

* kernel H2, the alpha sweep, counterpart of forward_sum_alpha_pallas
  (aligner_tpu/ops/forward_sum_pallas.py); plain version `alpha_plain`,
  the port of `_alpha_scan` (aligner_tpu/ops/forward_sum.py). It takes
  the plan of the posterior sweeps (`csrc/forward_sweep.cuh`);
* kernel H3, the beta sweep that emits the posterior gamma (the loss
  gradient up to its sign), counterpart of forward_sum_grad_pallas;
  plain version `gamma_plain`, the recursion of `_beta_scan` in the
  message form of `_beta_grad_kernel`. H3 and the skip-state H6 launch
  with `_sweep_plan`'s threads, cells per thread and ring of rows fetched
  ahead (`csrc/posterior_sweep.cuh`).

A CPU tensor takes the plain version; a CUDA tensor launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from .. import _build

NEG = -1e15
KERNEL = "forward_sum_alpha_kernel"
GRAD_KERNEL = "forward_sum_grad_kernel"

# (cells per thread, ring depth) of the posterior sweeps H3 and H6: the
# pairs `with_plan` in csrc/posterior_sweep.cuh builds. Each pair's ring
# is the deepest of at most 8 frames whose rows fit in a block's shared
# memory beside the two message columns at the widest column the pair
# takes, cells * MAX_THREADS.
SWEEP_PLANS = ((1, 8), (2, 8), (3, 8), (4, 6), (6, 3), (8, 2))
MAX_THREADS = 1024


def _sweep_plan(T: int) -> tuple[int, int, int, int]:
    """(threads, cells per thread, ring depth, shared-memory bytes) of H3
    or H6 over a column of T cells (H2 takes the same threads, cells and
    ring, and holds one row a slot): the fewest cells per thread with
    which MAX_THREADS threads cover the column, then the fewest threads,
    a multiple of 32, that cover it with as many cells each. The bytes
    are the kernel's layout: two message columns and `ring` slots of an
    lp row and an alpha row, each threads * cells floats. Raises
    ValueError past 8192 cells."""
    for cells, ring in SWEEP_PLANS:
        if cells * MAX_THREADS >= T:
            needed = -(-T // cells)
            threads = -(-needed // 32) * 32
            return threads, cells, ring, 8 * threads * cells * (1 + ring)
    raise ValueError(f"the posterior sweeps take at most "
                     f"{SWEEP_PLANS[-1][0] * MAX_THREADS} cells a column, "
                     f"got {T}")


def _forward_smem(pitch: int, ring: int, pad: int) -> int:
    """Shared-memory bytes of the forward sweep of H2 (pad 1) or H5 (pad
    2) whose threads hold `pitch` cells: `ring` lp rows and two columns
    behind `pad` cells each (csrc/forward_sweep.cuh: forward_smem)."""
    return 4 * (ring * pitch + 2 * (pitch + pad))


def _alphas_out(T_y: int, B: int, T: int, device) -> torch.Tensor:
    """The alpha lattice's output, which H2 writes whole: an uninitialised
    contiguous [T_y, B, T] tensor."""
    return torch.empty((T_y, B, T), dtype=torch.float32, device=device)


def _gamma_out(B: int, T_y: int, T: int, device) -> torch.Tensor:
    """The posterior's output, which a sweep writes whole: a [T_y, B, T]
    view of an uninitialised [B, T_y, T] tensor."""
    return torch.empty((B, T_y, T), dtype=torch.float32,
                       device=device).transpose(0, 1)


def alpha_plain(lp_tm: torch.Tensor, t_y: torch.Tensor) -> torch.Tensor:
    """lp_tm: f32 [T_y, B, T_x], already NEG-masked at x >= t_x; t_y: [B].
    Returns the alpha lattice [T_y, B, T_x]; frames past t_y freeze the
    carry, so alphas[-1] is each item's column at frame t_y - 1."""
    T_y, B, T_x = lp_tm.shape
    xs = torch.arange(T_x, device=lp_tm.device)
    first = torch.where(xs == 0, 0.0, NEG).to(lp_tm.dtype)
    ty = t_y.to(lp_tm.device)[:, None]
    prev = torch.full((B, T_x), NEG, dtype=lp_tm.dtype, device=lp_tm.device)
    neg_col = torch.full((B, 1), NEG, dtype=lp_tm.dtype, device=lp_tm.device)
    alphas = torch.empty_like(lp_tm)
    for y in range(T_y):
        if y == 0:
            alpha = lp_tm[0] + first
        else:
            prev_shift = torch.cat([neg_col, prev[:, :-1]], dim=1)
            alpha = lp_tm[y] + torch.logaddexp(prev, prev_shift)
        prev = torch.where(ty > y, alpha, prev)
        alphas[y] = prev
    return alphas


def _check_lattice(lp_tm: torch.Tensor, t, name: str) -> torch.Tensor:
    """Validate a float32 [T_y, B, T_x] lattice on the CPU or CUDA and
    return the per-item lengths `t` as int32 [B] on its device."""
    if lp_tm.ndim != 3 or lp_tm.dtype != torch.float32:
        raise ValueError(f"expected a float32 [T_y, B, T_x] lattice, got "
                         f"{lp_tm.dtype} {tuple(lp_tm.shape)}")
    if lp_tm.device.type not in ("cpu", "cuda"):
        raise ValueError(f"forward-sum runs on a CPU or CUDA tensor, got "
                         f"{lp_tm.device}")
    B = lp_tm.shape[1]
    t = torch.as_tensor(t).to(device=lp_tm.device, dtype=torch.int32)
    if t.shape != (B,):
        raise ValueError(f"{name} must be [{B}], got {tuple(t.shape)}")
    return t


def forward_sum_alpha(lp_tm: torch.Tensor, t_y):
    """Alpha lattice [T_y, B, T_x] and final column [B, T_x].

    lp_tm: f32 [T_y, B, T_x] (any strides), NEG-masked at x >= t_x;
    t_y: [B] int."""
    t_y = _check_lattice(lp_tm, t_y, "t_y")
    T_y, B, T_x = lp_tm.shape
    if lp_tm.numel() == 0:
        return (torch.empty_like(lp_tm),
                torch.full((B, T_x), NEG, device=lp_tm.device))
    if lp_tm.device.type == "cpu":
        alphas = alpha_plain(lp_tm, t_y)
        return alphas, alphas[-1]
    alphas = _alphas_out(T_y, B, T_x, lp_tm.device)
    final = torch.empty((B, T_x), dtype=torch.float32, device=lp_tm.device)
    threads, cells, ring, _ = _sweep_plan(T_x)
    t_y = t_y.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(lp_tm.device):
        err = lib.forward_sum_alpha_launch(
            lp_tm.data_ptr(), *lp_tm.stride(), t_y.data_ptr(),
            alphas.data_ptr(), final.data_ptr(), B, T_x, T_y, threads, cells,
            ring, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, KERNEL)
    _build.LAUNCHES[KERNEL] += 1
    return alphas, final


def gamma_plain(lp_tm: torch.Tensor, alphas: torch.Tensor,
                total: torch.Tensor, t_x: torch.Tensor,
                t_y: torch.Tensor) -> torch.Tensor:
    """Posterior occupancy gamma = exp(alpha + beta - total), [T_y, B, T_x].

    lp_tm: f32 [T_y, B, T_x], NEG-masked at x >= t_x; alphas: its alpha
    lattice; total: [B] log-marginal, already 0 for invalid items (else
    the exp overflows); t_x, t_y: [B]. A reverse sweep over the message
    M[y] = lp[y] + beta[y]: beta[y] = logaddexp(M[y+1, x], M[y+1, x+1]),
    the advance arm NEG at x == t_x - 1 and x == T_x - 1; beta = 0 at
    (t_x - 1, t_y - 1) and NEG elsewhere on frame t_y - 1; frames past
    t_y pass the message through. Gamma is exactly 0 off the live cells
    (y < t_y and lp > NEG/2). The result is a [T_y, B, T_x] view of a
    [B, T_y, T_x] tensor, the layout the kernel writes."""
    T_y, B, T_x = lp_tm.shape
    dev = lp_tm.device
    xs = torch.arange(T_x, device=dev)[None, :]
    tx = t_x.to(dev)[:, None]
    ty = t_y.to(dev)[:, None]
    x_is_last = xs == tx - 1
    no_advance = x_is_last | (xs == T_x - 1)
    end_col = torch.where(x_is_last, 0.0, NEG).to(lp_tm.dtype)
    tot = total.to(dev)[:, None]
    neg_col = torch.full((B, 1), NEG, dtype=lp_tm.dtype, device=dev)
    m_next = torch.full((B, T_x), NEG, dtype=lp_tm.dtype, device=dev)
    gamma = torch.empty((B, T_y, T_x), dtype=lp_tm.dtype, device=dev)
    for y in range(T_y - 1, -1, -1):
        lp = lp_tm[y]
        shift = torch.where(no_advance, NEG,
                            torch.cat([m_next[:, 1:], neg_col], dim=1))
        beta = torch.logaddexp(m_next, shift)
        beta = torch.where(ty - 1 == y, end_col, beta)
        live = (ty > y) & (lp > 0.5 * NEG)
        gamma[:, y] = torch.where(live, torch.exp(alphas[y] + beta - tot),
                                  0.0)
        m = lp + beta
        m = torch.where(m > 0.5 * NEG, m, NEG)
        m_next = torch.where(ty > y, m, m_next)
    return gamma.transpose(0, 1)


def _check_grad_inputs(lp_tm, alphas, total, t_x, t_y):
    """Validate a beta sweep's inputs; returns (total f32 [B], t_x, t_y
    int32 [B]) on the lattice's device."""
    t_x = _check_lattice(lp_tm, t_x, "t_x")
    t_y = _check_lattice(lp_tm, t_y, "t_y")
    B = lp_tm.shape[1]
    if alphas.shape != lp_tm.shape or alphas.dtype != torch.float32 \
            or alphas.device != lp_tm.device:
        raise ValueError(f"alphas must be float32 {tuple(lp_tm.shape)} on "
                         f"{lp_tm.device}, got {alphas.dtype} "
                         f"{tuple(alphas.shape)} on {alphas.device}")
    total = torch.as_tensor(total).to(device=lp_tm.device,
                                      dtype=torch.float32)
    if total.shape != (B,):
        raise ValueError(f"total must be [{B}], got {tuple(total.shape)}")
    return total, t_x, t_y


def forward_sum_grad(lp_tm: torch.Tensor, alphas: torch.Tensor,
                     total: torch.Tensor, t_x, t_y) -> torch.Tensor:
    """Posterior occupancy gamma [T_y, B, T_x] (a view of a [B, T_y, T_x]
    tensor): see `gamma_plain` for the contract. lp_tm and alphas are
    read through their strides; total is f32 [B]."""
    total, t_x, t_y = _check_grad_inputs(lp_tm, alphas, total, t_x, t_y)
    T_y, B, T_x = lp_tm.shape
    if lp_tm.device.type == "cpu":
        return gamma_plain(lp_tm, alphas, total, t_x, t_y)
    gamma = _gamma_out(B, T_y, T_x, lp_tm.device)
    if lp_tm.numel() == 0:
        return gamma
    threads, cells, ring, _ = _sweep_plan(T_x)
    total, t_x, t_y = total.contiguous(), t_x.contiguous(), t_y.contiguous()
    lib = _build.load_library()
    with torch.cuda.device(lp_tm.device):
        err = lib.forward_sum_grad_launch(
            lp_tm.data_ptr(), *lp_tm.stride(), alphas.data_ptr(),
            *alphas.stride(), total.data_ptr(), t_x.data_ptr(),
            t_y.data_ptr(), gamma.data_ptr(), *gamma.stride(), B, T_x, T_y,
            threads, cells, ring, torch.cuda.current_stream().cuda_stream)
    _build.check(lib, err, GRAD_KERNEL)
    _build.LAUNCHES[GRAD_KERNEL] += 1
    return gamma
