// The reverse message sweep that H3 (csrc/forward_sum.cu) and H6
// (csrc/skip_dp.cu) share: one block per item walks the item's live frames
// from y = t_y - 1 down to 0 over the message M[y] = lp[y] + beta[y], and
// emits the posterior gamma[y] = exp(alpha[y] + beta[y] - total). The two
// kernels differ only in beta (two arms or three), which each passes in.
//
// What bounds it on this card: a chain of t_y dependent column steps per
// item, whose coupling is one or two cells wide, so latency, not bytes
// (lp and alpha read once, gamma written once). The design keeps on the
// chain only what the next frame needs:
//
// * Rows fetched ahead. Each thread copies its own cells of lp and alpha
//   for frame y + 1 - RING (cp.async, 4 bytes each, through any stride)
//   into a ring of RING slots in shared memory before frame y's barrier,
//   and waits only for frame y - 1's copies. The copies are not guarded by
//   liveness (every address of a live frame is inside the lattice); the
//   guard is a select on the values. No device-memory latency sits on the
//   chain.
// * The posterior off the chain. Frame y's exp argument stays in a
//   register and gamma[y] is computed and stored during frame y - 1, so
//   its expf overlaps the chain's own. The chain per frame is: the
//   neighbours' M from shared memory, beta, M = lp + beta clamped to NEG
//   at or below NEG/2, a shared store and one block barrier (the message
//   columns are double-buffered).
// * Only live frames on the chain. A block first writes 0 to its item's
//   frames y >= t_y (all of them for an item whose gamma is 0 everywhere)
//   without a barrier, then starts at the end column. An item with
//   t_y > T_y has no end column inside the lattice; as in the plain
//   version its sweep starts from M[T_y] = NEG at frame T_y - 1.
// * CELLS cells per thread, c = threadIdx.x + k * blockDim.x, with the
//   threads and RING from the wrapper's plan
//   (ops/forward_sum_kernel.py:_sweep_plan); `with_plan` below lists the
//   (CELLS, RING) pairs built. Columns and ring rows are padded to
//   threads x CELLS cells, so a frame step is one basic block: with a
//   branch in it the compiler left the ring's reads and the posterior's
//   expf behind the chain, which then waited on them.
//
// Every thread does both jobs; a split into chain warps and warps that
// fetch and emit, synchronised by the same barrier, was no faster for H3
// and slower for H6. Timed on an NVIDIA H100 80GB HBM3 at 700 W
// (chip_smoke.py phase 7, B=16, ragged): H3 over 128 cells 163 ns a
// frame, H6 over 257 cells 308 ns, against 107 and 226 ns for the bare
// chain of one and two logaddexp with its exchange and barrier
// (python -m aligner_tpu_torch.probe_chain).
//
// Per cell the operations and their order are those of the plain versions
// (gamma_plain, gamma_skip_plain) and the Pallas bodies: logaddexp as
// m + log1pf(expf(-|a - b|)) with m = max(a, b), then expf((alpha + beta)
// - total), in precise expf/log1pf (no --use_fast_math; no multiply to
// contract). An exp argument of -inf stands for a dead cell (lp at or
// below NEG/2): expf gives exactly 0 there, as the plain version's select.
#pragma once
#include <cuda_runtime.h>
#include <math.h>

#include "cp_async.cuh"

namespace {

constexpr float NEG = -1e15f;
constexpr float DEAD = 0.5f * NEG;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

// One item's lattices, [T_y, T] through element strides: lp (NEG-masked
// off the item), its alpha lattice and the posterior gamma.
struct ItemLattices {
  const float* lp;
  long long sl_y, sl_c;
  const float* alpha;
  long long sa_y, sa_c;
  float* gamma;
  long long sg_y, sg_c;
};

// Shared memory of a sweep whose threads hold `pitch` cells (threads x
// cells, at least T): two message columns and RING slots of an lp row and
// an alpha row, `pitch` floats each.
inline size_t sweep_smem(int pitch, int ring) {
  return 2 * static_cast<size_t>(pitch) * (1 + ring) * sizeof(float);
}

// The sweep of one item (see above). `chain` is false for an item whose
// posterior is 0 everywhere (t_y < 1 among them); beta_at(nxt, c, end) is
// beta at cell c from the column nxt = M[y+1], or the end column's value
// when `end`. Cells c >= T run the chain on what their shared memory
// holds and touch no device memory, so the frame step has no branch.
template <int CELLS, int RING, class Beta>
__device__ __forceinline__ void posterior_sweep(const ItemLattices& item,
                                                int T, int T_y, int ty,
                                                bool chain, float tot,
                                                Beta beta_at) {
  static_assert(RING >= 2, "a frame is fetched at least one frame ahead");
  extern __shared__ float smem[];
  const int P = blockDim.x * CELLS;  // the pitch of a column or ring row
  float* cols = smem;                // M[y] at cols[(y & 1) * P + c]
  float* ring = smem + 2 * P;        // frame f in slot f % RING: lp, alpha
  int cell[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) cell[k] = threadIdx.x + k * blockDim.x;

  const int top = ty < T_y ? ty : T_y;  // the chain's frames: [0, top)
  // Frames past the chain: exactly 0, no barrier.
  for (int y = chain ? top : 0; y < T_y; ++y) {
#pragma unroll
    for (int k = 0; k < CELLS; ++k)
      if (cell[k] < T) item.gamma[y * item.sg_y + cell[k] * item.sg_c] = 0.f;
  }
  if (!chain) return;

  // Each cell's next lp and alpha to copy, from frame top - 1 down; one
  // commit group per frame (empty for f < 0). Frame f goes into the slot
  // that frame f + RING left the step before, so a copy never races a
  // read and lands RING - 1 steps ahead of its frame.
  const float* lp_at[CELLS];
  const float* alpha_at[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    lp_at[k] = item.lp + (top - 1) * item.sl_y + cell[k] * item.sl_c;
    alpha_at[k] = item.alpha + (top - 1) * item.sa_y + cell[k] * item.sa_c;
  }
  float* const last_slot = ring + (RING - 1) * 2 * P;
  float* fetch_slot = ring + ((top - 1) % RING) * 2 * P;
  int fetch_frame = top - 1;
  auto fetch = [&]() {
    if (fetch_frame >= 0) {
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        if (cell[k] < T) {
          cp_async4(fetch_slot + cell[k], lp_at[k]);
          cp_async4(fetch_slot + P + cell[k], alpha_at[k]);
        }
        lp_at[k] -= item.sl_y;
        alpha_at[k] -= item.sa_y;
      }
      fetch_slot = fetch_slot == ring ? last_slot : fetch_slot - 2 * P;
    }
    --fetch_frame;
    cp_async_commit();
  };
  for (int j = 1; j < RING; ++j) fetch();
  if (ty > T_y) {  // no end column inside the lattice: M[T_y] = NEG
#pragma unroll
    for (int k = 0; k < CELLS; ++k) cols[(top & 1) * P + cell[k]] = NEG;
  }
  cp_async_wait<RING - 2>();  // frame top - 1 has landed
  __syncthreads();

  const float* row = ring + ((top - 1) % RING) * 2 * P;  // frame y's slot
  float* gamma_at[CELLS];  // each cell's gamma at frame y + 1
#pragma unroll
  for (int k = 0; k < CELLS; ++k)
    gamma_at[k] = item.gamma + top * item.sg_y + cell[k] * item.sg_c;
  float pend[CELLS];  // frame y + 1's exp argument

  // Frame y: the chain, and gamma[y + 1] one frame late (its expf
  // overlaps the chain's, its store follows it). With constant `end` and
  // `emit` the step is one basic block, and every address it needs is
  // ready before the barrier that starts it.
  float* nxt = cols + (top & 1) * P;  // M[y + 1]
  float* cur = cols + ((top - 1) & 1) * P;
  auto step = [&](bool end, bool emit) {
    float lv[CELLS], av[CELLS], gm[CELLS];
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      lv[k] = row[cell[k]];
      av[k] = row[P + cell[k]];
      if (emit) gm[k] = expf(pend[k]);
    }
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      const float beta = beta_at(nxt, cell[k], end);
      const float m = lv[k] + beta;
      cur[cell[k]] = m > DEAD ? m : NEG;
      pend[k] = lv[k] > DEAD ? av[k] + beta - tot : -INFINITY;
    }
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      if (emit && cell[k] < T) __stwb(gamma_at[k], gm[k]);
      gamma_at[k] -= item.sg_y;
    }
    fetch();  // frame y + 1 - RING
    row = row == ring ? last_slot : row - 2 * P;
    float* const t = nxt;
    nxt = cur;
    cur = t;
    cp_async_wait<RING - 2>();  // frame y - 1 has landed
    __syncthreads();
  };
  step(ty <= T_y, false);  // frame top - 1
  for (int y = top - 2; y >= 0; --y) step(false, true);
#pragma unroll
  for (int k = 0; k < CELLS; ++k)
    if (cell[k] < T) __stwb(gamma_at[k], expf(pend[k]));
}

template <int C, int R>
struct Plan {
  static constexpr int cells = C;
  static constexpr int ring = R;
};

// f(Plan<cells, ring>{}) for the pairs of ops/forward_sum_kernel.py:
// SWEEP_PLANS (H2, H3 and H6); any other pair is refused.
template <class F>
cudaError_t with_plan(int cells, int ring, F f) {
  if (cells == 1 && ring == 8) return f(Plan<1, 8>{});
  if (cells == 2 && ring == 8) return f(Plan<2, 8>{});
  if (cells == 3 && ring == 8) return f(Plan<3, 8>{});
  if (cells == 4 && ring == 6) return f(Plan<4, 6>{});
  if (cells == 6 && ring == 3) return f(Plan<6, 3>{});
  if (cells == 8 && ring == 2) return f(Plan<8, 2>{});
  return cudaErrorInvalidValue;
}

// Launch a sweep kernel, one block per item, with `smem` bytes of shared
// memory (opted in above 48 KB); threads must be a multiple of 32, at most
// 1024, and cover the T cells. The forward sweeps (csrc/forward_sweep.cuh,
// H4 in csrc/skip_dp.cu) launch through it too, with their own layouts.
template <class Kernel, class... Args>
cudaError_t launch_sweep(Kernel kernel, int B, int threads, int cells,
                         int T, size_t smem, void* stream, Args... args) {
  if (threads % 32 != 0 || threads > 1024 ||
      static_cast<long long>(threads) * cells < T)
    return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(args...);
  return cudaGetLastError();
}

}  // namespace
