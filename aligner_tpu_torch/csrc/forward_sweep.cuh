// The forward alpha sweep of H2 (csrc/forward_sum.cu) and H5
// (csrc/skip_dp.cu): one block per item walks the item's live frames
// y = 0..t_y - 1 over
//
//   alpha[0, c] = lp[0, c] + first(c)
//   alpha[y, c] = lp[y, c] + arms(alpha[y - 1], c)
//
// and freezes the carry on frames y >= t_y. The recursion's arms are
// passed in, as the posterior sweeps pass beta (csrc/posterior_sweep.cuh,
// whose logaddexp, plans and launch it shares).
//
// What bounds it on this card: a chain of t_y dependent column steps per
// item, coupled one cell wide, so latency, not bytes (lp read once, alpha
// written once). Only what the next frame needs is on the chain:
//
// * Rows fetched ahead. Each thread copies its own cells of lp for frame
//   y + RING - 1 (cp.async, 4 bytes each, through any stride) into a ring
//   of RING slots in shared memory, and waits only for frame y + 1's
//   copies before the barrier that ends frame y. A thread reads only the
//   ring cells it copied itself, so the ring needs no barrier of its own;
//   frame f goes into the slot that frame f - RING left the step before.
// * A frame step of one basic block: the neighbours from the shared
//   column, the arms, the add of lp, a shared store, the alpha row's store
//   (__stwb) and one barrier (the columns are double-buffered). Frame 0 is
//   peeled; the columns carry PAD cells of NEG on the left (one for H2,
//   two for H5), so the arms read c - 1 and c - 2 without an `if`;
//   columns and ring rows are padded to threads x CELLS cells, and cells
//   c >= T run the chain on what their shared memory holds, touching no
//   device memory. Copies past
//   the last live frame are predicated off, not branched around.
// * Only live frames on the chain. After frame t_y - 1 each thread writes
//   its own cells of the frozen column to frames t_y..T_y - 1 and to the
//   final column, with no barrier.
// * CELLS cells per thread, c = threadIdx.x + k * blockDim.x, with the
//   threads, CELLS and RING of the wrapper's plan: H2 and H5 take the
//   posterior sweeps' `_sweep_plan` (ops/forward_sum_kernel.py) and
//   `with_plan`, and hold one row a slot where they hold two.
//
// Per cell the operations and their order are those of the plain version
// (alpha_plain, alpha_skip_plain) and the Pallas bodies: lp + logaddexp(...), in precise
// expf/log1pf (no --use_fast_math).
#pragma once
#include <cuda_runtime.h>

#include "cp_async.cuh"
#include "posterior_sweep.cuh"

namespace {

// One item's forward lattices, [T_y, T] through element strides: lp (read)
// and alpha (written), and its final column [T].
struct ForwardLattices {
  const float* lp;
  long long sl_y, sl_c;
  float* alpha;
  long long sa_y, sa_c;
  float* final_col;
};

// Shared memory of a forward sweep whose threads hold `pitch` cells: RING
// lp rows and two columns behind `pad` cells of NEG each.
inline size_t forward_smem(int pitch, int ring, int pad) {
  return (static_cast<size_t>(ring) * pitch + 2 * (pitch + pad)) *
         sizeof(float);
}

// The sweep of one item (see above). first_at(c) is frame 0's term at
// cell c; arms_at(prev, c) the recursion's term from the column
// prev = alpha[y - 1], whose cells -PAD..-1 hold NEG (PAD: how far left
// the arms read, 1 for H2's c - 1, 2 for H5's c - 2).
template <int CELLS, int RING, int PAD, class First, class Arms>
__device__ __forceinline__ void forward_sweep(const ForwardLattices& item,
                                              int T, int T_y, int ty,
                                              First first_at, Arms arms_at) {
  static_assert(RING >= 2, "a frame is fetched at least one frame ahead");
  extern __shared__ float smem[];
  const int P = blockDim.x * CELLS;  // the pitch of a column or ring row
  float* ring = smem;                // frame f in slot f % RING
  float* const last_slot = ring + (RING - 1) * P;
  float* prev = ring + RING * P + PAD;  // alpha[y - 1]
  float* cur = prev + P + PAD;          // alpha[y]
  int cell[CELLS];
  bool live[CELLS];  // inside the lattice: fetched and stored
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    cell[k] = threadIdx.x + k * blockDim.x;
    live[k] = cell[k] < T;
  }
  const int top = ty < 0 ? 0 : (ty < T_y ? ty : T_y);  // chain: [0, top)

  float a[CELLS];  // each cell's alpha at the chain's last frame
  float* out_at[CELLS];
#pragma unroll
  for (int k = 0; k < CELLS; ++k) {
    a[k] = NEG;
    out_at[k] = item.alpha + cell[k] * item.sa_c;
  }
  if (top > 0) {
    // Each cell's next lp to copy; one commit group per frame, the copies
    // of frames >= top predicated off.
    const float* lp_at[CELLS];
#pragma unroll
    for (int k = 0; k < CELLS; ++k) lp_at[k] = item.lp + cell[k] * item.sl_c;
    float* fetch_slot = ring;
    int fetch_frame = 0;
    auto fetch = [&]() {
      const bool go = fetch_frame < top;
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        if (go && live[k]) cp_async4(fetch_slot + cell[k], lp_at[k]);
        lp_at[k] += item.sl_y;
      }
      cp_async_commit();
      ++fetch_frame;
      fetch_slot = fetch_slot == last_slot ? ring : fetch_slot + P;
    };
    for (int j = 1; j < RING; ++j) fetch();  // frames 0..RING-2
    if (cell[0] < PAD) {
      prev[cell[0] - PAD] = NEG;
      cur[cell[0] - PAD] = NEG;
    }
    const float* row = ring;  // frame y's slot
    auto emit = [&]() {
#pragma unroll
      for (int k = 0; k < CELLS; ++k) {
        cur[cell[k]] = a[k];
        if (live[k]) __stwb(out_at[k], a[k]);
        out_at[k] += item.sa_y;
      }
      fetch();  // frame y + RING - 1, into the slot frame y - 1 left
      row = row == last_slot ? ring : row + P;
      float* const t = prev;
      prev = cur;
      cur = t;
      cp_async_wait<RING - 2>();  // frame y + 1 has landed
      __syncthreads();
    };
    cp_async_wait<RING - 2>();  // frame 0 has landed
#pragma unroll
    for (int k = 0; k < CELLS; ++k) a[k] = row[cell[k]] + first_at(cell[k]);
    emit();
    for (int y = 1; y < top; ++y) {
      float lv[CELLS];
#pragma unroll
      for (int k = 0; k < CELLS; ++k) lv[k] = row[cell[k]];
#pragma unroll
      for (int k = 0; k < CELLS; ++k) a[k] = lv[k] + arms_at(prev, cell[k]);
      emit();
    }
  }
  // The frozen carry: frames top..T_y-1 and the final column, no barrier.
  for (int y = top; y < T_y; ++y) {
#pragma unroll
    for (int k = 0; k < CELLS; ++k) {
      if (live[k]) __stwb(out_at[k], a[k]);
      out_at[k] += item.sa_y;
    }
  }
#pragma unroll
  for (int k = 0; k < CELLS; ++k)
    if (live[k]) item.final_col[cell[k]] = a[k];
}

}  // namespace
