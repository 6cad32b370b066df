// Skip-state (implicit-pause) lattice sweeps on Hopper: the pause-aware
// Viterbi and the forward-sum alpha and beta/posterior sweeps over
// T_s = 2*t_x + 1 states (even s: an optional shared pause; odd s: token
// (s-1)/2). Moves are stay, advance (from s-1) and skip (from s-2, only
// into odd s >= 3); paths start in {0, 1} and end in {ts-2, ts-1};
// enter_cost is added once per transition into a pause (an advance into
// an even state, and a start in state 0).
//
// H4, mas_skip_kernel, replaces the TPU kernels _viterbi_fwd_kernel and
// _viterbi_bwd_kernel via mas_skip_pallas and the start-state choice
// between them (aligner_tpu/ops/skip_dp_pallas.py), in one launch:
//
//   v[s,0]  = value[s,0] (+ enter_cost at s == 0) for s in {0, 1}
//   cand1   = fl(v[s-1,y-1] + enter_cost) on even s, v[s-1,y-1] on odd s
//   v[s,y]  = fl(max(v[s,y-1], cand1, v[s-2,y-1]) + value[s,y])
//   move    = 0, 1 or 2: a candidate replaces only if strictly greater,
//             advance against stay first, then skip against the better
//   walk:     s = ts-2, or ts-1 if v[ts-1,t_y-1] > v[ts-2,t_y-1];
//             for y = t_y-1..0: path[s,y] = 1; s -= move[s,y]
// Bit-identical to mas_skip_single (ops/skip_dp_reference.py): each add is
// one rounded float32 add in the reference's order, and x + 0.0f serves
// the cost-free form. A state never reads a higher state, so each item
// sweeps only its own ts states and t_y frames. Items outside
// 1 <= t_x <= t_y, or whose ts or t_y exceed the lattice, keep the
// zero-filled path.
//
// H5, forward_sum_skip_alpha_kernel, replaces _alpha_skip_kernel via
// forward_sum_skip_alpha_pallas (its per-frame body):
//
//   alpha[0,s] = lp[0,s] + (s == 0 ? enter_cost : s == 1 ? 0 : NEG)
//   alpha[y,s] = lp[y,s] + logaddexp(logaddexp(alpha[y-1,s], p1), p2)
//   p1 = alpha[y-1,s-1] (+ enter_cost on even s), NEG at s == 0
//   p2 = alpha[y-1,s-2] on odd s >= 3, else NEG
//   frames y >= t_y freeze the carry.
//
// H6, forward_sum_skip_gamma_kernel, replaces _gamma_skip_kernel via
// forward_sum_skip_gamma_pallas: a reverse sweep over the message
// M[y] = lp[y] + beta[y] that emits the posterior
//
//   beta[y,s]  = y == t_y-1 ? (s in {ts-1, ts-2} ? 0 : NEG)
//              : logaddexp(logaddexp(M[y+1,s], m1), m2)
//   m1 = M[y+1,s+1] (+ enter_cost on odd s) where s+1 < ts, else NEG
//   m2 = M[y+1,s+2] on odd s with s+2 < ts, else NEG
//   gamma[y,s] = exp(alpha[y,s] + beta[y,s] - total) on live cells
//                (y < t_y, lp > NEG/2), exactly 0 elsewhere
// with M clamped to NEG at or below NEG/2 and frames y >= t_y passing the
// message through. The caller zeroes `total` for invalid items, so the
// exp cannot overflow. An item with t_x > t_y, t_y < 1, or neither end
// state inside the lattice has gamma 0 everywhere and runs no chain; one
// with t_x = 0 keeps its chain, since its pause-only path is a path of
// the lattice and the plain version gives it mass.
//
// logaddexp is jnp.logaddexp's form in precise expf/log1pf; the file is
// built without --use_fast_math and has no multiply to contract.
//
// What bounds them on this card: like the plain-lattice sweeps, a chain
// of t_y dependent column steps per item (a shared-memory exchange with
// the s-1, s-2 or s+1, s+2 neighbours and one __syncthreads each; H4 adds
// a single-thread walk over the moves), i.e. latency, plus one pass over
// the lattices. One block per item runs the items in parallel; the column
// is double-buffered in shared memory, so a step takes one barrier;
// threads stride over T_s > 1024 and the neighbour reads stay inside the
// shared column. Lattices are read and written through strides, so the
// model's frame-major lattice is read in place, state-contiguous (one
// coalesced row per step); H4's moves (uint8 [B,T_y,T_s]) stay in L2. H6
// is the sweep of csrc/posterior_sweep.cuh (two nested logaddexp where H3
// has one), which says how its design keeps the loads, the posterior and
// the padded frames off the chain.
#include <cuda_runtime.h>
#include <stdint.h>

#include "posterior_sweep.cuh"

namespace {

__global__ void mas_skip_kernel(const float* __restrict__ value,
                                long long sv_b, long long sv_s,
                                long long sv_y, const int* __restrict__ t_x,
                                const int* __restrict__ t_y,
                                uint8_t* __restrict__ moves,
                                float* __restrict__ path, long long sp_b,
                                long long sp_s, long long sp_y, int T_s,
                                int T_y, float max_neg_val,
                                float enter_cost) {
  extern __shared__ float cols[];  // two value columns of T_s floats
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  if (tx < 1 || tx > ty || ty > T_y || tx > (T_s - 1) / 2) return;
  const int ts = 2 * tx + 1;

  const float* v = value + b * sv_b;
  uint8_t* moves_b = moves + static_cast<long long>(b) * T_y * T_s;
  float* prev = cols;
  float* cur = cols + T_s;

  // Frame 0: only the start states {0, 1} are live, and no move is made.
  for (int s = threadIdx.x; s < ts; s += blockDim.x) {
    float a = max_neg_val;
    if (s == 0) a = v[0] + enter_cost;
    if (s == 1) a = v[sv_s];
    prev[s] = a;
    moves_b[s] = 0;
  }
  __syncthreads();

  for (int y = 1; y < ty; ++y) {
    for (int s = threadIdx.x; s < ts; s += blockDim.x) {
      float best = prev[s];
      uint8_t m = 0;
      if (s >= 1) {
        float cand = prev[s - 1];
        if ((s & 1) == 0) cand += enter_cost;
        if (cand > best) {
          best = cand;
          m = 1;
        }
      }
      if (s >= 3 && (s & 1)) {
        const float cand = prev[s - 2];
        if (cand > best) {
          best = cand;
          m = 2;
        }
      }
      cur[s] = best + v[s * sv_s + y * sv_y];
      moves_b[static_cast<long long>(y) * T_s + s] = m;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  if (threadIdx.x != 0) return;
  // The last token unless the trailing pause is strictly better.
  int s = prev[ts - 1] > prev[ts - 2] ? ts - 1 : ts - 2;
  float* p = path + b * sp_b;
  for (int y = ty - 1; y >= 0; --y) {
    p[s * sp_s + y * sp_y] = 1.f;
    s -= moves_b[static_cast<long long>(y) * T_s + s];
  }
}

__global__ void forward_sum_skip_alpha_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_s, const int* __restrict__ t_y, float* __restrict__ alphas,
    float* __restrict__ final_col, int B, int T_s, int T_y,
    float enter_cost) {
  extern __shared__ float cols[];  // two alpha columns of T_s floats
  const int b = blockIdx.x;
  const int ty = t_y[b];
  const float* l = lp + b * sl_b;
  float* prev = cols;
  float* cur = cols + T_s;

  for (int s = threadIdx.x; s < T_s; s += blockDim.x) prev[s] = NEG;
  __syncthreads();

  for (int y = 0; y < T_y; ++y) {
    float* out = alphas + (static_cast<long long>(y) * B + b) * T_s;
    for (int s = threadIdx.x; s < T_s; s += blockDim.x) {
      float a;
      if (y >= ty) {
        a = prev[s];
      } else if (y == 0) {
        a = l[s * sl_s] + (s == 0 ? enter_cost : (s == 1 ? 0.f : NEG));
      } else {
        float p1 = NEG;
        float p2 = NEG;
        if (s >= 1) {
          p1 = prev[s - 1];
          if ((s & 1) == 0) p1 += enter_cost;
        }
        if (s >= 3 && (s & 1)) p2 = prev[s - 2];
        a = l[y * sl_y + s * sl_s] + logaddexp(logaddexp(prev[s], p1), p2);
      }
      cur[s] = a;
      out[s] = a;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  for (int s = threadIdx.x; s < T_s; s += blockDim.x)
    final_col[static_cast<long long>(b) * T_s + s] = prev[s];
}

template <int CELLS, int RING>
__global__ void __launch_bounds__(1024) forward_sum_skip_gamma_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_s, const float* __restrict__ alphas, long long sa_y,
    long long sa_b, long long sa_s, const float* __restrict__ total,
    const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ gamma, long long sg_y, long long sg_b,
    long long sg_s, int T_s, int T_y, float enter_cost) {
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const long long ts = 2LL * tx + 1;
  const int ty = t_y[b];
  const ItemLattices item{lp + b * sl_b,     sl_y, sl_s,
                          alphas + b * sa_b, sa_y, sa_s,
                          gamma + b * sg_b,  sg_y, sg_s};
  const bool chain = ty >= 1 && tx >= 0 && tx <= ty && ts - 2 < T_s;
  posterior_sweep<CELLS, RING>(
      item, T_s, T_y, ty, chain, total[b],
      [=](const float* nxt, int s, bool end) {
        if (end) return (s == ts - 1 || s == ts - 2) ? 0.f : NEG;
        float m1 = NEG;
        float m2 = NEG;
        // s + 1 < ts keeps the arc inside the item; s + 1 < T_s keeps the
        // read inside the shared column when ts exceeds it.
        if (s + 1 < ts && s + 1 < T_s) {
          m1 = nxt[s + 1];
          if (s & 1) m1 += enter_cost;
        }
        if ((s & 1) && s + 2 < ts && s + 2 < T_s) m2 = nxt[s + 2];
        return logaddexp(logaddexp(nxt[s], m1), m2);
      });
}

int block_threads(int T_s) {
  return T_s >= 1024 ? 1024 : ((T_s + 31) / 32) * 32;
}

// Two float columns of T_s in dynamic shared memory; above 48 KB the
// kernel has to opt in.
template <typename Kernel>
cudaError_t column_smem(Kernel kernel, int T_s, size_t* smem) {
  *smem = 2 * static_cast<size_t>(T_s) * sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// value: f32 lattice read as [B, T_s, T_y] through element strides sv_*;
// t_x, t_y: int32 [B]; moves: uint8 scratch [B, T_y, T_s]; path: f32,
// zero-filled, written through strides sp_*. Returns cudaGetLastError()
// after the launch.
extern "C" int mas_skip_launch(const float* value, long long sv_b,
                               long long sv_s, long long sv_y,
                               const int* t_x, const int* t_y,
                               uint8_t* moves, float* path, long long sp_b,
                               long long sp_s, long long sp_y, int B,
                               int T_s, int T_y, float max_neg_val,
                               float enter_cost, void* stream) {
  size_t smem;
  cudaError_t err = column_smem(mas_skip_kernel, T_s, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mas_skip_kernel<<<B, block_threads(T_s), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      value, sv_b, sv_s, sv_y, t_x, t_y, moves, path, sp_b, sp_s, sp_y, T_s,
      T_y, max_neg_val, enter_cost);
  return static_cast<int>(cudaGetLastError());
}

// lp: f32 lattice read as [T_y, B, T_s] through element strides sl_*
// (already masked with NEG at s >= 2*t_x+1); t_y: int32 [B]; alphas: f32
// [T_y, B, T_s] contiguous; final_col: f32 [B, T_s] contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int forward_sum_skip_alpha_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_s,
    const int* t_y, float* alphas, float* final_col, int B, int T_s, int T_y,
    float enter_cost, void* stream) {
  size_t smem;
  cudaError_t err = column_smem(forward_sum_skip_alpha_kernel, T_s, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  forward_sum_skip_alpha_kernel<<<B, block_threads(T_s), smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      lp, sl_y, sl_b, sl_s, t_y, alphas, final_col, B, T_s, T_y, enter_cost);
  return static_cast<int>(cudaGetLastError());
}

// lp, alphas: f32 lattices read as [T_y, B, T_s] through element strides
// (lp already masked with NEG at s >= 2*t_x+1); total: f32 [B], 0 for
// invalid items; t_x, t_y: int32 [B]; gamma: f32 written as [T_y, B, T_s]
// through element strides sg_*; threads, cells, ring: the wrapper's plan.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for a plan that was not built.
extern "C" int forward_sum_skip_gamma_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_s,
    const float* alphas, long long sa_y, long long sa_b, long long sa_s,
    const float* total, const int* t_x, const int* t_y, float* gamma,
    long long sg_y, long long sg_b, long long sg_s, int B, int T_s, int T_y,
    int threads, int cells, int ring, float enter_cost, void* stream) {
  return static_cast<int>(with_plan(cells, ring, [&](auto plan) {
    using P = decltype(plan);
    return launch_sweep(forward_sum_skip_gamma_kernel<P::cells, P::ring>, B,
                        threads, cells, T_s, ring, stream, lp, sl_y, sl_b,
                        sl_s, alphas, sa_y, sa_b, sa_s, total, t_x, t_y,
                        gamma, sg_y, sg_b, sg_s, T_s, T_y, enter_cost);
  }));
}
