// Forward-sum sweeps on Hopper: the log-domain forward (alpha) and
// backward (beta) algorithms over the monotonic alignment lattice, the
// loss and the gradient of the OTA objective.
//
// H2, forward_sum_alpha_kernel, replaces the TPU kernel _alpha_kernel via
// forward_sum_alpha_pallas (aligner_tpu/ops/forward_sum_pallas.py):
//
//   alpha[y,x] = lp[y,x] + (y == 0 ? (x == 0 ? 0 : NEG)
//                                  : logaddexp(alpha[y-1,x], alpha[y-1,x-1]))
//   frames y >= t_y freeze the carry: alpha[y] = alpha[y-1]
// with alpha[-1] = NEG everywhere and alpha[y-1,-1] = NEG.
//
// H3, forward_sum_grad_kernel, replaces _beta_grad_kernel via
// forward_sum_grad_pallas: a reverse sweep over the message
// M[y] = lp[y] + beta[y] that emits the posterior
//
//   beta[y,x]  = y == t_y-1 ? (x == t_x-1 ? 0 : NEG)
//                           : logaddexp(M[y+1,x], M[y+1,x+1])
//   gamma[y,x] = exp(alpha[y,x] + beta[y,x] - total)  on live cells
//                (y < t_y, lp > NEG/2), exactly 0 elsewhere
// with the advance arm NEG at x == t_x-1 and x == T_x-1, M clamped to
// NEG at or below NEG/2, and frames y >= t_y passing the message through.
// The caller zeroes `total` for invalid items, so the exp cannot overflow.
// An item outside 1 <= t_x <= min(t_y, T_x) has gamma 0 everywhere (its
// end column is all NEG, or no path meets alpha's), so it runs no chain.
//
// logaddexp is jnp.logaddexp's form, m + log1p(exp(-|a-b|)) with
// m = max(a, b), in precise expf/log1pf: the file is built without
// --use_fast_math, since the loss and its gradient are held to the JAX
// package at about 1e-5.
//
// What bounds both on this card: a chain of t_y dependent column steps per
// item (a shared-memory exchange with the x-1 or x+1 neighbour, one expf
// and one log1pf, one __syncthreads), i.e. latency, plus one pass over the
// lattices: H2 reads lp and writes alpha, H3 reads lp and alpha and writes
// gamma, each B*T_y*T_x*4 bytes. Reads and writes go through strides, so
// the transposed views the loss passes are never copied. One block per
// item runs the items in parallel. H2 is the sweep of
// csrc/forward_sweep.cuh and H3 that of csrc/posterior_sweep.cuh, which
// say how their design keeps the loads, the posterior and the frames past
// t_y off the chain.
#include <cuda_runtime.h>

#include "forward_sweep.cuh"
#include "posterior_sweep.cuh"

namespace {

template <int CELLS, int RING>
__global__ void __launch_bounds__(1024) forward_sum_alpha_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_x, const int* __restrict__ t_y,
    float* __restrict__ alphas, float* __restrict__ final_col, int B,
    int T_x, int T_y) {
  const int b = blockIdx.x;
  const ForwardLattices item{lp + b * sl_b,
                             sl_y,
                             sl_x,
                             alphas + static_cast<long long>(b) * T_x,
                             static_cast<long long>(B) * T_x,
                             1,
                             final_col + static_cast<long long>(b) * T_x};
  forward_sweep<CELLS, RING>(
      item, T_x, T_y, t_y[b], [](int x) { return x == 0 ? 0.f : NEG; },
      [](const float* prev, int x) { return logaddexp(prev[x], prev[x - 1]); });
}

template <int CELLS, int RING>
__global__ void __launch_bounds__(1024) forward_sum_grad_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_x, const float* __restrict__ alphas, long long sa_y,
    long long sa_b, long long sa_x, const float* __restrict__ total,
    const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ gamma, long long sg_y, long long sg_b,
    long long sg_x, int T_x, int T_y) {
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const ItemLattices item{lp + b * sl_b,     sl_y, sl_x,
                          alphas + b * sa_b, sa_y, sa_x,
                          gamma + b * sg_b,  sg_y, sg_x};
  const bool chain = tx >= 1 && tx <= ty && tx <= T_x;
  posterior_sweep<CELLS, RING>(
      item, T_x, T_y, ty, chain, total[b],
      [=](const float* nxt, int x, bool end) {
        if (end) return x == tx - 1 ? 0.f : NEG;
        const float adv = (x == tx - 1 || x == T_x - 1) ? NEG : nxt[x + 1];
        return logaddexp(nxt[x], adv);
      });
}

}  // namespace

// lp: f32 lattice read as [T_y, B, T_x] through element strides sl_*
// (already masked with NEG at x >= t_x); t_y: int32 [B]; alphas: f32
// [T_y, B, T_x] contiguous; final_col: f32 [B, T_x] contiguous; threads,
// cells, ring: the wrapper's plan. Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a plan that was not built.
extern "C" int forward_sum_alpha_launch(const float* lp, long long sl_y,
                                        long long sl_b, long long sl_x,
                                        const int* t_y, float* alphas,
                                        float* final_col, int B, int T_x,
                                        int T_y, int threads, int cells,
                                        int ring, void* stream) {
  return static_cast<int>(with_plan(cells, ring, [&](auto plan) {
    using P = decltype(plan);
    return launch_sweep(forward_sum_alpha_kernel<P::cells, P::ring>, B,
                        threads, cells, T_x,
                        forward_smem(threads * cells, P::ring), stream, lp,
                        sl_y, sl_b, sl_x, t_y, alphas, final_col, B, T_x,
                        T_y);
  }));
}

// lp, alphas: f32 lattices read as [T_y, B, T_x] through element strides
// (lp already masked with NEG at x >= t_x); total: f32 [B], 0 for invalid
// items; t_x, t_y: int32 [B]; gamma: f32 written as [T_y, B, T_x] through
// element strides sg_*; threads, cells, ring: the wrapper's plan. Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a plan
// that was not built.
extern "C" int forward_sum_grad_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_x,
    const float* alphas, long long sa_y, long long sa_b, long long sa_x,
    const float* total, const int* t_x, const int* t_y, float* gamma,
    long long sg_y, long long sg_b, long long sg_x, int B, int T_x, int T_y,
    int threads, int cells, int ring, void* stream) {
  return static_cast<int>(with_plan(cells, ring, [&](auto plan) {
    using P = decltype(plan);
    return launch_sweep(forward_sum_grad_kernel<P::cells, P::ring>, B,
                        threads, cells, T_x,
                        sweep_smem(threads * cells, P::ring), stream, lp,
                        sl_y, sl_b, sl_x, alphas, sa_y, sa_b, sa_x, total,
                        t_x, t_y, gamma, sg_y, sg_b, sg_x, T_x, T_y);
  }));
}
