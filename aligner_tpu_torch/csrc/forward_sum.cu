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
//
// logaddexp is jnp.logaddexp's form, m + log1p(exp(-|a-b|)) with
// m = max(a, b), in precise expf/log1pf: the file is built without
// --use_fast_math, since the loss and its gradient are held to the JAX
// package at about 1e-5.
//
// What bounds both on this card: a chain of T_y dependent column steps per
// item (a shared-memory exchange with the x-1 or x+1 neighbour, one expf
// and one log1pf, one __syncthreads), i.e. latency, plus one pass over the
// lattices: H2 writes alpha, H3 reads lp and alpha and writes gamma, each
// B*T_y*T_x*4 bytes. Reads and writes go through strides and are
// x-contiguous in the port's layouts, so each column step is one coalesced
// row per item, and the transposed views the loss passes are never copied.
// One block per item runs the items in parallel.
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e15f;

__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}

__global__ void forward_sum_alpha_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_x, const int* __restrict__ t_y,
    float* __restrict__ alphas, float* __restrict__ final_col, int B,
    int T_x, int T_y) {
  extern __shared__ float cols[];  // two alpha columns of T_x floats
  const int b = blockIdx.x;
  const int ty = t_y[b];
  const float* l = lp + b * sl_b;
  float* prev = cols;
  float* cur = cols + T_x;

  for (int x = threadIdx.x; x < T_x; x += blockDim.x) prev[x] = NEG;
  __syncthreads();

  for (int y = 0; y < T_y; ++y) {
    float* out = alphas + (static_cast<long long>(y) * B + b) * T_x;
    for (int x = threadIdx.x; x < T_x; x += blockDim.x) {
      float a;
      if (y >= ty) {
        a = prev[x];
      } else if (y == 0) {
        a = l[x * sl_x] + (x == 0 ? 0.f : NEG);
      } else {
        const float ps = x > 0 ? prev[x - 1] : NEG;
        a = l[y * sl_y + x * sl_x] + logaddexp(prev[x], ps);
      }
      cur[x] = a;
      out[x] = a;
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }

  for (int x = threadIdx.x; x < T_x; x += blockDim.x)
    final_col[static_cast<long long>(b) * T_x + x] = prev[x];
}

__global__ void forward_sum_grad_kernel(
    const float* __restrict__ lp, long long sl_y, long long sl_b,
    long long sl_x, const float* __restrict__ alphas, long long sa_y,
    long long sa_b, long long sa_x, const float* __restrict__ total,
    const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ gamma, long long sg_y, long long sg_b,
    long long sg_x, int T_x, int T_y) {
  extern __shared__ float cols[];  // two message columns of T_x floats
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const float tot = total[b];
  const float* l = lp + b * sl_b;
  const float* a = alphas + b * sa_b;
  float* g = gamma + b * sg_b;
  float* nxt = cols;
  float* cur = cols + T_x;

  for (int x = threadIdx.x; x < T_x; x += blockDim.x) nxt[x] = NEG;
  __syncthreads();

  for (int y = T_y - 1; y >= 0; --y) {
    for (int x = threadIdx.x; x < T_x; x += blockDim.x) {
      float m = nxt[x];
      float gm = 0.f;
      if (y < ty) {
        float beta;
        if (y == ty - 1) {
          beta = x == tx - 1 ? 0.f : NEG;
        } else {
          const float adv = (x == tx - 1 || x == T_x - 1) ? NEG : nxt[x + 1];
          beta = logaddexp(m, adv);
        }
        const float lv = l[y * sl_y + x * sl_x];
        if (lv > 0.5f * NEG) gm = expf(a[y * sa_y + x * sa_x] + beta - tot);
        m = lv + beta;
        if (!(m > 0.5f * NEG)) m = NEG;
      }
      cur[x] = m;
      g[y * sg_y + x * sg_x] = gm;
    }
    __syncthreads();
    float* t = nxt;
    nxt = cur;
    cur = t;
  }
}

}  // namespace

// lp: f32 lattice read as [T_y, B, T_x] through element strides sl_*
// (already masked with NEG at x >= t_x); t_y: int32 [B]; alphas: f32
// [T_y, B, T_x] contiguous; final_col: f32 [B, T_x] contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int forward_sum_alpha_launch(const float* lp, long long sl_y,
                                        long long sl_b, long long sl_x,
                                        const int* t_y, float* alphas,
                                        float* final_col, int B, int T_x,
                                        int T_y, void* stream) {
  const int threads = T_x >= 1024 ? 1024 : ((T_x + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(T_x) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        forward_sum_alpha_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  forward_sum_alpha_kernel<<<B, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      lp, sl_y, sl_b, sl_x, t_y, alphas, final_col, B, T_x, T_y);
  return static_cast<int>(cudaGetLastError());
}

// lp, alphas: f32 lattices read as [T_y, B, T_x] through element strides
// (lp already masked with NEG at x >= t_x); total: f32 [B], 0 for invalid
// items; t_x, t_y: int32 [B]; gamma: f32 written as [T_y, B, T_x] through
// element strides sg_*. Returns cudaGetLastError() after the launch.
extern "C" int forward_sum_grad_launch(
    const float* lp, long long sl_y, long long sl_b, long long sl_x,
    const float* alphas, long long sa_y, long long sa_b, long long sa_x,
    const float* total, const int* t_x, const int* t_y, float* gamma,
    long long sg_y, long long sg_b, long long sg_x, int B, int T_x, int T_y,
    void* stream) {
  const int threads = T_x >= 1024 ? 1024 : ((T_x + 31) / 32) * 32;
  const size_t smem = 2 * static_cast<size_t>(T_x) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        forward_sum_grad_kernel,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  forward_sum_grad_kernel<<<B, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      lp, sl_y, sl_b, sl_x, alphas, sa_y, sa_b, sa_x, total, t_x, t_y, gamma,
      sg_y, sg_b, sg_x, T_x, T_y);
  return static_cast<int>(cudaGetLastError());
}
