// MoBo boundary-search token sweeps on Hopper: the forward boundary
// recursion (soft and hard) and the backward recursion under the
// max-duration window D. All three read the token-major grid e [T_x, B, T_y1]
// through element strides (T_y1 = T_y + 1, position 0 = the virtual frame
// -1; position 0 and frames >= t_y already hold NEG, as
// ops/mobo.py:_prep_energies leaves them) and sweep over tokens, not frames.
//
// H7, mobo_alpha_kernel, replaces the TPU kernel _alpha_kernel via
// mobo_alpha_pallas (aligner_tpu/ops/mobo_pallas.py):
//
//   z_i(q)    = LSE_{d=1..D} e_i(q+d)
//   a_i(q)    = z_i(q) > NEG/2 ? logB_{i-1}(q) - z_i(q) : NEG
//   logB_i(p) = e_i(p) + LSE_{d=1..D} a_i(p-d), NEG where <= NEG/2
//   logB_{-1} = 0 at p == 0, NEG elsewhere; tokens i >= t_x repeat the
//   carry, so the last row is each item's row of token t_x - 1.
//
// H8, mobo_bp_kernel, replaces _bp_kernel via mobo_bp_pallas: the same
// recursion with max in place of the inner LSE, emitting the d that won
// (a later d replaces only if strictly greater; 0 on tokens >= t_x), and
// then, in the same launch, the walk over its own backpointers that the
// JAX package runs as a scan outside its kernel:
//
//   pos = t_y; for i = T_x-1..0: dur[i] = i < t_x ? bp_i(pos) : 0;
//   pos -= dur[i]   (pos clamped into the grid, which only an item with
//   no boundary sequence needs).
//
// H9, mobo_beta_kernel, replaces _beta_kernel via mobo_beta_pallas:
//
//   c(p)      = (e_{i+1}(p) > NEG/2 ? e_{i+1}(p) : NEG) + beta_{i+1}(p)
//   beta_i(p) = z_{i+1}(p) > NEG/2 ? LSE_{d=1..D} c(p+d) - z_{i+1}(p) : NEG
//   beta_{t_x-1} = 0 at p == t_y, NEG elsewhere; tokens i >= t_x hold NEG.
//   Token i reads the row of token i + 1 in place; no shifted copy of e.
//
// LSE is the reference's accumulation (ops/mobo.py:_window_lse): the max
// over d ascending, then the sum of expf(x_d - max) over d ascending, then
// max + logf(sum), in precise expf/logf; window cells outside the grid
// count as NEG and are not skipped, so a dead window sums D terms like the
// reference. The file is built without --use_fast_math and has no multiply
// to contract.
//
// What bounds them on this card: a chain of t_x dependent token steps per
// item, each two window passes of D shared-memory reads and D expf per
// cell (operations, not bytes: about 8*D per cell against 8 bytes moved).
// One block per item runs the items in parallel; threads stride over the
// T_y1 positions (1025 at T_mel 1024, one more than a block has threads);
// the rows that are read shifted live in shared memory with D cells of
// NEG on either side, so the window loops carry no bounds test; a step
// takes two barriers. The TPU kernel's 8-token chunks, (8,128) padding,
// broadcast length rows and VMEM carry are not carried over. z depends on
// e alone and could be taken off the chain; it is computed inside the
// token loop here, as the TPU body does.
#include <cuda_runtime.h>

namespace {

constexpr float NEG = -1e15f;
constexpr float DEAD = 0.5f * NEG;

// LSE over row[q+1 .. q+D].
__device__ __forceinline__ float window_lse_fwd(const float* row, int q,
                                                int D) {
  float m = row[q + 1];
  for (int d = 2; d <= D; ++d) m = fmaxf(m, row[q + d]);
  float s = 0.f;
  for (int d = 1; d <= D; ++d) s += expf(row[q + d] - m);
  return m + logf(s);
}

// LSE over row[p-1 .. p-D], d ascending.
__device__ __forceinline__ float window_lse_back(const float* row, int p,
                                                 int D) {
  float m = row[p - 1];
  for (int d = 2; d <= D; ++d) m = fmaxf(m, row[p - d]);
  float s = 0.f;
  for (int d = 1; d <= D; ++d) s += expf(row[p - d] - m);
  return m + logf(s);
}

// Shared rows of n cells with D cells of NEG before and after.
__device__ __forceinline__ void fill_rows(float* rows, int count) {
  for (int k = threadIdx.x; k < count; k += blockDim.x) rows[k] = NEG;
}

// The forward recursion of H7 and H8. HARD selects max/argmax and the
// backpointer output.
template <bool HARD>
__device__ __forceinline__ void forward_sweep(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, int tx, float* __restrict__ logB, int* __restrict__ bp,
    int B, int T_x, int n, int D, float* smem) {
  const int b = blockIdx.x;
  const int width = n + 2 * D;
  float* e_row = smem + D;              // e_i, read at q+1..q+D
  float* a_row = smem + width + D;      // a_i, read at p-1..p-D
  float* prev = smem + 2 * width;       // logB_{i-1}, each thread its own p
  fill_rows(smem, 2 * width);
  for (int p = threadIdx.x; p < n; p += blockDim.x) prev[p] = p ? NEG : 0.f;
  __syncthreads();

  const int live = tx < T_x ? (tx > 0 ? tx : 0) : T_x;
  const float* eb = e + b * se_b;
  for (int i = 0; i < live; ++i) {
    const long long out = (static_cast<long long>(i) * B + b) * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x)
      e_row[p] = eb[i * se_x + p * se_p];
    __syncthreads();
    for (int q = threadIdx.x; q < n; q += blockDim.x) {
      const float z = window_lse_fwd(e_row, q, D);
      a_row[q] = z > DEAD ? prev[q] - z : NEG;
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      float inner;
      if (HARD) {
        inner = a_row[p - 1];
        int arg = 1;
        for (int d = 2; d <= D; ++d) {
          const float c = a_row[p - d];
          if (c > inner) {
            inner = c;
            arg = d;
          }
        }
        bp[out + p] = arg;
      } else {
        inner = window_lse_back(a_row, p, D);
      }
      float v = e_row[p] + inner;
      if (!(v > DEAD)) v = NEG;
      prev[p] = v;
      if (!HARD) logB[out + p] = v;
    }
    // The next token's e_row is written only after every thread has left
    // the pass that reads it shifted, and its a_row after the barrier that
    // follows the e_row load.
  }
  // Tokens >= t_x repeat the carry (H7) or point nowhere (H8).
  for (int i = live; i < T_x; ++i) {
    const long long out = (static_cast<long long>(i) * B + b) * n;
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      if (HARD) {
        bp[out + p] = 0;
      } else {
        logB[out + p] = prev[p];
      }
    }
  }
}

__global__ void __launch_bounds__(1024) mobo_alpha_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, float* __restrict__ logB,
    int B, int T_x, int n, int D) {
  extern __shared__ float smem[];
  forward_sweep<false>(e, se_x, se_b, se_p, t_x[blockIdx.x], logB, nullptr, B,
                       T_x, n, D, smem);
}

__global__ void __launch_bounds__(1024) mobo_bp_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, const int* __restrict__ t_y,
    int* __restrict__ bp, int* __restrict__ durs, int B, int T_x, int n,
    int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  forward_sweep<true>(e, se_x, se_b, se_p, tx, nullptr, bp, B, T_x, n, D,
                      smem);
  __syncthreads();                       // this block's bp rows are written
  if (threadIdx.x != 0) return;
  int pos = t_y[b];
  for (int i = T_x - 1; i >= 0; --i) {
    pos = pos < 0 ? 0 : (pos > n - 1 ? n - 1 : pos);
    const int d =
        i < tx ? bp[(static_cast<long long>(i) * B + b) * n + pos] : 0;
    durs[static_cast<long long>(b) * T_x + i] = d;
    pos -= d;
  }
}

__global__ void __launch_bounds__(1024) mobo_beta_kernel(
    const float* __restrict__ e, long long se_x, long long se_b,
    long long se_p, const int* __restrict__ t_x, const int* __restrict__ t_y,
    float* __restrict__ beta, int B, int T_x, int n, int D) {
  extern __shared__ float smem[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const int width = n + 2 * D;
  float* e_row = smem + D;              // e_{i+1}, read at p+1..p+D
  float* c_row = smem + width + D;      // e^_{i+1} + beta_{i+1}, the same
  float* nxt = smem + 2 * width;        // beta_{i+1}, each thread its own p
  fill_rows(smem, 2 * width);
  __syncthreads();

  const float* eb = e + b * se_b;
  for (int i = T_x - 1; i >= 0; --i) {
    const long long out = (static_cast<long long>(i) * B + b) * n;
    if (i >= tx) {                       // dead token: NEG from the start
      for (int p = threadIdx.x; p < n; p += blockDim.x) beta[out + p] = NEG;
      continue;
    }
    if (i == tx - 1) {                   // the pinned final boundary
      for (int p = threadIdx.x; p < n; p += blockDim.x) {
        const float v = p == ty ? 0.f : NEG;
        nxt[p] = v;
        beta[out + p] = v;
      }
      continue;
    }
    // The last token of the grid has no successor and reads a NEG row
    // (only an item with t_x > T_x gets here with i == T_x - 1).
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float ev = i + 1 < T_x ? eb[(i + 1) * se_x + p * se_p] : NEG;
      e_row[p] = ev;
      c_row[p] = (ev > DEAD ? ev : NEG) + nxt[p];
    }
    __syncthreads();
    for (int p = threadIdx.x; p < n; p += blockDim.x) {
      const float z = window_lse_fwd(e_row, p, D);
      const float inner = window_lse_fwd(c_row, p, D);
      const float v = z > DEAD ? inner - z : NEG;
      nxt[p] = v;
      beta[out + p] = v;
    }
    __syncthreads();                     // before the rows are overwritten
  }
}

int block_threads(int n) { return n >= 1024 ? 1024 : ((n + 31) / 32) * 32; }

// Two rows of n + 2*D floats and one of n in dynamic shared memory; above
// 48 KB the kernel has to opt in.
template <typename Kernel>
cudaError_t row_smem(Kernel kernel, int n, int D, size_t* smem) {
  *smem = (3 * static_cast<size_t>(n) + 4 * static_cast<size_t>(D)) *
          sizeof(float);
  if (*smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(*smem));
}

}  // namespace

// e: f32 grid read as [T_x, B, T_y1] through element strides se_*; t_x:
// int32 [B]; logB: f32 [T_x, B, T_y1] contiguous; D >= 1. Returns
// cudaGetLastError() after the launch.
extern "C" int mobo_alpha_launch(const float* e, long long se_x,
                                 long long se_b, long long se_p,
                                 const int* t_x, float* logB, int B, int T_x,
                                 int T_y1, int D, void* stream) {
  size_t smem;
  cudaError_t err = row_smem(mobo_alpha_kernel, T_y1, D, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mobo_alpha_kernel<<<B, block_threads(T_y1), smem,
                      static_cast<cudaStream_t>(stream)>>>(
      e, se_x, se_b, se_p, t_x, logB, B, T_x, T_y1, D);
  return static_cast<int>(cudaGetLastError());
}

// e, t_x as above; t_y: int32 [B]; bp: int32 [T_x, B, T_y1] contiguous;
// durs: int32 [B, T_x] contiguous. Returns cudaGetLastError() after the
// launch.
extern "C" int mobo_bp_launch(const float* e, long long se_x, long long se_b,
                              long long se_p, const int* t_x, const int* t_y,
                              int* bp, int* durs, int B, int T_x, int T_y1,
                              int D, void* stream) {
  size_t smem;
  cudaError_t err = row_smem(mobo_bp_kernel, T_y1, D, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mobo_bp_kernel<<<B, block_threads(T_y1), smem,
                   static_cast<cudaStream_t>(stream)>>>(
      e, se_x, se_b, se_p, t_x, t_y, bp, durs, B, T_x, T_y1, D);
  return static_cast<int>(cudaGetLastError());
}

// e, t_x, t_y as above; beta: f32 [T_x, B, T_y1] contiguous. Returns
// cudaGetLastError() after the launch.
extern "C" int mobo_beta_launch(const float* e, long long se_x,
                                long long se_b, long long se_p,
                                const int* t_x, const int* t_y, float* beta,
                                int B, int T_x, int T_y1, int D,
                                void* stream) {
  size_t smem;
  cudaError_t err = row_smem(mobo_beta_kernel, T_y1, D, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  mobo_beta_kernel<<<B, block_threads(T_y1), smem,
                     static_cast<cudaStream_t>(stream)>>>(
      e, se_x, se_b, se_p, t_x, t_y, beta, B, T_x, T_y1, D);
  return static_cast<int>(cudaGetLastError());
}
