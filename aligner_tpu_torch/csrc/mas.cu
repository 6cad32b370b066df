// Monotonic Alignment Search on Hopper: forward max-plus sweep that emits
// one decision bit per cell, then a walk over the bits to a path or to
// per-token durations. One kernel for what the TPU package splits into
// eight Pallas routes by layout, VMEM budget and fusion
// (aligner_tpu/ops/mas_pallas.py):
//   _fused_kernel_nat_tiled (mas_pallas_nat_fused_tiled), _fused_kernel_nat
//   (mas_pallas_fused_nat), _fused_kernel (mas_pallas_fused_tm),
//   _forward_kernel (mas_pallas_bits), _backtrack_kernel
//   (mas_pallas_backtrack), _forward_kernel_natv (mas_pallas_bits_nat),
//   _backtrack_kernel_nat_cmp (mas_pallas_backtrack_nat, form="cmp") and
//   _backtrack_kernel_durs (mas_pallas_durations).
//
// Recurrence (bit-identical to aligner_tpu/ops/mas_reference.py):
//   cum[x,y] = max(v_cur, v_prev) + value[x,y]
//   v_cur    = cum[x,y-1], or max_neg_val when x == y
//   v_prev   = cum[x-1,y-1]; at x == 0: 0 when y == 0, else max_neg_val
//   bit[x,y] = (x > 0) & ((x == y) | (cum[x,y-1] < cum[x-1,y-1]))
//   walk:      index = t_x-1; for y = t_y-1..0: path[index,y] = 1;
//              index -= bit[index,y]
// The cumulative column starts at 0. Cells outside the reachable band
// (x > y, or x < t_x - (t_y - y)) are computed but never read by the walk
// and no in-band cell depends on them; their bits are stored as 0, so the
// bit lattice is a defined result when it is returned on its own. Cells at
// x >= t_x or y >= t_y are not computed at all (nothing in range depends on
// them). Bit-identity rests on `fmaxf` then one rounded f32 add: the file
// is built without --use_fast_math and has no multiply to contract.
//
// What bounds it on this card: each item is a chain of t_y dependent
// column steps (a shared-memory exchange with the x-1 neighbour and one
// __syncthreads each), followed by a single-thread walk of t_y dependent
// loads from the bit scratch. Both are latency chains, not bandwidth: the
// value lattice is read once and the bit scratch (uint8 [B,T_y,T_x], 4 MB
// at B=32, 128x1024) stays in the 50 MB L2. The design keeps the chain
// short per step (two shared loads, a max, an add, a compare) and runs
// items in parallel, one block each. Under-filling the 132 SMs at small B,
// bit-packing, bits in shared memory and a parallel walk are left for
// later work. Timed apart on an NVIDIA H100 80GB HBM3, 700.00 W, at B=32,
// 128x1024 ragged (chip_smoke.py phase 7, the range over three runs), the
// sweep alone takes 0.195-0.196 ms and the walk alone 0.195-0.202 ms (its
// 16.8 MB zero fill included) of the fused 0.355-0.362 ms.
//
// The kernel also runs as either half alone, for the two-pass route
// (mas_pallas_bits_nat + mas_pallas_backtrack_nat, form="cmp"): with no
// `path` and no `durations` it stops after the forward sweep and leaves the
// bits (the caller zero-fills them, so that cells it does not compute are
// 0); with no `value` it skips the sweep and walks bits it is given.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One step of the walk: down a token where the bit is set. Any non-zero
// byte counts as set and row 0 never steps, so bits handed to the walk
// alone cannot take it out of the lattice.
__device__ __forceinline__ int step(uint8_t bit, int index) {
  return index - ((bit != 0 && index > 0) ? 1 : 0);
}

__global__ void mas_kernel(const float* __restrict__ value,
                           long long sv_b, long long sv_x, long long sv_y,
                           const int* __restrict__ t_x,
                           const int* __restrict__ t_y,
                           uint8_t* __restrict__ bits,
                           float* __restrict__ path,
                           long long sp_b, long long sp_x, long long sp_y,
                           int* __restrict__ durations,
                           int T_x, int T_y, float max_neg_val) {
  extern __shared__ float cols[];  // two cumulative columns of T_x floats
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  // Items outside 1 <= t_x <= t_y keep the zero-filled output.
  if (tx < 1 || tx > ty || tx > T_x || ty > T_y) return;

  uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;

  if (value != nullptr) {
    const float* v = value + b * sv_b;
    float* prev = cols;
    float* cur = cols + T_x;

    for (int x = threadIdx.x; x < tx; x += blockDim.x) prev[x] = 0.f;
    __syncthreads();

    for (int y = 0; y < ty; ++y) {
      const int lo = tx - (ty - y);  // lowest row the walk can reach at y
      for (int x = threadIdx.x; x < tx; x += blockDim.x) {
        const float p = prev[x];
        const float ps = x > 0 ? prev[x - 1] : 0.f;
        const float v_cur = (x == y) ? max_neg_val : p;
        const float v_prev = (x == 0) ? (y == 0 ? 0.f : max_neg_val) : ps;
        cur[x] = fmaxf(v_cur, v_prev) + v[x * sv_x + y * sv_y];
        bits_b[static_cast<long long>(y) * T_x + x] =
            (x > 0) && (x <= y) && (x >= lo) && ((x == y) || (p < ps));
      }
      // One barrier per column: the next step reads `cur` as `prev` and
      // overwrites the old `prev`, whose reads all happened before this.
      __syncthreads();
      float* t = prev;
      prev = cur;
      cur = t;
    }
  }

  if (threadIdx.x != 0 || (path == nullptr && durations == nullptr)) return;
  int index = tx - 1;
  if (path != nullptr) {
    float* p = path + b * sp_b;
    for (int y = ty - 1; y >= 0; --y) {
      p[index * sp_x + y * sp_y] = 1.f;
      index = step(bits_b[static_cast<long long>(y) * T_x + index], index);
    }
  } else {
    int* d = durations + static_cast<long long>(b) * T_x;
    for (int y = ty - 1; y >= 0; --y) {
      d[index] += 1;
      index = step(bits_b[static_cast<long long>(y) * T_x + index], index);
    }
  }
}

}  // namespace

// value: f32 lattice read as [B, T_x, T_y] through element strides
// sv_*; t_x, t_y: int32 [B]; bits: uint8 [B, T_y, T_x], contiguous. At most
// one of `path` (f32, zero-filled, written through strides sp_*) and
// `durations` (int32 [B, T_x], zero-filled) is non-null. With both null
// the launch is the forward sweep alone and `bits` (zero-filled) is its
// result; with `value` null it is the walk alone over the `bits` given.
// Returns cudaGetLastError() after the launch.
extern "C" int mas_launch(const float* value, long long sv_b, long long sv_x,
                          long long sv_y, const int* t_x, const int* t_y,
                          uint8_t* bits, float* path, long long sp_b,
                          long long sp_x, long long sp_y, int* durations,
                          int B, int T_x, int T_y, float max_neg_val,
                          void* stream) {
  // The walk alone needs one thread per item and no columns.
  const bool sweep = value != nullptr;
  const int threads =
      !sweep ? 32 : (T_x >= 1024 ? 1024 : ((T_x + 31) / 32) * 32);
  const size_t smem = sweep ? 2 * static_cast<size_t>(T_x) * sizeof(float) : 0;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mas_kernel<<<B, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      value, sv_b, sv_x, sv_y, t_x, t_y, bits, path, sp_b, sp_x, sp_y,
      durations, T_x, T_y, max_neg_val);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* aligner_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
