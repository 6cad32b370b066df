// The two-pass MAS route on Hopper: variants of the two halves that
// mas.cu fuses (forward decision bits in device memory, then a separate
// walk), kept selectable so that each can be measured against the fused
// kernel. They replace the A/B variants of aligner_tpu/ops/mas_pallas.py:
//
//   mas_walk_stage_kernel   _backtrack_kernel_nat, the staged walk of
//                           mas_pallas_backtrack_nat(form="stage")
//   mas_walk_idx_kernel     _backtrack_kernel_idx, the walk-only half of
//                           mas_pallas_backtrack_nat_split
//   mas_expand_kernel       _expand_kernel, its expand half
//   mas_bits_chains_kernel  _forward_kernel_natv_multi, the K-chain forward
//                           of mas_pallas_bits_nat_multi
//   mas_walk_chains_kernel  _backtrack_kernel_nat_cmp_multi, the K-chain
//                           walk of mas_pallas_backtrack_nat_multi
//
// Contract, shared with mas.cu: bits are uint8 [B, T_y, T_x], contiguous,
//   bit[x,y] = (x > 0) & ((x == y) | (cum[x,y-1] < cum[x-1,y-1]))
// on the band the walk can reach and 0 elsewhere; the walk is
//   index = t_x-1; for y = t_y-1..0: path[index,y] = 1; index -= bit[index,y]
// Items outside 1 <= t_x <= t_y, or with a length beyond the lattice, get
// an all-zero path; frames y >= t_y emit nothing. Paths are f32 and written
// through element strides, so the natural [B, T_x, T_y] and the frame-major
// [B, T_y, T_x] layouts are the same launch. The forward keeps mas.cu's
// arithmetic, `fmaxf` then one rounded add, and the file is built without
// --use_fast_math, so bits and paths are identical to the fused kernel's.
//
// What bounds them on this card. Every walk is a chain of t_y dependent
// one-byte loads from the bit lattice (L2 latency each), run by a single
// thread per item: latency, not bytes. What the variants change is how the
// path gets to memory and how many chains a block keeps in flight:
//  - the staged walk and the expand kernel write every cell of the path,
//    zeros included, with all threads and coalesced along frames, into an
//    uninitialised output: the zero-fill pass that the scattered walk needs
//    before it (a second write of the whole path) is gone;
//  - the staged walk overlaps the two: one warp walks a chunk of frames
//    while the other warps store the tile of the chunk walked before it;
//  - the split form moves the walk into a kernel that writes four bytes
//    per frame, and the path into a kernel with no carry at all, which is
//    bounded by the bytes of the path alone;
//  - the K-chain kernels put K items into one block: K columns advance per
//    __syncthreads in the forward, K load chains are in flight per block in
//    the walk (one per warp, so that they do not serialise in one warp).
//    They trade blocks for warps: B / K blocks instead of B.
//
// Measured by chip_smoke.py phase 7 (CUDA events, wrapper and output
// allocation included) on an NVIDIA H100 80GB HBM3, 700.00 W, ragged
// 128x1024; each figure is the range over three runs of the script, at
// B=32 and then at B=256:
//   staged walk               0.174-0.180    0.410-0.417 ms
//   fused kernel's walk alone 0.195-0.202    0.445-0.458 ms (with zero fill)
//   index walk                0.155-0.163    0.163-0.172 ms
//   expand                    0.029-0.036    0.050-0.053 ms
//   forward, 1 chain          0.195-0.196    0.260-0.261 ms
//   forward, 2 chains         0.261-0.265    0.359-0.364 ms
//   forward, 4 chains         0.380-0.387    0.426-0.432 ms
//   walk, 2 chains            0.167-0.174    0.421-0.427 ms
//   walk, 4 chains            0.165-0.172    0.420-0.426 ms
// The expand kernel at B=32 reads the host's launch overhead, not the card
// (one `torch.eq` into a float32 output takes 0.022 ms there), and moves
// 2.6 TB/s at B=256, where that call takes 0.136 ms. So K items per block
// lose in the forward (a barrier over K times the warps, K columns' loads
// from one SM) and gain little in the walk; whole-tile writes save the fill
// and no more; and a walk that also streams the path through the L2 loses
// its bits from it at B=256 (path 134 MB, bits 32 MB, L2 50 MB), which the
// index walk does not.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 128;         // frames per staged tile
constexpr int kStageRows = 4;       // tile rows stored per pass
constexpr int kStageThreads = 32 + kStageRows * kChunk;
constexpr int kIdxWarps = 4;        // items per block of the index walk
constexpr int kExpandThreads = 128;
constexpr int kExpandFrames = 4;    // frames per thread of the expand kernel
constexpr int kExpandRows = 32;     // token rows per block of the expand kernel

// One step of the walk: down a token where the bit is set. Any non-zero
// byte counts as set and row 0 never steps, so bits that did not come from
// the forward kernels cannot take the walk out of the lattice.
__device__ __forceinline__ int step(uint8_t bit, int index) {
  return index - ((bit != 0 && index > 0) ? 1 : 0);
}

__device__ __forceinline__ bool valid_item(int tx, int ty, int T_x, int T_y) {
  return tx >= 1 && tx <= ty && tx <= T_x && ty <= T_y;
}

// Staged walk. One block per item. Frames are taken in chunks of kChunk,
// from the last chunk to the first. In iteration c the first warp walks
// chunk n-1-c (lane 0 follows the bits and records token index + 1 per
// frame in shared memory, 0 for a frame that emits nothing) while the other
// warps store the [T_x, kChunk] tile of the chunk walked in iteration c-1,
// zeros included. Every cell of the item's path is written, so the output
// needs no zero-fill. Stores are coalesced along frames when sp_y == 1.
__global__ void mas_walk_stage_kernel(const uint8_t* __restrict__ bits,
                                      const int* __restrict__ t_x,
                                      const int* __restrict__ t_y,
                                      float* __restrict__ path,
                                      long long sp_b, long long sp_x,
                                      long long sp_y, int T_x, int T_y) {
  __shared__ int hot[2][kChunk];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = valid_item(tx, ty, T_x, T_y);
  const uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;
  float* p = path + b * sp_b;
  const int n = (T_y + kChunk - 1) / kChunk;
  int index = tx - 1;  // carried across chunks by the walking thread

  for (int c = 0; c <= n; ++c) {
    if (threadIdx.x < 32) {
      if (c < n) {
        const int y0 = (n - 1 - c) * kChunk;
        int* out = hot[c & 1];
        for (int j = threadIdx.x; j < kChunk; j += 32) {
          if (!valid || y0 + j >= ty) out[j] = 0;
        }
        if (threadIdx.x == 0 && valid) {
          const int last = min(ty, y0 + kChunk) - 1;
          for (int y = last; y >= y0; --y) {
            out[y - y0] = index + 1;
            index =
                step(bits_b[static_cast<long long>(y) * T_x + index], index);
          }
        }
      }
    } else if (c > 0) {
      const int t = threadIdx.x - 32;
      const int j = t % kChunk;
      const int y = (n - c) * kChunk + j;
      if (y < T_y) {
        const int token = hot[(c - 1) & 1][j];
        for (int x = t / kChunk; x < T_x; x += kStageRows) {
          p[x * sp_x + y * sp_y] = (token == x + 1) ? 1.f : 0.f;
        }
      }
    }
    // The tile walked in this iteration is stored in the next one, and the
    // buffer stored in this one is walked into in the next.
    __syncthreads();
  }
}

// Index walk. One warp per item: lane 0 follows the bits and writes token
// index + 1 for each frame below t_y; all lanes write 0 for the frames
// from t_y on (every frame of an invalid item), so the whole row is
// written.
__global__ void mas_walk_idx_kernel(const uint8_t* __restrict__ bits,
                                    const int* __restrict__ t_x,
                                    const int* __restrict__ t_y,
                                    int* __restrict__ idx, int B, int T_x,
                                    int T_y) {
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x * kIdxWarps + threadIdx.x / 32;
  if (b >= B) return;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = valid_item(tx, ty, T_x, T_y);
  int* out = idx + static_cast<long long>(b) * T_y;
  for (int y = (valid ? ty : 0) + lane; y < T_y; y += 32) out[y] = 0;
  if (lane != 0 || !valid) return;
  const uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;
  int index = tx - 1;
  for (int y = ty - 1; y >= 0; --y) {
    out[y] = index + 1;
    index = step(bits_b[static_cast<long long>(y) * T_x + index], index);
  }
}

// Expand. path[b,x,y] = (x + 1 == idx[b,y]), every cell written, no carry.
// A block covers kExpandThreads * kExpandFrames frames of kExpandRows token
// rows of one item; a thread reads its frames' indices once and keeps them
// in registers while it goes down the rows.
__global__ void mas_expand_kernel(const int* __restrict__ idx,
                                  float* __restrict__ path, long long sp_b,
                                  long long sp_x, long long sp_y, int T_x,
                                  int T_y) {
  const int b = blockIdx.y;
  const int y0 = blockIdx.x * (kExpandThreads * kExpandFrames) + threadIdx.x;
  const int x0 = blockIdx.z * kExpandRows;
  const int x1 = min(x0 + kExpandRows, T_x);
  const int* in = idx + static_cast<long long>(b) * T_y;
  float* p = path + b * sp_b;
  int token[kExpandFrames];
#pragma unroll
  for (int k = 0; k < kExpandFrames; ++k) {
    const int y = y0 + k * kExpandThreads;
    token[k] = y < T_y ? in[y] : 0;
  }
  for (int x = x0; x < x1; ++x) {
#pragma unroll
    for (int k = 0; k < kExpandFrames; ++k) {
      const int y = y0 + k * kExpandThreads;
      if (y < T_y) p[x * sp_x + y * sp_y] = (token[k] == x + 1) ? 1.f : 0.f;
    }
  }
}

// K-chain forward. Block j advances the columns of items c * B/K + j,
// c = 0..K-1, one frame per step: blockDim.x / K threads (whole warps) per
// item, striding over its token rows, and one __syncthreads per frame for
// all K columns. The K items differ in length, so the block runs to the
// longest valid one and threads of finished or invalid items only meet the
// barrier. Same arithmetic and the same band mask as mas.cu.
__global__ void mas_bits_chains_kernel(const float* __restrict__ value,
                                       long long sv_b, long long sv_x,
                                       long long sv_y,
                                       const int* __restrict__ t_x,
                                       const int* __restrict__ t_y,
                                       uint8_t* __restrict__ bits, int B,
                                       int T_x, int T_y, int chains,
                                       float max_neg_val) {
  extern __shared__ float cols[];  // per chain, two columns of T_x floats
  const int per = blockDim.x / chains;
  const int c = threadIdx.x / per;
  const int lane = threadIdx.x % per;
  const int stride_b = B / chains;
  const int b = c * stride_b + blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = valid_item(tx, ty, T_x, T_y);
  int steps = 0;
  for (int k = 0; k < chains; ++k) {
    const int bk = k * stride_b + blockIdx.x;
    if (valid_item(t_x[bk], t_y[bk], T_x, T_y)) steps = max(steps, t_y[bk]);
  }

  const float* v = value + b * sv_b;
  uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;
  float* prev = cols + 2 * static_cast<long long>(c) * T_x;
  float* cur = prev + T_x;

  if (valid) {
    for (int x = lane; x < tx; x += per) prev[x] = 0.f;
  }
  __syncthreads();

  for (int y = 0; y < steps; ++y) {
    if (valid && y < ty) {
      const int lo = tx - (ty - y);
      for (int x = lane; x < tx; x += per) {
        const float p = prev[x];
        const float ps = x > 0 ? prev[x - 1] : 0.f;
        const float v_cur = (x == y) ? max_neg_val : p;
        const float v_prev = (x == 0) ? (y == 0 ? 0.f : max_neg_val) : ps;
        cur[x] = fmaxf(v_cur, v_prev) + v[x * sv_x + y * sv_y];
        bits_b[static_cast<long long>(y) * T_x + x] =
            (x > 0) && (x <= y) && (x >= lo) && ((x == y) || (p < ps));
      }
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
}

// K-chain walk. Block j walks items c * B/K + j, c = 0..K-1, lane 0 of
// warp c each: K chains of dependent loads in flight per block. The ones
// are scattered into a zero-filled path, as in mas.cu.
__global__ void mas_walk_chains_kernel(const uint8_t* __restrict__ bits,
                                       const int* __restrict__ t_x,
                                       const int* __restrict__ t_y,
                                       float* __restrict__ path,
                                       long long sp_b, long long sp_x,
                                       long long sp_y, int B, int T_x,
                                       int T_y, int chains) {
  if (threadIdx.x % 32 != 0) return;
  const int b = (threadIdx.x / 32) * (B / chains) + blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  if (!valid_item(tx, ty, T_x, T_y)) return;
  const uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;
  float* p = path + b * sp_b;
  int index = tx - 1;
  for (int y = ty - 1; y >= 0; --y) {
    p[index * sp_x + y * sp_y] = 1.f;
    index = step(bits_b[static_cast<long long>(y) * T_x + index], index);
  }
}

}  // namespace

// Every entry point launches on `stream` and returns cudaGetLastError().
// bits: uint8 [B, T_y, T_x], contiguous; t_x, t_y: int32 [B]; path: f32,
// read as [B, T_x, T_y] through element strides sp_*; B, T_x, T_y >= 1.

// path: uninitialised; every cell is written.
extern "C" int mas_walk_stage_launch(const uint8_t* bits, const int* t_x,
                                     const int* t_y, float* path,
                                     long long sp_b, long long sp_x,
                                     long long sp_y, int B, int T_x, int T_y,
                                     void* stream) {
  mas_walk_stage_kernel<<<B, kStageThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      bits, t_x, t_y, path, sp_b, sp_x, sp_y, T_x, T_y);
  return static_cast<int>(cudaGetLastError());
}

// idx: int32 [B, T_y], uninitialised; every cell is written.
extern "C" int mas_walk_idx_launch(const uint8_t* bits, const int* t_x,
                                   const int* t_y, int* idx, int B, int T_x,
                                   int T_y, void* stream) {
  const int blocks = (B + kIdxWarps - 1) / kIdxWarps;
  mas_walk_idx_kernel<<<blocks, 32 * kIdxWarps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      bits, t_x, t_y, idx, B, T_x, T_y);
  return static_cast<int>(cudaGetLastError());
}

// idx: int32 [B, T_y]; path: uninitialised; every cell is written.
extern "C" int mas_expand_launch(const int* idx, float* path, long long sp_b,
                                 long long sp_x, long long sp_y, int B,
                                 int T_x, int T_y, void* stream) {
  const int frames = kExpandThreads * kExpandFrames;
  const dim3 grid((T_y + frames - 1) / frames, B,
                  (T_x + kExpandRows - 1) / kExpandRows);
  mas_expand_kernel<<<grid, kExpandThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      idx, path, sp_b, sp_x, sp_y, T_x, T_y);
  return static_cast<int>(cudaGetLastError());
}

// value: f32 lattice read as [B, T_x, T_y] through element strides sv_*;
// bits: zero-filled (cells off the band, at x >= t_x or y >= t_y, and of
// invalid items are not written). chains is 1, 2 or 4 and divides B.
extern "C" int mas_bits_chains_launch(const float* value, long long sv_b,
                                      long long sv_x, long long sv_y,
                                      const int* t_x, const int* t_y,
                                      uint8_t* bits, int B, int T_x, int T_y,
                                      int chains, float max_neg_val,
                                      void* stream) {
  if ((chains != 1 && chains != 2 && chains != 4) || B % chains != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int most = (1024 / chains) / 32 * 32;  // whole warps per chain
  const int want = ((T_x + 31) / 32) * 32;
  const int per = want < most ? want : most;
  const size_t smem =
      2 * static_cast<size_t>(chains) * T_x * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        mas_bits_chains_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  mas_bits_chains_kernel<<<B / chains, per * chains, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      value, sv_b, sv_x, sv_y, t_x, t_y, bits, B, T_x, T_y, chains,
      max_neg_val);
  return static_cast<int>(cudaGetLastError());
}

// path: zero-filled. chains is 1, 2 or 4 and divides B.
extern "C" int mas_walk_chains_launch(const uint8_t* bits, const int* t_x,
                                      const int* t_y, float* path,
                                      long long sp_b, long long sp_x,
                                      long long sp_y, int B, int T_x, int T_y,
                                      int chains, void* stream) {
  if ((chains != 1 && chains != 2 && chains != 4) || B % chains != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  mas_walk_chains_kernel<<<B / chains, 32 * chains, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      bits, t_x, t_y, path, sp_b, sp_x, sp_y, B, T_x, T_y, chains);
  return static_cast<int>(cudaGetLastError());
}
