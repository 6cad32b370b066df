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
//  - the K-chain walk puts K items into one block: K load chains in
//    flight per block (one per warp, so that they do not serialise in one
//    warp), B / K blocks instead of B;
//  - the K-chain forward runs K of H1's forward chains a block
//    (csrc/mas_forward.cuh), each over its own item behind its own named
//    barrier, so that no chain waits for a longer item; its bits go into a
//    ballot plane of its own, and every byte is written from the plane, so
//    the output needs no zero fill. K chains share one SM's schedulers and
//    load/store unit, so a chain runs as H1 does with K items to an SM.
//
// Times: PERF.md (chip_smoke.py phase 7, NVIDIA H100 80GB HBM3). The
// expand kernel at B=32 reads the host's launch overhead, not the card;
// whole-tile writes save the fill and no more; and a walk that also
// streams the path through the L2 loses its bits from it at B=256 (path
// 134 MB, bits 32 MB, L2 50 MB), which the index walk does not.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mas_forward.cuh"

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

// K-chain forward. Block j sweeps items c * B/K + j, c = 0..K-1: chain c
// is a group of `per` threads (whole warps) that runs H1's forward
// (csrc/mas_forward.cuh) over its own item behind its own named barrier
// 1 + c, to its own t_y, its decision bits in a ballot plane of its own
// (in shared memory where K planes fit, else in the device-memory scratch
// [B, item_words]); then it writes every byte of its item's [T_y, T_x]
// from the plane (write_bits), 0 off the band and on an invalid item.
template <int CELLS, int RING, bool SHARED_PLANES, bool TILES>
__global__ void __launch_bounds__(1024) mas_bits_chains_kernel(
    const float* __restrict__ value, long long sv_b, long long sv_x,
    long long sv_y, const int* __restrict__ t_x, const int* __restrict__ t_y,
    uint8_t* __restrict__ bits, unsigned* __restrict__ scratch, int B,
    int T_x, int T_y, int chains, float max_neg_val) {
  extern __shared__ unsigned smem_words[];
  const int per = blockDim.x / chains;
  const int c = threadIdx.x / per;
  const int b = c * (B / chains) + blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = valid_item(tx, ty, T_x, T_y);
  const int P = per * CELLS;
  const int W = P / 32;
  unsigned* const own = smem_words + c * (forward_smem(
                                              P, RING,
                                              SHARED_PLANES ? T_y : 0) /
                                          sizeof(unsigned));
  unsigned* const planes =
      SHARED_PLANES ? own : scratch + b * item_words(T_y, W);
  float* const ring = reinterpret_cast<float*>(
      own + (SHARED_PLANES ? static_cast<size_t>(T_y) * W : 0));
  const ChainGroup chain{1 + c, static_cast<unsigned>(c * per),
                         static_cast<unsigned>(per)};
  if (valid)
    mas_forward<CELLS, RING, TILES>(value + b * sv_b, sv_x, sv_y, tx, ty,
                                    planes, ring, ring + RING * (P + 4),
                                    max_neg_val, chain);
  chain.sync();
  write_bits<SHARED_PLANES>(planes, W, tx, valid ? ty : 0, ty,
                            bits + static_cast<long long>(b) * T_y * T_x,
                            T_x, T_y, chain);
}

// The K-chain forward over columns wider than a chain's plans: chain c's
// threads stride its item's column, two unpadded columns of T_x floats in
// shared memory, values loaded after the chain's barrier, each byte stored
// as it is decided; then the frames the sweep did not reach are written 0.
__global__ void __launch_bounds__(1024) mas_bits_chains_wide_kernel(
    const float* __restrict__ value, long long sv_b, long long sv_x,
    long long sv_y, const int* __restrict__ t_x, const int* __restrict__ t_y,
    uint8_t* __restrict__ bits, int B, int T_x, int T_y, int chains,
    float max_neg_val) {
  extern __shared__ float cols[];
  const int per = blockDim.x / chains;
  const int c = threadIdx.x / per;
  const int tid = threadIdx.x - c * per;
  const int b = c * (B / chains) + blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = valid_item(tx, ty, T_x, T_y);
  const ChainGroup chain{1 + c, static_cast<unsigned>(c * per),
                         static_cast<unsigned>(per)};
  const float* v = value + b * sv_b;
  uint8_t* bits_b = bits + static_cast<long long>(b) * T_y * T_x;
  float* prev = cols + 2 * static_cast<long long>(c) * T_x;
  float* cur = prev + T_x;
  if (valid) {
    for (int x = tid; x < tx; x += per) prev[x] = 0.f;
    chain.sync();
    for (int y = 0; y < ty; ++y) {
      const int lo = tx - (ty - y);
      for (int x = tid; x < T_x; x += per) {
        uint8_t bit = 0;
        if (x < tx) {
          const float p = prev[x];
          const float ps = x > 0 ? prev[x - 1] : 0.f;
          const float v_cur = (x == y) ? max_neg_val : p;
          const float v_prev = (x == 0) ? (y == 0 ? 0.f : max_neg_val) : ps;
          cur[x] = fmaxf(v_cur, v_prev) + v[x * sv_x + y * sv_y];
          bit = (x > 0) && (x <= y) && (x >= lo) && ((x == y) || (p < ps));
        }
        bits_b[static_cast<long long>(y) * T_x + x] = bit;
      }
      chain.sync();
      float* t = prev;
      prev = cur;
      cur = t;
    }
  }
  for (long long g = static_cast<long long>(valid ? ty : 0) * T_x + tid;
       g < static_cast<long long>(T_y) * T_x; g += per)
    bits_b[g] = 0;
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
// bits: uninitialised, every byte is written; scratch: int32 [B, T_y *
// threads * cells / 32 + (T_y + 1) / 2], the planes when they do not live
// in shared memory (else unused). chains is 1, 2 or 4 and divides B;
// threads (a chain's), cells, ring, shared_planes and fetch (0 rows, 1
// tiles, 2 the wide kernel) are the wrapper's plan (ops/mas_kernel.py:
// _chains_plan). Returns cudaErrorInvalidValue for a plan that was not
// built or does not cover the column.
extern "C" int mas_bits_chains_launch(
    const float* value, long long sv_b, long long sv_x, long long sv_y,
    const int* t_x, const int* t_y, uint8_t* bits, void* scratch, int B,
    int T_x, int T_y, int chains, int threads, int cells, int ring,
    int shared_planes, int fetch, float max_neg_val, void* stream) {
  if ((chains != 1 && chains != 2 && chains != 4) || B % chains != 0 ||
      threads % 32 != 0 || threads * chains > 1024 ||
      static_cast<long long>(threads) * cells < T_x)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B / chains);
  const dim3 block(threads * chains);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto launch = [&](auto kernel, size_t smem, auto... args) {
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return err;
    }
    kernel<<<grid, block, smem, s>>>(args...);
    return cudaGetLastError();
  };
  if (fetch == FETCH_WIDE)
    return static_cast<int>(launch(
        mas_bits_chains_wide_kernel,
        2 * static_cast<size_t>(chains) * T_x * sizeof(float), value, sv_b,
        sv_x, sv_y, t_x, t_y, bits, B, T_x, T_y, chains, max_neg_val));
  return static_cast<int>(with_mas_plan(
      cells, ring, shared_planes != 0, fetch == FETCH_TILES, [&](auto plan) {
        using P = decltype(plan);
        return launch(
            mas_bits_chains_kernel<P::cells, P::ring, P::shared, P::tiles>,
            chains * forward_smem(threads * cells, P::ring,
                                  P::shared ? T_y : 0),
            value, sv_b, sv_x, sv_y, t_x, t_y, bits,
            static_cast<unsigned*>(scratch), B, T_x, T_y, chains,
            max_neg_val);
      }));
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
