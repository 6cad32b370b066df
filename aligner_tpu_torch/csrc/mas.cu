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
// and no in-band cell depends on them; the bytes returned on their own
// are 0 there. Cells at x >= t_x or frames y >= t_y feed nothing in range.
// Bit-identity rests on `fmaxf` then one rounded f32 add: the file is
// built without --use_fast_math and has no multiply to contract.
//
// What bounds it on this card: each item is a chain of t_y dependent
// column steps (a shared-memory exchange with the x-1 neighbour and one
// __syncthreads each), then a single-thread walk of t_y dependent steps:
// latency, not bytes. The design keeps on each chain only what the next
// step needs (the layout of H4, csrc/skip_dp.cu, with one plane where H4
// has two):
// * Decision bits as a ballot plane. Each warp turns its cells' bits into
//   one 32-bit word a frame with __ballot_sync and one lane stores it:
//   T_x / 32 words a frame, 16 KB at 128x1024, in shared memory where it
//   fits beside the ring and the columns, else in a device-memory scratch
//   [B, T_y * words + the frames' tokens], 8x smaller than a byte a cell.
//   The bits never reach device memory on the fused path.
// * A walk that reads words ahead. index falls by at most one a frame, so
//   four frames' bits lie in the word of index or the one below; both are
//   read before the four steps. Token 0 never steps (bit 0 of word 0 is
//   clear in every plane), so bits handed to the walk alone cannot take it
//   out of the lattice.
// * The path written whole. The walk leaves each frame's token in shared
//   memory (int16; -1 for a frame that emits nothing); after one barrier
//   every thread writes the item's [T_x, T_y] tile, zeros included, four
//   floats a store along whichever axis has stride 1. The output needs no
//   zero fill. Durations: the walk writes each token's run once and the
//   other threads write 0 past t_x.
// * The forward sweep of csrc/mas_forward.cuh, which H13 shares: values
//   fetched ahead by cp.async into a ring in shared memory, in rows where
//   the tokens are contiguous and in tiles of 8 frames x 4 tokens where
//   the frames are (serving's natural [B, T_x, T_y] lattice); a frame step
//   of one basic block; only y < t_y on the chain.
// The wrapper's plan (ops/mas_kernel.py: _mas_plan, from the shape and
// strides, before the launch) gives threads, cells, ring, fetch and where
// the plane lives. A column wider than the widest plan (8192 tokens) takes
// mas_wide_kernel: threads stride the column, two unpadded columns in
// shared memory, values loaded after the barrier, the plane in device
// memory, the same walk and stores.
//
// The kernel also runs as either half alone, for the two-pass route
// (mas_pallas_bits_nat + mas_pallas_backtrack_nat, form="cmp"): with
// `bits` given and no `path` or `durations`, the sweep writes every byte
// of uint8 [B, T_y, T_x] from the plane (0 off the band), sixteen bytes a
// store along x where T_x allows it (write_bits in csrc/mas_forward.cuh);
// with no `value`, it first loads the given bytes into the
// plane (a ballot of byte != 0 a warp) and walks from there.
#include <cuda_runtime.h>
#include <stdint.h>

#include "mas_forward.cuh"
#include "posterior_sweep.cuh"

namespace {

// Shared memory of H1 whose threads hold `pitch` cells: the forward's (the
// plane of `plane_frames` frames, 0 when it lives in device memory, the
// ring and the columns), and the walk's token a frame (int16) when the
// plane is shared.
inline size_t mas_smem(int pitch, int ring, int plane_frames) {
  return forward_smem(pitch, ring, plane_frames) +
         static_cast<size_t>(plane_frames) * sizeof(short);
}

// The walk of one valid item, by one thread: visit(y, index, step) for
// y = ty-1..0, step being the bit that takes index to frame y - 1 (0 at
// frame 0). Returns the last index.
template <bool SHARED, class Visit>
__device__ int walk(const unsigned* planes, int W, int tx, int ty,
                    Visit visit) {
  int index = tx - 1;
  int y = ty - 1;
  // Four frames a round: their bits lie in word index / 32 or the one
  // below, both read before the four steps.
  for (; y >= 4; y -= 4) {
    const int w = index >> 5;
    unsigned hi[4], lo[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned* row = planes + static_cast<long long>(y - j) * W;
      hi[j] = load<SHARED>(row + w);
      lo[j] = load<SHARED>(row + (w > 0 ? w - 1 : 0));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const unsigned word = (index >> 5) == w ? hi[j] : lo[j];
      const int step = (word >> (index & 31)) & 1u;
      visit(y - j, index, step);
      index -= step;
    }
  }
  for (; y > 0; --y) {
    const unsigned word =
        load<SHARED>(planes + static_cast<long long>(y) * W + (index >> 5));
    const int step = (word >> (index & 31)) & 1u;
    visit(y, index, step);
    index -= step;
  }
  visit(0, index, 0);
  return index;
}

// Every cell of the item's path, zeros included: path(x, y) =
// (token[y] == x), through strides sp_*, four floats a store along the
// axis of stride 1 where the tile allows it.
template <bool SHARED>
__device__ void write_path(float* p, long long sp_x, long long sp_y,
                           int T_x, int T_y, const short* token) {
  const bool y_inner = sp_y == 1;
  const int inner = y_inner ? T_y : T_x;
  const int outer = y_inner ? T_x : T_y;
  const long long so = y_inner ? sp_x : sp_y;
  const long long si = y_inner ? sp_y : sp_x;
  if (si == 1 && inner % 4 == 0 && so % 4 == 0 &&
      (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
    const int groups = inner / 4;
    for (int g = threadIdx.x; g < outer * groups; g += blockDim.x) {
      const int o = g / groups;
      const int i = 4 * (g - o * groups);
      float e[4];
      if (y_inner) {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          e[j] = load<SHARED>(token + i + j) == o ? 1.f : 0.f;
      } else {
        const int t = load<SHARED>(token + o);
#pragma unroll
        for (int j = 0; j < 4; ++j) e[j] = i + j == t ? 1.f : 0.f;
      }
      *reinterpret_cast<float4*>(p + o * so + i) =
          make_float4(e[0], e[1], e[2], e[3]);
    }
  } else {
    for (int g = threadIdx.x; g < outer * inner; g += blockDim.x) {
      const int o = g / inner;
      const int i = g - o * inner;
      const int x = y_inner ? o : i;
      const int y = y_inner ? i : o;
      p[x * sp_x + y * sp_y] = load<SHARED>(token + y) == x ? 1.f : 0.f;
    }
  }
}

// Bits 0..7 of b to bits 0, 4, ..., 28.
__device__ __forceinline__ unsigned spread4(unsigned b) {
  b = (b | (b << 12)) & 0x000F000Fu;
  b = (b | (b << 6)) & 0x03030303u;
  return (b | (b << 3)) & 0x11111111u;
}

// The walk alone: the given bytes of frames [0, ty) into the plane, bit
// x = (byte x != 0) for 0 < x < tx, every other bit of the words the walk
// can read clear. Where T_x is a multiple of 4 (and the bytes 4-byte
// aligned), each lane reads four bytes
// and a warp a 128-token chunk of a frame, U chunks in flight before their
// ballots: ballot k holds byte k of every lane, and word j of the chunk
// interleaves bits 8j..8j+7 of the four ballots. Else one ballot of one
// byte a lane per word.
template <bool SHARED>
__device__ void load_planes(const uint8_t* bits, unsigned* planes, int W,
                            int tx, int ty, int T_x) {
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int warps = blockDim.x / 32;
  const int words = (tx + 31) / 32;  // the words the walk can read
  auto keep = [&](int w) {           // the bits of word w inside (0, tx)
    const int hi = tx - 32 * w;
    const unsigned below = hi >= 32 ? ~0u : (1u << hi) - 1u;
    return w == 0 ? below & ~1u : below;
  };
  if (T_x % 4 == 0 && (reinterpret_cast<uintptr_t>(bits) & 3) == 0) {
    constexpr int U = 8;
    const int chunks = (tx + 127) / 128;
    const int n = ty * chunks;
    for (int i0 = warp * U; i0 < n; i0 += warps * U) {
      unsigned v[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        const int y = i / chunks;
        const int c = i - y * chunks;
        v[u] = i < n && 128 * c + 4 * lane < T_x
                   ? reinterpret_cast<const unsigned*>(
                         bits + static_cast<long long>(y) * T_x)[32 * c + lane]
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int i = i0 + u;
        if (i >= n) break;  // the same for every lane of the warp
        const int y = i / chunks;
        const int c = i - y * chunks;
        unsigned ballot[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          ballot[k] = __ballot_sync(~0u, (v[u] >> (8 * k)) & 0xFFu);
        const int j = lane;  // lanes 0..3 store word 4c + j
        const int w = 4 * c + j;
        if (j < 4 && w < words) {
          unsigned word = 0;
#pragma unroll
          for (int k = 0; k < 4; ++k)
            word |= spread4((ballot[k] >> (8 * j)) & 0xFFu) << k;
          planes[static_cast<long long>(y) * W + w] = word & keep(w);
        }
      }
    }
    return;
  }
  for (int i = warp; i < ty * words; i += warps) {
    const int y = i / words;
    const int w = i - y * words;
    const int x = 32 * w + lane;
    const bool set = x < tx && bits[static_cast<long long>(y) * T_x + x] != 0;
    const unsigned word = __ballot_sync(~0u, set);
    if (lane == 0) planes[static_cast<long long>(y) * W + w] = word & keep(w);
  }
}

// Everything after the plane of frames [0, ty) is complete and shown to
// every thread by a barrier: the bytes, the walk, the path or durations.
// Pointers are the item's own; a null output is not written.
template <bool SHARED>
__device__ void finish(const unsigned* planes, int W, short* token,
                       bool valid, int tx, int ty, uint8_t* bits,
                       float* path, long long sp_x, long long sp_y,
                       int* durations, int T_x, int T_y) {
  const int top = valid ? ty : 0;  // the frames that emit
  if (bits != nullptr)
    write_bits<SHARED>(planes, W, tx, top, ty, bits, T_x, T_y,
                       BlockGroup{});
  if (durations != nullptr) {
    for (int x = (valid ? tx : 0) + threadIdx.x; x < T_x; x += blockDim.x)
      durations[x] = 0;
    if (valid && threadIdx.x == 0) {
      int run = 0;
      const int last = walk<SHARED>(planes, W, tx, ty,
                                    [&](int, int index, int step) {
                                      ++run;
                                      if (step) {
                                        durations[index] = run;
                                        run = 0;
                                      }
                                    });
      durations[last] = run;
    }
  }
  if (path != nullptr) {
    for (int y = top + threadIdx.x; y < T_y; y += blockDim.x) token[y] = -1;
    if (valid && threadIdx.x == 0)
      walk<SHARED>(planes, W, tx, ty, [&](int y, int index, int) {
        token[y] = static_cast<short>(index);
      });
    __syncthreads();
    write_path<SHARED>(path, sp_x, sp_y, T_x, T_y, token);
  }
}

template <int CELLS, int RING, bool SHARED_PLANES, bool TILES>
__global__ void __launch_bounds__(1024) mas_kernel(
    const float* __restrict__ value, long long sv_b, long long sv_x,
    long long sv_y, const int* __restrict__ t_x, const int* __restrict__ t_y,
    uint8_t* __restrict__ bits, float* __restrict__ path, long long sp_b,
    long long sp_x, long long sp_y, int* __restrict__ durations,
    unsigned* __restrict__ scratch, int T_x, int T_y, float max_neg_val) {
  extern __shared__ unsigned smem_words[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = tx >= 1 && tx <= ty && tx <= T_x && ty <= T_y;

  const int P = blockDim.x * CELLS;  // the pitch of a column
  const int W = P / 32;              // plane words a frame
  // Frame y's bit at cell c: bit c % 32 of planes[y * W + c / 32].
  unsigned* const planes =
      SHARED_PLANES ? smem_words : scratch + b * item_words(T_y, W);
  float* const ring = reinterpret_cast<float*>(
      smem_words + (SHARED_PLANES ? static_cast<size_t>(T_y) * W : 0));
  float* const cols = ring + RING * (P + 4);
  short* const token = SHARED_PLANES
                           ? reinterpret_cast<short*>(cols + 2 * (P + 1))
                           : reinterpret_cast<short*>(
                                 planes + static_cast<long long>(T_y) * W);
  const long long item = static_cast<long long>(b) * T_y * T_x;

  if (value != nullptr && valid) {
    mas_forward<CELLS, RING, TILES>(value + b * sv_b, sv_x, sv_y, tx, ty,
                                    planes, ring, cols, max_neg_val,
                                    BlockGroup{});
  } else if (value == nullptr && valid) {
    load_planes<SHARED_PLANES>(bits + item, planes, W, tx, ty, T_x);
  }
  __syncthreads();
  finish<SHARED_PLANES>(planes, W, token, valid, tx, ty,
                        value != nullptr && bits != nullptr ? bits + item
                                                            : nullptr,
                        path != nullptr ? path + b * sp_b : nullptr, sp_x,
                        sp_y,
                        durations != nullptr
                            ? durations + static_cast<long long>(b) * T_x
                            : nullptr,
                        T_x, T_y);
}

// Columns wider than the widest plan: threads stride the column (`cells`
// a thread), two unpadded columns of T_x floats in shared memory, values
// loaded after the barrier, the plane in device memory.
__global__ void __launch_bounds__(1024) mas_wide_kernel(
    const float* __restrict__ value, long long sv_b, long long sv_x,
    long long sv_y, const int* __restrict__ t_x, const int* __restrict__ t_y,
    uint8_t* __restrict__ bits, float* __restrict__ path, long long sp_b,
    long long sp_x, long long sp_y, int* __restrict__ durations,
    unsigned* __restrict__ scratch, int T_x, int T_y, float max_neg_val,
    int cells) {
  extern __shared__ float cols[];
  const int b = blockIdx.x;
  const int tx = t_x[b];
  const int ty = t_y[b];
  const bool valid = tx >= 1 && tx <= ty && tx <= T_x && ty <= T_y;
  const int W = blockDim.x * cells / 32;
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x % 32;
  unsigned* const planes = scratch + b * item_words(T_y, W);
  short* const token =
      reinterpret_cast<short*>(planes + static_cast<long long>(T_y) * W);
  const long long item = static_cast<long long>(b) * T_y * T_x;

  if (value != nullptr && valid) {
    const float* v = value + b * sv_b;
    float* prev = cols;
    float* cur = cols + T_x;
    for (int x = threadIdx.x; x < tx; x += blockDim.x) prev[x] = 0.f;
    __syncthreads();
    for (int y = 0; y < ty; ++y) {
      for (int k = 0; k < cells; ++k) {
        const int x = threadIdx.x + k * blockDim.x;
        bool set = false;
        if (x < tx) {
          const float p = prev[x];
          const float ps =
              x > 0 ? prev[x - 1] : (y == 0 ? 0.f : max_neg_val);
          cur[x] = fmaxf(x == y ? max_neg_val : p, ps) + v[x * sv_x + y * sv_y];
          set = x > 0 && (x == y || p < ps);
        }
        const unsigned word = __ballot_sync(~0u, set);
        if (lane == 0)
          planes[static_cast<long long>(y) * W + threadIdx.x / 32 +
                 k * warps] = word;
      }
      __syncthreads();
      float* const t = prev;
      prev = cur;
      cur = t;
    }
  } else if (value == nullptr && valid) {
    load_planes<false>(bits + item, planes, W, tx, ty, T_x);
  }
  __syncthreads();
  finish<false>(planes, W, token, valid, tx, ty,
                value != nullptr && bits != nullptr ? bits + item : nullptr,
                path != nullptr ? path + b * sp_b : nullptr, sp_x, sp_y,
                durations != nullptr
                    ? durations + static_cast<long long>(b) * T_x
                    : nullptr,
                T_x, T_y);
}

}  // namespace

// value: f32 lattice read as [B, T_x, T_y] through element strides sv_*,
// or null for the walk alone; t_x, t_y: int32 [B]; bits: uint8
// [B, T_y, T_x], contiguous: written whole by the sweep when non-null
// (the forward alone), read by the walk alone; path: f32 written whole
// through strides sp_*, or null; durations: int32 [B, T_x] written whole,
// or null (at most one of the two); scratch: int32 [B, T_y * threads *
// cells / 32 + (T_y + 1) / 2], the plane and the walk's tokens when the
// plane does not live in shared memory (else unused); threads, cells,
// ring, shared_planes, fetch (0 rows, 1 tiles, 2 the wide kernel): the
// wrapper's plan. Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a plan that was not built.
extern "C" int mas_launch(const float* value, long long sv_b, long long sv_x,
                          long long sv_y, const int* t_x, const int* t_y,
                          uint8_t* bits, float* path, long long sp_b,
                          long long sp_x, long long sp_y, int* durations,
                          void* scratch, int B, int T_x, int T_y,
                          int threads, int cells, int ring,
                          int shared_planes, int fetch, float max_neg_val,
                          void* stream) {
  unsigned* const words = static_cast<unsigned*>(scratch);
  if (fetch == FETCH_WIDE)
    return static_cast<int>(launch_sweep(
        mas_wide_kernel, B, threads, cells, T_x,
        2 * static_cast<size_t>(T_x) * sizeof(float), stream, value, sv_b,
        sv_x, sv_y, t_x, t_y, bits, path, sp_b, sp_x, sp_y, durations,
        words, T_x, T_y, max_neg_val, cells));
  return static_cast<int>(with_mas_plan(
      cells, ring, shared_planes != 0, fetch == FETCH_TILES, [&](auto plan) {
        using P = decltype(plan);
        return launch_sweep(
            mas_kernel<P::cells, P::ring, P::shared, P::tiles>, B, threads,
            cells, T_x,
            mas_smem(threads * cells, P::ring, P::shared ? T_y : 0), stream,
            value, sv_b, sv_x, sv_y, t_x, t_y, bits, path, sp_b, sp_x, sp_y,
            durations, words, T_x, T_y, max_neg_val);
      }));
}

extern "C" const char* aligner_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
