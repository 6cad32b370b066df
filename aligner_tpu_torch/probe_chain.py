"""Floor of a sweep's frame step on the card: blocks that do nothing but
the chain of H3 or H6 (`csrc/posterior_sweep.cuh`), of H2
(`csrc/forward_sweep.cuh`, one logaddexp as H3), of H4's forward and
walk (`csrc/skip_dp.cu`), of H1's forward (`csrc/mas.cu`) or of H5's
fetched-ahead forward (`csrc/forward_sweep.cuh` with two arms), one cell
per thread, in nanoseconds per dependent step.

    python -m aligner_tpu_torch.probe_chain

A step reads the x and x+1 neighbours (and x+2 for two arms) of the
message column from shared memory, takes one precise logaddexp (two
nested for two arms, as H6), adds lp, clamps at NEG/2, stores the new
column and passes one block barrier (the columns double-buffered). lp is
a constant, or is loaded from device memory after the barrier, as H2 and
H5 load it: from a lattice that stays in the 50 MB L2 (1024 frames) or
one that streams from device memory (8192 frames).

H4's forward step is max-plus over three arms (stay, advance with its
cost, skip): the neighbours from the shared column, two compares and
selects, an add, a shared store, the two ballots of its moves stored by
one lane a warp into bit planes in shared memory, and one barrier. Its
walk step is one thread's dependent read of a frame's plane words, at a
word chosen by the state the last read gave, a shift, a subtract and the
path's store; the planes in shared memory, or in device memory read from
L2 (`ld.global.cg`).

H1's forward step is max-plus over two arms (stay, advance; the diagonal's
arm a select), one ballot of its decision bits stored by one lane a warp
into a plane in shared memory, and one barrier. H5's step is the one
`csrc/forward_sweep.cuh` runs for it: lp of frame y + 7 fetched by
cp.async into a ring of 8 rows (from a lattice that stays in L2), the
three arms as selects behind two pad cells, two nested logaddexp, the
alpha row's store, the wait for frame y + 1 and one barrier.

H8's token step (`csrc/mobo.cu`) is a window of D compares, max and argmax
with d ascending, over the exchanged row in shared memory, the carry's
update, the next row's store and one barrier (128 blocks of 160 threads,
D = 32, as at phase 7). Its walk's dependent step reads one backpointer of
a cluster of 8 blocks of 129 positions: a byte of the owning block's
shared memory through distributed shared memory, or an int32 from L2.

Builds its own small CUDA source with nvcc into `_build/`, launches 16
blocks (the phase-7 batch) of 128 threads (H2's and H3's column) and of
288 (H4's, H5's and H6's), and prints one JSON line per shape with the
best of five launches by CUDA events, beside the card's name and power
limit. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import math
import sys

SOURCE = r"""
#include <cuda_runtime.h>
#include <math.h>
constexpr float NEG = -1e15f;
__device__ __forceinline__ float logaddexp(float a, float b) {
  const float m = fmaxf(a, b);
  return m + log1pf(expf(-fabsf(a - b)));
}
// `steps` dependent column steps of blockDim.x cells; lp row y % rows of
// a [rows, gridDim.x, blockDim.x] lattice when LOAD, else lv.
template <int ARMS, bool LOAD>
__global__ void chain(const float* __restrict__ lp, int rows, float lv,
                      float* __restrict__ out, int steps) {
  extern __shared__ float cols[];
  const int T = blockDim.x;
  const int c = threadIdx.x;
  cols[c] = 0.f;
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float* in = cols + (y & 1) * T;
    float* cur = cols + ((y + 1) & 1) * T;
    float beta = logaddexp(in[c], c + 1 < T ? in[c + 1] : NEG);
    if (ARMS == 2) beta = logaddexp(beta, c + 2 < T ? in[c + 2] : NEG);
    const float l =
        LOAD ? lp[((long long)(y % rows) * gridDim.x + blockIdx.x) * T + c]
             : lv;
    const float m = l + beta;
    cur[c] = m > 0.5f * NEG ? m : NEG;
    __syncthreads();
  }
  out[blockIdx.x * T + c] = cols[(steps & 1) * T + c];
}
// `steps` dependent max-plus steps of H4 over blockDim.x cells, the moves'
// bit planes stored into `frames` frames of shared memory, cyclically.
__global__ void viterbi_chain(float lv, float* __restrict__ out, int steps,
                              int frames) {
  extern __shared__ uint2 planes[];
  const int T = blockDim.x;
  const int W = T / 32;
  float* prev = reinterpret_cast<float*>(planes + frames * W) + 2;
  float* cur = prev + T + 2;
  const int c = threadIdx.x;
  if (c < 2) {
    prev[c - 2] = -INFINITY;
    cur[c - 2] = -INFINITY;
  }
  prev[c] = 0.f;
  const float cost = (c & 1) ? 0.f : -0.5f;
  const bool skips = (c & 1) && c >= 3;
  int slot = 0;
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float stay = prev[c];
    const float adv = prev[c - 1] + cost;
    const float skip = skips ? prev[c - 2] : -INFINITY;
    const bool take1 = adv > stay;
    const float best1 = take1 ? adv : stay;
    const bool take2 = skip > best1;
    cur[c] = (take2 ? skip : best1) + lv;
    const unsigned a = __ballot_sync(~0u, take1 && !take2);
    const unsigned b = __ballot_sync(~0u, take2);
    if (c % 32 == 0) planes[slot + c / 32] = make_uint2(a, b);
    slot = slot + W == frames * W ? 0 : slot + W;
    float* const t = prev;
    prev = cur;
    cur = t;
    __syncthreads();
  }
  out[blockIdx.x * T + c] = prev[c] + planes[c % (frames * W)].x;
}
// `steps` dependent walk steps of H4 over `frames` frames of planes
// (cyclically), W words a frame: in shared memory (zeroed here), or in
// device memory (gplanes) read from L2.
template <bool GLOBAL>
__global__ void walk_chain(const uint2* __restrict__ gplanes,
                           float* __restrict__ path, int steps, int frames) {
  extern __shared__ uint2 splanes[];
  const int W = blockDim.x / 32;
  const uint2* planes = splanes;
  if (GLOBAL) {
    planes = gplanes + static_cast<long long>(blockIdx.x) * frames * W;
  } else {
    for (int i = threadIdx.x; i < frames * W; i += blockDim.x)
      splanes[i] = make_uint2(0u, 0u);
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  float* p = path + static_cast<long long>(blockIdx.x) * 32 * W * frames;
  int s = 32 * W - 1;
  int y = frames - 1;
  for (int i = 0; i < steps; ++i) {
    p[static_cast<long long>(s) * frames + y] = 1.f;
    const uint2 m = GLOBAL ? __ldcg(planes + y * W + (s >> 5))
                           : planes[y * W + (s >> 5)];
    s -= ((m.x >> (s & 31)) & 1u) + 2 * ((m.y >> (s & 31)) & 1u);
    y = y == 0 ? frames - 1 : y - 1;
  }
}
// `steps` dependent max-plus steps of H1 over blockDim.x cells: the stay
// and advance arms from the shared column (a pad cell of -1e9 left of it),
// the diagonal's arm a select, one ballot of the decision bits stored by
// one lane a warp into a plane of `frames` frames in shared memory
// (cyclically), and one barrier.
__global__ void mas_chain(float lv, float* __restrict__ out, int steps,
                          int frames) {
  extern __shared__ unsigned plane[];
  const int T = blockDim.x;
  const int W = T / 32;
  float* prev = reinterpret_cast<float*>(plane + frames * W) + 1;
  float* cur = prev + T + 1;
  const int c = threadIdx.x;
  if (c == 0) {
    prev[-1] = -1e9f;
    cur[-1] = -1e9f;
  }
  prev[c] = 0.f;
  int slot = 0;
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float p = prev[c];
    const float ps = prev[c - 1];
    const bool diag = c == y;
    cur[c] = fmaxf(diag ? -1e9f : p, ps) + lv;
    const unsigned word = __ballot_sync(~0u, c > 0 && (diag || p < ps));
    if (c % 32 == 0) plane[slot + c / 32] = word;
    slot = slot + W == frames * W ? 0 : slot + W;
    float* const t = prev;
    prev = cur;
    cur = t;
    __syncthreads();
  }
  out[blockIdx.x * T + c] = prev[c] + plane[c % (frames * W)];
}
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// `steps` dependent steps of H5's forward over blockDim.x cells: lp of
// frame y + RING - 1 (a [rows, gridDim.x, blockDim.x] lattice, rows a
// power of 2) fetched by cp.async into a ring of RING rows, each thread its
// own cell; the stay, advance (with its cost on even cells) and skip arms
// as selects from the shared column (two pad cells of NEG), two nested
// logaddexp, the alpha row's store, the wait for frame y + 1 and one
// barrier.
template <int RING>
__global__ void skip_alpha_chain(const float* __restrict__ lp, int rows,
                                 float* __restrict__ alpha, int steps) {
  extern __shared__ float ring[];
  const int T = blockDim.x;
  const int c = threadIdx.x;
  float* prev = ring + RING * T + 2;
  float* cur = prev + T + 2;
  if (c < 2) {
    prev[c - 2] = NEG;
    cur[c - 2] = NEG;
  }
  prev[c] = 0.f;
  const long long stride = static_cast<long long>(gridDim.x) * T;
  const float* src = lp + static_cast<long long>(blockIdx.x) * T + c;
  float* dst = alpha + static_cast<long long>(blockIdx.x) * T + c;
  for (int f = 0; f < RING - 1; ++f) {
    cp_async4(ring + f * T + c, src + (f & (rows - 1)) * stride);
    cp_async_commit();
  }
  const float cost = (c & 1) ? 0.f : -0.5f;
  cp_async_wait<RING - 2>();
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float l = ring[(y & (RING - 1)) * T + c];
    const float adv = prev[c - 1];
    const float p1 = (c & 1) ? adv : (c == 0 ? NEG : adv + cost);
    const float p2 = ((c & 1) && c >= 3) ? prev[c - 2] : NEG;
    const float a = l + logaddexp(logaddexp(prev[c], p1), p2);
    cur[c] = a;
    __stwb(dst + (y & (rows - 1)) * stride, a);
    const int f = y + RING - 1;
    cp_async4(ring + (f & (RING - 1)) * T + c, src + (f & (rows - 1)) * stride);
    cp_async_commit();
    float* const t = prev;
    prev = cur;
    cur = t;
    cp_async_wait<RING - 2>();
    __syncthreads();
  }
}
// `steps` dependent token steps of H8 over blockDim.x cells: a window of D
// compares (max and argmax, d ascending, a later d only if strictly
// greater) over the exchanged row in shared memory, D cells of halo left of
// it, the carry's update, the next row's store and one barrier (the rows
// double-buffered).
__global__ void bp_chain(int* __restrict__ out, int steps, int D) {
  extern __shared__ float xrows[];
  const int T = blockDim.x;
  const int c = threadIdx.x;
  for (int k = c; k < 2 * (T + D); k += T) xrows[k] = NEG;
  __syncthreads();
  float carry = c ? NEG : 0.f;
  xrows[D + c] = carry + 0.5f;
  int acc = 0;
  __syncthreads();
  for (int y = 0; y < steps; ++y) {
    const float* a = xrows + (y & 1) * (T + D) + D;
    float* next = xrows + ((y + 1) & 1) * (T + D) + D;
    float m = a[c - 1];
    int at = 1;
#pragma unroll 8
    for (int d = 2; d <= D; ++d) {
      const float v = a[c - d];
      const bool take = v > m;
      m = take ? v : m;
      at = take ? d : at;
    }
    float v = m - 0.5f;
    if (!(v > 0.5f * NEG)) v = NEG;
    carry = v;
    next[c] = v + 0.5f;
    acc += at;
    __syncthreads();
  }
  out[blockIdx.x * T + c] = acc + static_cast<int>(carry > 0.f);
}
// `steps` dependent steps of H8's walk over a cluster of 8 blocks of w
// positions and `frames` token rows of backpointers (1..3, cyclically): by
// thread 0 of block 0, its position falling by each read value (and
// wrapping), through distributed shared memory from the owning block's
// bytes (DSMEM), or from an int32 [frames, 8 w] array in L2.
__device__ __forceinline__ unsigned cluster_address(const void* local,
                                                    int rank) {
  unsigned remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote)
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(local))),
                 "r"(rank));
  return remote;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\n"
               "barrier.cluster.wait.acquire;\n" ::: "memory");
}
template <bool DSMEM>
__global__ void __cluster_dims__(8, 1, 1)
    walk_bp_chain(const int* __restrict__ gbp, int* __restrict__ out,
                  int steps, int frames, int w) {
  extern __shared__ unsigned char bytes[];
  for (int k = threadIdx.x; k < frames * w; k += blockDim.x)
    bytes[k] = static_cast<unsigned char>(1 + k % 3);
  cluster_sync();
  unsigned rank;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(rank));
  if (rank == 0 && threadIdx.x == 0) {
    const int n = 8 * w;
    int pos = n - 1, r = 7, i = frames - 1;
    for (int s = 0; s < steps; ++s) {
      int d;
      if (DSMEM) {
        while (pos < r * w) --r;
        unsigned v;
        asm volatile("ld.shared::cluster.u8 %0, [%1];\n"
                     : "=r"(v)
                     : "r"(cluster_address(bytes + i * w + pos - r * w, r))
                     : "memory");
        d = static_cast<int>(v);
      } else {
        d = __ldcg(gbp + static_cast<long long>(i) * n + pos);
      }
      pos -= d;
      if (pos < 0) {
        pos += n;
        r = 7;
      }
      i = i == 0 ? frames - 1 : i - 1;
    }
    out[blockIdx.x] = pos;
  }
  cluster_sync();
}
template <class Launch>
float best_of_five(Launch launch) {
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  float best = 1e30f;
  for (int rep = 0; rep < 6; ++rep) {  // the first one warms up
    cudaEventRecord(start);
    launch();
    if (cudaGetLastError() != cudaSuccess) return -1.f;
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms;
    cudaEventElapsedTime(&ms, start, end);
    if (rep > 0) best = ms < best ? ms : best;
  }
  return cudaGetLastError() == cudaSuccess ? best : -1.f;
}
// Best of five launches in ms of H4's forward chain (walk < 0) or of its
// walk from shared memory (walk == 0) or from L2 (walk == 1), or -1 if a
// launch failed.
extern "C" float time_viterbi(int walk, const void* gplanes, float* out,
                              int blocks, int threads, int steps,
                              int frames) {
  const size_t planes = static_cast<size_t>(frames) * threads / 32 * 8;
  if (walk < 0) {
    const size_t smem = planes + 2 * (threads + 2) * sizeof(float);
    cudaFuncSetAttribute(viterbi_chain,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(smem));
    return best_of_five([&] {
      viterbi_chain<<<blocks, threads, smem>>>(-0.5f, out, steps, frames);
    });
  }
  if (walk == 0) {
    cudaFuncSetAttribute(walk_chain<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         static_cast<int>(planes));
    return best_of_five([&] {
      walk_chain<false><<<blocks, threads, planes>>>(nullptr, out, steps,
                                                     frames);
    });
  }
  return best_of_five([&] {
    walk_chain<true><<<blocks, threads, 0>>>(
        static_cast<const uint2*>(gplanes), out, steps, frames);
  });
}
// Best of five launches in ms of H1's bare forward chain, or -1 if a
// launch failed.
extern "C" float time_mas(float* out, int blocks, int threads, int steps,
                          int frames) {
  const size_t smem = static_cast<size_t>(frames) * threads / 32 * 4 +
                      2 * (threads + 1) * sizeof(float);
  cudaFuncSetAttribute(mas_chain, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  return best_of_five([&] {
    mas_chain<<<blocks, threads, smem>>>(-0.5f, out, steps, frames);
  });
}
// Best of five launches in ms of H5's fetched-ahead chain (a ring of 8
// rows), or -1 if a launch failed.
extern "C" float time_skip_alpha(const float* lp, int rows, float* alpha,
                                 int blocks, int threads, int steps) {
  const size_t smem = (8 * threads + 2 * (threads + 2)) * sizeof(float);
  return best_of_five([&] {
    skip_alpha_chain<8><<<blocks, threads, smem>>>(lp, rows, alpha, steps);
  });
}
// Best of five launches in ms of H8's bare token step, or -1 if a launch
// failed.
extern "C" float time_bp(int* out, int blocks, int threads, int steps,
                         int D) {
  const size_t smem = 2 * static_cast<size_t>(threads + D) * sizeof(float);
  return best_of_five([&] {
    bp_chain<<<blocks, threads, smem>>>(out, steps, D);
  });
}
// Best of five launches in ms of H8's walk from distributed shared memory
// (dsmem != 0) or from L2, on `clusters` clusters of 8 blocks, or -1 if a
// launch failed.
extern "C" float time_bp_walk(int dsmem, const int* gbp, int* out,
                              int clusters, int threads, int steps,
                              int frames, int w) {
  const size_t smem = static_cast<size_t>(frames) * w;
  auto kernel = dsmem ? walk_bp_chain<true> : walk_bp_chain<false>;
  cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(smem));
  return best_of_five([&] {
    kernel<<<8 * clusters, threads, smem>>>(gbp, out, steps, frames, w);
  });
}
// Best of five launches in ms, or -1 if a launch failed.
extern "C" float time_chain(int arms, const float* lp, int rows, float lv,
                            float* out, int blocks, int threads,
                            int steps) {
  auto kernel = arms == 1 ? (lp ? &chain<1, true> : &chain<1, false>)
                          : (lp ? &chain<2, true> : &chain<2, false>);
  const size_t smem = 2 * threads * sizeof(float);
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  float best = 1e30f;
  for (int rep = 0; rep < 6; ++rep) {  // the first one warms up
    cudaEventRecord(start);
    kernel<<<blocks, threads, smem>>>(lp, rows, lv, out, steps);
    if (cudaGetLastError() != cudaSuccess) return -1.f;
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms;
    cudaEventElapsedTime(&ms, start, end);
    if (rep > 0) best = ms < best ? ms : best;
  }
  return cudaGetLastError() == cudaSuccess ? best : -1.f;
}
"""

BLOCKS = 16
STEPS = 10240
WIDTHS = (128, 288)        # H2's and H3's, H4's to H6's columns at phase 7
# lp: None (a constant), or the frames of a lattice that stays in L2 or
# streams from device memory.
LOADS = (("none", 0), ("l2", 1024), ("device memory", 8192))


def main() -> int:
    import torch
    from aligner_tpu_torch import _build
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    lib = _build.build_probe("probe_chain", SOURCE)
    lib.time_chain.restype = ctypes.c_float
    lib.time_chain.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                               ctypes.c_float, ctypes.c_void_p,
                               ctypes.c_int, ctypes.c_int, ctypes.c_int]
    torch.cuda.init()
    card = _build.card_label(0)
    for threads in WIDTHS:
        out = torch.empty(BLOCKS * threads, device="cuda")
        for arms in (1, 2):
            # lp = -log(arms + 1) keeps an interior message constant.
            lv = -math.log(arms + 1)
            for load, rows in LOADS:
                lp = (torch.full((rows, BLOCKS, threads), lv, device="cuda")
                      if rows else None)
                ms = lib.time_chain(arms, lp.data_ptr() if rows else None,
                                    max(rows, 1), lv, out.data_ptr(),
                                    BLOCKS, threads, STEPS)
                if ms < 0:
                    print(json.dumps({"error": "chain launch failed"}))
                    return 1
                print(json.dumps({"probe": "chain", "logaddexp": arms,
                                  "lp_load": load, "blocks": BLOCKS,
                                  "threads": threads,
                                  "ns_per_step": ms / STEPS * 1e6,
                                  "device": card}), flush=True)
                del lp
    threads, frames = WIDTHS[1], 1024                # H4 at phase 7
    lib.time_viterbi.restype = ctypes.c_float
    lib.time_viterbi.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int]
    planes = torch.zeros((BLOCKS, frames, threads // 16), dtype=torch.int32,
                         device="cuda")
    out = torch.empty(BLOCKS * threads * frames, device="cuda")
    for walk, step in ((-1, "H4 forward: max-plus, 3 arms, 2 ballots into "
                            "shared planes"),
                       (0, "H4 walk: planes in shared memory"),
                       (1, "H4 walk: planes in device memory, from L2")):
        ms = lib.time_viterbi(walk, planes.data_ptr(), out.data_ptr(),
                              BLOCKS, threads, STEPS, frames)
        if ms < 0:
            print(json.dumps({"error": "viterbi launch failed"}))
            return 1
        print(json.dumps({"probe": "viterbi", "step": step,
                          "blocks": BLOCKS, "threads": threads,
                          "ns_per_step": ms / STEPS * 1e6, "device": card}),
              flush=True)
    lib.time_mas.restype = ctypes.c_float
    lib.time_mas.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                             ctypes.c_int, ctypes.c_int]
    threads = WIDTHS[0]                              # H1 at phase 7
    out = torch.empty(BLOCKS * threads, device="cuda")
    ms = lib.time_mas(out.data_ptr(), BLOCKS, threads, STEPS, frames)
    if ms < 0:
        print(json.dumps({"error": "mas launch failed"}))
        return 1
    print(json.dumps({"probe": "mas", "step": "H1 forward: max-plus, 2 "
                      "arms, 1 ballot into a shared plane", "blocks": BLOCKS,
                      "threads": threads, "ns_per_step": ms / STEPS * 1e6,
                      "device": card}), flush=True)
    lib.time_skip_alpha.restype = ctypes.c_float
    lib.time_skip_alpha.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int]
    threads, rows = WIDTHS[1], 1024                  # H5 at phase 7
    lp = torch.full((rows, BLOCKS, threads), -math.log(3), device="cuda")
    alpha = torch.empty_like(lp)
    ms = lib.time_skip_alpha(lp.data_ptr(), rows, alpha.data_ptr(), BLOCKS,
                             threads, STEPS)
    if ms < 0:
        print(json.dumps({"error": "skip alpha launch failed"}))
        return 1
    print(json.dumps({"probe": "skip_alpha", "step": "H5 forward: lp "
                      "fetched 8 frames ahead from L2, 3 arms by selects, 2 "
                      "logaddexp, alpha stored", "blocks": BLOCKS,
                      "threads": threads, "ns_per_step": ms / STEPS * 1e6,
                      "device": card}), flush=True)
    lib.time_bp.restype = ctypes.c_float
    lib.time_bp.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                            ctypes.c_int, ctypes.c_int]
    threads, D = 160, 32                 # H8's chain threads at phase 7
    out = torch.empty(8 * BLOCKS * threads, dtype=torch.int32, device="cuda")
    ms = lib.time_bp(out.data_ptr(), 8 * BLOCKS, threads, STEPS, D)
    if ms < 0:
        print(json.dumps({"error": "bp launch failed"}))
        return 1
    print(json.dumps({"probe": "bp", "step": f"H8 token: max/argmax over "
                      f"D={D} cells from shared memory, one barrier",
                      "blocks": 8 * BLOCKS, "threads": threads,
                      "ns_per_step": ms / STEPS * 1e6, "device": card}),
          flush=True)
    lib.time_bp_walk.restype = ctypes.c_float
    lib.time_bp_walk.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                 ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, ctypes.c_int]
    frames, w = 128, 129                 # H8's slice at phase 7
    gbp = (torch.arange(frames * 8 * w, device="cuda", dtype=torch.int32)
           % 3 + 1)
    walk_steps = 4096
    for dsmem, how in ((1, "distributed shared memory (ld.shared::cluster)"),
                       (0, "L2 (ld.global.cg)")):
        ms = lib.time_bp_walk(dsmem, gbp.data_ptr(), out.data_ptr(),
                              BLOCKS, threads, walk_steps, frames, w)
        if ms < 0:
            print(json.dumps({"error": "bp walk launch failed"}))
            return 1
        print(json.dumps({"probe": "bp_walk", "step": f"H8 walk: a "
                          f"dependent backpointer read through {how}",
                          "clusters": BLOCKS, "ns_per_step":
                          ms / walk_steps * 1e6, "device": card}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
