"""Floor of a sweep's frame step on the card: blocks that do nothing but
the chain of H3 or H6 (`csrc/posterior_sweep.cuh`), of H2
(`csrc/forward_sweep.cuh`, one logaddexp as H3) or of H4's forward and
walk (`csrc/skip_dp.cu`), one cell per thread, in nanoseconds per
dependent step.

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
    return 0


if __name__ == "__main__":
    sys.exit(main())
