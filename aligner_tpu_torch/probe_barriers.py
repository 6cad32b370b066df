"""Cost of one barrier on the card: a cluster barrier (`cluster.sync()`,
what a token step of H7 or H9 would pay with one barrier over the
cluster per token) against a block barrier (`__syncthreads()`, what they
pay now), at the shapes the MoBo sweeps launch.

    python -m aligner_tpu_torch.probe_barriers

Builds its own small CUDA source with nvcc into `_build/` (nothing of the
package's library), launches 128 blocks that do nothing but pass 12800
barriers, and prints one JSON line per shape with the best of five
launches by CUDA events, in nanoseconds per barrier, beside the card's
name and power limit. Exits 1 without a CUDA device.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

SOURCE = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;
__global__ void cluster_barriers(int n) {
  for (int i = 0; i < n; ++i) cg::this_cluster().sync();
}
__global__ void block_barriers(int n) {
  for (int i = 0; i < n; ++i) __syncthreads();
}
// Best of five launches in ms, or -1 if a launch failed.
extern "C" float time_barriers(int cluster, int blocks, int C, int threads,
                               int n) {
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(blocks);
  config.blockDim = dim3(threads);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  cudaEvent_t start, end;
  cudaEventCreate(&start);
  cudaEventCreate(&end);
  float best = 1e30f;
  for (int rep = 0; rep < 5; ++rep) {
    cudaEventRecord(start);
    cudaError_t err = cluster
        ? cudaLaunchKernelEx(&config, cluster_barriers, n)
        : cudaLaunchKernelEx(&config, block_barriers, n);
    if (err != cudaSuccess) return -1.f;
    cudaEventRecord(end);
    cudaEventSynchronize(end);
    float ms;
    cudaEventElapsedTime(&ms, start, end);
    best = ms < best ? ms : best;
  }
  return cudaGetLastError() == cudaSuccess ? best : -1.f;
}
"""

BARRIERS = 12800
# (barrier, blocks, blocks per cluster, threads): H7/H9 at B=16 (C=8, w=129:
# 160 chain threads, 640 with the z prologue's groups), at B=64 (C=2,
# w=513: 544 threads) and one block per item.
SHAPES = (("cluster", 128, 8, 160), ("cluster", 128, 8, 640),
          ("cluster", 128, 2, 544), ("cluster", 128, 1, 640),
          ("block", 128, 1, 160), ("block", 128, 1, 640))


def main() -> int:
    import torch
    from aligner_tpu_torch import _build
    if not torch.cuda.is_available():
        print(json.dumps({"error": "no CUDA device"}))
        return 1
    os.makedirs(_build._BUILD_DIR, exist_ok=True)
    src = os.path.join(_build._BUILD_DIR, "probe_barriers.cu")
    lib_path = os.path.join(_build._BUILD_DIR, "probe_barriers.so")
    with open(src, "w") as f:
        f.write(SOURCE)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:4], "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(lib_path)
    lib.time_barriers.restype = ctypes.c_float
    lib.time_barriers.argtypes = [ctypes.c_int] * 5
    torch.cuda.init()
    card = _build.card_label(0)
    for barrier, blocks, C, threads in SHAPES:
        ms = lib.time_barriers(barrier == "cluster", blocks, C, threads,
                               BARRIERS)
        if ms < 0:
            print(json.dumps({"error": f"{barrier} barrier launch failed"}))
            return 1
        print(json.dumps({"barrier": barrier, "blocks": blocks,
                          "blocks_per_cluster": C, "threads": threads,
                          "ns_per_barrier": ms / BARRIERS * 1e6,
                          "device": card}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
