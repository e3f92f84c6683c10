// Shared by the Hopper kernels (viterbi.cu, forward.cu): limits and the
// float4 node-group loads and stores.  Each thread owns NPT consecutive
// nodes (NPT a multiple of 4), so its group of one plane or table row is
// NPT / 4 aligned float4s, coalesced along K across the warp.
#pragma once

#include <cuda_runtime.h>

namespace dcp {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_K = 4096;
constexpr unsigned FULL = 0xffffffffu;

template <int NPT>
__device__ __forceinline__ void ldg_nodes(const float* __restrict__ p,
                                          float (&v)[NPT]) {
#pragma unroll
  for (int g = 0; g < NPT / 4; ++g) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(p) + g);
    v[4 * g] = x.x;
    v[4 * g + 1] = x.y;
    v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

template <int NPT>
__device__ __forceinline__ void lds_nodes(const float* p, float (&v)[NPT]) {
#pragma unroll
  for (int g = 0; g < NPT / 4; ++g) {
    const float4 x = reinterpret_cast<const float4*>(p)[g];
    v[4 * g] = x.x;
    v[4 * g + 1] = x.y;
    v[4 * g + 2] = x.z;
    v[4 * g + 3] = x.w;
  }
}

template <int NPT>
__device__ __forceinline__ void sts_nodes(float* p, const float (&v)[NPT]) {
#pragma unroll
  for (int g = 0; g < NPT / 4; ++g)
    reinterpret_cast<float4*>(p)[g] =
        make_float4(v[4 * g], v[4 * g + 1], v[4 * g + 2], v[4 * g + 3]);
}

// the launch's argument checks, shared by both entry points
inline bool bad_shape(int B, int K, int ntab) {
  return K <= 0 || K % 32 != 0 || K > MAX_K || B > 65535 || ntab <= 0;
}

}  // namespace dcp
