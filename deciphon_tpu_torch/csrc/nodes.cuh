// Shared by the Hopper kernels (viterbi.cu, forward.cu): limits and the
// node-group loads and stores.  Each thread owns NPT consecutive nodes;
// for NPT a multiple of 4 its group of one plane or table row is NPT / 4
// aligned float4s, coalesced along K across the warp (the *_nodes
// helpers); the *_span helpers take any NPT.
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

// Any NPT (the Viterbi kernel's one-warp plans run NPT = K / 32 nodes a
// lane, 1..12): the widest aligned vector that divides NPT, float4, float2
// or scalar.  A group starts at k0 = lane * NPT of a K-aligned row, so
// float2 groups are 8-byte aligned whenever NPT is even.
template <int NPT>
__device__ __forceinline__ void ldg_span(const float* __restrict__ p,
                                         float (&v)[NPT]) {
  if constexpr (NPT % 4 == 0) {
    ldg_nodes<NPT>(p, v);
  } else if constexpr (NPT % 2 == 0) {
#pragma unroll
    for (int g = 0; g < NPT / 2; ++g) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(p) + g);
      v[2 * g] = x.x;
      v[2 * g + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NPT; ++n) v[n] = __ldg(p + n);
  }
}

template <int NPT>
__device__ __forceinline__ void lds_span(const float* p, float (&v)[NPT]) {
  if constexpr (NPT % 4 == 0) {
    lds_nodes<NPT>(p, v);
  } else if constexpr (NPT % 2 == 0) {
#pragma unroll
    for (int g = 0; g < NPT / 2; ++g) {
      const float2 x = reinterpret_cast<const float2*>(p)[g];
      v[2 * g] = x.x;
      v[2 * g + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int n = 0; n < NPT; ++n) v[n] = p[n];
  }
}

template <int NPT>
__device__ __forceinline__ void sts_span(float* p, const float (&v)[NPT]) {
  if constexpr (NPT % 4 == 0) {
    sts_nodes<NPT>(p, v);
  } else if constexpr (NPT % 2 == 0) {
#pragma unroll
    for (int g = 0; g < NPT / 2; ++g)
      reinterpret_cast<float2*>(p)[g] = make_float2(v[2 * g], v[2 * g + 1]);
  } else {
#pragma unroll
    for (int n = 0; n < NPT; ++n) p[n] = v[n];
  }
}

// the launch's argument checks, shared by both entry points
inline bool bad_shape(int B, int K, int ntab) {
  return K <= 0 || K % 32 != 0 || K > MAX_K || B > 65535 || ntab <= 0;
}

}  // namespace dcp
