// Batched codon-frame Viterbi for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel deciphon_tpu/ops/viterbi_pallas.py
// `_kernel` under semiring="max", on base-4 or taller (IUPAC, base 4+D)
// fragment tables: for every (read, profile) pair it computes the alt
// (plan-7 profile) and null (R-loop) Viterbi log-likelihoods, with the
// same recurrence:
//   - a 5-position lookback ring of the core in-flow, B->entry folded in
//     at write time and the position-0 slot seeded with S->B->entry;
//   - the N/J/C/R specials from each read's length (precomputed per read
//     by the wrapper, so kernel and plain version add the same values);
//   - the mute D-chain as a telescoped prefix scan,
//     VD = max(cdd + shift1(scan(VM + a_base)), NEG);
//   - VE as a reduce over the nodes, then VB and VT;
//   - capture of alt = T and null = R at i == seq_len.
// `viterbi_kernel<NPT>` (every join, scan and reduce an fmaxf) is
// exposed as dcp_viterbi_max.  The forward algorithm has a
// kernel of its own, in scaled probability space (forward.cu).  The
// table height `ntab` is a runtime argument, so the extended tables take
// the same code: only the row indices in eidx (sentinel = ntab - 1)
// differ.
//
// What bounds it on the card: per position, each CTA gathers the 5
// lookback rows of its profile's fragment table (5 * K * 4 bytes from L2:
// a profile's table is 1365 * K * 4 bytes, 0.7 MB at K = 128 and 22 MB at
// K = 4096, far too big for shared memory) and crosses two block-wide
// barriers (the D-chain scan and the VE reduce).  The design answers both:
//   - one CTA per (read, profile), reads on blockIdx.x and profiles on
//     blockIdx.y, so the CTAs resident together share one profile's table
//     in the 50 MB L2; row loads are float4 per thread, coalesced along K;
//   - each thread owns NPT consecutive nodes, and keeps its slice of both
//     lookback rings in shared memory: no other thread reads it, so the
//     rings need no barrier, and the scan is a thread-local prefix plus
//     one warp-shuffle scan of thread totals;
//   - the specials are per-read scalars that every thread recomputes in
//     registers, so they need no barrier either;
//   - the only barriers are the two cross-warp exchanges (scan totals,
//     then the VE reduce together with the k -> k+1 shift of the core
//     out-flow across warp edges);
//   - each CTA stops at its own read's length.
//
// NEG (-1e30) is the dead value, never -inf: (-inf) - (-inf) is NaN in
// the a_base/cdd terms.  -inf appears only as the identity of the scan
// and the reduce, where it is only ever joined and added to finite
// values, then clamped back to NEG.

#include "nodes.cuh"

namespace {

using namespace dcp;

// transition planes of the packed [B, NPLANES, K] tensor
enum { P_ENTRY, P_MM_OUT, P_IM_OUT, P_DM_OUT, P_MI, P_II, P_ABASE, P_CDD,
       NPLANES };

// fm    [B, ntab, K]  match fragment tables
// fin   [B, 2, ntab]  insert (row 0) and null (row 1) fragment tables
// trans [B, NPLANES, K]
// eidx  [S, Lp, 5]    end-fragment indices, eidx[s, i-1, l-1] = seq[i-l:i]
// sp    [S, 3]        per-read NN (= CC = JJ), NB (= CT = JB), RR
// alt, nul [S, B]
template <int NPT>
__global__ void __launch_bounds__(MAX_THREADS)
viterbi_kernel(const float* __restrict__ fm, const float* __restrict__ fin,
                   const float* __restrict__ trans,
                   const int* __restrict__ eidx,
                   const int* __restrict__ seq_len,
                   const float* __restrict__ sp, float t_EJ, float t_EC,
                   float* __restrict__ alt, float* __restrict__ nul, int B,
                   int K, int ntab, int Lp) {
  extern __shared__ float4 smem4[];
  float* ring_cs = reinterpret_cast<float*>(smem4);  // [5][K] core in-flow
  float* ring_ic = ring_cs + 5 * K;                   // [5][K] insert in-flow
  __shared__ float warp_tot[MAX_WARPS];
  __shared__ float warp_max[MAX_WARPS];
  __shared__ float warp_core[MAX_WARPS];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = tid * NPT;
  const bool active = k0 < K;
  const float NINF = -__int_as_float(0x7f800000);

  const float* tr = trans + (size_t)b * NPLANES * K + k0;
  const float* fm_b = fm + (size_t)b * ntab * K + k0;
  const float* fi_b = fin + (size_t)b * 2 * ntab;
  const float* fn_b = fi_b + ntab;
  const int* ei = eidx + (size_t)s * Lp * 5;
  // a read longer than its index rows is never captured (stays NEG)
  const int L = seq_len[s] <= Lp ? seq_len[s] : 0;
  const float NN = sp[3 * s], NB = sp[3 * s + 1], RR = sp[3 * s + 2];

  if (active) {
    float entry[NPT], negs[NPT];
    ldg_nodes<NPT>(tr + P_ENTRY * K, entry);
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      negs[n] = NEG;
      entry[n] = NB + entry[n];  // position 0: S -> B -> entry
    }
    sts_nodes<NPT>(ring_cs + k0, entry);
    sts_nodes<NPT>(ring_ic + k0, negs);
    for (int slot = 1; slot < 5; ++slot) {
      sts_nodes<NPT>(ring_cs + slot * K + k0, negs);
      sts_nodes<NPT>(ring_ic + slot * K + k0, negs);
    }
  }
  // specials ring, index l-1 holds position i-l (every thread a copy)
  // (VB enters the DP only through ring_cs, so it needs no ring here)
  float spN[5], spJ[5], spC[5], spE[5], spR[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) spN[l] = spJ[l] = spC[l] = spE[l] = spR[l] = NEG;
  float out_alt = NEG, out_null = NEG;

  for (int i = 1; i <= L; ++i) {
    int idx[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) idx[l] = __ldg(ei + (i - 1) * 5 + l);

    // match and insert in-flow over the 5 fragment lengths
    float accM[NPT], accI[NPT], emn[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int slot = (i - 1 - l + 5) % 5;  // position i - (l + 1)
      const float emi = __ldg(fi_b + idx[l]);
      emn[l] = __ldg(fn_b + idx[l]);
      if (active) {
        float em[NPT], rc[NPT], ri[NPT];
        ldg_nodes<NPT>(fm_b + (size_t)idx[l] * K, em);
        lds_nodes<NPT>(ring_cs + slot * K + k0, rc);
        lds_nodes<NPT>(ring_ic + slot * K + k0, ri);
#pragma unroll
        for (int n = 0; n < NPT; ++n) {
          const float cm = rc[n] + em[n];
          const float ci = ri[n] + emi;
          accM[n] = l == 0 ? cm : fmaxf(accM[n], cm);
          accI[n] = l == 0 ? ci : fmaxf(accI[n], ci);
        }
      }
    }

    // N / J / C loops and the null R loop; S only at position i-l == 0
    float accN = NEG, accJ = NEG, accC = NEG, accR = NEG;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const float start = (l + 1 == i) ? 0.f : NEG;
      const float vn = fmaxf(spN[l], start) + NN + emn[l];
      const float vj = fmaxf(spE[l] + t_EJ, spJ[l]) + NN + emn[l];
      const float vc = fmaxf(spE[l] + t_EC, spC[l]) + NN + emn[l];
      const float vr = fmaxf(spR[l] + RR, start) + emn[l];
      accN = l == 0 ? vn : fmaxf(accN, vn);
      accJ = l == 0 ? vj : fmaxf(accJ, vj);
      accC = l == 0 ? vc : fmaxf(accC, vc);
      accR = l == 0 ? vr : fmaxf(accR, vr);
    }

    // D-chain prefix scan: thread-local prefix, then the thread totals
    float pre[NPT];
    float tot = NINF;
    if (active) {
      float ab[NPT];
      ldg_nodes<NPT>(tr + P_ABASE * K, ab);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float a = accM[n] + ab[n];
        pre[n] = n == 0 ? a : fmaxf(pre[n - 1], a);
      }
      tot = pre[NPT - 1];
    }
    float x = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = fmaxf(x, y);
    }
    float excl = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) excl = NINF;
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();
    for (int w = 0; w < warp; ++w) excl = fmaxf(excl, warp_tot[w]);

    float VD[NPT], core[NPT];
    float m = NINF;
    if (active) {
      float cdd[NPT], mm[NPT], im[NPT], dm[NPT];
      ldg_nodes<NPT>(tr + P_CDD * K, cdd);
      ldg_nodes<NPT>(tr + P_MM_OUT * K, mm);
      ldg_nodes<NPT>(tr + P_IM_OUT * K, im);
      ldg_nodes<NPT>(tr + P_DM_OUT * K, dm);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float bsh = n == 0 ? excl : fmaxf(excl, pre[n - 1]);
        VD[n] = fmaxf(cdd[n] + bsh, NEG);  // numeric clamp, both semirings
        m = fmaxf(m, fmaxf(accM[n], VD[n]));
        core[n] = fmaxf(accM[n] + mm[n],
                           fmaxf(accI[n] + im[n], VD[n] + dm[n]));
      }
    }
#pragma unroll
    // butterfly: both lanes of a pair join the same two values, and
    // join is symmetric, so every lane ends with the same bits
    for (int o = 16; o > 0; o >>= 1)
      m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
    const float last = active ? core[NPT - 1] : NEG;
    float prev = __shfl_up_sync(FULL, last, 1);  // core[k0 - 1]
    if (lane == 0) warp_max[warp] = m;
    if (lane == 31) warp_core[warp] = last;
    __syncthreads();
    float VE = warp_max[0];
    for (int w = 1; w < nwarps; ++w) VE = fmaxf(VE, warp_max[w]);
    if (lane == 0) prev = warp > 0 ? warp_core[warp - 1] : NEG;

    const float VB =
        fmaxf(accN + NB, fmaxf(VE + t_EJ + NB, accJ + NB));
    const float VT = fmaxf(VE + t_EC + NB, accC + NB);
    if (i == L) {
      out_alt = VT;
      out_null = accR;
    }

    // write position i into ring slot i % 5 (this thread's nodes only)
    if (active) {
      const int slot = i % 5;
      float entry[NPT], mi[NPT], ii[NPT], cs[NPT], ic[NPT];
      ldg_nodes<NPT>(tr + P_ENTRY * K, entry);
      ldg_nodes<NPT>(tr + P_MI * K, mi);
      ldg_nodes<NPT>(tr + P_II * K, ii);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float csh = n == 0 ? prev : core[n - 1];
        cs[n] = fmaxf(csh, VB + entry[n]);
        ic[n] = fmaxf(accM[n] + mi[n], accI[n] + ii[n]);
      }
      sts_nodes<NPT>(ring_cs + slot * K + k0, cs);
      sts_nodes<NPT>(ring_ic + slot * K + k0, ic);
    }
#pragma unroll
    for (int l = 4; l > 0; --l) {
      spN[l] = spN[l - 1];
      spJ[l] = spJ[l - 1];
      spC[l] = spC[l - 1];
      spE[l] = spE[l - 1];
      spR[l] = spR[l - 1];
    }
    spN[0] = accN;
    spJ[0] = accJ;
    spC[0] = accC;
    spE[0] = VE;
    spR[0] = accR;
  }
  if (tid == 0) {
    alt[(size_t)s * B + b] = out_alt;
    nul[(size_t)s * B + b] = out_null;
  }
}

template <int NPT>
cudaError_t launch(const float* fm, const float* fin, const float* trans,
                   const int* eidx, const int* seq_len, const float* sp,
                   float t_EJ, float t_EC, float* alt, float* nul, int S,
                   int B, int K, int ntab, int Lp, cudaStream_t stream) {
  const int smem = 2 * 5 * K * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      viterbi_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int threads = ((K / NPT + 31) / 32) * 32;
  viterbi_kernel<NPT><<<dim3(S, B), threads, smem, stream>>>(
      fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt, nul, B, K, ntab,
      Lp);
  return cudaGetLastError();
}

}  // namespace

extern "C" int dcp_viterbi_max(const float* fm, const float* fin,
                               const float* trans, const int* eidx,
                               const int* seq_len, const float* sp,
                               float t_EJ, float t_EC, float* alt, float* nul,
                               int S, int B, int K, int ntab, int Lp,
                               void* stream) {
  if (S <= 0 || B <= 0) return (int)cudaSuccess;
  if (bad_shape(B, K, ntab)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 4 nodes a thread up to K = 2048 (<= 512 threads), 8 above
  if (K <= 2048)
    return (int)launch<4>(fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt,
                          nul, S, B, K, ntab, Lp, st);
  return (int)launch<8>(fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt,
                        nul, S, B, K, ntab, Lp, st);
}

extern "C" const char* dcp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
