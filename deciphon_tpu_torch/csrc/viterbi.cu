// Batched codon-frame Viterbi for Hopper, sm_90a.
//
// Replaces the Pallas TPU kernel deciphon_tpu/ops/viterbi_pallas.py
// `_kernel` (:178) under semiring="max", on base-4 or taller (IUPAC, base
// 4+D) fragment tables: for every (read, profile) pair it computes the alt
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
// Every add takes the operands, in the order, that the plain version
// (ops/viterbi_cuda.scores_plain) gives it, and every join is an fmaxf,
// which is exact: kernel and plain version agree bit for bit.  The table
// height `ntab` is a runtime argument, so the extended tables take the
// same code: only the row indices in eidx (sentinel = ntab - 1) differ.
// The forward algorithm has a kernel of its own (forward.cu).
//
// Work per (node, position): 35 f32 instructions, the recurrence's 34
// (chip_smoke.py MAX_OPS) and the join that merges a thread's prefix with
// the scan of the threads before it.  Per position and warp, on top: the
// eidx loads, the insert/null scalars, the N/J/C/R specials, the warp
// scan, the VE butterfly and the k -> k+1 shuffle of the core out-flow.
//
// Bytes per (node, position) through the SM's L1/shared-memory datapath
// (128 B a clock): the first design moved ~100 B -- 5 row
// gathers (20 B), 5 slots of both lookback rings from shared memory
// (40 B), 8 transition planes re-read from L1 every position (32 B) and
// the ring stores (8 B).  This one moves 20 B where the rings are in
// registers and 68 B where they are not, and keeps the next position's
// loads in flight:
//   - the 8 planes are per-thread constants for the whole read, loaded
//     into registers once, before the position loop;
//   - each thread owns its nodes' ring slots (no other thread reads
//     them), so the position loop is unrolled by 5: every slot index is
//     then a compile-time constant and the rings can be 2 x 5 x NPT
//     registers (template REG), with the early exit at i == L inside the
//     unrolled body;
//   - position i+1's row gathers and insert/null scalars are issued right
//     after position i's in-flow (before its scan exchanges), and the
//     eidx row of position i+2 with them, so the dependent chain eidx ->
//     rows -> in-flow of the first design (a TPU DMA double-buffer,
//     viterbi_pallas.py:216-219) is off every position's critical path;
//   - the specials run one lookback a lane: lane l < 5 holds N, J, C, E
//     and R of position i - l - 1 and gathers that fragment's null score,
//     three xor shuffles join the five, and each position shifts the
//     values one lane up (5 registers a thread instead of a 25-register
//     ring, and one lookback's arithmetic a lane instead of five);
//   - narrow profiles (K = 32 NPT, NPT 1..12) run one warp per (read,
//     profile), every lane holding nodes, rings in registers up to NPT 8
//     and in shared memory above (10 NPT more registers would not fit):
//     the D-chain scan and the VE reduce are warp shuffles and the kernel
//     has no barrier; a CTA holds `reads` such warps of one profile, so
//     one-warp reads no longer meet the 32-CTAs-per-SM cap at 32 warps;
//   - wider profiles run one CTA of `warps` warps per (read, profile) with
//     two barriers per position (scan totals, then the VE reduce with the
//     core out-flow across warp edges).  Their rings stay in shared
//     memory: in registers they would leave room for fewer CTAs an SM
//     (PERF.md); the 4-node CTA kernels are held to 128 registers
//     (DCP_VIT_CTA_MINB) for the same reason (ops/tune_npt.py).
// What bounds it now: latency, not bytes.  One-warp plans reach 11-25% of
// the recurrence's arithmetic bound at 8-22 warps an SM; CTA plans 8-12%,
// waiting on their two barriers a position with 1-4 CTAs an SM.
// The launch shape of every padded width comes from
// ops/viterbi_cuda.viterbi_plan, which the entry point checks against the
// instantiations below.
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

// reads per CTA of the one-warp kernels, at most
constexpr int MAX_READS = 8;

// Every (NPT, W, REG) instantiation: NPT consecutive nodes a lane; W == 1
// a one-warp kernel (K == 32 NPT, `reads` warps a CTA, one read each),
// else a CTA of up to W warps per read; REG: rings in registers.
// ops/viterbi_cuda.VITERBI_KERNELS mirrors this list.
#define DCP_VITERBI_KERNELS(X)                                     \
  X(1, 1, true) X(2, 1, true) X(3, 1, true) X(4, 1, true)          \
  X(5, 1, true) X(6, 1, true) X(7, 1, true) X(8, 1, true)          \
  X(9, 1, false) X(10, 1, false) X(11, 1, false) X(12, 1, false)   \
  X(4, 8, false) X(8, 8, false) X(8, 16, false)

// Settings a build may change (ops/tune_npt.py compares them):
//   DCP_VIT_WARP_MINB   CTAs of MAX_READS warps an SM must hold, which
//                       sets the one-warp kernels' register budget (1: up
//                       to 255 a thread);
//   DCP_VIT_CTA_MINB    the same for the CTA kernels of 4 nodes a lane
//                       and up to 8 warps (2: at most 128 a thread; left
//                       to itself ptxas takes 188-225, and 3 CTAs of 5
//                       warps no longer fit an SM).
#ifndef DCP_VIT_WARP_MINB
#define DCP_VIT_WARP_MINB 1
#endif
#ifndef DCP_VIT_CTA_MINB
#define DCP_VIT_CTA_MINB 2
#endif

// fm    [B, ntab, K]  match fragment tables
// fin   [B, 2, ntab]  insert (row 0) and null (row 1) fragment tables
// trans [B, NPLANES, K]
// eidx  [S, Lp, 5]    end-fragment indices, eidx[s, i-1, l-1] = seq[i-l:i]
// sp    [S, 3]        per-read NN (= CC = JJ), NB (= CT = JB), RR
// alt, nul [S, B]
template <int NPT, int W, bool REG>
__global__ void __launch_bounds__(W == 1 ? 32 * MAX_READS : 32 * W,
                                  W == 1                 ? DCP_VIT_WARP_MINB
                                  : NPT == 4 && W == 8   ? DCP_VIT_CTA_MINB
                                                         : 1)
viterbi_kernel(const float* __restrict__ fm, const float* __restrict__ fin,
               const float* __restrict__ trans, const int* __restrict__ eidx,
               const int* __restrict__ seq_len, const float* __restrict__ sp,
               float t_EJ, float t_EC, float* __restrict__ alt,
               float* __restrict__ nul, int S, int B, int K, int ntab, int Lp,
               int reads) {
  constexpr bool ONE_WARP = W == 1;
  extern __shared__ float4 smem4[];
  __shared__ float warp_tot[W];
  __shared__ float warp_max[W];
  __shared__ float warp_core[W];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s = ONE_WARP ? blockIdx.x * reads + warp : blockIdx.x;
  if (ONE_WARP && s >= S) return;  // spare warps of the last CTA
  const int b = blockIdx.y;
  const int t = ONE_WARP ? lane : threadIdx.x;  // thread of this read
  const int nwarps = ONE_WARP ? 1 : blockDim.x >> 5;
  const int k0 = t * NPT;
  // a one-warp kernel runs K == 32 NPT (checked at launch)
  const bool active = ONE_WARP || k0 < K;
  const float NINF = -__int_as_float(0x7f800000);

  const float* tr = trans + (size_t)b * NPLANES * K + k0;
  const float* fm_b = fm + (size_t)b * ntab * K + k0;
  const float* fi_b = fin + (size_t)b * 2 * ntab;
  const float* fn_b = fi_b + ntab;
  const int* ei = eidx + (size_t)s * Lp * 5;
  // a read longer than its index rows is never captured (stays NEG)
  const int L = seq_len[s] <= Lp ? seq_len[s] : 0;
  const float NN = sp[3 * s], NB = sp[3 * s + 1], RR = sp[3 * s + 2];

  // the transition planes, in registers for the whole read
  float entry[NPT], mm[NPT], im[NPT], dm[NPT], mi[NPT], ii[NPT], ab[NPT],
      cdd[NPT];
  // rings: slot p % 5 holds position p; in registers, or this read's
  // [5][K] core and insert in-flow in shared memory
  float rcs[REG ? 5 : 1][NPT], ric[REG ? 5 : 1][NPT];
  float* ring_cs = reinterpret_cast<float*>(smem4) +
                   (ONE_WARP ? warp * 10 * K : 0) + k0;
  float* ring_ic = ring_cs + 5 * K;
  if (active) {
    ldg_span<NPT>(tr + P_ENTRY * K, entry);
    ldg_span<NPT>(tr + P_MM_OUT * K, mm);
    ldg_span<NPT>(tr + P_IM_OUT * K, im);
    ldg_span<NPT>(tr + P_DM_OUT * K, dm);
    ldg_span<NPT>(tr + P_MI * K, mi);
    ldg_span<NPT>(tr + P_II * K, ii);
    ldg_span<NPT>(tr + P_ABASE * K, ab);
    ldg_span<NPT>(tr + P_CDD * K, cdd);
    float e0[NPT], negs[NPT];
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      negs[n] = NEG;
      e0[n] = NB + entry[n];  // position 0: S -> B -> entry
    }
    if constexpr (REG) {
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        rcs[0][n] = e0[n];
        ric[0][n] = NEG;
#pragma unroll
        for (int slot = 1; slot < 5; ++slot) rcs[slot][n] = ric[slot][n] = NEG;
      }
    } else {
      sts_span<NPT>(ring_cs, e0);
      sts_span<NPT>(ring_ic, negs);
#pragma unroll
      for (int slot = 1; slot < 5; ++slot) {
        sts_span<NPT>(ring_cs + slot * K, negs);
        sts_span<NPT>(ring_ic + slot * K, negs);
      }
    }
  }
  // specials across lanes: while position i is computed, lane l < 5 of
  // every warp holds N, J, C, E and R of position i - l - 1 (its
  // lookback), and gathers the null score of that fragment; each
  // position shifts them one lane up and puts its own in lane 0 (VB
  // enters the DP only through the core ring, so it needs no slot here)
  const int lb = lane < 5 ? lane : 4;  // this lane's lookback - 1
  float sN = NEG, sJ = NEG, sC = NEG, sE = NEG, sR = NEG;

  // in flight: the rows and insert scalars of the position about to be
  // computed (and this lane's null scalar), and the eidx row of the one
  // after it (and this lane's index in it)
  float nrow[5][NPT], nemi[5], nemn = NEG;
  int nidx[5], nlb = 0;
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    nemi[l] = NEG;
    nidx[l] = 0;
  }
  if (L >= 1) {
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int idx = __ldg(ei + l);
      nemi[l] = __ldg(fi_b + idx);
      if (active) ldg_span<NPT>(fm_b + (size_t)idx * K, nrow[l]);
    }
    nemn = __ldg(fn_b + __ldg(ei + lb));
  }
  if (L >= 2) {
#pragma unroll
    for (int l = 0; l < 5; ++l) nidx[l] = __ldg(ei + 5 + l);
    nlb = __ldg(ei + 5 + lb);
  }

  float out_alt = NEG, out_null = NEG;
  for (int i0 = 1; i0 <= L; i0 += 5) {
    // positions i0 .. i0 + 4; i0 % 5 == 1, so position i0 + j sits in
    // ring slot (j + 1) % 5 and every slot below is a constant
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const int i = i0 + j;
      if (i <= L) {  // the same for every thread of the read
        const int cur = (j + 1) % 5;

        // match and insert in-flow over the 5 fragment lengths
        float accM[NPT], accI[NPT];
        if (active) {
#pragma unroll
          for (int l = 0; l < 5; ++l) {
            const int slot = (j - l + 5) % 5;  // position i - (l + 1)
            float rc[NPT], ri[NPT];
            if constexpr (REG) {
#pragma unroll
              for (int n = 0; n < NPT; ++n) {
                rc[n] = rcs[slot][n];
                ri[n] = ric[slot][n];
              }
            } else {
              lds_span<NPT>(ring_cs + slot * K, rc);
              lds_span<NPT>(ring_ic + slot * K, ri);
            }
#pragma unroll
            for (int n = 0; n < NPT; ++n) {
              const float cm = rc[n] + nrow[l][n];
              const float ci = ri[n] + nemi[l];
              accM[n] = l == 0 ? cm : fmaxf(accM[n], cm);
              accI[n] = l == 0 ? ci : fmaxf(accI[n], ci);
            }
          }
        }

        // N / J / C loops and the null R loop, one lookback a lane; S
        // only at position 0.  The joins over lanes 0-7 (5-7 hold the
        // identity) leave the maxima in lane 0, and every lane needs N
        // and J (for VB); C and R enter only the capture, in thread 0.
        float accN, accJ, accC, accR;
        {
          const float start = (lane + 1 == i) ? 0.f : NEG;
          const float en = nemn;
          accN = fmaxf(sN, start) + NN + en;
          accJ = fmaxf(sE + t_EJ, sJ) + NN + en;
          accC = fmaxf(sE + t_EC, sC) + NN + en;
          accR = fmaxf(sR + RR, start) + en;
          if (lane >= 5) accN = accJ = accC = accR = NINF;
#pragma unroll
          for (int o = 4; o > 0; o >>= 1) {
            accN = fmaxf(accN, __shfl_xor_sync(FULL, accN, o));
            accJ = fmaxf(accJ, __shfl_xor_sync(FULL, accJ, o));
            accC = fmaxf(accC, __shfl_xor_sync(FULL, accC, o));
            accR = fmaxf(accR, __shfl_xor_sync(FULL, accR, o));
          }
          accN = __shfl_sync(FULL, accN, 0);
          accJ = __shfl_sync(FULL, accJ, 0);
        }

        // position i+1's gathers, and position i+2's eidx row, in flight
        // through the exchanges below
        if (i < L) {
#pragma unroll
          for (int l = 0; l < 5; ++l) {
            nemi[l] = __ldg(fi_b + nidx[l]);
            if (active) ldg_span<NPT>(fm_b + (size_t)nidx[l] * K, nrow[l]);
          }
          nemn = __ldg(fn_b + nlb);
          if (i + 1 < L) {
#pragma unroll
            for (int l = 0; l < 5; ++l) nidx[l] = __ldg(ei + (i + 1) * 5 + l);
            nlb = __ldg(ei + (i + 1) * 5 + lb);
          }
        }

        // D-chain prefix scan: thread-local prefix, then the thread totals
        float pre[NPT];
        float tot = NINF;
        if (active) {
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
        if constexpr (!ONE_WARP) {
          if (lane == 31) warp_tot[warp] = x;
          __syncthreads();
          // all W loads issue at once; the joins keep the warps before
#pragma unroll
          for (int w = 0; w < W; ++w) {
            const float v = warp_tot[w];
            if (w < warp) excl = fmaxf(excl, v);
          }
        }

        float VD[NPT], core[NPT];
        float m = NINF;
        if (active) {
#pragma unroll
          for (int n = 0; n < NPT; ++n) {
            const float bsh = n == 0 ? excl : fmaxf(excl, pre[n - 1]);
            VD[n] = fmaxf(cdd[n] + bsh, NEG);  // numeric clamp
            m = fmaxf(m, fmaxf(accM[n], VD[n]));
            core[n] = fmaxf(accM[n] + mm[n],
                            fmaxf(accI[n] + im[n], VD[n] + dm[n]));
          }
        }
        // butterfly: both lanes of a pair join the same two values, and
        // fmaxf is symmetric, so every lane ends with the same bits
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        const float last = active ? core[NPT - 1] : NEG;
        float prev = __shfl_up_sync(FULL, last, 1);  // core[k0 - 1]
        float VE = m;
        if constexpr (ONE_WARP) {
          if (lane == 0) prev = NEG;
        } else {
          if (lane == 0) warp_max[warp] = m;
          if (lane == 31) warp_core[warp] = last;
          __syncthreads();
          VE = warp_max[0];
#pragma unroll
          for (int w = 1; w < W; ++w) {
            const float v = warp_max[w];
            if (w < nwarps) VE = fmaxf(VE, v);
          }
          if (lane == 0) prev = warp > 0 ? warp_core[warp - 1] : NEG;
        }

        const float VB = fmaxf(accN + NB, fmaxf(VE + t_EJ + NB, accJ + NB));
        const float VT = fmaxf(VE + t_EC + NB, accC + NB);
        if (i == L) {
          out_alt = VT;
          out_null = accR;
        }

        // write position i into ring slot i % 5 (this thread's nodes only)
        if (active) {
          float cs[NPT], ic[NPT];
#pragma unroll
          for (int n = 0; n < NPT; ++n) {
            const float csh = n == 0 ? prev : core[n - 1];
            cs[n] = fmaxf(csh, VB + entry[n]);
            ic[n] = fmaxf(accM[n] + mi[n], accI[n] + ii[n]);
          }
          if constexpr (REG) {
#pragma unroll
            for (int n = 0; n < NPT; ++n) {
              rcs[cur][n] = cs[n];
              ric[cur][n] = ic[n];
            }
          } else {
            sts_span<NPT>(ring_cs + cur * K, cs);
            sts_span<NPT>(ring_ic + cur * K, ic);
          }
        }
        // position i becomes every lane's next lookback: shift up one
        // lane, lane 0 takes it
        sN = __shfl_up_sync(FULL, sN, 1);
        sJ = __shfl_up_sync(FULL, sJ, 1);
        sC = __shfl_up_sync(FULL, sC, 1);
        sE = __shfl_up_sync(FULL, sE, 1);
        sR = __shfl_up_sync(FULL, sR, 1);
        if (lane == 0) {
          sN = accN;
          sJ = accJ;
          sC = accC;
          sE = VE;
          sR = accR;
        }
      }
    }
  }
  if (t == 0) {
    alt[(size_t)s * B + b] = out_alt;
    nul[(size_t)s * B + b] = out_null;
  }
}

struct Args {
  const float *fm, *fin, *trans;
  const int *eidx, *seq_len;
  const float* sp;
  float t_EJ, t_EC;
  float *alt, *nul;
  int S, B, K, ntab, Lp;
};

// One launch of plan (warps per read, reads per CTA, shared bytes) on the
// (NPT, W, REG) instantiation; a plan that does not fit it is refused.
template <int NPT, int W, bool REG>
cudaError_t launch(const Args& a, int warps, int reads, int smem,
                   cudaStream_t stream) {
  const bool fits =
      W == 1 ? (a.K == 32 * NPT && warps == 1 && reads >= 1 &&
                reads <= MAX_READS)
             : (reads == 1 && warps >= 1 && warps <= W &&
                (warps - 1) * 32 * NPT < a.K && a.K <= warps * 32 * NPT);
  const int ring_bytes = REG ? 0 : reads * 10 * a.K * (int)sizeof(float);
  if (!fits || smem != ring_bytes) return cudaErrorInvalidValue;
  if (smem > 0) {
    cudaError_t err = cudaFuncSetAttribute(
        viterbi_kernel<NPT, W, REG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid(W == 1 ? (a.S + reads - 1) / reads : a.S, a.B);
  viterbi_kernel<NPT, W, REG><<<grid, 32 * warps * reads, smem, stream>>>(
      a.fm, a.fin, a.trans, a.eidx, a.seq_len, a.sp, a.t_EJ, a.t_EC, a.alt,
      a.nul, a.S, a.B, a.K, a.ntab, a.Lp, reads);
  return cudaGetLastError();
}

}  // namespace

// The plan (npt, kernel_warps, reg_ring, warps, reads, smem) is
// ops/viterbi_cuda.viterbi_plan's for this K; it names the instantiation
// (npt, kernel_warps, reg_ring) and its launch shape.
extern "C" int dcp_viterbi_max(const float* fm, const float* fin,
                               const float* trans, const int* eidx,
                               const int* seq_len, const float* sp,
                               float t_EJ, float t_EC, float* alt, float* nul,
                               int S, int B, int K, int ntab, int Lp, int npt,
                               int kernel_warps, int reg_ring, int warps,
                               int reads, int smem, void* stream) {
  if (S <= 0 || B <= 0) return (int)cudaSuccess;
  if (bad_shape(B, K, ntab)) return (int)cudaErrorInvalidValue;
  const Args a{fm, fin, trans, eidx, seq_len, sp, t_EJ, t_EC, alt, nul,
               S, B, K, ntab, Lp};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DCP_LAUNCH(n, w, r)                                            \
  if (npt == n && kernel_warps == w && (reg_ring != 0) == r)           \
    return (int)launch<n, w, r>(a, warps, reads, smem, st);
  DCP_VITERBI_KERNELS(DCP_LAUNCH)
#undef DCP_LAUNCH
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* dcp_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
