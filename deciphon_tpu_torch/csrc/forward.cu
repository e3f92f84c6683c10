// Batched codon-frame forward for Hopper, sm_90a, in scaled probability
// space.
//
// Replaces the Pallas TPU kernel deciphon_tpu/ops/viterbi_pallas.py
// `_kernel` under semiring="logsumexp" (:165-175), on base-4 or taller
// (IUPAC) fragment tables: for every (read, profile) pair the alt and
// null forward log-likelihoods, the recurrence of viterbi.cu with every
// max replaced by a sum.  Instead of joining log values (an expf and a
// log1pf per join, 16 joins per node and position), it holds every value
// as a linear f32 times a power of two, as HMMER3's SIMD Forward does
// (impl_sse/fwdback.c), so the node loops are multiplies and FMAs.
//
// Scales.  A value is x * 2^X with an integer X, and every join of two
// values multiplies the smaller by 2^(difference of exponents), a power
// of two: exact down to the subnormals.  With the largest value near 1,
// f32 reaches down to 2^-149, ~103 nats below it, and one read can hold
// values further apart in one position: after a strong first hit the
// lagging remains of its paths in the high nodes sit that far above a
// fresh start from N in the low nodes, and under multi_hits = false
// only N can start the next hit.  One exponent per position would flush
// that start to 0 and lose every path through a second copy of the
// domain.  So:
//   - each thread's NPT nodes share an exponent per position, and each
//     of its lookback slots keeps the exponent of the position that wrote
//     it (nodeX[l]); a slot's scale is chosen when it is written, from
//     its own largest value;
//   - the specials have four: N, the null R loop, J and C together (both
//     fed from E), and E (the nodes' sum);
//   - values that cross from one scale to another (the D-chain and VE
//     across threads, the core out-flow k -> k+1 across a thread edge,
//     B into the node entries, E into J and C) carry their exponent;
//   - a zero holds the exponent ZERO_X, so it never sets a scale;
//   - at capture, log(x) + X ln 2 with X summed as an integer; a zero (a
//     dead cell) becomes NEG, never -inf or NaN.
// The rest of the arithmetic:
//   - the 5 gathered match-table entries are the log tables of the max
//     kernel, exponentiated on the fly (exp2f of log2(e) * x: 5 MUFU ops
//     per node and position); the insert and null entries are per-CTA
//     scalars.  NEG padding becomes exactly 0.
//   - the transitions come as probability planes (`ptrans`, packed on the
//     host per block: exp of the per-node log transitions, source-
//     indexed), so a dead link is exactly 0 and needs no clamp.
//   - the D-chain D[k+1] = D[k] * dd[k] + M[k] * md[k] is a scan of the
//     affine maps x -> a x + b 2^e, composed (a, b) then (c, d) =
//     (a c, b c + d) at the larger exponent: thread-local over its NPT
//     nodes, warp shuffles of the triple, then the warp totals through
//     the first barrier.
//   - VE reduces in the second barrier's exchange, beside the core
//     out-flow of the warp edges.
// Loads, rings and barriers are those of viterbi.cu; the launch shape is
// this kernel's own.  Each thread owns NPT nodes: 4 for K <= 128, so the
// CTA is one warp and its barriers are cheap; 8 above, where fewer warps
// per CTA beat more CTAs per SM.
// What bounds it on the card: the same dependent chain per position (an
// eidx load, 5 L2 row gathers, two barriers) and, in arithmetic, the
// five exponentials per node-position on the 16-per-clock MUFU pipe and
// the per-position work of the scales.
//
// The build keeps --use_fast_math off: flush-to-zero would drop the
// subnormal tail that the power-of-two joins rely on.

#include "nodes.cuh"

namespace {

using namespace dcp;

constexpr float LOG2E = 1.4426950408889634f;
constexpr double LN2 = 0.6931471805599453;
// the exponent of a zero: below any real one, so it never sets a scale,
// and a zero scaled to another exponent stays exactly 0
constexpr int ZERO_X = -(1 << 28);

// The launch shape, which a build may set to compare others
// (ops/tune_npt.py): the widest K run at 4 nodes a thread (one
// warp up to K = 128), and the CTAs of 512 threads an SM must hold at
// 4 nodes a thread (1: up to 128 registers; 2: at most 64).
#ifndef DCP_FWD_NPT4_MAX_K
#define DCP_FWD_NPT4_MAX_K 128
#endif
#ifndef DCP_FWD_NPT4_MIN_BLOCKS
#define DCP_FWD_NPT4_MIN_BLOCKS 1
#endif

// probability planes of the packed [B, NPLANES, K] ptrans tensor
enum { Q_ENTRY, Q_MM_OUT, Q_IM_OUT, Q_DM_OUT, Q_MI, Q_II, Q_MD_OUT,
       Q_DD_OUT, NPLANES };

// a log-space table entry as a probability (NEG -> 0)
__device__ __forceinline__ float prob(float logp) {
  return exp2f(logp * LOG2E);
}

// 2^d exactly, subnormals included: 0 below 2^-149, and capped at 2^127
// (a scale up is at most 2^126, see rescale; a cap at 2^127 only ever
// scales a zero, a live exponent minus ZERO_X)
__device__ __forceinline__ float pow2(int d) {
  d = min(d, 127);
  if (d >= -126) return __int_as_float((d + 127) << 23);
  return d >= -149 ? __int_as_float(1 << (d + 149)) : 0.f;
}

// the exponent of x held at exponent e: e, or ZERO_X for a zero
__device__ __forceinline__ int live(float x, int e) {
  return x > 0.f ? e : ZERO_X;
}

// x 2^xe + y 2^ye, at exponent e = the larger live one; symmetric, so
// both lanes of a butterfly get the same bits
__device__ __forceinline__ float join(float x, int xe, float y, int ye,
                                      int& e) {
  xe = live(x, xe);
  ye = live(y, ye);
  e = max(xe, ye);
  return x * pow2(xe - e) + y * pow2(ye - e);
}

// the factor that brings m (held at exponent e) into [0.5, 1), with e
// moved to match; a zero gets ZERO_X.  A subnormal m gets 2^126, the
// largest factor pow2 gives exactly, and stays below 0.5.
__device__ __forceinline__ float rescale(float m, int& e) {
  int d;
  frexpf(m, &d);
  d = max(d, -126);
  e = m > 0.f ? e + d : ZERO_X;
  return pow2(-d);
}

// log of x * 2^e, NEG for a zero
__device__ __forceinline__ float log_scaled(float x, int e) {
  return x > 0.f ? (float)((double)logf(x) + (double)e * LN2) : NEG;
}

// fm     [B, ntab, K]  match fragment tables (log)
// fin    [B, 2, ntab]  insert (row 0) and null (row 1) fragment tables (log)
// ptrans [B, NPLANES, K] transition probabilities
// eidx   [S, Lp, 5]    end-fragment indices, eidx[s, i-1, l-1] = seq[i-l:i]
// sp     [S, 3]        per-read log NN (= CC = JJ), NB (= CT = JB), RR
// alt, nul [S, B]
template <int NPT>
__global__ void __launch_bounds__(MAX_THREADS,
                                  NPT == 4 ? DCP_FWD_NPT4_MIN_BLOCKS : 1)
forward_kernel(const float* __restrict__ fm, const float* __restrict__ fin,
               const float* __restrict__ ptrans,
               const int* __restrict__ eidx, const int* __restrict__ seq_len,
               const float* __restrict__ sp, float t_EJ, float t_EC,
               float* __restrict__ alt, float* __restrict__ nul, int B, int K,
               int ntab, int Lp) {
  extern __shared__ float4 smem4[];
  float* ring_cs = reinterpret_cast<float*>(smem4);  // [5][K] core in-flow
  float* ring_ic = ring_cs + 5 * K;                   // [5][K] insert in-flow
  // per warp: its D-chain map (a, b 2^bx), its share of VE (sum 2^sx)
  // and its last node's core out-flow (core 2^cx)
  __shared__ float warp_a[MAX_WARPS], warp_b[MAX_WARPS];
  __shared__ float warp_sum[MAX_WARPS], warp_core[MAX_WARPS];
  __shared__ int warp_bx[MAX_WARPS], warp_sx[MAX_WARPS], warp_cx[MAX_WARPS];

  const int s = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = tid * NPT;
  const bool active = k0 < K;

  const float* tr = ptrans + (size_t)b * NPLANES * K + k0;
  const float* fm_b = fm + (size_t)b * ntab * K + k0;
  const float* fi_b = fin + (size_t)b * 2 * ntab;
  const float* fn_b = fi_b + ntab;
  const int* ei = eidx + (size_t)s * Lp * 5;
  // a read longer than its index rows is never captured (stays NEG)
  const int L = seq_len[s] <= Lp ? seq_len[s] : 0;
  const float NN = expf(sp[3 * s]), NB = expf(sp[3 * s + 1]);
  const float RR = expf(sp[3 * s + 2]);
  const float EJ = expf(t_EJ), EC = expf(t_EC);

  // this thread's node slots: lookback l holds position i-1-l, at
  // exponent nodeX[l]
  int nodeX[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) nodeX[l] = ZERO_X;
  if (active) {
    // position 0: S -> B -> entry; every other slot dead
    float entry[NPT], zero[NPT];
    ldg_nodes<NPT>(tr + Q_ENTRY * K, entry);
    float m = 0.f;
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      zero[n] = 0.f;
      entry[n] *= NB;
      m = fmaxf(m, entry[n]);
    }
    nodeX[0] = 0;
    const float f = rescale(m, nodeX[0]);
#pragma unroll
    for (int n = 0; n < NPT; ++n) entry[n] *= f;
    sts_nodes<NPT>(ring_cs + k0, entry);
    sts_nodes<NPT>(ring_ic + k0, zero);
    for (int slot = 1; slot < 5; ++slot) {
      sts_nodes<NPT>(ring_cs + slot * K + k0, zero);
      sts_nodes<NPT>(ring_ic + slot * K + k0, zero);
    }
  }
  // specials ring, index l holds position i-1-l (every thread a copy),
  // each value with its exponent
  float spN[5], spJ[5], spC[5], spE[5], spR[5];
  int spXN[5], spXR[5], spXJC[5], spXE[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    spN[l] = spJ[l] = spC[l] = spE[l] = spR[l] = 0.f;
    spXN[l] = spXR[l] = spXJC[l] = spXE[l] = ZERO_X;
  }
  float out_alt = NEG, out_null = NEG;

  for (int i = 1; i <= L; ++i) {
    int idx[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) idx[l] = __ldg(ei + (i - 1) * 5 + l);

    // position i's exponents: the largest of the slots that feed each
    // value (S, 1 at exponent 0, feeds N and R up to i = 5)
    int X = ZERO_X, XJC = ZERO_X;
    int XN = i <= 5 ? 0 : ZERO_X, XR = XN;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      X = max(X, nodeX[l]);
      XN = max(XN, spXN[l]);
      XR = max(XR, spXR[l]);
      XJC = max(XJC, max(spXJC[l], spXE[l]));
    }

    // N / J / C loops and the null R loop, and per lookback its slot's
    // scale into this thread's exponent with the insert emission
    const float startN = pow2(-XN), startR = pow2(-XR);
    float sc[5], emi[5];
    float accN = 0.f, accJ = 0.f, accC = 0.f, accR = 0.f;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      sc[l] = pow2(nodeX[l] - X);
      emi[l] = prob(__ldg(fi_b + idx[l])) * sc[l];
      const float en = prob(__ldg(fn_b + idx[l]));
      const bool start = l + 1 == i;
      const float nn = NN * en;
      accN = fmaf(fmaf(spN[l], pow2(spXN[l] - XN), start ? startN : 0.f), nn,
                  accN);
      accR = fmaf(fmaf(spR[l] * RR, pow2(spXR[l] - XR), start ? startR : 0.f),
                  en, accR);
      const float fe = spE[l] * pow2(spXE[l] - XJC);
      const float fj = pow2(spXJC[l] - XJC);
      accJ = fmaf(fmaf(fe, EJ, spJ[l] * fj), nn, accJ);
      accC = fmaf(fmaf(fe, EC, spC[l] * fj), nn, accC);
    }

    // match and insert in-flow over the 5 fragment lengths
    float accM[NPT], accI[NPT];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const int slot = (i - 1 - l + 5) % 5;  // position i - (l + 1)
      if (active) {
        float em[NPT], rc[NPT], ri[NPT];
        ldg_nodes<NPT>(fm_b + (size_t)idx[l] * K, em);
        lds_nodes<NPT>(ring_cs + slot * K + k0, rc);
        lds_nodes<NPT>(ring_ic + slot * K + k0, ri);
#pragma unroll
        for (int n = 0; n < NPT; ++n) {
          const float cm = rc[n] * prob(em[n]);
          accM[n] = l == 0 ? cm * sc[0] : fmaf(cm, sc[l], accM[n]);
          accI[n] = l == 0 ? ri[n] * emi[0] : fmaf(ri[n], emi[l], accI[n]);
        }
      }
    }

    // D-chain: inclusive scan of this thread's maps (a, b) = (dd, M md)
    // at its exponent X, then the thread totals (a, b 2^bx) across the
    // warp (identity (1, 0) when idle)
    float pa[NPT], pb[NPT];
    float ta = 1.f, tb = 0.f;
    if (active) {
      float md[NPT], dd[NPT];
      ldg_nodes<NPT>(tr + Q_MD_OUT * K, md);
      ldg_nodes<NPT>(tr + Q_DD_OUT * K, dd);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float bn = accM[n] * md[n];
        pa[n] = n == 0 ? dd[0] : pa[n - 1] * dd[n];
        pb[n] = n == 0 ? bn : fmaf(pb[n - 1], dd[n], bn);
      }
      ta = pa[NPT - 1];
      tb = pb[NPT - 1];
    }
    int tx = X;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float ya = __shfl_up_sync(FULL, ta, o);
      const float yb = __shfl_up_sync(FULL, tb, o);
      const int yx = __shfl_up_sync(FULL, tx, o);
      if (lane >= o) {  // the earlier lanes' map first
        tb = join(yb * ta, yx, tb, tx, tx);
        ta = ya * ta;
      }
    }
    float ea = __shfl_up_sync(FULL, ta, 1);
    float eb = __shfl_up_sync(FULL, tb, 1);
    int ex = __shfl_up_sync(FULL, tx, 1);
    if (lane == 0) {
      ea = 1.f;
      eb = 0.f;
    }
    if (lane == 31) {
      warp_a[warp] = ta;
      warp_b[warp] = tb;
      warp_bx[warp] = tx;
    }
    __syncthreads();
    // D entering this thread's first node: the earlier warps' maps, then
    // the earlier lanes', applied to D = 0 before node 0
    float din = 0.f;
    int dx = ZERO_X;
    for (int w = 0; w < warp; ++w)
      din = join(warp_a[w] * din, dx, warp_b[w], warp_bx[w], dx);
    din = join(ea * din, dx, eb, ex, dx);
    // the thread's working exponent: its slots' or that of the D entering
    // it, the larger
    const int XP = max(X, live(din, dx));
    const float rs = pow2(X - XP);
    din *= pow2(dx - XP);

    float VD[NPT], core[NPT];
    float esum = 0.f;
    if (active) {
      float mm[NPT], im[NPT], dm[NPT];
      ldg_nodes<NPT>(tr + Q_MM_OUT * K, mm);
      ldg_nodes<NPT>(tr + Q_IM_OUT * K, im);
      ldg_nodes<NPT>(tr + Q_DM_OUT * K, dm);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        accM[n] *= rs;
        accI[n] *= rs;
        VD[n] = n == 0 ? din : fmaf(pa[n - 1], din, pb[n - 1] * rs);
        esum += accM[n] + VD[n];
        core[n] = fmaf(accM[n], mm[n], fmaf(accI[n], im[n], VD[n] * dm[n]));
      }
    }
    int sx = XP;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float y = __shfl_xor_sync(FULL, esum, o);
      const int yx = __shfl_xor_sync(FULL, sx, o);
      esum = join(esum, sx, y, yx, sx);
    }
    const float last = active ? core[NPT - 1] : 0.f;
    float prev = __shfl_up_sync(FULL, last, 1);  // core[k0 - 1]
    int prevX = __shfl_up_sync(FULL, XP, 1);
    if (lane == 0) {
      warp_sum[warp] = esum;
      warp_sx[warp] = sx;
    }
    if (lane == 31) {
      warp_core[warp] = last;
      warp_cx[warp] = XP;
    }
    __syncthreads();
    float VE = warp_sum[0];
    int XE = warp_sx[0];
    for (int w = 1; w < nwarps; ++w)
      VE = join(VE, XE, warp_sum[w], warp_sx[w], XE);
    if (lane == 0) {
      prev = warp > 0 ? warp_core[warp - 1] : 0.f;
      prevX = warp > 0 ? warp_cx[warp - 1] : ZERO_X;
    }

    int XB, XT;
    float VB = join(accN, XN, accJ, XJC, XB);
    VB = join(VB, XB, VE * EJ, XE, XB) * NB;
    const float VT = join(VE * EC, XE, accC, XJC, XT) * NB;
    if (i == L) {
      out_alt = log_scaled(VT, XT);
      out_null = log_scaled(accR, XR);
    }

#pragma unroll
    for (int l = 4; l > 0; --l) nodeX[l] = nodeX[l - 1];
    nodeX[0] = ZERO_X;
    // write position i into ring slot i % 5 (this thread's nodes only),
    // at the exponent of its own largest value
    if (active) {
      const int slot = i % 5;
      float entry[NPT], mi[NPT], ii[NPT], cs[NPT], ic[NPT];
      ldg_nodes<NPT>(tr + Q_ENTRY * K, entry);
      ldg_nodes<NPT>(tr + Q_MI * K, mi);
      ldg_nodes<NPT>(tr + Q_II * K, ii);
      const int pX = live(prev, prevX), bX = live(VB, XB);
      int e = max(XP, max(pX, bX));
      const float ro = pow2(XP - e);
      const float rp = prev * pow2(pX - e), rb = VB * pow2(bX - e);
      float m = 0.f;
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float csh = n == 0 ? rp : core[n - 1] * ro;
        cs[n] = fmaf(rb, entry[n], csh);
        ic[n] = fmaf(accM[n], mi[n], accI[n] * ii[n]) * ro;
        m = fmaxf(m, fmaxf(cs[n], ic[n]));
      }
      const float f = rescale(m, e);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        cs[n] *= f;
        ic[n] *= f;
      }
      sts_nodes<NPT>(ring_cs + slot * K + k0, cs);
      sts_nodes<NPT>(ring_ic + slot * K + k0, ic);
      nodeX[0] = e;
    }
#pragma unroll
    for (int l = 4; l > 0; --l) {
      spN[l] = spN[l - 1];
      spJ[l] = spJ[l - 1];
      spC[l] = spC[l - 1];
      spE[l] = spE[l - 1];
      spR[l] = spR[l - 1];
      spXN[l] = spXN[l - 1];
      spXR[l] = spXR[l - 1];
      spXJC[l] = spXJC[l - 1];
      spXE[l] = spXE[l - 1];
    }
    // position i's specials, each brought into [0.5, 1)
    spXN[0] = XN;
    spN[0] = accN * rescale(accN, spXN[0]);
    spXR[0] = XR;
    spR[0] = accR * rescale(accR, spXR[0]);
    spXE[0] = XE;
    spE[0] = VE * rescale(VE, spXE[0]);
    spXJC[0] = XJC;
    const float fjc = rescale(fmaxf(accJ, accC), spXJC[0]);
    spJ[0] = accJ * fjc;
    spC[0] = accC * fjc;
  }
  if (tid == 0) {
    alt[(size_t)s * B + b] = out_alt;
    nul[(size_t)s * B + b] = out_null;
  }
}

template <int NPT>
cudaError_t launch(const float* fm, const float* fin, const float* ptrans,
                   const int* eidx, const int* seq_len, const float* sp,
                   float t_EJ, float t_EC, float* alt, float* nul, int S,
                   int B, int K, int ntab, int Lp, cudaStream_t stream) {
  const int smem = 2 * 5 * K * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      forward_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int threads = ((K / NPT + 31) / 32) * 32;
  forward_kernel<NPT><<<dim3(S, B), threads, smem, stream>>>(
      fm, fin, ptrans, eidx, seq_len, sp, t_EJ, t_EC, alt, nul, B, K, ntab,
      Lp);
  return cudaGetLastError();
}

}  // namespace

// same arguments as dcp_viterbi_max, with the probability planes in the
// place of the log ones
extern "C" int dcp_viterbi_lse(const float* fm, const float* fin,
                               const float* ptrans, const int* eidx,
                               const int* seq_len, const float* sp,
                               float t_EJ, float t_EC, float* alt, float* nul,
                               int S, int B, int K, int ntab, int Lp,
                               void* stream) {
  if (S <= 0 || B <= 0) return (int)cudaSuccess;
  if (bad_shape(B, K, ntab)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  // 4 nodes a thread up to K = DCP_FWD_NPT4_MAX_K (<= 2048, 512
  // threads), 8 above
  if (K <= DCP_FWD_NPT4_MAX_K && K <= 2048)
    return (int)launch<4>(fm, fin, ptrans, eidx, seq_len, sp, t_EJ, t_EC, alt,
                          nul, S, B, K, ntab, Lp, st);
  return (int)launch<8>(fm, fin, ptrans, eidx, seq_len, sp, t_EJ, t_EC, alt,
                        nul, S, B, K, ntab, Lp, st);
}
