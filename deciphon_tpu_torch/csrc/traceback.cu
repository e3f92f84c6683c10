// Backpointer Viterbi (pass 2 of a scan) for Hopper, sm_90a.
//
// Replaces the JAX package's jitted traceback DP,
// deciphon_tpu/ops/viterbi_trace.py `_trace_scan_batch` (:266), a vmap
// over hits of the `lax.scan` in `_trace_scan` (:40).  It is the kernel
// behind ops/viterbi_trace.trace_kernel, whose plain version is
// ops/viterbi_trace.trace_dp: for every (profile, read) hit h of a chunk
// and every read position it writes the argmax codes that the host walk
// (viterbi_trace.walk) follows back to a state path:
//   bpM, bpI [L, H, K] int8  (l-1) * origins + origin
//   dD       [L, H, K] bool  the D-chain extends through D_{k-1}
//   bpE      [L, H] int32    < K: M_k, else D_{k-K}
//   bpN, bpJ, bpC, bpB, bpT [L, H] int32;  VT [L, H] f32
// The paths must be identical to the plain version's, not merely equal in
// score, so every value is the one trace_dp computes, bit for bit:
//   - candidates in trace_dp's order (match: 5 lengths x origins B, M, I,
//     D; insert: 5 lengths x M, I; N, J, C: 5 lengths x 2 origins), each
//     list walked with a strict `>` so that the first maximum wins, as
//     torch.argmax does;
//   - every f32 add with trace_dp's operands in its order:
//     (V + trans) + em, ((VE + EJ) + NN) + em, (VM + md_next) - cdd_next,
//     cdd + b[k-1] clamped at NEG; joins are maxima, which are exact;
//   - the D-chain's cdd, md_next and cdd_next come from the wrapper, made
//     by the same torch calls as trace_dp's (a cumsum on the card is a
//     parallel scan whose rounding a serial sum here would not repeat);
//     the kernel takes only their prefix MAX over k, which is exact in
//     any order;
//   - E over the 2K slots [VM_0..VM_{K-1}, D_0 = NEG, VD_1..VD_{K-1}] is a
//     block-wide argmax that keeps the lowest index among equal maxima.
// Every hit runs the chunk's Lmax positions, as trace_dp does, so all
// rows agree with it, also those past a read's length (the sentinel
// rows of eidx).
//
// Layout: one CTA per hit, NPT consecutive nodes a thread (1, 2, 4 or 8
// as K grows to 512, 1024, 2048, 4096; at most 512 threads).  The
// lookback rings of M, I and D (5 positions each) live in shared memory
// as [3][5][K + 1] with a NEG sentinel in column 0, so node k's k - 1
// neighbour is column k and no value moves between threads; where 15 (K
// + 1) floats do not fit beside the D-chain arrays (K above ~3400) the
// rings are the wrapper's scratch in device memory instead (L1/L2), the
// same code through a generic pointer.  The specials (S, N, J, C, E, B
// rings of 5) are a few scalars: every thread computes them alike, so no
// barrier broadcasts VB, and thread 0 alone writes them out.
//
// Per position, three barriers: the warp totals of the D-chain scan; the
// a and b arrays of the D-chain published for the k - 1 and k - 2 reads of
// dD and VD; the warp winners of E together with the ring writes.
// What bounds it: the positions are serial, and each position of a hit
// waits on its three barriers with a single CTA per hit (H <= 128 CTAs
// on 132 SMs), so latency, not the arithmetic or bytes counted in
// chip_smoke.py's bound, is the limit.  A later design may keep the rings
// in registers, drop a barrier by shuffling the D-chain's neighbours, or
// split a wide hit over a cluster.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_THREADS = 512;
constexpr int MAX_WARPS = MAX_THREADS / 32;
constexpr int MAX_K = 4096;
constexpr unsigned FULL = 0xffffffffu;
// the planes of the packed [H, NPLANES, K] tensor
// (viterbi_trace.TRACE_PLANES)
enum { P_ENTRY, P_MM_IN, P_IM_IN, P_DM_IN, P_MI, P_II, P_MD_NEXT,
       P_CDD_NEXT, P_CDD, NPLANES };
// the three core rings, each [5][K + 1]
enum { R_M, R_I, R_D };

// (value, index) argmax join: the larger value, the lower index on ties
__device__ __forceinline__ void arg_join(float& v, int& i, float v2, int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

// fmT    [H, ntab, K]  match fragment tables, rows contiguous along K
// fin    [H, 2, ntab]  insert (row 0) and null (row 1) fragment tables
// planes [H, NPLANES, K]
// eidx   [H, Lmax, 5]  end-fragment indices
// sp     [H, 2]        NN (= CC = JJ) and NB (= CT = JB) of each read
// scratch [H, 3, 5, K + 1] rings when they are not in shared memory
template <int NPT>
__global__ void __launch_bounds__(MAX_THREADS)
traceback_kernel(const float* __restrict__ fmT, const float* __restrict__ fin,
                 const float* __restrict__ planes, const int* __restrict__ eidx,
                 const float* __restrict__ sp, float t_EJ, float t_EC,
                 float* scratch, int8_t* __restrict__ bpM,
                 int8_t* __restrict__ bpI, uint8_t* __restrict__ dD,
                 int* __restrict__ bpE, int* __restrict__ bpN,
                 int* __restrict__ bpJ, int* __restrict__ bpC,
                 int* __restrict__ bpB, int* __restrict__ bpT,
                 float* __restrict__ VT, int H, int K, int ntab, int Lmax,
                 int ring_in_smem) {
  extern __shared__ float smem[];
  __shared__ float warp_tot[MAX_WARPS];
  __shared__ float warp_ev[MAX_WARPS];
  __shared__ int warp_ei[MAX_WARPS];

  const int h = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int nwarps = blockDim.x >> 5;
  const int k0 = t * NPT;
  const float NINF = -__int_as_float(0x7f800000);

  const int RS = K + 1;  // a ring row: sentinel column 0, node k at k + 1
  float* ring = ring_in_smem ? smem : scratch + (size_t)h * 15 * RS;
  // the D-chain's a and b, node k at k + 2, NEG at 0 and 1
  float* sa = smem + (ring_in_smem ? 15 * RS : 0);
  float* sb = sa + K + 2;
  for (int j = t; j < 15 * RS; j += blockDim.x) ring[j] = NEG;
  if (t < 2) sa[t] = sb[t] = NEG;

  const float* fm_h = fmT + (size_t)h * ntab * K;
  const float* fi_h = fin + (size_t)h * 2 * ntab;
  const float* fn_h = fi_h + ntab;
  const float* pl = planes + (size_t)h * NPLANES * K;
  const int* ei = eidx + (size_t)h * Lmax * 5;
  const float NN = sp[2 * h], NB = sp[2 * h + 1];

  // specials, index l = lookback - 1 (position i - 1 - l); position 0
  // holds S = 0 and B = NB, every other slot is dead
  float rS[5], rN[5], rJ[5], rC[5], rE[5], rB[5];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    rS[l] = l == 0 ? 0.f : NEG;
    rB[l] = l == 0 ? NB : NEG;
    rN[l] = rJ[l] = rC[l] = rE[l] = NEG;
  }
  __syncthreads();

  for (int pos = 0; pos < Lmax; ++pos) {
    const int i = pos + 1;
    int idx[5];
    float emi[5], emn[5];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      idx[l] = __ldg(ei + pos * 5 + l);
      emi[l] = __ldg(fi_h + idx[l]);
      emn[l] = __ldg(fn_h + idx[l]);
    }
    const size_t row = ((size_t)pos * H + h) * K;  // [pos, h, :]

    // match and insert: argmax over the candidates in trace_dp's order
    float VMn[NPT], VIn[NPT], pre[NPT];
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      const int k = k0 + n;
      VMn[n] = VIn[n] = NINF;
      // a node past K carries the prefix of the nodes before it
      pre[n] = n == 0 ? NINF : pre[n - 1];
      if (k < K) {
        const float entry = __ldg(pl + P_ENTRY * K + k);
        const float mm = __ldg(pl + P_MM_IN * K + k);
        const float im = __ldg(pl + P_IM_IN * K + k);
        const float dm = __ldg(pl + P_DM_IN * K + k);
        const float mi = __ldg(pl + P_MI * K + k);
        const float ii = __ldg(pl + P_II * K + k);
        float bm = 0.f, bi = 0.f;
        int cm = 0, ci = 0;
#pragma unroll
        for (int l = 0; l < 5; ++l) {
          const int slot = (i - 1 - l + 5) % 5;  // position i - 1 - l
          const float* rm = ring + (R_M * 5 + slot) * RS;
          const float* ri = ring + (R_I * 5 + slot) * RS;
          const float* rd = ring + (R_D * 5 + slot) * RS;
          const float em = __ldg(fm_h + (size_t)idx[l] * K + k);
          // origins B, M, I, D; column k is node k - 1
          const float c0 = (rB[l] + entry) + em;
          const float c1 = (rm[k] + mm) + em;
          const float c2 = (ri[k] + im) + em;
          const float c3 = (rd[k] + dm) + em;
          if (l == 0) {
            bm = c0;
            cm = 0;
          } else if (c0 > bm) {
            bm = c0;
            cm = 4 * l;
          }
          if (c1 > bm) { bm = c1; cm = 4 * l + 1; }
          if (c2 > bm) { bm = c2; cm = 4 * l + 2; }
          if (c3 > bm) { bm = c3; cm = 4 * l + 3; }
          // origins M, I at node k itself
          const float d0 = (rm[k + 1] + mi) + emi[l];
          const float d1 = (ri[k + 1] + ii) + emi[l];
          if (l == 0) {
            bi = d0;
            ci = 0;
          } else if (d0 > bi) {
            bi = d0;
            ci = 2 * l;
          }
          if (d1 > bi) { bi = d1; ci = 2 * l + 1; }
        }
        VMn[n] = bm;
        VIn[n] = bi;
        bpM[row + k] = (int8_t)cm;
        bpI[row + k] = (int8_t)ci;
        // D-chain: a = (VM + md_next) - cdd_next, then its prefix max
        const float a = (bm + __ldg(pl + P_MD_NEXT * K + k)) -
                        __ldg(pl + P_CDD_NEXT * K + k);
        sa[k + 2] = a;
        pre[n] = n == 0 ? a : fmaxf(pre[n - 1], a);
      }
    }
    // inclusive prefix max over the block: thread totals, warp scan,
    // then the warps before this one
    float x = pre[NPT - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = fmaxf(x, y);
    }
    float excl = __shfl_up_sync(FULL, x, 1);
    if (lane == 0) excl = NINF;
    if (lane == 31) warp_tot[warp] = x;
    __syncthreads();  // (1) warp totals
    for (int w = 0; w < warp; ++w) excl = fmaxf(excl, warp_tot[w]);
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      const int k = k0 + n;
      if (k < K) sb[k + 2] = fmaxf(excl, pre[n]);
    }
    __syncthreads();  // (2) a and b of every node

    // VD, dD, the ring writes and this thread's E candidates
    const int cur = i % 5;
    float* wm = ring + (R_M * 5 + cur) * RS;
    float* wi = ring + (R_I * 5 + cur) * RS;
    float* wd = ring + (R_D * 5 + cur) * RS;
    float ev = NINF;
    int eidx_best = 0x7fffffff;
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      const int k = k0 + n;
      if (k < K) {
        // cdd + b[k-1] (NEG at k = 0), clamped at NEG
        const float VD = fmaxf(__ldg(pl + P_CDD * K + k) + sb[k + 1], NEG);
        dD[row + k] = sa[k + 1] < sb[k] ? 1 : 0;  // a[k-1] < b[k-2]
        wm[k + 1] = VMn[n];
        wi[k + 1] = VIn[n];
        wd[k + 1] = VD;
        arg_join(ev, eidx_best, VMn[n], k);
        arg_join(ev, eidx_best, k == 0 ? NEG : VD, K + k);
      }
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(FULL, ev, o);
      const int i2 = __shfl_xor_sync(FULL, eidx_best, o);
      arg_join(ev, eidx_best, v2, i2);
    }
    if (lane == 0) {
      warp_ev[warp] = ev;
      warp_ei[warp] = eidx_best;
    }
    __syncthreads();  // (3) warp winners of E, ring writes
    float VE = warp_ev[0];
    int bE = warp_ei[0];
    for (int w = 1; w < nwarps; ++w) arg_join(VE, bE, warp_ev[w], warp_ei[w]);

    // N, J, C loops: [5 lengths, 2 origins], first maximum
    float VNn = 0.f, VJn = 0.f, VCn = 0.f;
    int cN = 0, cJ = 0, cC = 0;
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      const float n0 = (rS[l] + NN) + emn[l];
      const float n1 = (rN[l] + NN) + emn[l];
      const float j0 = ((rE[l] + t_EJ) + NN) + emn[l];
      const float j1 = (rJ[l] + NN) + emn[l];
      const float q0 = ((rE[l] + t_EC) + NN) + emn[l];
      const float q1 = (rC[l] + NN) + emn[l];
      if (l == 0) {
        VNn = n0; VJn = j0; VCn = q0;
      } else {
        if (n0 > VNn) { VNn = n0; cN = 2 * l; }
        if (j0 > VJn) { VJn = j0; cJ = 2 * l; }
        if (q0 > VCn) { VCn = q0; cC = 2 * l; }
      }
      if (n1 > VNn) { VNn = n1; cN = 2 * l + 1; }
      if (j1 > VJn) { VJn = j1; cJ = 2 * l + 1; }
      if (q1 > VCn) { VCn = q1; cC = 2 * l + 1; }
    }
    // B: [S (dead), N, E, J]; T: [E, C]
    float VBn = NEG;
    int cB = 0;
    const float b1 = VNn + NB;
    const float b2 = (VE + t_EJ) + NB;
    const float b3 = VJn + NB;
    if (b1 > VBn) { VBn = b1; cB = 1; }
    if (b2 > VBn) { VBn = b2; cB = 2; }
    if (b3 > VBn) { VBn = b3; cB = 3; }
    float VTn = (VE + t_EC) + NB;
    int cT = 0;
    const float t1 = VCn + NB;
    if (t1 > VTn) { VTn = t1; cT = 1; }
    if (t == 0) {
      const size_t o = (size_t)pos * H + h;
      bpE[o] = bE;
      bpN[o] = cN;
      bpJ[o] = cJ;
      bpC[o] = cC;
      bpB[o] = cB;
      bpT[o] = cT;
      VT[o] = VTn;
    }
#pragma unroll
    for (int l = 4; l > 0; --l) {
      rS[l] = rS[l - 1];
      rN[l] = rN[l - 1];
      rJ[l] = rJ[l - 1];
      rC[l] = rC[l - 1];
      rE[l] = rE[l - 1];
      rB[l] = rB[l - 1];
    }
    rS[0] = NEG;
    rN[0] = VNn;
    rJ[0] = VJn;
    rC[0] = VCn;
    rE[0] = VE;
    rB[0] = VBn;
  }
}

struct Args {
  const float *fmT, *fin, *planes;
  const int* eidx;
  const float* sp;
  float t_EJ, t_EC;
  float* scratch;
  int8_t *bpM, *bpI;
  uint8_t* dD;
  int *bpE, *bpN, *bpJ, *bpC, *bpB, *bpT;
  float* VT;
  int H, K, ntab, Lmax;
};

template <int NPT>
cudaError_t launch(const Args& a, int threads, int smem, int ring_in_smem,
                   cudaStream_t stream) {
  if (threads < 32 || threads > MAX_THREADS || threads % 32 ||
      threads * NPT < a.K || (threads - 32) * NPT >= a.K)
    return cudaErrorInvalidValue;
  const int want = (ring_in_smem ? 15 * (a.K + 1) : 0) + 2 * (a.K + 2);
  if (smem != want * (int)sizeof(float)) return cudaErrorInvalidValue;
  if (!ring_in_smem && a.scratch == nullptr) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      traceback_kernel<NPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  traceback_kernel<NPT><<<a.H, threads, smem, stream>>>(
      a.fmT, a.fin, a.planes, a.eidx, a.sp, a.t_EJ, a.t_EC, a.scratch, a.bpM,
      a.bpI, a.dD, a.bpE, a.bpN, a.bpJ, a.bpC, a.bpB, a.bpT, a.VT, a.H, a.K,
      a.ntab, a.Lmax, ring_in_smem);
  return cudaGetLastError();
}

}  // namespace

// One launch over H hits of width K, Lmax positions; (npt, threads, smem,
// ring_in_smem) is ops/viterbi_trace.trace_plan(K)'s, which the launch
// checks.  Returns a cudaError_t.
extern "C" int dcp_traceback(const float* fmT, const float* fin,
                             const float* planes, const int* eidx,
                             const float* sp, float t_EJ, float t_EC,
                             float* scratch, int8_t* bpM, int8_t* bpI,
                             uint8_t* dD, int* bpE, int* bpN, int* bpJ,
                             int* bpC, int* bpB, int* bpT, float* VT, int H,
                             int K, int ntab, int Lmax, int npt, int threads,
                             int smem, int ring_in_smem, void* stream) {
  if (H <= 0 || Lmax <= 0) return (int)cudaSuccess;
  if (K <= 0 || K > MAX_K || ntab <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{fmT, fin, planes, eidx, sp, t_EJ, t_EC, scratch, bpM, bpI,
               dD, bpE, bpN, bpJ, bpC, bpB, bpT, VT, H, K, ntab, Lmax};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (npt) {
    case 1: return (int)launch<1>(a, threads, smem, ring_in_smem, st);
    case 2: return (int)launch<2>(a, threads, smem, ring_in_smem, st);
    case 4: return (int)launch<4>(a, threads, smem, ring_in_smem, st);
    case 8: return (int)launch<8>(a, threads, smem, ring_in_smem, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
