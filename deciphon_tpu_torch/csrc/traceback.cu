// Backpointer Viterbi (pass 2 of a scan) for Hopper, sm_90a.
//
// Replaces the JAX package's jitted traceback DP,
// deciphon_tpu/ops/viterbi_trace.py `_trace_scan_batch` (:266), a vmap
// over hits of the `lax.scan` in `_trace_scan` (:40).  It is the kernel
// behind ops/viterbi_trace.launch_trace, whose plain version is
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
//     D; insert: 5 lengths x M, I; N, J, C: 5 lengths x 2 origins), and
//     the first maximum wins, as torch.argmax keeps it.  The lists are
//     reduced as trees of contiguous runs (a later run wins only when
//     strictly greater), which gives the same winner as a serial walk;
//   - every f32 add with trace_dp's operands in its order:
//     (V + trans) + em, ((VE + EJ) + NN) + em, (VM + md_next) - cdd_next,
//     cdd + b[k-1] clamped at NEG; joins are maxima, which are exact;
//   - the D-chain's cdd, md_next and cdd_next come from the wrapper, made
//     by the same torch calls as trace_dp's (a cumsum on the card is a
//     parallel scan whose rounding a serial sum here would not repeat);
//     the kernel takes only their prefix MAX over k, exact in any order;
//   - E over the 2K slots [VM_0..VM_{K-1}, D_0 = NEG, VD_1..VD_{K-1}] is
//     an argmax that keeps the lowest index among equal maxima.
// Every hit runs the chunk's Lmax positions, as trace_dp does, so all
// rows agree with it, also those past a read's length (the sentinel rows
// of eidx).
//
// What bounds it: the positions of a hit are serial, and a chunk holds
// 1-128 hits, so the time is the latency of one position times Lmax.  The
// first design (one CTA per hit, three barriers a position, the planes
// re-read and the rings in shared or device memory) took ~4000 cycles a
// position.  This one shortens the chain of a position:
//   - of a position's candidates only one, the B origin of lookback 1,
//     needs the position before's VB, which waits on that position's E
//     reduction.  So the candidates of lookbacks 2..5 of position i+1
//     (16 of the 20 match and 8 of the 10 insert ones, whose ring slots
//     are complete) are computed while position i's E reduction runs,
//     and position i+1 starts from lookback 1 and ends with its B origin
//     (index 0, first in trace_dp's order: it wins ties);
//   - the 9 planes (TRACE_PLANES) are a thread's constants for the whole
//     hit, loaded into registers once;
//   - the fragment rows and insert and null scores of position i+2 and
//     the eidx row of position i+3 are issued at position i, so the
//     dependent loads eidx -> rows are in flight for a whole position.
//     They are volatile asm loads (ldg_ahead): the compiler moved the
//     same loads written with __ldg next to their uses, where each
//     waited out its latency;
//   - candidate lists reduce as trees of contiguous runs;
//   - the N, J, C specials run one lookback a lane (lane l < 5 holds
//     N, J, C and E of position i - 1 - l and the null score of its
//     fragment; three xor shuffles pick the first maximum), and VB, which
//     every node's B origin needs, is a ring of 5 registers.
// Measured on an H100 (PERF.md), a position takes ~1 us at K 8 and ~1.5-3
// us at K 129-600, issue-latency bound: a hit's warps sit one to an SM
// sub-partition with nothing else to issue while they wait, so a
// position's time grows with the nodes a thread holds.  Two plan kinds,
// chosen per width by ops/viterbi_trace.trace_plan, spread a hit over as
// many threads as it fills (a warp per hit with its rings in registers
// and no barrier was no faster than a one-warp CTA even at K <= 32, nor
// at 2-12 nodes a lane to K 384):
//   - CTA plans (K <= 1024): one CTA per hit, 1 node a thread up to K 512
//     and 2 above, rings in shared memory as [3][5][RS]
//     (column 0 the sentinel NEG, node k at k + 1, so no ring value moves
//     between threads) and two barriers a position: (A) the warp totals
//     of the D-chain scan, with each warp's last a and its partial prefix
//     at its second-to-last node, which give the next warp's k - 1 and
//     k - 2 neighbours; (B) E's warp winners, with the ring writes; the
//     next position's lookbacks 2..5 run before B.  B cannot merge with
//     the next position's A: VB of position i enters every node's match
//     candidate at position i + 1, so the next warp totals depend on all
//     of position i's E winners;
//   - cluster plans (K > 1024): a cluster of 2 or 4 CTAs per hit, each
//     with its share of the nodes and their rings in its own shared
//     memory (one CTA's 245 KB of rings at K 4096 and 1 node a thread
//     would not fit, nor would 4096 threads).  The same two barriers are
//     cluster barriers; every warp writes its totals and winners into the
//     tables of every CTA (distributed shared memory), and each CTA's last
//     node writes its M, I and D into column 0 of the next CTA's rings.
//     A refused cluster launch returns an error.
// The host queues every chunk of a scan before one wait
// (viterbi_trace.trace_scan; one a window of QUEUE_BYTES in a large
// scan), each on a stream of its own, so the small launches of a scan
// run side by side.
//
// NEG (-1e30) is the dead value, as in trace_dp; -inf appears only as the
// identity of the scans and reductions.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr float NEG = -1e30f;
constexpr int MAX_K = 4096;
constexpr int CTA_THREADS = 512;   // threads per CTA of a CTA/cluster plan
constexpr int MAX_WARPS = CTA_THREADS / 32;
constexpr int MAX_CLUSTER = 4;     // CTAs per hit of a cluster plan
constexpr int NTAB = MAX_CLUSTER * MAX_WARPS;  // a cross-warp table
constexpr unsigned FULL = 0xffffffffu;
// the planes of the packed [H, NPLANES, K] tensor
// (viterbi_trace.TRACE_PLANES)
enum { P_ENTRY, P_MM_IN, P_IM_IN, P_DM_IN, P_MI, P_II, P_MD_NEXT,
       P_CDD_NEXT, P_CDD, NPLANES };
// the three core rings, each [5][RS]
enum { R_M, R_I, R_D };
// plan kinds (viterbi_trace.TRACE_KINDS)
enum { CTA, CLUS };
// cross-warp tables after the rings, [NX][NTAB]: per warp of the hit its
// scan total, its partial prefix at its last lane's second-to-last node,
// its last a, and E's winner (value, index)
enum { X_TOT, X_Q, X_A, X_EV, X_EI, NX };

// Every (kind, NPT) instantiation: those of the plan table,
// ops/viterbi_trace.TRACE_TABLE (its TRACE_KERNELS mirrors this list).
#define DCP_TRACE_KERNELS(X) \
  X(CTA, 1) X(CTA, 2) X(CLUS, 2) X(CLUS, 4)

// first maximum of a list in two contiguous runs, (v2, c2) the later run:
// it wins only when strictly greater
__device__ __forceinline__ void first_max(float& v, int& c, float v2,
                                          int c2) {
  const bool take = v2 > v;
  v = take ? v2 : v;
  c = take ? c2 : c;
}

// (value, index) join in either order: the larger value, the lower index
// on equal values
__device__ __forceinline__ void arg_join(float& v, int& i, float v2,
                                         int i2) {
  if (v2 > v || (v2 == v && i2 < i)) {
    v = v2;
    i = i2;
  }
}

__device__ __forceinline__ int pick5(const int (&x)[5], int l) {
  return l == 0 ? x[0] : l == 1 ? x[1] : l == 2 ? x[2] : l == 3 ? x[3]
                                                                : x[4];
}

// Loads that stay where they are written.  A read-only load (__ldg)
// may be moved next to its first use, and the compiler does that to the
// gathers of a position ahead, which then wait out their whole latency
// in the position that uses them; a volatile asm load keeps its place in
// program order, so it is in flight through the position between.
__device__ __forceinline__ float ldg_ahead(const float* p) {
#ifdef __CUDA_ARCH__
  float v;
  asm volatile("ld.global.nc.f32 %0, [%1];" : "=f"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

__device__ __forceinline__ int ldg_ahead(const int* p) {
#ifdef __CUDA_ARCH__
  int v;
  asm volatile("ld.global.nc.s32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
#else
  return *p;
#endif
}

__device__ __forceinline__ float4 ldg_ahead4(const float* p) {
#ifdef __CUDA_ARCH__
  float4 v;
  asm volatile("ld.global.nc.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "l"(p));
  return v;
#else
  return *reinterpret_cast<const float4*>(p);
#endif
}

__device__ __forceinline__ float2 ldg_ahead2(const float* p) {
#ifdef __CUDA_ARCH__
  float2 v;
  asm volatile("ld.global.nc.v2.f32 {%0, %1}, [%2];"
               : "=f"(v.x), "=f"(v.y)
               : "l"(p));
  return v;
#else
  return *reinterpret_cast<const float2*>(p);
#endif
}

// A thread's NPT values of one fragment row (row = its node 0) with
// ldg_ahead: nodes k0.. below K, NEG past it (their loads clamped to the
// row's last aligned group, so no branch); aligned vector loads where K
// keeps them aligned.
template <int NPT>
__device__ __forceinline__ void ldg_row_ahead(const float* row, int k0,
                                              int K, float (&v)[NPT]) {
  if constexpr (NPT % 4 == 0) {
    if ((K & 3) == 0) {
#pragma unroll
      for (int g = 0; g < NPT / 4; ++g) {
        const int k = k0 + 4 * g;
        const float4 x = ldg_ahead4(row + (k < K ? k : K - 4));
        v[4 * g] = k < K ? x.x : NEG;
        v[4 * g + 1] = k < K ? x.y : NEG;
        v[4 * g + 2] = k < K ? x.z : NEG;
        v[4 * g + 3] = k < K ? x.w : NEG;
      }
      return;
    }
  } else if constexpr (NPT % 2 == 0) {
    if ((K & 1) == 0) {
#pragma unroll
      for (int g = 0; g < NPT / 2; ++g) {
        const int k = k0 + 2 * g;
        const float2 x = ldg_ahead2(row + (k < K ? k : K - 2));
        v[2 * g] = k < K ? x.x : NEG;
        v[2 * g + 1] = k < K ? x.y : NEG;
      }
      return;
    }
  }
#pragma unroll
  for (int n = 0; n < NPT; ++n) {
    const int k = k0 + n;
    const float x = ldg_ahead(row + (k < K ? k : K - 1));
    v[n] = k < K ? x : NEG;
  }
}

// A thread's NPT one-byte codes at p = row + k0, the `valid` ones below K
// (none when valid <= 0); 4-byte stores where K keeps them aligned, so a
// group of 4 lies wholly below K or past it
template <int NPT, typename T>
__device__ __forceinline__ void st_codes(T* p, int valid, int K,
                                         const int (&c)[NPT]) {
  if constexpr (NPT % 4 == 0) {
    if ((K & 3) == 0) {
#pragma unroll
      for (int g = 0; g < NPT / 4; ++g)
        if (4 * g < valid)
          reinterpret_cast<uint32_t*>(p)[g] =
              (uint32_t)(uint8_t)c[4 * g] |
              (uint32_t)(uint8_t)c[4 * g + 1] << 8 |
              (uint32_t)(uint8_t)c[4 * g + 2] << 16 |
              (uint32_t)(uint8_t)c[4 * g + 3] << 24;
      return;
    }
  }
#pragma unroll
  for (int n = 0; n < NPT; ++n)
    if (n < valid) p[n] = (T)c[n];
}

// the barrier of a hit's threads: its CTA or its cluster
template <int KIND>
__device__ __forceinline__ void sync_hit() {
  if constexpr (KIND == CTA) {
    __syncthreads();
  } else {
    cg::this_cluster().sync();
  }
}

// a cross-warp table entry, written into every CTA of the hit
template <int KIND>
__device__ __forceinline__ void publish(float* xt, int x, int w, float v,
                                        int C) {
  if constexpr (KIND == CLUS) {
    cg::cluster_group cl = cg::this_cluster();
    for (int r = 0; r < C; ++r) cl.map_shared_rank(xt, r)[x * NTAB + w] = v;
  } else {
    xt[x * NTAB + w] = v;
  }
}

// A ring slot's values at this thread's nodes k0 - 1 .. k0 + NPT - 1
// (column c of the shared-memory ring is node c - 1 of the CTA's span)
template <int NPT>
__device__ __forceinline__ void ring_slot(const float* ring, int RS,
                                          int col, int slot,
                                          float (&m)[NPT + 1],
                                          float (&iv)[NPT + 1],
                                          float (&d)[NPT + 1]) {
#pragma unroll
  for (int n = 0; n <= NPT; ++n) {
    m[n] = ring[(R_M * 5 + slot) * RS + col + n];
    iv[n] = ring[(R_I * 5 + slot) * RS + col + n];
    d[n] = ring[(R_D * 5 + slot) * RS + col + n];
  }
}

// A position's candidates of lookbacks 2..5 (l = 1..4, in ring slots
// (base - l) % 5, base the slot of the position before it): (pM, pcM)
// the first maximum of match candidates 4..19 and (pI, pcI) of insert
// candidates 2..9, each lookback's runs (B, M) and (I, D) joined first.
// None of them needs the position before's VB, so they are computed
// while that position's E reduction runs.
template <int NPT>
__device__ __forceinline__ void later_lookbacks(
    int base, const float (&rB)[5], const float* ring, int RS,
    int col, const float (&entry)[NPT], const float (&mm)[NPT],
    const float (&im)[NPT], const float (&dm)[NPT], const float (&mi)[NPT],
    const float (&ii)[NPT], const float (&row)[5][NPT],
    const float (&emiv)[5], float (&pM)[NPT], int (&pcM)[NPT],
    float (&pI)[NPT], int (&pcI)[NPT]) {
#pragma unroll
  for (int l = 1; l < 5; ++l) {
    const int slot = (base - l + 5) % 5;
    float m[NPT + 1], iv[NPT + 1], d[NPT + 1];
    ring_slot<NPT>(ring, RS, col, slot, m, iv, d);
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      const float em = row[l][n];
      float v = (rB[slot] + entry[n]) + em;
      int c = 4 * l;
      first_max(v, c, (m[n] + mm[n]) + em, 4 * l + 1);
      float w = (iv[n] + im[n]) + em;
      int cw = 4 * l + 2;
      first_max(w, cw, (d[n] + dm[n]) + em, 4 * l + 3);
      first_max(v, c, w, cw);
      float u = (m[n + 1] + mi[n]) + emiv[l];
      int cu = 2 * l;
      first_max(u, cu, (iv[n + 1] + ii[n]) + emiv[l], 2 * l + 1);
      if (l == 1) {
        pM[n] = v;
        pcM[n] = c;
        pI[n] = u;
        pcI[n] = cu;
      } else {
        first_max(pM[n], pcM[n], v, c);
        first_max(pI[n], pcI[n], u, cu);
      }
    }
  }
}

// the eidx row of position p (1-based), clamped to the last one
__device__ __forceinline__ void ld_idx(const int* ei, int p, int Lmax,
                                       int (&x)[5]) {
  const int r = (p < Lmax ? p : Lmax) - 1;
#pragma unroll
  for (int l = 0; l < 5; ++l) x[l] = ldg_ahead(ei + r * 5 + l);
}

struct Args {
  const float *fmT, *fin, *planes;
  const int* eidx;
  const float* sp;
  float t_EJ, t_EC;
  int8_t *bpM, *bpI;
  uint8_t* dD;
  int *bpE, *bpN, *bpJ, *bpC, *bpB, *bpT;
  float* VT;
  int H, K, ntab, Lmax, cluster;
};

// fmT    [H, ntab, K]  match fragment tables, rows contiguous along K
// fin    [H, 2, ntab]  insert (row 0) and null (row 1) fragment tables
// planes [H, NPLANES, K]
// eidx   [H, Lmax, 5]  end-fragment indices
// sp     [H, 2]        NN (= CC = JJ) and NB (= CT = JB) of each read
template <int KIND, int NPT>
__global__ void __launch_bounds__(CTA_THREADS, 1)
traceback_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int K = a.K, H = a.H, Lmax = a.Lmax;
  const float NINF = -__int_as_float(0x7f800000);

  // the hit, this thread's place in it and its first node
  const int C = KIND == CLUS ? a.cluster : 1;  // CTAs of the hit
  const int rank = KIND == CLUS ? (int)cg::this_cluster().block_rank() : 0;
  const int h = blockIdx.x / C;
  const int t = threadIdx.x;
  const int NT = blockDim.x;     // this CTA's share of the hit's threads
  const int nw = NT >> 5;
  const int gw = rank * nw + warp;  // warp in the hit
  const int nwh = C * nw;           // warps of the hit
  const int k0 = (rank * NT + t) * NPT;
  const int valid = K - k0;  // this thread's nodes below K, up to NPT
  const bool writer = t == 0 && rank == 0;

  // rings [3][5][RS]: column c is this CTA's node c - 1, column 0 the
  // node before its first (NEG, or the previous CTA's last)
  const int RS = NT * NPT + 1;
  float* ring = smem;
  float* xt = smem + 15 * RS;  // cross-warp tables
  const int col = t * NPT;     // this thread's node n is column col + n + 1
  for (int j = t; j < 15 * RS; j += NT) ring[j] = NEG;
  sync_hit<KIND>();

  // the planes, in registers for the whole hit
  // (volatile loads: a read-only load could be repeated in the loop)
  const float* pl = a.planes + (size_t)h * NPLANES * K;
  float entry[NPT], mm[NPT], im[NPT], dm[NPT], mi[NPT], ii[NPT],
      mdn[NPT], cddn[NPT], cdd[NPT];
  ldg_row_ahead<NPT>(pl + P_ENTRY * K, k0, K, entry);
  ldg_row_ahead<NPT>(pl + P_MM_IN * K, k0, K, mm);
  ldg_row_ahead<NPT>(pl + P_IM_IN * K, k0, K, im);
  ldg_row_ahead<NPT>(pl + P_DM_IN * K, k0, K, dm);
  ldg_row_ahead<NPT>(pl + P_MI * K, k0, K, mi);
  ldg_row_ahead<NPT>(pl + P_II * K, k0, K, ii);
  ldg_row_ahead<NPT>(pl + P_MD_NEXT * K, k0, K, mdn);
  ldg_row_ahead<NPT>(pl + P_CDD_NEXT * K, k0, K, cddn);
  ldg_row_ahead<NPT>(pl + P_CDD * K, k0, K, cdd);

  const float* fm_h = a.fmT + (size_t)h * a.ntab * K;
  const float* fi_h = a.fin + (size_t)h * 2 * a.ntab;
  const float* fn_h = fi_h + a.ntab;
  const int* ei = a.eidx + (size_t)h * Lmax * 5;
  const float NN = a.sp[2 * h], NB = a.sp[2 * h + 1];
  const int lb = lane < 5 ? lane : 4;  // this lane's lookback - 1

  // VB by ring slot (position p at slot p % 5): position 0 holds NB
  float rB[5] = {NB, NEG, NEG, NEG, NEG};
  // lane l < 5: N, J, C and E of position i - 1 - l
  float sN = NEG, sJ = NEG, sC = NEG, sE = NEG;

  // The pipeline, at the start of position i: (pM, pcM, pI, pcI) are
  // its candidates of lookbacks 2..5, em0 and emi0 its lookback-1 row
  // values and insert score; row and emiv hold position i+1's fragment
  // rows and insert scores, idx position i+2's eidx row; en0, en1 this
  // lane's null score of positions i and i+1.
  float pM[NPT], pI[NPT], em0[NPT], emi0;
  int pcM[NPT], pcI[NPT];
  float row[5][NPT], emiv[5], en0, en1;
  int idx[5];
  ld_idx(ei, 1, Lmax, idx);
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    emiv[l] = ldg_ahead(fi_h + idx[l]);
    ldg_row_ahead<NPT>(fm_h + (size_t)idx[l] * K, k0, K, row[l]);
  }
  en0 = ldg_ahead(fn_h + pick5(idx, lb));
  ld_idx(ei, 2, Lmax, idx);
  // position 1's lookbacks 2..5 (slots 4..1: dead positions before 0)
  later_lookbacks<NPT>(0, rB, ring, RS, col, entry, mm, im, dm, mi, ii,
                       row, emiv, pM, pcM, pI, pcI);
#pragma unroll
  for (int n = 0; n < NPT; ++n) em0[n] = row[0][n];
  emi0 = emiv[0];
#pragma unroll
  for (int l = 0; l < 5; ++l) {
    emiv[l] = ldg_ahead(fi_h + idx[l]);
    ldg_row_ahead<NPT>(fm_h + (size_t)idx[l] * K, k0, K, row[l]);
  }
  en1 = ldg_ahead(fn_h + pick5(idx, lb));
  ld_idx(ei, 3, Lmax, idx);

  for (int i = 1; i <= Lmax; ++i) {
    const int pos = i - 1;
    const int prev = (i - 1) % 5;  // ring slot of position i - 1
    const int cur = i % 5;         // ring slot of position i
    const size_t orow = ((size_t)pos * H + h) * K + k0;

    // (1) lookback 1 (position i - 1, now complete), then the first
    // maximum over all: match B (index 0), (M, (I, D)) (1..3), the
    // rest (4..19); insert (M, I) (0..1), the rest (2..9)
    float VM[NPT], VI[NPT];
    int cm[NPT], ci[NPT];
    {
      float m[NPT + 1], iv[NPT + 1], d[NPT + 1];
      ring_slot<NPT>(ring, RS, col, prev, m, iv, d);
#pragma unroll
      for (int n = 0; n < NPT; ++n) {
        const float em = em0[n];
        float v = (m[n] + mm[n]) + em;
        int c = 1;
        float w = (iv[n] + im[n]) + em;
        int cw = 2;
        first_max(w, cw, (d[n] + dm[n]) + em, 3);
        first_max(v, c, w, cw);
        first_max(v, c, pM[n], pcM[n]);
        VM[n] = (rB[prev] + entry[n]) + em;
        cm[n] = 0;
        first_max(VM[n], cm[n], v, c);
        VI[n] = (m[n + 1] + mi[n]) + emi0;
        ci[n] = 0;
        first_max(VI[n], ci[n], (iv[n + 1] + ii[n]) + emi0, 1);
        first_max(VI[n], ci[n], pI[n], pcI[n]);
      }
    }
    st_codes<NPT>(a.bpM + orow, valid, K, cm);
    st_codes<NPT>(a.bpI + orow, valid, K, ci);

    // (2) D-chain: a = (VM + md_next) - cdd_next and its prefix max
    // b; the thread's prefix, then a warp scan of the thread totals
    float av[NPT], pre[NPT];
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      av[n] = n < valid ? (VM[n] + mdn[n]) - cddn[n] : NINF;
      pre[n] = n == 0 ? av[0] : fmaxf(pre[n - 1], av[n]);
    }
    float x = pre[NPT - 1];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float y = __shfl_up_sync(FULL, x, o);
      if (lane >= o) x = fmaxf(x, y);
    }
    float excl = __shfl_up_sync(FULL, x, 1);  // this warp's nodes < k0
    if (lane == 0) excl = NINF;
    // b at this thread's second-to-last node (its k - 1 for NPT 1),
    // within the warp, and its last a: the next thread's k - 2 and
    // k - 1 neighbours
    const float q = NPT >= 2 ? fmaxf(excl, pre[NPT >= 2 ? NPT - 2 : 0])
                             : excl;
    float q_up = __shfl_up_sync(FULL, q, 1);
    float a_up = __shfl_up_sync(FULL, av[NPT - 1], 1);
    float before = NINF, before2 = NINF;  // warps < gw, and < gw - 1
    if (lane == 31) {
      publish<KIND>(xt, X_TOT, gw, x, C);
      publish<KIND>(xt, X_Q, gw, q, C);
      publish<KIND>(xt, X_A, gw, av[NPT - 1], C);
    }
    sync_hit<KIND>();  // (A)
    for (int w = 0; w < gw; ++w) {
      before2 = before;
      before = fmaxf(before, xt[X_TOT * NTAB + w]);
    }
    if (lane == 0 && gw > 0) {
      q_up = xt[X_Q * NTAB + gw - 1];
      a_up = xt[X_A * NTAB + gw - 1];
    }
    const float E = fmaxf(excl, before);  // max of a over nodes < k0
    const float b_m1 = k0 == 0 ? NEG : E;  // b[k0 - 1]
    const float b_m2 =                     // b[k0 - 2]
        k0 < 2 ? NEG : fmaxf(q_up, lane == 0 ? before2 : before);
    const float a_m1 = k0 == 0 ? NEG : a_up;  // a[k0 - 1]

    // VD, dD and this thread's E candidates (M then D of each node)
    float VD[NPT], b[NPT];
    int dd[NPT];
    float ev = NINF;
    int eb = 0x7fffffff;
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      b[n] = fmaxf(E, pre[n]);
      const float bm1 = n == 0 ? b_m1 : b[n - 1];
      VD[n] = fmaxf(cdd[n] + bm1, NEG);
      const float am1 = n == 0 ? a_m1 : av[n - 1];
      const float bm2 = n == 0 ? b_m2 : n == 1 ? b_m1 : b[n - 2];
      dd[n] = am1 < bm2 ? 1 : 0;
      if (n < valid) {
        const int k = k0 + n;
        arg_join(ev, eb, VM[n], k);
        arg_join(ev, eb, k == 0 ? NEG : VD[n], K + k);
      }
    }
    st_codes<NPT>(a.dD + orow, valid, K, dd);

    // position i into ring slot cur (position i - 5, last read as
    // the previous position's lookback 5)
#pragma unroll
    for (int n = 0; n < NPT; ++n) {
      ring[(R_M * 5 + cur) * RS + col + n + 1] = VM[n];
      ring[(R_I * 5 + cur) * RS + col + n + 1] = VI[n];
      ring[(R_D * 5 + cur) * RS + col + n + 1] = VD[n];
    }
    if constexpr (KIND == CLUS) {
      // a CTA's last node is column 0 of the next CTA's rings
      if (rank < C - 1 && t == NT - 1) {
        cg::cluster_group cl = cg::this_cluster();
        float* r1 = cl.map_shared_rank(ring, rank + 1);
        r1[(R_M * 5 + cur) * RS] = VM[NPT - 1];
        r1[(R_I * 5 + cur) * RS] = VI[NPT - 1];
        r1[(R_D * 5 + cur) * RS] = VD[NPT - 1];
      }
    }
    // (3) E: this warp's winner
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(FULL, ev, o);
      const int i2 = __shfl_xor_sync(FULL, eb, o);
      arg_join(ev, eb, v2, i2);
    }
    if (lane == 0) {
      publish<KIND>(xt, X_EV, gw, ev, C);
      publish<KIND>(xt, X_EI, gw, __int_as_float(eb), C);
    }

    // (4) while E settles: position i+1's lookbacks 2..5 (positions
    // i-1 .. i-4, whose ring slots are complete), then the gathers of
    // position i+2 and the eidx row of position i+3
    later_lookbacks<NPT>(cur, rB, ring, RS, col, entry, mm, im, dm, mi,
                         ii, row, emiv, pM, pcM, pI, pcI);
#pragma unroll
    for (int n = 0; n < NPT; ++n) em0[n] = row[0][n];
    emi0 = emiv[0];
#pragma unroll
    for (int l = 0; l < 5; ++l) {
      emiv[l] = ldg_ahead(fi_h + idx[l]);
      ldg_row_ahead<NPT>(fm_h + (size_t)idx[l] * K, k0, K, row[l]);
    }
    const float en2 = ldg_ahead(fn_h + pick5(idx, lb));
    ld_idx(ei, i + 3, Lmax, idx);

    // (5) VE, then N, J, C: lane l < 5 the lookback l + 1 of each,
    // (S or E, self) origins; the first maximum over [5 lengths, 2
    // origins]; then B and T
    sync_hit<KIND>();  // (B): E winners, ring writes
    float VE = xt[X_EV * NTAB];
    int bE = __float_as_int(xt[X_EI * NTAB]);
    for (int w = 1; w < nwh; ++w)
      arg_join(VE, bE, xt[X_EV * NTAB + w],
               __float_as_int(xt[X_EI * NTAB + w]));
    const float sS = lane == i - 1 ? 0.f : NEG;  // S = 0 at position 0
    float vN = (sS + NN) + en0;
    float vJ = ((sE + a.t_EJ) + NN) + en0;
    float vC = ((sE + a.t_EC) + NN) + en0;
    int cN = 2 * lb, cJ = 2 * lb, cC = 2 * lb;
    first_max(vN, cN, (sN + NN) + en0, 2 * lb + 1);
    first_max(vJ, cJ, (sJ + NN) + en0, 2 * lb + 1);
    first_max(vC, cC, (sC + NN) + en0, 2 * lb + 1);
    if (lane >= 5) {
      vN = vJ = vC = NINF;
      cN = cJ = cC = 0x7fffffff;
    }
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      arg_join(vN, cN, __shfl_xor_sync(FULL, vN, o),
               __shfl_xor_sync(FULL, cN, o));
      arg_join(vJ, cJ, __shfl_xor_sync(FULL, vJ, o),
               __shfl_xor_sync(FULL, cJ, o));
      arg_join(vC, cC, __shfl_xor_sync(FULL, vC, o),
               __shfl_xor_sync(FULL, cC, o));
    }
    const float VNn = __shfl_sync(FULL, vN, 0);
    const float VJn = __shfl_sync(FULL, vJ, 0);
    const float VCn = __shfl_sync(FULL, vC, 0);
    // B: [S (dead), N, E, J]; T: [E, C]
    float VBn = NEG;
    int cB = 0;
    const float b1 = VNn + NB;
    const float b2 = (VE + a.t_EJ) + NB;
    const float b3 = VJn + NB;
    if (b1 > VBn) { VBn = b1; cB = 1; }
    if (b2 > VBn) { VBn = b2; cB = 2; }
    if (b3 > VBn) { VBn = b3; cB = 3; }
    float VTn = (VE + a.t_EC) + NB;
    int cT = 0;
    const float t1 = VCn + NB;
    if (t1 > VTn) { VTn = t1; cT = 1; }
    if (writer) {
      const size_t o = (size_t)pos * H + h;
      a.bpE[o] = bE;
      a.bpN[o] = cN;
      a.bpJ[o] = cJ;
      a.bpC[o] = cC;
      a.bpB[o] = cB;
      a.bpT[o] = cT;
      a.VT[o] = VTn;
    }
    rB[cur] = VBn;
    // position i becomes every lane's next lookback: shift up one
    // lane, lane 0 takes it
    sN = __shfl_up_sync(FULL, sN, 1);
    sJ = __shfl_up_sync(FULL, sJ, 1);
    sC = __shfl_up_sync(FULL, sC, 1);
    sE = __shfl_up_sync(FULL, sE, 1);
    if (lane == 0) {
      sN = VNn;
      sJ = VJn;
      sC = VCn;
      sE = VE;
    }
    en0 = en1;
    en1 = en2;
  }
  // no CTA of a cluster leaves while the other may still reach its
  // shared memory
  if constexpr (KIND == CLUS) cg::this_cluster().sync();
}

// One launch of plan (warps per hit and CTA, CTAs per hit, threads,
// shared bytes) on the (KIND, NPT) instantiation; a plan that does not
// fit it is refused, and so is a cluster the card cannot place.
template <int KIND, int NPT>
cudaError_t launch(const Args& a, int warps, int cluster, int threads,
                   int smem, cudaStream_t stream) {
  const int NT = 32 * warps;
  const int K = a.K;
  // a CTA plan has no idle warp, a cluster's last CTA holds a node
  const bool fits = threads == NT && NT <= CTA_THREADS &&
                    K <= cluster * NT * NPT &&
                    (KIND == CTA ? cluster == 1 && (NT - 32) * NPT < K
                                 : cluster >= 2 && cluster <= MAX_CLUSTER &&
                                       (cluster - 1) * NT * NPT < K);
  if (!fits || smem != (15 * (NT * NPT + 1) + NX * NTAB) * (int)sizeof(float))
    return cudaErrorInvalidValue;
  void (*kern)(const Args) = traceback_kernel<KIND, NPT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(a.H * cluster);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  if constexpr (KIND == CLUS) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int placed = 0;
    err = cudaOccupancyMaxActiveClusters(&placed, kern, &cfg);
    if (err != cudaSuccess) return err;
    if (placed < 1) return cudaErrorLaunchOutOfResources;
  }
  err = cudaLaunchKernelEx(&cfg, kern, a);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

// One launch over H hits of width K, Lmax positions.  The plan (kind,
// npt, warps, cluster, threads, smem) is
// ops/viterbi_trace.trace_plan(K)'s: it names the instantiation (kind,
// npt) and its launch shape, which the launch checks.  Returns a
// cudaError_t.
extern "C" int dcp_traceback(const float* fmT, const float* fin,
                             const float* planes, const int* eidx,
                             const float* sp, float t_EJ, float t_EC,
                             int8_t* bpM, int8_t* bpI, uint8_t* dD,
                             int* bpE, int* bpN, int* bpJ, int* bpC,
                             int* bpB, int* bpT, float* VT, int H, int K,
                             int ntab, int Lmax, int kind, int npt,
                             int warps, int cluster, int threads, int smem,
                             void* stream) {
  if (H <= 0 || Lmax <= 0) return (int)cudaSuccess;
  if (K <= 0 || K > MAX_K || ntab <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{fmT, fin, planes, eidx, sp, t_EJ, t_EC, bpM, bpI,
               dD, bpE, bpN, bpJ, bpC, bpB, bpT, VT, H, K, ntab,
               Lmax, cluster};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DCP_LAUNCH(k, n)         \
  if (kind == k && npt == n)    \
    return (int)launch<k, n>(a, warps, cluster, threads, smem, st);
  DCP_TRACE_KERNELS(DCP_LAUNCH)
#undef DCP_LAUNCH
  return (int)cudaErrorInvalidValue;
}
