// Fragment-table synthesis for Hopper, sm_90a: one launch per block.
//
// Replaces no TPU kernel.  The JAX package builds a block's tables in XLA
// (deciphon_tpu/ops/tables.py, two one-hot matmuls per fragment length);
// the port's plain version, ops/tables.synth_fragment_tables, is a chain
// of ~330 torch operations per chunk of 2684 rows (base 5), each gather
// writing a [rows, F] temporary, and a transpose of the whole table into
// the kernels' layout after it.  This kernel writes each entry once, in
// that layout:
//   out[r, f] = max(log(sum_t Me[r, midx(f,t)] * (qq[r, pair(f,t)] * c_t)),
//                   NEG)
// for every row r (a node of the block, or an insert or null row) and
// every fragment row f of the table (ntab rows; the sentinel row has no
// terms and comes out NEG), where Me [R, S^3] are the rows' pattern
// marginals, qq[r, i*S+j] = qe[r,i] * qe[r,j] their background pairs and
// c_t the coefficient of the term's class (frame.term_coefs).  The term
// lists are ops/tables.term_rows: `start` [ntab+1] offsets into `word`,
// a term's word midx | combo << 16, where combo indexes the (pair,
// class) combinations that occur (`combo`: i | j << 8 | class << 16;
// 93 of them at base 5, 129 at base 6).
//
// Rows: [0, B*Kp) are the nodes b*Kp + k, written to fm [B, ntab, Kp];
// [B*Kp, B*Kp + 2B) the insert and null rows 2b + {0, 1}, written to
// fin [B, 2, ntab].  Kp is a multiple of 32, so a tile of 32 rows holds
// nodes of one profile or insert/null rows only.
//
// Arithmetic: every product and sum is the plain version's, in its order
// (qq = qe_i * qe_j; qq * c; Me * that; the terms summed first to last),
// as __fmul_rn / __fadd_rn so that no FMA contracts them; the log is
// logf.  The tables equal the plain version's on the card up to logf's
// rounding.
//
// What bounds it: the output (B * ntab * Kp floats, 13 GB for the
// base-5 tables of 836,771 nodes) at 3.35 TB/s, and the terms: 47,615 a
// node at base 5, 110,718 at base 6.  The design:
//   - a CTA takes a tile of 32 rows, one a lane, and stages their Me
//     and each combination's qq * c in shared memory row-minor (pitch
//     33), from coalesced reads of the row-major inputs: a warp's gather
//     by midx or combo touches 32 consecutive words, no bank twice.  A
//     term is then a word, two shared-memory gathers, a product and a
//     sum (the products qq * c are the plain version's, made once a row
//     and combination instead of once a term);
//   - its 16 warps walk the fragment rows, warp w taking rows w, w + 16,
//     ...; a row has at most 32 terms (22 in frame.TERMS), which lane t
//     loads as one coalesced read a row, issued a row ahead (its start
//     two rows ahead), and a shuffle hands each term's word to the whole
//     warp.  (The first design read every word from L1/L2 inside the
//     term loop, where each waited out a miss: 14.1 ms for the smoke
//     DB's base-5 tables, 8% of the bytes' floor; words a row ahead
//     behind their start: 11.6 ms).  16 warps a CTA rather than 8 keep
//     narrow launches (one wide profile: 129 CTAs) from leaving the SMs
//     with too few warps to hide latency;
//   - each row's store is 32 consecutive floats along K;
//   - where Me does not fit in shared memory (reads of seven or more
//     distinct IUPAC codes) the lanes read it from device memory.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr float NEG = -1e30f;
constexpr int TILE = 32;          // rows a CTA, one a lane
constexpr int PITCH = TILE + 1;   // row-minor staging, conflict-free
constexpr int WARPS = 16;         // warps a CTA, striding fragment rows
constexpr int MAX_SMEM = 232448;  // a CTA's dynamic shared memory, H100
constexpr unsigned FULL = 0xffffffffu;

template <bool STAGE_ME>
__global__ void __launch_bounds__(TILE * WARPS)
tables_kernel(const float* __restrict__ me, const float* __restrict__ qe,
              const int* __restrict__ start,
              const uint32_t* __restrict__ word,
              const int* __restrict__ combo, const float* __restrict__ coef,
              float* __restrict__ fm, float* __restrict__ fin, int B, int Kp,
              int ntab, int S, int ncombo) {
  extern __shared__ float smem[];
  const int S3 = S * S * S;
  float* qqc_s = smem;                 // [ncombo][PITCH]
  float* me_s = qqc_s + ncombo * PITCH;  // [S3][PITCH] when staged
  const int nodes = B * Kp;
  const int R = nodes + 2 * B;
  const int r0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int r = r0 + lane;

  for (int i = tid; i < TILE * ncombo; i += TILE * WARPS) {
    const int row = i / ncombo, c = i - row * ncombo;
    const int cb = __ldg(combo + c);
    float v = 0.f;
    if (r0 + row < R) {
      const float* q = qe + (size_t)(r0 + row) * S;
      v = __fmul_rn(__fmul_rn(q[cb & 0xFF], q[(cb >> 8) & 0xFF]),
                    __ldg(coef + (cb >> 16)));
    }
    qqc_s[c * PITCH + row] = v;
  }
  if (STAGE_ME) {
    // the tile's rows are contiguous in me: read them in order
    const float* src = me + (size_t)r0 * S3;
    for (int i = tid; i < TILE * S3; i += TILE * WARPS) {
      const int row = i / S3, m = i - row * S3;
      me_s[m * PITCH + row] = r0 + row < R ? src[i] : 0.f;
    }
  }
  __syncthreads();

  const float* me_r = me + (size_t)(r < R ? r : 0) * S3;
  const bool node = r0 < nodes;
  float* out;
  size_t stride;  // between fragment rows
  if (node) {
    const int b = r0 / Kp;
    out = fm + (size_t)b * ntab * Kp + (r - b * Kp);
    stride = Kp;
  } else {
    out = fin + (size_t)(r - nodes) * ntab;
    stride = 1;
  }
  const bool live = r < R;
  // a row's term list is two loads, its start and then its words: the
  // start goes out two rows ahead and the words one row ahead, so
  // neither waits on the other inside a row
  int f = tid >> 5;
  int t0 = 0, n = 0;  // start and count of row f + WARPS once loaded
  auto row_terms = [&](int g) {
    t0 = 0;
    n = 0;
    if (g < ntab) {
      t0 = __ldg(start + g);
      n = __ldg(start + g + 1) - t0;
    }
  };
  row_terms(f);
  uint32_t wf = lane < n ? __ldg(word + t0 + lane) : 0u;
  int T = n;
  row_terms(f + WARPS);
  for (; f < ntab; f += WARPS) {
    const uint32_t wn = lane < n ? __ldg(word + t0 + lane) : 0u;
    const int Tn = n;
    row_terms(f + 2 * WARPS);
    float acc = 0.f;
#pragma unroll 4
    for (int t = 0; t < T; ++t) {
      const uint32_t w = __shfl_sync(FULL, wf, t);
      const int m = w & 0xFFFF;
      const float mv = STAGE_ME ? me_s[m * PITCH + lane] : __ldg(me_r + m);
      acc = __fadd_rn(acc, __fmul_rn(mv, qqc_s[(w >> 16) * PITCH + lane]));
    }
    float v = logf(acc);
    v = v < NEG ? NEG : v;  // clamp_min: NaN stays NaN
    if (live) out[(size_t)f * stride] = v;
    wf = wn;
    T = Tn;
  }
}

size_t smem_bytes(int S, int ncombo, bool stage_me) {
  return sizeof(float) * PITCH *
         ((size_t)ncombo + (stage_me ? (size_t)S * S * S : 0));
}

template <bool STAGE_ME>
cudaError_t launch(const float* me, const float* qe, const int* start,
                   const uint32_t* word, const int* combo, const float* coef,
                   float* fm, float* fin, int B, int Kp, int ntab, int S,
                   int ncombo, cudaStream_t stream) {
  const size_t smem = smem_bytes(S, ncombo, STAGE_ME);
  if (smem > MAX_SMEM) return cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        tables_kernel<STAGE_ME>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  const long rows = (long)B * Kp + 2L * B;
  const unsigned grid = (unsigned)((rows + TILE - 1) / TILE);
  tables_kernel<STAGE_ME><<<grid, TILE * WARPS, smem, stream>>>(
      me, qe, start, word, combo, coef, fm, fin, B, Kp, ntab, S, ncombo);
  return cudaGetLastError();
}

}  // namespace

// me [B*Kp + 2B, S^3], qe [B*Kp + 2B, S] f32 row-major; start [ntab+1]
// int32, word [start[ntab]] uint32, combo [ncombo] int32
// (ops/tables.term_rows, at most 32 terms a row); coef [9] f32
// (ops/tables.coef_row); fm [B, ntab, Kp], fin [B, 2, ntab] f32 out.
extern "C" int dcp_tables(const float* me, const float* qe, const int* start,
                          const uint32_t* word, const int* combo,
                          const float* coef, float* fm, float* fin, int B,
                          int Kp, int ntab, int S, int ncombo, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (Kp <= 0 || Kp % TILE || ntab <= 0 || S < 5 || S > 16 || ncombo <= 0 ||
      ncombo > 0xFFFF)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem_bytes(S, ncombo, true) <= MAX_SMEM)
    return (int)launch<true>(me, qe, start, word, combo, coef, fm, fin, B, Kp,
                             ntab, S, ncombo, st);
  return (int)launch<false>(me, qe, start, word, combo, coef, fm, fin, B, Kp,
                            ntab, S, ncombo, st);
}
