// K5 (decode and verify) and K3m (K3's MLA mode): absorbed multi-head
// latent attention (DeepSeek-V2 MLA) over the single latent pool.
//
// Replaces the MLA mode (v_head_dim set) of three Pallas kernels of
// kvcached_tpu/ops:
//   - paged_attention.py _decode_write_kernel_mla (entry point
//     paged_attention_decode(mla_v_dim=...)): K5, decode form;
//   - paged_attention.py _verify_write_kernel_mla over _verify_body
//     (paged_attention_verify(mla_v_dim=...)): K5, verify form;
//   - paged_prefill.py _prefill_kernel (paged_prefill_attention_batch(
//     mla_v_dim=...)): K3m.
// Semantics kept exactly:
//   - the pool is [L, P, 1, TP, D], D = 640: a token's latent entry is c_kv
//     (R = 512 lanes) ++ the shared rope key (64) ++ 64 zero lanes.  Page 0
//     is the zero page; a write aimed at it is discarded;
//   - decode / verify first store each fed token's entry at its slot;
//   - query row r of chunk row n is head r % H of token r / H (q is
//     [N, Tq, H, D], so row r is q[n] + r * D), at position qbase + r / H:
//     qbase = q_starts[n] (prefill), or kv_lens[n] - Tq (decode, verify,
//     whose kv_lens include the fed tokens);
//   - it sees key k when k <= its position, k < kv_lens[n] and k < the
//     page table's width maxp * TP (the engine's verify rows may overhang
//     their table; those queries are discarded);
//   - scores (q . k) over all D lanes times sm_scale in float32; values are
//     the first R lanes of the same entries; online softmax in float32; a
//     bfloat16 pool multiplies bf16 operands (q, k, the softmax weights, v)
//     with float32 accumulation, a float32 pool multiplies in float32;
//   - output lanes [R, D) are zero (the TPU kernel's accumulator lanes past
//     v_head_dim stay zero), and a row that sees no key yields zeros.
//
// What bounds it on an H100: decode reads each 1280-byte bf16 entry once
// for all 16 heads (~29 FLOPs a byte): device-memory bytes.  Verify at T=5
// (80 query rows, ~144 FLOPs a byte) is still under the ~295 FLOP/byte
// ridge; prefill (T*16 rows a chunk) is bound by tensor-core operations.
//
// Design.  One kernel family, grid (chunk row, query tile, key split):
//   - a block holds up to 64 query rows (M m-tiles of 16, M a template
//     parameter: 1 for decode, 3 for T=5 verify, 4 for prefill; float32
//     blocks hold 16) and walks 32-key tiles of its key range.  Each tile
//     of 640-lane entries is copied once into shared memory (cp.async,
//     double-buffered: 2 x 41 KB) and used as K (all lanes) and as V (the
//     first 512): one read for both, the point of the MLA mode;
//   - S = Q K^T on the tensor cores (mma.sync m16n8k16): the M x 4 score
//     tiles (16 rows x 8 keys) are dealt to the 8 warps, each a 640-deep
//     product with Q and K fragments read from shared memory, the scaled
//     and masked scores stored to shared memory;
//   - online softmax, 4 threads a row, the running max and sum in their
//     registers; the weights, rounded to bf16, go to shared memory;
//   - O += P V on the tensor cores, each warp owning 64 of the 512 value
//     lanes for all M m-tiles (8 * M * 4 accumulators a thread): a 64-row x
//     512-lane float32 accumulator would be 256 registers a thread at 4
//     warps.  Splitting the value lanes across warps and sharing P through
//     shared memory is the public FlashMLA design;
//   - float32 pools run the same loop on the CUDA cores, 16 rows a block,
//     2 value lanes a thread;
//   - a row's keys split over several blocks (decode, verify: sized by the
//     wrapper for one wave, kvc_mla_wave_blocks) write (max, sum, acc) partials that a merge
//     launch combines; a single split (prefill) writes the normalised
//     output directly.
// Not yet done: wgmma, a TMA ring, ldmatrix for the fragments, and folding
// the token store into the attention pass.
#include "kv_common.cuh"

namespace {

using namespace kvc;
using bf16 = __nv_bfloat16;

constexpr int D = 640;             // latent lanes (ops MLA_HEAD_DIM)
constexpr int R = 512;             // value lanes (ops MLA_V_DIM)
constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KT = 32;             // keys per tile (ops MLA_KEY_TILE)
constexpr int MAX_ROWS = 64;       // query rows per bf16 block (ops MLA_ROWS)
constexpr int F32_ROWS = 16;       // query rows per float32 block
constexpr int LD = D + 8;          // bf16 smem row: rows 4 banks apart
constexpr int F_LD = D + 1;        // float32 smem key row
constexpr int S_LD = KT + 1;       // score row (floats)
constexpr int P_LD = KT + 8;       // softmax weight row (bf16)
constexpr int VL = R / WARPS;      // value lanes a warp owns (bf16)
constexpr int TPR = 4;             // softmax threads a row
constexpr int KPT = KT / TPR;      // keys a softmax thread handles
constexpr int WRITE_THREADS = 128;
constexpr int MERGE_THREADS = 128;  // 4 value lanes a thread

static_assert(R % (WARPS * 8) == 0 && D % 16 == 0 && KT % 16 == 0, "tile shapes");
static_assert(MAX_ROWS * TPR <= THREADS, "softmax threads");

// Position of the first query of chunk row n, and its key limit.
__device__ __forceinline__ void row_geometry(const int* q_starts, const int* kv_lens,
                                             int n, int Tq, int width, int& qbase,
                                             int& klim) {
  const int kl = kv_lens[n];
  qbase = q_starts ? q_starts[n] : kl - Tq;
  klim = min(kl, width);
}

// Keys [lo, hi) of query tile z's split s: below the row's limit and the
// causal limit of the tile's last query row.  The attention pass and the
// merge both derive it, so an empty split is never written or read.
__device__ __forceinline__ void tile_keys(int qbase, int klim, int H, int rows,
                                          int qrows, int z, int split, int s,
                                          int& lo, int& hi) {
  const int last = min((z + 1) * qrows, rows) - 1;
  lo = s * split;
  hi = min(min(klim, qbase + last / H + 1), lo + split);
}

// Store the fed tokens' latent entries.  One block per fed token.
template <typename T>
__global__ void __launch_bounds__(WRITE_THREADS) mla_write_kernel(
    const T* __restrict__ k_new,          // [N*Tq, D]
    T* __restrict__ pool,                 // [L, P, 1, TP, D]
    const int* __restrict__ slot_pages,   // [N*Tq]
    const int* __restrict__ slot_offsets, int layer, int num_pages, int TP) {
  const int i = blockIdx.x;
  const int page = slot_pages[i];
  if (page == 0) return;  // the zero page: discard
  constexpr int NV = D * sizeof(T) / 16;
  const size_t dst = (((size_t)layer * num_pages + page) * TP + slot_offsets[i]) * D;
  const uint4* src = reinterpret_cast<const uint4*>(k_new + (size_t)i * D);
  for (int v = threadIdx.x; v < NV; v += WRITE_THREADS)
    reinterpret_cast<uint4*>(pool + dst)[v] = src[v];
}

// One softmax step over a tile: thread (row srow, part spart) takes keys
// [spart * KPT, +KPT) of the row's scores s_row, folds them into its running
// max m and sum l (the same in the row's 4 threads), writes the weights
// through `put` and returns the factor that rescales the row's output.
template <typename Put>
__device__ __forceinline__ float softmax_step(const float* s_row, int spart, float& m,
                                              float& l, Put put) {
  float sv[KPT], mx = -INFINITY;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    sv[j] = s_row[spart * KPT + j];
    mx = fmaxf(mx, sv[j]);
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
  const float m_new = fmaxf(m, mx);
  // a row that has seen nothing yet keeps m = -inf and scale 1
  const float alpha = m_new == -INFINITY ? 1.f : expf(m - m_new);
  float ps = 0.f;
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const float p = sv[j] == -INFINITY ? 0.f : expf(sv[j] - m_new);
    ps += p;
    put(spart * KPT + j, p);
  }
  ps += __shfl_xor_sync(0xffffffffu, ps, 1);
  ps += __shfl_xor_sync(0xffffffffu, ps, 2);
  l = l * alpha + ps;
  m = m_new;
  return alpha;
}

// Copy one KT-key tile of entries into k_s as one cp.async group; rows past
// nk are zeroed (their weights are 0, and 0 * NaN would not be).
__device__ __forceinline__ void copy_tile(bf16* k_s, const bf16* __restrict__ pool,
                                          const int* __restrict__ row_pages,
                                          size_t lbase, int TP, int t0, int nk,
                                          int tid) {
#pragma unroll
  for (int u = 0; u < KT * (D / 8) / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int kr = idx / (D / 8), c = (idx % (D / 8)) * 8;
    bf16* dst = k_s + kr * LD + c;
    if (kr < nk) {
      const int pos = t0 + kr;
      cp_async16(dst, pool + lbase + ((size_t)row_pages[pos / TP] * TP + pos % TP) * D + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// c += the 16-lane slice [c0, c0 + 16) of Q K^T for one (16-row, 8-key)
// score tile: qa at this lane's row gq and column 2 tq of the m-tile in
// q_s, kb at its key gq and column 2 tq of the n-tile in k_s.
__device__ __forceinline__ void score_step(float (&c)[4], const bf16* qa, const bf16* kb,
                                           int c0) {
  const uint32_t a[4] = {*reinterpret_cast<const uint32_t*>(qa + c0),
                         *reinterpret_cast<const uint32_t*>(qa + 8 * LD + c0),
                         *reinterpret_cast<const uint32_t*>(qa + c0 + 8),
                         *reinterpret_cast<const uint32_t*>(qa + 8 * LD + c0 + 8)};
  mma_bf16(c, a, *reinterpret_cast<const uint32_t*>(kb + c0),
           *reinterpret_cast<const uint32_t*>(kb + c0 + 8));
}

template <int M>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (16 * M * LD + 2 * KT * LD + 16 * M * P_LD) +
         sizeof(float) * (16 * M * S_LD + 16 * M);
}

// Attention pass, bfloat16 pools: M m-tiles of query rows on the tensor cores.
template <int M>
__global__ void __launch_bounds__(THREADS) mla_attend_mma_kernel(
    const bf16* __restrict__ q,            // [N, rows, D]
    const bf16* __restrict__ pool,         // [L, P, 1, TP, D]
    const int* __restrict__ page_tables,   // [N, maxp]
    const int* __restrict__ q_starts,      // [N] or null
    const int* __restrict__ kv_lens,       // [N]
    bf16* __restrict__ out,                // [N, rows, D] (a single split)
    float* __restrict__ part_acc,          // [N, S, rows, R] (several splits)
    float* __restrict__ part_ml,           // [N, S, rows, 2]
    int layer, int num_pages, int TP, int maxp, int Tq, int H, int split,
    float sm_scale) {
  constexpr int QR = 16 * M;
  extern __shared__ uint4 smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);               // [QR][LD]
  bf16* const k_buf = q_s + QR * LD;                                 // [2][KT][LD]
  bf16* const p_s = k_buf + 2 * KT * LD;                             // [QR][P_LD]
  float* const s_s = reinterpret_cast<float*>(p_s + QR * P_LD);      // [QR][S_LD]
  float* const a_s = s_s + QR * S_LD;                                // [QR]

  const int n = blockIdx.x, z = blockIdx.y, sp = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;
  const int rows = Tq * H, r0 = z * QR, nrows = min(QR, rows - r0);
  int qbase, klim, lo, hi;
  row_geometry(q_starts, kv_lens, n, Tq, maxp * TP, qbase, klim);
  tile_keys(qbase, klim, H, rows, QR, z, split, sp, lo, hi);
  if (lo >= hi && S > 1) return;  // an empty split: the merge skips it

  const int* row_pages = page_tables + (size_t)n * maxp;
  const size_t lbase = (size_t)layer * num_pages * TP * D;
  if (lo < hi) copy_tile(k_buf, pool, row_pages, lbase, TP, lo, min(KT, hi - lo), tid);
  const bf16* qrow = q + ((size_t)n * rows + r0) * D;
  for (int i = tid; i < QR * (D / 8); i += THREADS) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(q_s + r * LD + c) =
        r < nrows ? *reinterpret_cast<const uint4*>(qrow + (size_t)r * D + c)
                  : make_uint4(0, 0, 0, 0);
  }

  float o[M][VL / 8][4];
#pragma unroll
  for (int mt = 0; mt < M; ++mt)
#pragma unroll
    for (int j = 0; j < VL / 8; ++j) o[mt][j][0] = o[mt][j][1] = o[mt][j][2] = o[mt][j][3] = 0.f;
  const int srow = tid / TPR, spart = tid % TPR;  // this thread's softmax row
  float m_run = -INFINITY, l_run = 0.f;

  for (int t0 = lo, buf = 0; t0 < hi; t0 += KT, buf ^= 1) {
    const int nk = min(KT, hi - t0);
    // the next tile's copies fly during this tile's math; the other buffer
    // was released by the barrier that ended the previous tile
    if (t0 + KT < hi) {
      copy_tile(k_buf + (buf ^ 1) * KT * LD, pool, row_pages, lbase, TP, t0 + KT,
                min(KT, hi - t0 - KT), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, the first time, q_s) landed
    const bf16* k_s = k_buf + buf * KT * LD;

    // 1. S = Q K^T, one (16-row, 8-key) score tile per warp and turn; two
    //    accumulators halve the dependent mma chain
    for (int pair = warp; pair < M * (KT / 8); pair += WARPS) {
      const int mt = pair / (KT / 8), nt = pair % (KT / 8);
      const bf16* qa = q_s + (mt * 16 + gq) * LD + 2 * tq;
      const bf16* kb = k_s + (nt * 8 + gq) * LD + 2 * tq;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ks += 2) {
        score_step(c0, qa, kb, ks * 16);
        score_step(c1, qa, kb, ks * 16 + 16);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = mt * 16 + gq + 8 * (e / 2), col = nt * 8 + 2 * tq + (e % 2);
        const bool ok = row < nrows && col < nk && t0 + col <= qbase + (r0 + row) / H;
        s_s[row * S_LD + col] = ok ? (c0[e] + c1[e]) * sm_scale : -INFINITY;
      }
    }
    __syncthreads();

    // 2. online softmax; weights rounded to bf16
    if (srow < QR) {
      bf16* p_row = p_s + srow * P_LD;
      const float alpha = softmax_step(s_s + srow * S_LD, spart, m_run, l_run,
                                       [&](int k, float p) { p_row[k] = from_f<bf16>(p); });
      if (spart == 0) a_s[srow] = alpha;
    }
    __syncthreads();

    // 3. O = O * alpha + P V over this warp's 64 value lanes
#pragma unroll
    for (int mt = 0; mt < M; ++mt) {
      const float a0 = a_s[mt * 16 + gq], a1 = a_s[mt * 16 + gq + 8];
#pragma unroll
      for (int dn = 0; dn < VL / 8; ++dn) {
        o[mt][dn][0] *= a0;
        o[mt][dn][1] *= a0;
        o[mt][dn][2] *= a1;
        o[mt][dn][3] *= a1;
      }
#pragma unroll
      for (int j = 0; j < KT / 16; ++j) {
        const bf16* pr = p_s + (mt * 16 + gq) * P_LD + j * 16 + 2 * tq;
        const uint32_t pa[4] = {*reinterpret_cast<const uint32_t*>(pr),
                                *reinterpret_cast<const uint32_t*>(pr + 8 * P_LD),
                                *reinterpret_cast<const uint32_t*>(pr + 8),
                                *reinterpret_cast<const uint32_t*>(pr + 8 * P_LD + 8)};
        const bf16* vr = k_s + (j * 16 + 2 * tq) * LD + warp * VL + gq;
#pragma unroll
        for (int dn = 0; dn < VL / 8; ++dn) {
          const bf16* v = vr + dn * 8;
          mma_bf16(o[mt][dn], pa, pack_halves(v, v + LD),
                   pack_halves(v + 8 * LD, v + 9 * LD));
        }
      }
    }
    __syncthreads();  // this buffer, s_s and p_s are consumed
  }

  // each row's max and sum, from its softmax threads, for every warp
  if (srow < QR && spart == 0) {
    s_s[srow * S_LD] = m_run;
    s_s[srow * S_LD + 1] = l_run;
  }
  __syncthreads();
  const size_t prow = ((size_t)n * S + sp) * rows + r0;  // first partial row
#pragma unroll
  for (int mt = 0; mt < M; ++mt) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = mt * 16 + gq + 8 * i;
      if (row >= nrows) continue;
      const float l = s_s[row * S_LD + 1];
      if (S == 1) {
        const float inv = 1.f / (l == 0.f ? 1.f : l);
        bf16* orow = out + ((size_t)n * rows + r0 + row) * D + warp * VL + 2 * tq;
#pragma unroll
        for (int dn = 0; dn < VL / 8; ++dn)
          *reinterpret_cast<uint32_t*>(orow + dn * 8) =
              pack_bf16(o[mt][dn][2 * i] * inv, o[mt][dn][2 * i + 1] * inv);
      } else {
        float* acc = part_acc + (prow + row) * R + warp * VL + 2 * tq;
#pragma unroll
        for (int dn = 0; dn < VL / 8; ++dn)
          *reinterpret_cast<float2*>(acc + dn * 8) =
              make_float2(o[mt][dn][2 * i], o[mt][dn][2 * i + 1]);
        if (warp == 0 && tq == 0) {
          part_ml[2 * (prow + row)] = s_s[row * S_LD];
          part_ml[2 * (prow + row) + 1] = l;
        }
      }
    }
  }
  if (S == 1) {  // lanes past the values are zero
    for (int i = tid; i < nrows * (D - R) / 8; i += THREADS) {
      const int r = i / ((D - R) / 8), c = R + (i % ((D - R) / 8)) * 8;
      *reinterpret_cast<uint4*>(out + ((size_t)n * rows + r0 + r) * D + c) =
          make_uint4(0, 0, 0, 0);
    }
  }
}

constexpr size_t kF32Smem =
    sizeof(float) * ((size_t)F32_ROWS * D + (size_t)KT * F_LD + F32_ROWS * S_LD + F32_ROWS);

// Attention pass, float32 pools: CUDA cores, 16 query rows, 2 value lanes a
// thread.  Scores: warp w takes rows 2w and 2w + 1, a lane one key.
__global__ void __launch_bounds__(THREADS) mla_attend_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ pool,
    const int* __restrict__ page_tables, const int* __restrict__ q_starts,
    const int* __restrict__ kv_lens, float* __restrict__ out,
    float* __restrict__ part_acc, float* __restrict__ part_ml, int layer,
    int num_pages, int TP, int maxp, int Tq, int H, int split, float sm_scale) {
  constexpr int QR = F32_ROWS;
  static_assert(QR == 2 * WARPS && KT == 32 && R == 2 * THREADS, "f32 thread map");
  extern __shared__ float fsm[];
  float* const q_s = fsm;                 // [QR][D]
  float* const k_s = q_s + QR * D;        // [KT][F_LD]
  float* const s_s = k_s + KT * F_LD;     // [QR][S_LD]: scores, then weights
  float* const a_s = s_s + QR * S_LD;     // [QR]

  const int n = blockIdx.x, z = blockIdx.y, sp = blockIdx.z, S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rows = Tq * H, r0 = z * QR, nrows = min(QR, rows - r0);
  int qbase, klim, lo, hi;
  row_geometry(q_starts, kv_lens, n, Tq, maxp * TP, qbase, klim);
  tile_keys(qbase, klim, H, rows, QR, z, split, sp, lo, hi);
  if (lo >= hi && S > 1) return;

  const float* qrow = q + ((size_t)n * rows + r0) * D;
  for (int i = tid; i < QR * D; i += THREADS)
    q_s[i] = i / D < nrows ? qrow[i] : 0.f;
  const int* row_pages = page_tables + (size_t)n * maxp;
  const size_t lbase = (size_t)layer * num_pages * TP * D;
  float acc[QR][2];
#pragma unroll
  for (int r = 0; r < QR; ++r) acc[r][0] = acc[r][1] = 0.f;
  const int srow = tid / TPR, spart = tid % TPR;
  float m_run = -INFINITY, l_run = 0.f;

  for (int t0 = lo; t0 < hi; t0 += KT) {
    const int nk = min(KT, hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = tid; i < KT * (D / 4); i += THREADS) {
      const int kr = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (kr < nk) {
        const int pos = t0 + kr;
        v = *reinterpret_cast<const float4*>(
            pool + lbase + ((size_t)row_pages[pos / TP] * TP + pos % TP) * D + c);
      }
      float* dst = k_s + kr * F_LD + c;
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int row = 2 * warp + j;
      const float* qr = q_s + row * D;
      const float* kr = k_s + lane * F_LD;
      float dot = 0.f;
#pragma unroll 16
      for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kr[e], dot);
      const bool ok = row < nrows && lane < nk && t0 + lane <= qbase + (r0 + row) / H;
      s_s[row * S_LD + lane] = ok ? dot * sm_scale : -INFINITY;
    }
    __syncthreads();
    if (srow < QR) {
      float* row = s_s + srow * S_LD;
      const float alpha =
          softmax_step(row, spart, m_run, l_run, [&](int k, float p) { row[k] = p; });
      if (spart == 0) a_s[srow] = alpha;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < QR; ++r) {
      const float* pr = s_s + r * S_LD;
      float pv0 = 0.f, pv1 = 0.f;
#pragma unroll 8
      for (int k = 0; k < KT; ++k) {
        pv0 = fmaf(pr[k], k_s[k * F_LD + tid], pv0);
        pv1 = fmaf(pr[k], k_s[k * F_LD + tid + THREADS], pv1);
      }
      acc[r][0] = acc[r][0] * a_s[r] + pv0;
      acc[r][1] = acc[r][1] * a_s[r] + pv1;
    }
  }
  __syncthreads();
  if (srow < QR && spart == 0) {
    s_s[srow * S_LD] = m_run;
    s_s[srow * S_LD + 1] = l_run;
  }
  __syncthreads();
  const size_t prow = ((size_t)n * S + sp) * rows + r0;
#pragma unroll
  for (int r = 0; r < QR; ++r) {
    if (r >= nrows) continue;
    const float l = s_s[r * S_LD + 1];
    if (S == 1) {
      const float inv = 1.f / (l == 0.f ? 1.f : l);
      float* orow = out + ((size_t)n * rows + r0 + r) * D;
      orow[tid] = acc[r][0] * inv;
      orow[tid + THREADS] = acc[r][1] * inv;
      if (tid < D - R) orow[R + tid] = 0.f;
    } else {
      float* pa = part_acc + (prow + r) * R;
      pa[tid] = acc[r][0];
      pa[tid + THREADS] = acc[r][1];
      if (tid == 0) {
        part_ml[2 * (prow + r)] = s_s[r * S_LD];
        part_ml[2 * (prow + r) + 1] = l;
      }
    }
  }
}

// Merge: combine the non-empty splits of one query row.  Grid (row n,
// query row), 4 value lanes a thread.
template <typename T>
__global__ void __launch_bounds__(MERGE_THREADS) mla_merge_kernel(
    const float* __restrict__ part_acc, const float* __restrict__ part_ml,
    const int* __restrict__ q_starts, const int* __restrict__ kv_lens,
    T* __restrict__ out, int Tq, int H, int width, int qrows, int split, int S) {
  static_assert(R == 4 * MERGE_THREADS && D - R <= MERGE_THREADS, "merge thread map");
  const int n = blockIdx.x, r = blockIdx.y, tid = threadIdx.x;
  const int rows = Tq * H, z = r / qrows;
  int qbase, klim;
  row_geometry(q_starts, kv_lens, n, Tq, width, qbase, klim);
  const size_t row0 = (size_t)n * S * rows + r;  // partial row of split s: row0 + s * rows
  float M = -INFINITY;
  for (int s = 0; s < S; ++s) {
    int lo, hi;
    tile_keys(qbase, klim, H, rows, qrows, z, split, s, lo, hi);
    if (lo < hi) M = fmaxf(M, part_ml[2 * (row0 + (size_t)s * rows)]);
  }
  float L = 0.f;
  float4 A = make_float4(0.f, 0.f, 0.f, 0.f);
  if (M != -INFINITY) {
    for (int s = 0; s < S; ++s) {
      int lo, hi;
      tile_keys(qbase, klim, H, rows, qrows, z, split, s, lo, hi);
      if (lo >= hi) continue;
      const size_t pr = row0 + (size_t)s * rows;
      const float ms = part_ml[2 * pr];
      const float w = ms == -INFINITY ? 0.f : expf(ms - M);
      L += part_ml[2 * pr + 1] * w;
      const float4 a = reinterpret_cast<const float4*>(part_acc + pr * R)[tid];
      A.x += a.x * w;
      A.y += a.y * w;
      A.z += a.z * w;
      A.w += a.w * w;
    }
  }
  const float inv = 1.f / (L == 0.f ? 1.f : L);
  T* orow = out + ((size_t)n * rows + r) * D;
  orow[4 * tid] = from_f<T>(A.x * inv);
  orow[4 * tid + 1] = from_f<T>(A.y * inv);
  orow[4 * tid + 2] = from_f<T>(A.z * inv);
  orow[4 * tid + 3] = from_f<T>(A.w * inv);
  if (tid < D - R) orow[R + tid] = from_f<T>(0.f);
}

struct Args {
  const void *q, *pool, *page_tables, *q_starts, *kv_lens;
  void *out;
  float *part_acc, *part_ml;
  int layer, num_pages, TP, maxp, Tq, H, split;
  float sm_scale;
};

// Allow each attention kernel its dynamic shared memory (above 48 KB), once.
template <int M>
cudaError_t configure_bf16() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attend_mma_kernel<M>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem_bytes<M>());
  done = e == cudaSuccess;
  return e;
}

cudaError_t configure_f32() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attend_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32Smem);
  done = e == cudaSuccess;
  return e;
}

// Blocks of a configured attention kernel (e: the result of configuring it)
// that the current device runs at once: its SMs times the blocks one SM
// holds, registers and shared memory permitting.
template <typename K>
int wave_blocks(cudaError_t e, K kernel, size_t smem, int* blocks) {
  int dev = 0, sms = 0, per_sm = 0;
  if (e == cudaSuccess) e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
  if (e == cudaSuccess) *blocks = sms * per_sm;
  return (int)e;
}

template <int M>
int attend_bf16(dim3 grid, const Args& a, cudaStream_t stream) {
  const cudaError_t e = configure_bf16<M>();
  if (e != cudaSuccess) return (int)e;
  mla_attend_mma_kernel<M><<<grid, THREADS, mma_smem_bytes<M>(), stream>>>(
      (const bf16*)a.q, (const bf16*)a.pool, (const int*)a.page_tables,
      (const int*)a.q_starts, (const int*)a.kv_lens, (bf16*)a.out, a.part_acc,
      a.part_ml, a.layer, a.num_pages, a.TP, a.maxp, a.Tq, a.H, a.split, a.sm_scale);
  return (int)cudaGetLastError();
}

int attend_f32(dim3 grid, const Args& a, cudaStream_t stream) {
  const cudaError_t e = configure_f32();
  if (e != cudaSuccess) return (int)e;
  mla_attend_f32_kernel<<<grid, THREADS, kF32Smem, stream>>>(
      (const float*)a.q, (const float*)a.pool, (const int*)a.page_tables,
      (const int*)a.q_starts, (const int*)a.kv_lens, (float*)a.out, a.part_acc,
      a.part_ml, a.layer, a.num_pages, a.TP, a.maxp, a.Tq, a.H, a.split, a.sm_scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const Args& a, const void* k_new, const void* slot_pages,
           const void* slot_offsets, int N, int qrows, cudaStream_t stream) {
  if (k_new) {
    mla_write_kernel<T><<<N * a.Tq, WRITE_THREADS, 0, stream>>>(
        (const T*)k_new, (T*)a.pool, (const int*)slot_pages, (const int*)slot_offsets,
        a.layer, a.num_pages, a.TP);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = a.Tq * a.H, width = a.maxp * a.TP;
  const int S = width > a.split ? (width + a.split - 1) / a.split : 1;
  const dim3 grid(N, (rows + qrows - 1) / qrows, S);
  int rc;
  if (sizeof(T) == 4) {
    rc = attend_f32(grid, a, stream);
  } else {
    switch (qrows / 16) {
      case 1: rc = attend_bf16<1>(grid, a, stream); break;
      case 2: rc = attend_bf16<2>(grid, a, stream); break;
      case 3: rc = attend_bf16<3>(grid, a, stream); break;
      default: rc = attend_bf16<4>(grid, a, stream); break;
    }
  }
  if (rc != 0 || S == 1) return rc;
  mla_merge_kernel<T><<<dim3(N, rows), MERGE_THREADS, 0, stream>>>(
      a.part_acc, a.part_ml, (const int*)a.q_starts, (const int*)a.kv_lens, (T*)a.out,
      a.Tq, a.H, width, qrows, a.split, S);
  return (int)cudaGetLastError();
}

bool valid_rows(bool f32, int qrows) {
  return f32 ? qrows == F32_ROWS : qrows >= 16 && qrows <= MAX_ROWS && qrows % 16 == 0;
}

}  // namespace

// Blocks of the attention pass for (dtype, qrows a block) that the current
// device runs at once; the wrapper sizes the key split of decode and
// verify for one such wave.
extern "C" int kvc_mla_wave_blocks(int dtype, int qrows, int* blocks) {
  const bool f32 = dtype == kvc::kF32;
  if (!valid_rows(f32, qrows) || (!f32 && dtype != kvc::kBF16))
    return (int)cudaErrorInvalidValue;
  if (f32) return wave_blocks(configure_f32(), mla_attend_f32_kernel, kF32Smem, blocks);
  switch (qrows / 16) {
    case 1:
      return wave_blocks(configure_bf16<1>(), mla_attend_mma_kernel<1>, mma_smem_bytes<1>(),
                         blocks);
    case 2:
      return wave_blocks(configure_bf16<2>(), mla_attend_mma_kernel<2>, mma_smem_bytes<2>(),
                         blocks);
    case 3:
      return wave_blocks(configure_bf16<3>(), mla_attend_mma_kernel<3>, mma_smem_bytes<3>(),
                         blocks);
    default:
      return wave_blocks(configure_bf16<4>(), mla_attend_mma_kernel<4>, mma_smem_bytes<4>(),
                         blocks);
  }
}

// q, out [N, Tq, H, D]; pool [L, P, 1, TP, D]; q_starts null for decode /
// verify rows; k_new [N, Tq, D] with slot_pages / slot_offsets [N, Tq], or
// all three null (no write).  qrows: query rows a block (a multiple of 16
// up to 64 for bf16, 16 for float32).  split: keys a block, a multiple of
// 32; with S = ceil(maxp * TP / split) > 1 splits, scratch holds
// N * S * Tq * H * (R + 2) floats (the wrapper allocates it).
extern "C" int kvc_mla_attend(
    int dtype, const void* q, void* pool, const void* page_tables,
    const void* q_starts, const void* kv_lens, const void* k_new,
    const void* slot_pages, const void* slot_offsets, void* out, void* scratch,
    int N, int Tq, int H, int layer, int num_pages, int TP, int maxp, int qrows,
    int split, float sm_scale, void* stream) {
  if (Tq < 1 || H < 1 || maxp < 1 || split < KT || split % KT) return (int)cudaErrorInvalidValue;
  const bool f32 = dtype == kvc::kF32;
  if (!valid_rows(f32, qrows)) return (int)cudaErrorInvalidValue;
  const int S = maxp * TP > split ? (maxp * TP + split - 1) / split : 1;
  if (S > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t part_rows = (size_t)N * S * Tq * H;
  float* part_acc = (float*)scratch;  // first: vector stores stay aligned
  Args a{q, pool, page_tables, q_starts, kv_lens, out, part_acc,
         part_acc ? part_acc + part_rows * R : nullptr,
         layer, num_pages, TP, maxp, Tq, H, split, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (f32) return launch<float>(a, k_new, slot_pages, slot_offsets, N, qrows, s);
  if (dtype == kvc::kBF16)
    return launch<bf16>(a, k_new, slot_pages, slot_offsets, N, qrows, s);
  return (int)cudaErrorInvalidValue;
}
