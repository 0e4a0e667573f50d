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
// Byte latent pools (int8, e4m3; the mode the reference runs for int8 and
// float8_e4m3fn pools):
//   - a fed entry is stored as the reference stores it: int8
//     clip(round(x / k_sc), -127, 127) with the layer's K scale k_sc (NaN
//     as 0), e4m3 the value rounded to nearest even with NaN past 464
//     (kvc::store_f); q comes in bf16 and the entries in float32;
//   - the values are the same entries, so k_sc is the only scale: scores
//     are (q . k) * sm_scale * k_sc, the output is (p . v) * k_sc / l;
//   - the operands are bf16 (q, the widened entries, the softmax weights)
//     with float32 accumulation, even for a float32 model, and the output
//     is float32.
//
// What bounds it on an H100: decode reads each 1280-byte bf16 entry (640
// bytes in a byte pool) once for all 16 heads (~29 FLOPs a byte at bf16):
// device-memory bytes.  Verify at T=5 (80 query rows, ~144 FLOPs a byte at
// bf16, ~288 in a byte pool) is still at or under the ~295 FLOP/byte ridge;
// prefill (T*16 rows a chunk) is bound by tensor-core operations.
//
// Design.  One kernel family, grid (chunk row, query tile, key split):
//   - a block holds up to 64 query rows (M m-tiles of 16, M a template
//     parameter: 1 for decode, 3 for T=5 verify, 4 for prefill; float32
//     blocks hold 16) and walks 32-key tiles of its key range.  Each tile
//     of 640-lane entries is copied once into shared memory as the pool
//     stores it (cp.async, double-buffered: 2 x 41 KB at bf16, 2 x 21 KB
//     for a byte pool) and used as K (all lanes) and as V (the first 512):
//     one read for both, the point of the MLA mode;
//   - S = Q K^T on the tensor cores (mma.sync m16n8k16): the M x 4 score
//     tiles (16 rows x 8 keys) are dealt to the 8 warps, a warp keeping one
//     column of 8 keys for its m-tiles, so each K fragment is read (and,
//     from a byte pool, widened to bf16) once for all of them; each tile is
//     a 640-deep product, the scaled and masked scores stored to shared
//     memory;
//   - online softmax, 4 threads a row, the running max and sum in their
//     registers; the weights, rounded to bf16, go to shared memory;
//   - O += P V on the tensor cores, each warp owning 64 of the 512 value
//     lanes for all M m-tiles (8 * M * 4 accumulators a thread), each V
//     fragment read (and widened) once for all M: a 64-row x 512-lane
//     float32 accumulator would be 256 registers a thread at 4 warps.
//     Splitting the value lanes across warps and sharing P through shared
//     memory is the public FlashMLA design;
//   - byte pools keep the double buffer: the raw entries are staged by
//     cp.async and widened to bf16 only as the fragments are built, from
//     shared memory;
//   - float32 pools run the same loop on the CUDA cores, 16 rows a block,
//     2 value lanes a thread;
//   - a row's keys split over several blocks (decode, verify: sized by the
//     wrapper for one wave, kvc_mla_wave_blocks) write (max, sum, acc)
//     partials that a merge launch combines; a single split (prefill) writes
//     the normalised output directly.
// Not yet done: wgmma, a TMA ring, ldmatrix for the fragments, native byte
// operands, and folding the token store into the attention pass.
#include <type_traits>

#include "kv_common.cuh"

namespace {

using namespace kvc;
using bf16 = __nv_bfloat16;

constexpr int D = 640;             // latent lanes (ops MLA_HEAD_DIM)
constexpr int R = 512;             // value lanes (ops MLA_V_DIM)
constexpr int THREADS = 256;       // 8 warps
constexpr int WARPS = THREADS / 32;
constexpr int KT = 32;             // keys per tile (ops MLA_KEY_TILE)
constexpr int MAX_ROWS = 64;       // query rows per tensor-core block (ops MLA_ROWS)
constexpr int F32_ROWS = 16;       // query rows per float32 block
constexpr int LD = D + 8;          // bf16 smem row: rows 4 banks apart
constexpr int LDB = D + 16;        // byte smem key row: rows 4 banks apart, 16-byte aligned
constexpr int F_LD = D + 1;        // float32 smem key row
constexpr int S_LD = KT + 1;       // score row (floats)
constexpr int P_LD = KT + 8;       // softmax weight row (bf16)
constexpr int VL = R / WARPS;      // value lanes a warp owns (bf16)
constexpr int TPR = 4;             // softmax threads a row
constexpr int KPT = KT / TPR;      // keys a softmax thread handles
constexpr int NT = KT / 8;         // score tile columns (8 keys each)
constexpr int MSTEP = WARPS / NT;  // m-tiles between a warp's score tiles
constexpr int WRITE_THREADS = 128;
constexpr int MERGE_THREADS = 128;  // 4 value lanes a thread

static_assert(R % (WARPS * 8) == 0 && D % 16 == 0 && KT % 16 == 0, "tile shapes");
static_assert(MAX_ROWS * TPR <= THREADS, "softmax threads");
static_assert(WARPS % NT == 0, "score tiles: a warp keeps one key column");

// Elements of a shared-memory key row of pool type P.
template <typename P>
constexpr int KEY_LD = sizeof(P) == 1 ? LDB : LD;

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

// Store the fed tokens' latent entries, one block per fed token: copied for
// float32 and bf16 pools, quantized from float32 for byte pools (k_sc: the
// layer's int8 K scale, 1 without scales).
template <typename P>
__global__ void __launch_bounds__(WRITE_THREADS) mla_write_kernel(
    const typename Types<P>::New* __restrict__ k_new,  // [N*Tq, D]
    P* __restrict__ pool,                 // [L, P, 1, TP, D]
    const int* __restrict__ slot_pages,   // [N*Tq]
    const int* __restrict__ slot_offsets, const float* __restrict__ k_scales,
    int layer, int num_pages, int TP) {
  const int i = blockIdx.x;
  const int page = slot_pages[i];
  if (page == 0) return;  // the zero page: discard
  const size_t dst = (((size_t)layer * num_pages + page) * TP + slot_offsets[i]) * D;
  uint4* to = reinterpret_cast<uint4*>(pool + dst);
  if constexpr (sizeof(P) == 1) {
    const float k_sc = k_scales ? k_scales[layer] : 1.f;
    const float4* src = reinterpret_cast<const float4*>(k_new + (size_t)i * D);
    for (int v = threadIdx.x; v < D / 16; v += WRITE_THREADS)
      to[v] = make_uint4(store4<P>(src[4 * v], k_sc), store4<P>(src[4 * v + 1], k_sc),
                         store4<P>(src[4 * v + 2], k_sc), store4<P>(src[4 * v + 3], k_sc));
  } else {
    constexpr int NV = D * sizeof(P) / 16;
    const uint4* src = reinterpret_cast<const uint4*>(k_new + (size_t)i * D);
    for (int v = threadIdx.x; v < NV; v += WRITE_THREADS) to[v] = src[v];
  }
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

// Copy one KT-key tile of entries into k_s as one cp.async group, as the
// pool stores them (rows of KEY_LD<P> elements); rows past nk are zeroed
// (their weights are 0, and 0 * NaN would not be).
template <typename P>
__device__ __forceinline__ void copy_tile(P* k_s, const P* __restrict__ pool,
                                          const int* __restrict__ row_pages,
                                          size_t lbase, int TP, int t0, int nk,
                                          int tid) {
  constexpr int CH = D * (int)sizeof(P) / 16;  // 16-byte chunks an entry
  constexpr int EL = 16 / (int)sizeof(P);      // elements a chunk
  static_assert(KT * CH % THREADS == 0, "copy map");
#pragma unroll
  for (int u = 0; u < KT * CH / THREADS; ++u) {
    const int idx = tid + u * THREADS;
    const int kr = idx / CH, c = (idx % CH) * EL;
    P* dst = k_s + kr * KEY_LD<P> + c;
    if (kr < nk) {
      const int pos = t0 + kr;
      cp_async16(dst, pool + lbase + ((size_t)row_pages[pos / TP] * TP + pos % TP) * D + c);
    } else {
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// B-fragment word of two neighbouring lanes (p[0] low, p[1] high) of one key
// row, as bf16: widened from a byte pool (int8 and e4m3 values are exact in
// bf16).
template <typename P>
__device__ __forceinline__ uint32_t key_pair(const P* p);
template <>
__device__ __forceinline__ uint32_t key_pair<bf16>(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
template <>
__device__ __forceinline__ uint32_t key_pair<int8_t>(const int8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
  return pack_bf16(byte_f<int8_t>(w, 0), byte_f<int8_t>(w, 1));
}
template <>
__device__ __forceinline__ uint32_t key_pair<e4m3>(const e4m3* p) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      *reinterpret_cast<const __nv_fp8x2_storage_t*>(p), __NV_E4M3);
  const float2 f = __half22float2(__half2(h));
  return pack_bf16(f.x, f.y);
}

// B-fragment word of one lane of two key rows (lo low, hi high), as bf16.
template <typename P>
__device__ __forceinline__ uint32_t lane_pair(const P* lo, const P* hi) {
  if constexpr (std::is_same<P, bf16>::value) {
    return pack_halves(lo, hi);
  } else {
    return pack_bf16(to_f<P>(*lo), to_f<P>(*hi));
  }
}

// A fragment of Q's 16-lane slice [c0, c0 + 16) at this lane's row gq and
// column 2 tq of an m-tile in q_s.
__device__ __forceinline__ void q_frag(uint32_t (&a)[4], const bf16* qa, int c0) {
  a[0] = *reinterpret_cast<const uint32_t*>(qa + c0);
  a[1] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + c0);
  a[2] = *reinterpret_cast<const uint32_t*>(qa + c0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(qa + 8 * LD + c0 + 8);
}

// two output values of one row at o (o[0], o[1])
__device__ __forceinline__ void store2(bf16* o, float a, float b) {
  *reinterpret_cast<uint32_t*>(o) = pack_bf16(a, b);
}
__device__ __forceinline__ void store2(float* o, float a, float b) {
  *reinterpret_cast<float2*>(o) = make_float2(a, b);
}

template <int M, typename P>
constexpr size_t mma_smem_bytes() {
  return sizeof(bf16) * (16 * M * LD + 16 * M * P_LD) + sizeof(P) * 2 * KT * KEY_LD<P> +
         sizeof(float) * (16 * M * S_LD + 16 * M);
}

// Attention pass on the tensor cores, bf16 and byte pools: M m-tiles of
// query rows.
template <int M, typename P>
__global__ void __launch_bounds__(THREADS) mla_attend_mma_kernel(
    const bf16* __restrict__ q,            // [N, rows, D]
    const P* __restrict__ pool,            // [L, P, 1, TP, D]
    const int* __restrict__ page_tables,   // [N, maxp]
    const int* __restrict__ q_starts,      // [N] or null
    const int* __restrict__ kv_lens,       // [N]
    const float* __restrict__ k_scales,    // [L] int8 K scales, or null
    typename Types<P>::Out* __restrict__ out,  // [N, rows, D] (a single split)
    float* __restrict__ part_acc,          // [N, S, rows, R] (several splits)
    float* __restrict__ part_ml,           // [N, S, rows, 2]
    int layer, int num_pages, int TP, int maxp, int Tq, int H, int split,
    float sm_scale) {
  constexpr int QR = 16 * M, KL = KEY_LD<P>;
  constexpr int MW = (M + MSTEP - 1) / MSTEP;  // m-tiles a warp scores, at most
  extern __shared__ uint4 smem_raw[];
  bf16* const q_s = reinterpret_cast<bf16*>(smem_raw);               // [QR][LD]
  P* const k_buf = reinterpret_cast<P*>(q_s + QR * LD);              // [2][KT][KL]
  bf16* const p_s = reinterpret_cast<bf16*>(k_buf + 2 * KT * KL);    // [QR][P_LD]
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
  const float k_sc = k_scales ? k_scales[layer] : 1.f;

  const int* row_pages = page_tables + (size_t)n * maxp;
  const size_t lbase = (size_t)layer * num_pages * TP * D;
  if (lo < hi) copy_tile<P>(k_buf, pool, row_pages, lbase, TP, lo, min(KT, hi - lo), tid);
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
  // this warp's score tiles: key column nt of m-tiles mt0, mt0 + MSTEP, ...
  const int nt = warp % NT, mt0 = warp / NT;

  for (int t0 = lo, buf = 0; t0 < hi; t0 += KT, buf ^= 1) {
    const int nk = min(KT, hi - t0);
    // the next tile's copies fly during this tile's math; the other buffer
    // was released by the barrier that ended the previous tile
    if (t0 + KT < hi) {
      copy_tile<P>(k_buf + (buf ^ 1) * KT * KL, pool, row_pages, lbase, TP, t0 + KT,
                   min(KT, hi - t0 - KT), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile (and, the first time, q_s) landed
    const P* k_s = k_buf + buf * KT * KL;

    // 1. S = Q K^T: each K fragment serves the warp's m-tiles; two
    //    accumulators a tile halve the dependent mma chain.  A warp without
    //    an m-tile (half of them at M = 1) skips the loop and its K loads,
    //    which otherwise slow decode on an H100 (PERF.md §6)
    if (mt0 < M) {
      float c[MW][2][4];
#pragma unroll
      for (int i = 0; i < MW; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) c[i][0][e] = c[i][1][e] = 0.f;
      const P* kb = k_s + (nt * 8 + gq) * KL + 2 * tq;
#pragma unroll 4
      for (int ks = 0; ks < D / 16; ks += 2) {
        const uint32_t b0 = key_pair<P>(kb + ks * 16), b1 = key_pair<P>(kb + ks * 16 + 8);
        const uint32_t b2 = key_pair<P>(kb + ks * 16 + 16), b3 = key_pair<P>(kb + ks * 16 + 24);
#pragma unroll
        for (int i = 0; i < MW; ++i) {
          const int mt = mt0 + MSTEP * i;
          if (mt < M) {
            const bf16* qa = q_s + (mt * 16 + gq) * LD + 2 * tq;
            uint32_t a[4];
            q_frag(a, qa, ks * 16);
            mma_bf16(c[i][0], a, b0, b1);
            q_frag(a, qa, ks * 16 + 16);
            mma_bf16(c[i][1], a, b2, b3);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < MW; ++i) {
        const int mt = mt0 + MSTEP * i;
        if (mt >= M) continue;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = mt * 16 + gq + 8 * (e / 2), col = nt * 8 + 2 * tq + (e % 2);
          const bool ok = row < nrows && col < nk && t0 + col <= qbase + (r0 + row) / H;
          s_s[row * S_LD + col] = ok ? (c[i][0][e] + c[i][1][e]) * sm_scale * k_sc : -INFINITY;
        }
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

    // 3. O = O * alpha + P V over this warp's 64 value lanes; each V
    //    fragment serves all M m-tiles
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
    }
#pragma unroll
    for (int j = 0; j < KT / 16; ++j) {
      uint32_t pa[M][4];
#pragma unroll
      for (int mt = 0; mt < M; ++mt) {
        const bf16* pr = p_s + (mt * 16 + gq) * P_LD + j * 16 + 2 * tq;
        pa[mt][0] = *reinterpret_cast<const uint32_t*>(pr);
        pa[mt][1] = *reinterpret_cast<const uint32_t*>(pr + 8 * P_LD);
        pa[mt][2] = *reinterpret_cast<const uint32_t*>(pr + 8);
        pa[mt][3] = *reinterpret_cast<const uint32_t*>(pr + 8 * P_LD + 8);
      }
      const P* vr = k_s + (j * 16 + 2 * tq) * KL + warp * VL + gq;
#pragma unroll
      for (int dn = 0; dn < VL / 8; ++dn) {
        const P* v = vr + dn * 8;
        const uint32_t b0 = lane_pair<P>(v, v + KL), b1 = lane_pair<P>(v + 8 * KL, v + 9 * KL);
#pragma unroll
        for (int mt = 0; mt < M; ++mt) mma_bf16(o[mt][dn], pa[mt], b0, b1);
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
        auto* orow = out + ((size_t)n * rows + r0 + row) * D + warp * VL + 2 * tq;
#pragma unroll
        for (int dn = 0; dn < VL / 8; ++dn)
          store2(orow + dn * 8, o[mt][dn][2 * i] * k_sc * inv, o[mt][dn][2 * i + 1] * k_sc * inv);
      } else {
        float* acc = part_acc + (prow + row) * R + warp * VL + 2 * tq;
#pragma unroll
        for (int dn = 0; dn < VL / 8; ++dn)
          store2(acc + dn * 8, o[mt][dn][2 * i] * k_sc, o[mt][dn][2 * i + 1] * k_sc);
        if (warp == 0 && tq == 0) {
          part_ml[2 * (prow + row)] = s_s[row * S_LD];
          part_ml[2 * (prow + row) + 1] = l;
        }
      }
    }
  }
  if (S == 1) {  // lanes past the values are zero
    constexpr int ZV = (D - R) * (int)sizeof(typename Types<P>::Out) / 16;  // a row's 16-byte stores
    for (int i = tid; i < nrows * ZV; i += THREADS) {
      const int r = i / ZV, c = i % ZV;
      reinterpret_cast<uint4*>(out + ((size_t)n * rows + r0 + r) * D + R)[c] =
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
  const float* k_scales;
  void *out;
  float *part_acc, *part_ml;
  int layer, num_pages, TP, maxp, Tq, H, split;
  float sm_scale;
};

// Allow each attention kernel its dynamic shared memory (above 48 KB), once.
template <int M, typename P>
cudaError_t configure_mma() {
  static bool done = false;
  if (done) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(
      mla_attend_mma_kernel<M, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)mma_smem_bytes<M, P>());
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

// f(tag) with a value of the pool type of dtype code `dtype`.
template <typename F>
int with_pool_type(int dtype, F f) {
  switch (dtype) {
    case kF32: return f(float{});
    case kBF16: return f(bf16{});
    case kI8: return f(int8_t{});
    case kE4M3: return f(e4m3{});
    default: return (int)cudaErrorInvalidValue;
  }
}

// f(std::integral_constant<int, M>) for qrows = 16 M query rows a block.
template <typename F>
int with_m_tiles(int qrows, F f) {
  switch (qrows / 16) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 3: return f(std::integral_constant<int, 3>{});
    default: return f(std::integral_constant<int, 4>{});
  }
}

template <int M, typename P>
int attend_mma(dim3 grid, const Args& a, cudaStream_t stream) {
  const cudaError_t e = configure_mma<M, P>();
  if (e != cudaSuccess) return (int)e;
  mla_attend_mma_kernel<M, P><<<grid, THREADS, mma_smem_bytes<M, P>(), stream>>>(
      (const bf16*)a.q, (const P*)a.pool, (const int*)a.page_tables,
      (const int*)a.q_starts, (const int*)a.kv_lens, a.k_scales,
      (typename Types<P>::Out*)a.out, a.part_acc, a.part_ml, a.layer, a.num_pages, a.TP,
      a.maxp, a.Tq, a.H, a.split, a.sm_scale);
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

template <typename P>
int launch(const Args& a, const void* k_new, const void* slot_pages,
           const void* slot_offsets, int N, int qrows, cudaStream_t stream) {
  using Out = typename Types<P>::Out;
  if (k_new) {
    mla_write_kernel<P><<<N * a.Tq, WRITE_THREADS, 0, stream>>>(
        (const typename Types<P>::New*)k_new, (P*)a.pool, (const int*)slot_pages,
        (const int*)slot_offsets, a.k_scales, a.layer, a.num_pages, a.TP);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  const int rows = a.Tq * a.H, width = a.maxp * a.TP;
  const int S = width > a.split ? (width + a.split - 1) / a.split : 1;
  const dim3 grid(N, (rows + qrows - 1) / qrows, S);
  int rc;
  if constexpr (std::is_same<P, float>::value) {
    rc = attend_f32(grid, a, stream);
  } else {
    rc = with_m_tiles(qrows, [&](auto m) { return attend_mma<decltype(m)::value, P>(grid, a, stream); });
  }
  if (rc != 0 || S == 1) return rc;
  mla_merge_kernel<Out><<<dim3(N, rows), MERGE_THREADS, 0, stream>>>(
      a.part_acc, a.part_ml, (const int*)a.q_starts, (const int*)a.kv_lens, (Out*)a.out,
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
  if (!valid_rows(dtype == kvc::kF32, qrows)) return (int)cudaErrorInvalidValue;
  return with_pool_type(dtype, [&](auto tag) -> int {
    using P = decltype(tag);
    if constexpr (std::is_same<P, float>::value) {
      return wave_blocks(configure_f32(), mla_attend_f32_kernel, kF32Smem, blocks);
    } else {
      return with_m_tiles(qrows, [&](auto m) {
        constexpr int M = decltype(m)::value;
        return wave_blocks(configure_mma<M, P>(), mla_attend_mma_kernel<M, P>,
                           mma_smem_bytes<M, P>(), blocks);
      });
    }
  });
}

// dtype: the pool's code (kvc::DType).  q, out [N, Tq, H, D] (q bf16 and
// out float32 for byte pools, else the pool's type); pool [L, P, 1, TP, D];
// q_starts null for decode / verify rows; k_new [N, Tq, D] (float32 for
// byte pools) with slot_pages / slot_offsets [N, Tq], or all three null (no
// write); k_scales the int8 pool's [L] K scales, or null (ones).  qrows:
// query rows a block (a multiple of 16 up to 64 on the tensor cores, 16
// for float32).  split: keys a block, a multiple of 32; with S = ceil(maxp
// * TP / split) > 1 splits, scratch holds N * S * Tq * H * (R + 2) floats
// (the wrapper allocates it).
extern "C" int kvc_mla_attend(
    int dtype, const void* q, void* pool, const void* page_tables,
    const void* q_starts, const void* kv_lens, const void* k_new,
    const void* slot_pages, const void* slot_offsets, const float* k_scales, void* out,
    void* scratch, int N, int Tq, int H, int layer, int num_pages, int TP, int maxp,
    int qrows, int split, float sm_scale, void* stream) {
  if (Tq < 1 || H < 1 || maxp < 1 || split < KT || split % KT) return (int)cudaErrorInvalidValue;
  if (!valid_rows(dtype == kvc::kF32, qrows)) return (int)cudaErrorInvalidValue;
  const int S = maxp * TP > split ? (maxp * TP + split - 1) / split : 1;
  if (S > 1 && scratch == nullptr) return (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const size_t part_rows = (size_t)N * S * Tq * H;
  float* part_acc = (float*)scratch;  // first: vector stores stay aligned
  Args a{q, pool, page_tables, q_starts, kv_lens, k_scales, out, part_acc,
         part_acc ? part_acc + part_rows * R : nullptr,
         layer, num_pages, TP, maxp, Tq, H, split, sm_scale};
  cudaStream_t s = (cudaStream_t)stream;
  return with_pool_type(dtype, [&](auto tag) {
    return launch<decltype(tag)>(a, k_new, slot_pages, slot_offsets, N, qrows, s);
  });
}
