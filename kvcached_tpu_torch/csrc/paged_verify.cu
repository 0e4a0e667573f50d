// K4: speculative-decode verification.  Writes each row's T fed tokens into
// their slots, then causal multi-query attention over the paged pool.
//
// Replaces the Pallas kernel of kvcached_tpu/ops/paged_attention.py:
// _verify_write_kernel over _verify_body (entry point
// paged_attention_verify).  Semantics kept exactly:
//   - fed token t of row b is stored at (slot_pages[b, t], slot_offsets[b, t])
//     of `layer`; slot page 0 is the zero page and the write is discarded;
//   - query t of row b sits at position base + t, base = seq_len - T
//     (seq_len includes the T fed tokens); it attends keys < base + t + 1
//     and < seq_len, and with a window also >= max(base + t + 1 - window, 0);
//   - query row r = t*G + g of kv head h is q head h*G + g of token t;
//   - scores (q . k) * sm_scale in float32, with a soft-cap softcap *
//     tanh(score / softcap) before the mask when softcap > 0 (Gemma2's
//     attn_logit_softcapping, _verify_body's logit_softcap; 0 is off, and
//     the launch then runs instances without the cap); online softmax in
//     float32; a bfloat16 pool multiplies bf16 operands (q, k, the softmax
//     weights, v) with float32 accumulation, a float32 pool multiplies in
//     float32;
//   - byte pools (int8, e4m3): the fed tokens are quantized on write as
//     the reference does (kv_common.cuh store_f); the bf16 path runs on
//     their values widened to bf16 (exact), with bf16 q and a float32
//     output; an int8 pool's K scale multiplies the scores after sm_scale,
//     its V scale the merged output;
//   - a query row that sees no key yields zeros;
//   - the key range is clamped to the page-table width: the engine passes
//     honest seq_lens that overhang a row's table by up to T - 1 (those
//     queries' outputs are discarded), and no entry past a row's table is
//     read.  (The TPU kernel reads a clamped page there; only discarded
//     outputs differ.)
//
// What bounds it on an H100: device-memory bytes, as K1.  Each (row, kv
// head) reads its keys and values once for all of its T*G query rows (20 at
// Llama-3-8B with 4 drafts: ~20 FLOPs a byte, far below the ~295 FLOP/byte
// ridge).  Design:
//   - pass 0, grid (row x fed token): stores the fed tokens as 16-byte
//     vectors.  The attention passes follow on the same stream and read the
//     tokens from the pool like any other key;
//   - pass 1, grid (row, kv head, split): split-K as K1.  Each block takes
//     SPLIT tokens of one (row, kv head) and all of its query rows (up to
//     ROWS), so an 8-row x 8-kv-head batch becomes hundreds of blocks for
//     132 SMs; a block whose range is empty exits at once.  The tile math
//     is K3's (kv_common.cuh): bf16 pools run Q.K^T and P.V on the tensor
//     cores (mma.sync m16n8k16, 4 warps of 16 query rows; warps past the
//     last query row only copy), with 64-key tiles double-buffered in
//     shared memory and the next tile's cp.async copies in flight during
//     this tile's math; float32 pools run on the CUDA cores in float32, one
//     thread per head_dim lane.  Each block writes an unnormalised (max,
//     sum, acc) partial per query row;
//   - pass 2, grid (row, kv head, query row): merges the non-empty splits.
// head_dim: 128, or 256 when built with -DKVC_HEAD_DIM=256 (the
// paged_verify_d256 library; the wrapper picks the library by the pools'
// width).  At 256 the tensor-core pass stages the block's 64 query rows in
// shared memory beside the double-buffered K and V tiles (165 KB of dynamic
// shared memory: one block an SM) and reads one k-step's Q fragment at a
// time (kv_common.cuh mma_scores), and the float32 pass gives each of the
// 256 lanes a thread (137 KB).  The query-row limit stays ROWS = 64 (T *
// G <= 64) at both widths.
// Not yet done: wgmma, a TMA ring, and folding the token store into pass 1
// (as K1 does).
#include "kv_common.cuh"

namespace {

using namespace kvc;

#ifndef KVC_HEAD_DIM
#define KVC_HEAD_DIM 128
#endif
constexpr int D = KVC_HEAD_DIM;  // head_dim of this library
static_assert(D == 128 || D == 256, "head_dim 128 or 256");
constexpr int THREADS = kThreads;  // token writes and tensor-core blocks: 4 warps
constexpr int F32_THREADS = D;     // float32 blocks: one thread per lane
constexpr int ROWS = kF32Rows;  // query rows per block (ops MAX_VERIFY_ROWS)
constexpr int SPLIT = 256;      // tokens per split block (ops VERIFY_SPLIT)
constexpr int MMA_KT = kMmaKeys;
constexpr int MMA_LD = D + 8;   // padded smem row (bf16 elements)
constexpr int TILE = kF32Keys;
constexpr int LOADS = MMA_KT * (D / 8) / THREADS;  // K (and V) vectors a thread copies a tile
constexpr int MMA_TILE = MMA_KT * MMA_LD;            // bf16 elements of one K or V tile
// K and V, two buffers; at head_dim 256 also the block's query rows
constexpr size_t kSmemBF16 =
    sizeof(__nv_bfloat16) * (4 * MMA_TILE + (D == 128 ? 0 : ROWS * MMA_LD));

// Keys [lo, hi) of split `split` of a row: from the window start of the
// row's first query, below the row's length and the table width.  Pass 1
// and pass 2 both derive it, so an empty split is never written or read.
__device__ __forceinline__ void split_range(int s_len, int Tq, int TP, int maxp,
                                            int window, int split, int& lo,
                                            int& hi) {
  const int first = window > 0 ? max(s_len - Tq + 1 - window, 0) : 0;
  lo = max(first, split * SPLIT);
  hi = min(min(s_len, maxp * TP), (split + 1) * SPLIT);
}

// Pass 0: store the fed tokens.  One block per (row, fed token).  float32
// and bf16 pools copy 16-byte vectors; byte pools quantize float32 tokens
// one value a thread, as the reference writes them.
template <typename T>
__global__ void __launch_bounds__(THREADS) verify_write_kernel(
    const typename Types<T>::New* __restrict__ k_new,  // [B*Tq, KH, D]
    const typename Types<T>::New* __restrict__ v_new,
    T* __restrict__ k_pool,               // [L, P, KH, TP, D]
    T* __restrict__ v_pool,
    const int* __restrict__ slot_pages,   // [B*Tq]
    const int* __restrict__ slot_offsets,
    const float* __restrict__ k_scales,   // [L, KH] int8, else null
    const float* __restrict__ v_scales,
    int layer, int num_pages, int KH, int TP) {
  const int bt = blockIdx.x;
  const int page = slot_pages[bt];
  if (page == 0) return;  // the zero page: discard
  const int off = slot_offsets[bt];
  const size_t page_stride = (size_t)KH * TP * D;
  const size_t dst0 =
      ((size_t)layer * num_pages + page) * page_stride + (size_t)off * D;
  if constexpr (sizeof(T) == 1) {
    for (int i = threadIdx.x; i < KH * D; i += THREADS) {
      const int h = i / D, c = i % D;
      const size_t src = ((size_t)bt * KH + h) * D + c;
      const size_t dst = dst0 + (size_t)h * TP * D + c;
      k_pool[dst] = store_f<T>(k_new[src], head_scale(k_scales, layer, KH, h));
      v_pool[dst] = store_f<T>(v_new[src], head_scale(v_scales, layer, KH, h));
    }
  } else {
    constexpr int VEC = 16 / sizeof(T);  // elements per 16-byte vector
    constexpr int PER_HEAD = D / VEC;
    for (int i = threadIdx.x; i < KH * PER_HEAD; i += THREADS) {
      const int h = i / PER_HEAD, c = (i % PER_HEAD) * VEC;
      const size_t src = ((size_t)bt * KH + h) * D + c;
      const size_t dst = dst0 + (size_t)h * TP * D + c;
      *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src);
      *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src);
    }
  }
}

// Start copying one 64-key tile of K and V into (k_s, v_s), all of this
// thread's 2 * LOADS 16-byte copies in flight at once, as one copy group;
// rows past nk are zeroed (their weights are 0, and 0 * NaN would not be).
// A byte pool's values are widened to bf16 on the way (8 bytes loaded, 16
// stored), which cp.async cannot do: its tile lands before the call returns.
template <typename P>
__device__ __forceinline__ void copy_tile(__nv_bfloat16* k_s, __nv_bfloat16* v_s,
                                          const P* __restrict__ k_pool,
                                          const P* __restrict__ v_pool,
                                          const int* __restrict__ row_pages,
                                          size_t kbase, size_t page_stride, int TP,
                                          int t0, int nk, int tid) {
#pragma unroll
  for (int u = 0; u < LOADS; ++u) {
    const int idx = tid + u * THREADS;
    const int kr = idx / (D / 8), c = (idx % (D / 8)) * 8;
    __nv_bfloat16* kd = k_s + kr * MMA_LD + c;
    __nv_bfloat16* vd = v_s + kr * MMA_LD + c;
    if (kr < nk) {
      const int pos = t0 + kr;
      const size_t src = kbase + (size_t)row_pages[pos / TP] * page_stride +
                         (size_t)(pos % TP) * D + c;
      if constexpr (sizeof(P) == 2) {
        cp_async16(kd, k_pool + src);
        cp_async16(vd, v_pool + src);
      } else {
        *reinterpret_cast<uint4*>(kd) =
            widen8<P>(*reinterpret_cast<const uint2*>(k_pool + src));
        *reinterpret_cast<uint4*>(vd) =
            widen8<P>(*reinterpret_cast<const uint2*>(v_pool + src));
      }
    } else {
      *reinterpret_cast<uint4*>(kd) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(vd) = make_uint4(0, 0, 0, 0);
    }
  }
  cp_async_commit();
}

// buffer `buf` of a double-buffered tile, as the array the tile step takes
__device__ __forceinline__ const __nv_bfloat16 (
    &tile(const __nv_bfloat16* base, int buf))[MMA_KT][MMA_LD] {
  return *reinterpret_cast<const __nv_bfloat16(*)[MMA_KT][MMA_LD]>(
      base + buf * MMA_TILE);
}

// Pass 1, bfloat16 and byte pools (P): tensor cores; kCap: the
// soft-capping instance.
template <typename P, bool kCap>
__global__ void __launch_bounds__(THREADS) verify_split_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // [B, Tq, KH*G, D]
    const P* __restrict__ k_pool,              // [L, P, KH, TP, D]
    const P* __restrict__ v_pool,
    const int* __restrict__ page_tables,       // [B, maxp]
    const int* __restrict__ seq_lens,          // [B]
    const float* __restrict__ k_scales,        // [L, KH] int8, else null
    float* __restrict__ part_m,                // [B, KH, S, R]
    float* __restrict__ part_l,
    float* __restrict__ part_acc,              // [B, KH, S, R, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale, float softcap) {
  // two buffers of a K tile and a V tile: [2][MMA_KT][MMA_LD] each (and
  // at head_dim 256 the query rows, [ROWS][MMA_LD])
  extern __shared__ uint4 smem_tiles[];
  __nv_bfloat16* const k_buf = reinterpret_cast<__nv_bfloat16*>(smem_tiles);
  __nv_bfloat16* const v_buf = k_buf + 2 * MMA_TILE;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int s_len = seq_lens[b];
  int lo, hi;
  split_range(s_len, Tq, TP, maxp, window, split, lo, hi);
  if (lo >= hi) return;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int R = Tq * G, QH = KH * G, base = s_len - Tq;
  const bool warp_live = 16 * warp < R;

  // this lane's two query rows: r[0] = 16*warp + gq, r[1] = r[0] + 8
  int qpos[2];
  bool live[2];
#if KVC_HEAD_DIM == 128
  uint32_t qa[D / 16][4];
#endif
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gq + 8 * i;
    live[i] = r < R;
    qpos[i] = base + r / G;
  }
#if KVC_HEAD_DIM == 128
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + gq + 8 * i;
      uint32_t lo32 = 0, hi32 = 0;
      if (live[i]) {
        const __nv_bfloat16* qr =
            q + (((size_t)b * Tq + r / G) * QH + h * G + r % G) * D;
        lo32 = *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 2 * tq);
        hi32 = *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 2 * tq + 8);
      }
      qa[ks][i] = lo32;       // a0 / a1: columns 2tq, 2tq+1
      qa[ks][2 + i] = hi32;   // a2 / a3: columns 2tq+8, 2tq+9
    }
  }
#else
  // the block's query rows into shared memory (zeros past R); the first
  // tile's barrier publishes them
  auto& q_s = *reinterpret_cast<__nv_bfloat16(*)[ROWS][MMA_LD]>(v_buf + 2 * MMA_TILE);
  for (int idx = tid; idx < ROWS * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < R)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)b * Tq + r / G) * QH + h * G + r % G) * D + c);
    *reinterpret_cast<uint4*>(&q_s[r][c]) = v;
  }
  const auto& qa = *reinterpret_cast<const __nv_bfloat16(*)[16][MMA_LD]>(q_s[16 * warp]);
#endif

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const size_t page_stride = (size_t)KH * TP * D;
  const size_t kbase = (size_t)layer * num_pages * page_stride + (size_t)h * TP * D;
  const int* row_pages = page_tables + (size_t)b * maxp;
  const float ksc = head_scale(k_scales, layer, KH, h);

  copy_tile(k_buf, v_buf, k_pool, v_pool, row_pages, kbase, page_stride, TP, lo,
            min(MMA_KT, hi - lo), tid);
  for (int t0 = lo, buf = 0; t0 < hi; t0 += MMA_KT, buf ^= 1) {
    const int nk = min(MMA_KT, hi - t0);
    // the next tile's copies fly during this tile's math; the other buffer
    // was released by the barrier that ended the previous tile
    if (t0 + MMA_KT < hi) {
      copy_tile(k_buf + (buf ^ 1) * MMA_TILE, v_buf + (buf ^ 1) * MMA_TILE, k_pool,
                v_pool, row_pages, kbase, page_stride, TP, t0 + MMA_KT,
                min(MMA_KT, hi - t0 - MMA_KT), tid);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // this tile landed for every thread
    if (warp_live)  // a warp with no query row only copies
      mma_attend_tile<kCap, D>(qa, live, qpos, tile(k_buf, buf), tile(v_buf, buf), t0,
                               nk, window, sm_scale, ksc, softcap, o, m, l);
    __syncthreads();  // this buffer is consumed: the next copy may refill it
  }

  const size_t prow = (((size_t)b * KH + h) * gridDim.z + split) * R;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];  // each lane summed its own columns: reduce the quad
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (!live[i]) continue;
    const int r = 16 * warp + gq + 8 * i;
    if (tq == 0) {
      part_m[prow + r] = m[i];
      part_l[prow + r] = li;
    }
    float* acc = part_acc + (prow + r) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<float2*>(acc + dn * 8 + 2 * tq) =
          make_float2(o[dn][2 * i], o[dn][2 * i + 1]);
    }
  }
}

// Pass 1, float32 pools: CUDA cores, one thread per head_dim lane; kCap:
// the soft-capping instance.
template <bool kCap>
__global__ void __launch_bounds__(F32_THREADS) verify_split_f32_kernel(
    const float* __restrict__ q,              // [B, Tq, KH*G, D]
    const float* __restrict__ k_pool,         // [L, P, KH, TP, D]
    const float* __restrict__ v_pool,
    const int* __restrict__ page_tables,      // [B, maxp]
    const int* __restrict__ seq_lens,         // [B]
    float* __restrict__ part_m,               // [B, KH, S, R]
    float* __restrict__ part_l,
    float* __restrict__ part_acc,             // [B, KH, S, R, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale, float softcap) {
  extern __shared__ float smem[];
  float* q_s = smem;                       // [ROWS][D]
  float* k_s = q_s + ROWS * D;             // [TILE][D + 1]
  float* v_s = k_s + TILE * (D + 1);       // [TILE][D]
  float* p_s = v_s + TILE * D;             // [ROWS][TILE]
  float* m_s = p_s + ROWS * TILE;          // [ROWS]
  float* l_s = m_s + ROWS;
  float* a_s = l_s + ROWS;

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z, d = threadIdx.x;
  const int s_len = seq_lens[b];
  int lo, hi;
  split_range(s_len, Tq, TP, maxp, window, split, lo, hi);
  if (lo >= hi) return;
  const int R = Tq * G, QH = KH * G, base = s_len - Tq;

  for (int r = 0; r < R; ++r)
    q_s[r * D + d] = q[(((size_t)b * Tq + r / G) * QH + h * G + r % G) * D + d];
  if (d < ROWS) {
    m_s[d] = -INFINITY;
    l_s[d] = 0.f;
    a_s[d] = 1.f;
  }
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.f;
  __syncthreads();

  const size_t page_stride = (size_t)KH * TP * D;
  const size_t kbase = (size_t)layer * num_pages * page_stride + (size_t)h * TP * D;
  const int* row_pages = page_tables + (size_t)b * maxp;

  for (int t0 = lo; t0 < hi; t0 += TILE) {
    const int nk = min(TILE, hi - t0);
#pragma unroll  // all TILE rows' loads in flight at once
    for (int t = 0; t < TILE; ++t) {
      if (t < nk) {
        const int pos = t0 + t;
        const size_t src = kbase + (size_t)row_pages[pos / TP] * page_stride +
                           (size_t)(pos % TP) * D + d;
        k_s[t * (D + 1) + d] = k_pool[src];
        v_s[t * D + d] = v_pool[src];
      }
    }
    __syncthreads();
    f32_attend_tile<kCap, D>(q_s, k_s, v_s, p_s, m_s, l_s, a_s, acc, R, G, base, t0, nk,
                             window, sm_scale, softcap);
    __syncthreads();
  }

  const size_t prow = (((size_t)b * KH + h) * gridDim.z + split) * R;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < R) part_acc[(prow + r) * D + d] = acc[r];
  }
  if (d < R) {
    part_m[prow + d] = m_s[d];
    part_l[prow + d] = l_s[d];
  }
}

// Pass 2: merge the non-empty splits of one query row of one (row, kv
// head); an int8 pool's V scale multiplies the merged output.
template <typename T>
__global__ void __launch_bounds__(D) verify_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const int* __restrict__ seq_lens,
    const float* __restrict__ v_scales,
    typename Types<T>::Out* __restrict__ out,  // [B, Tq, KH*G, D]
    int layer, int KH, int G, int TP, int maxp, int Tq, int window, int S) {
  const int b = blockIdx.x, h = blockIdx.y, r = blockIdx.z, d = threadIdx.x;
  const int R = Tq * G;
  const int s_len = seq_lens[b];
  const size_t row0 = ((size_t)b * KH + h) * S;
  float M = -INFINITY;
#pragma unroll 8  // independent loads: keep several in flight
  for (int s = 0; s < S; ++s) {
    int lo, hi;
    split_range(s_len, Tq, TP, maxp, window, s, lo, hi);
    if (lo < hi) M = fmaxf(M, part_m[(row0 + s) * R + r]);
  }
  float Lsum = 0.f, A = 0.f;
  if (M != -INFINITY) {
#pragma unroll 8
    for (int s = 0; s < S; ++s) {
      int lo, hi;
      split_range(s_len, Tq, TP, maxp, window, s, lo, hi);
      if (lo >= hi) continue;
      const size_t pr = (row0 + s) * R + r;
      const float ms = part_m[pr];
      const float wt = ms == -INFINITY ? 0.f : expf(ms - M);
      Lsum += part_l[pr] * wt;
      A += part_acc[pr * D + d] * wt;
    }
  }
  const int t = r / G, g = r % G;
  out[(((size_t)b * Tq + t) * (KH * G) + h * G + g) * D + d] = from_f<typename Types<T>::Out>(
      A * head_scale(v_scales, layer, KH, h) / (Lsum == 0.f ? 1.f : Lsum));
}

template <typename P, bool kCap>
int split_mma(dim3 grid, const void* q, const void* k_pool, const void* v_pool,
              const void* page_tables, const void* seq_lens,
              const float* k_scales, float* part_m, float* part_l,
              float* part_acc, int layer, int num_pages, int KH, int G, int TP,
              int maxp, int Tq, int window, float sm_scale, float softcap,
              cudaStream_t stream) {
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_split_mma_kernel<P, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kSmemBF16);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  verify_split_mma_kernel<P, kCap><<<grid, THREADS, kSmemBF16, stream>>>(
      (const __nv_bfloat16*)q, (const P*)k_pool, (const P*)v_pool,
      (const int*)page_tables, (const int*)seq_lens, k_scales, part_m, part_l,
      part_acc, layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <bool kCap>
int split_f32(dim3 grid, const void* q, const void* k_pool, const void* v_pool,
              const void* page_tables, const void* seq_lens, float* part_m,
              float* part_l, float* part_acc, int layer, int num_pages, int KH,
              int G, int TP, int maxp, int Tq, int window, float sm_scale,
              float softcap, cudaStream_t stream) {
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        verify_split_f32_kernel<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kF32SmemBytes<D>);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  verify_split_f32_kernel<kCap><<<grid, F32_THREADS, kF32SmemBytes<D>, stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)page_tables, (const int*)seq_lens, part_m, part_l, part_acc,
      layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, void* k_pool, void* v_pool, const void* page_tables,
           const void* seq_lens, const void* k_new, const void* v_new,
           const void* slot_pages, const void* slot_offsets,
           const float* k_scales, const float* v_scales, void* out,
           void* scratch, int B, int Tq, int layer, int num_pages, int KH,
           int G, int TP, int maxp, int window, float sm_scale, float softcap,
           cudaStream_t stream) {
  using New = typename Types<T>::New;
  verify_write_kernel<T><<<B * Tq, THREADS, 0, stream>>>(
      (const New*)k_new, (const New*)v_new, (T*)k_pool, (T*)v_pool,
      (const int*)slot_pages, (const int*)slot_offsets, k_scales, v_scales,
      layer, num_pages, KH, TP);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int S = maxp * TP > 0 ? (maxp * TP + SPLIT - 1) / SPLIT : 1;
  const int R = Tq * G;
  float* part_acc = (float*)scratch;  // first: float2 stores stay aligned
  float* part_m = part_acc + (size_t)B * KH * S * R * D;
  float* part_l = part_m + (size_t)B * KH * S * R;
  const dim3 grid(B, KH, S);
  // the cap picks the instance: an uncapped launch runs code without it
  int rc;
  if constexpr (sizeof(T) == 4)
    rc = (softcap > 0.f ? split_f32<true> : split_f32<false>)(
        grid, q, k_pool, v_pool, page_tables, seq_lens, part_m, part_l,
        part_acc, layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale,
        softcap, stream);
  else
    rc = (softcap > 0.f ? split_mma<T, true> : split_mma<T, false>)(
        grid, q, k_pool, v_pool, page_tables, seq_lens, k_scales, part_m,
        part_l, part_acc, layer, num_pages, KH, G, TP, maxp, Tq, window,
        sm_scale, softcap, stream);
  if (rc != 0) return rc;
  verify_merge_kernel<T><<<dim3(B, KH, R), D, 0, stream>>>(
      part_m, part_l, part_acc, (const int*)seq_lens, v_scales,
      (typename Types<T>::Out*)out, layer, KH, G, TP, maxp, Tq, window, S);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim: the pools' width, which must be this library's (D).  scratch:
// B * KH * S * T * G * (D + 2) floats, S = max(ceil(maxp * TP / 256), 1);
// the wrapper allocates it.  T * G <= 64.  q, the tokens and out
// are in the pool's type for float32 and bf16 pools; for int8 and e4m3
// pools q is bf16, the tokens and out float32.  k_scales / v_scales: an
// int8 pool's [L, KH] float32 scales (null: 1); softcap: the logit
// soft-cap (0: off).
extern "C" int kvc_paged_verify(
    int dtype, int head_dim, const void* q, void* k_pool, void* v_pool,
    const void* page_tables, const void* seq_lens, const void* k_new,
    const void* v_new, const void* slot_pages, const void* slot_offsets,
    const float* k_scales, const float* v_scales, void* out, void* scratch,
    int B, int T, int layer, int num_pages, int KH, int G, int TP, int maxp,
    int window, float sm_scale, float softcap, void* stream) {
  if (head_dim != D || G < 1 || T < 1 || T * G > ROWS) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define KVC_DTYPE(P)                                                         \
  return launch<P>(q, k_pool, v_pool, page_tables, seq_lens, k_new, v_new,   \
                   slot_pages, slot_offsets, k_scales, v_scales, out, scratch, \
                   B, T, layer, num_pages, KH, G, TP, maxp, window, sm_scale,  \
                   softcap, s)
  switch (dtype) {
    case kvc::kF32: KVC_DTYPE(float);
    case kvc::kBF16: KVC_DTYPE(__nv_bfloat16);
    case kvc::kI8: KVC_DTYPE(int8_t);
    case kvc::kE4M3: KVC_DTYPE(kvc::e4m3);
  }
#undef KVC_DTYPE
  return (int)cudaErrorInvalidValue;
}
