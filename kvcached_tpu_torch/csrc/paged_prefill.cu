// K3: causal flash prefill over the paged pool, N independent chunks.
//
// Replaces the Pallas kernel _prefill_kernel of
// kvcached_tpu/ops/paged_prefill.py (entry points
// paged_prefill_attention_batch and its N=1 view paged_prefill_attention).
// Each of the N rows is a chunk of T query tokens at global positions
// q_start + t, attending over its own page table up to kv_len.  Semantics:
//   - query row r = t*G + g of kv head h is q head h*G + g of token t;
//   - mask: kv <= q_pos && kv < kv_len, and with a window also
//     kv > q_pos - window;
//   - scores (q . k) * sm_scale in float32, with a soft-cap softcap *
//     tanh(score / softcap) before the mask when softcap > 0 (Gemma2's
//     attn_logit_softcapping, _prefill_kernel's logit_softcap; 0 is off;
//     the launch picks a capping or a plain instance of each kernel),
//     online softmax in float32; a
//     bfloat16 pool multiplies bf16 operands (q, k, the softmax weights, v)
//     with float32 accumulation, a float32 pool multiplies in float32;
//   - byte pools (int8, e4m3) run the bf16 path on their values widened to
//     bf16 (exact), with bf16 q and a float32 output; an int8 pool's K
//     scale multiplies the scores after sm_scale, its V scale the output;
//   - a query row that sees no key (kv_len == 0 rows) yields zeros;
//   - rows are independent and the tiling depends on T only, so a batch
//     is bit-identical to N serial calls.
// The TPU kernel's q_tile cap (a VMEM limit) and its T % q_tile assert do
// not apply: any T works here.
//
// What bounds it on an H100: tensor-core operations at long chunks (about
// 4*T*kv*D FLOPs per q head against T*D and kv*D bytes), bytes at short
// ones.  Both kernels take one block per (row, kv head, ROWS query rows)
// and stop at the block's causal limit: key tiles wholly beyond the last
// query position of the block are never loaded.
//   - bfloat16 and byte pools (the serving path): 4 warps, 16 query rows each, run
//     Q.K^T and P.V on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     float32 accumulate), FlashAttention-2 style: Q stays in registers as
//     A fragments, each 64-key tile of K and V is staged in shared memory
//     (rows padded to dodge bank conflicts), the score fragments are
//     softmaxed in registers (row max and sum reduced across the 4 lanes
//     that share a row) and reused directly as the A fragments of P.V.
//   - float32 pools: one thread per head_dim lane on the CUDA cores, 32-key
//     tiles, float32 throughout (the tensor cores have no full-float32
//     path).
// head_dim: 128, or 256 when built with -DKVC_HEAD_DIM=256 (the
// paged_prefill_d256 library; the wrapper picks the library by the pools'
// width).  At 256 a warp's Q fragments (64 registers) and output
// fragments (128) would not fit beside its scores in 255 registers, so the
// tensor-core kernel stages the block's 64 query rows in shared memory and
// reads one k-step's fragment at a time (kv_common.cuh mma_scores); with
// the K and V tiles that is 99 KB of dynamic shared memory a block.  The
// float32 kernel gives each of the 256 lanes a thread (137 KB).
// Not yet done: wgmma, a TMA ring, and overlap of the next tile's loads
// with the current tile's math.
#include "kv_common.cuh"

namespace {

using namespace kvc;

#ifndef KVC_HEAD_DIM
#define KVC_HEAD_DIM 128
#endif
constexpr int D = KVC_HEAD_DIM;  // head_dim of this library
static_assert(D == 128 || D == 256, "head_dim 128 or 256");
constexpr int THREADS = kThreads;  // tensor-core blocks: 4 warps
constexpr int F32_THREADS = D;     // float32 blocks: one thread per lane
constexpr int ROWS = kF32Rows;  // query rows (token x group head) per block
constexpr int TILE = kF32Keys;  // keys staged per step

template <bool kCap>
__global__ void __launch_bounds__(F32_THREADS) paged_prefill_kernel(
    const float* __restrict__ q,          // [N, Tq, KH*G, D]
    const float* __restrict__ k_pool,     // [L, P, KH, TP, D]
    const float* __restrict__ v_pool,
    const int* __restrict__ page_tables,  // [N, maxp]
    const int* __restrict__ q_starts,     // [N]
    const int* __restrict__ kv_lens,      // [N]
    float* __restrict__ out,              // [N, Tq, KH*G, D]
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

  const int n = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const int QT = ROWS / G;                 // query tokens per block
  const int t_begin = blockIdx.z * QT;
  const int n_tok = min(QT, Tq - t_begin);
  const int rows = n_tok * G;
  const int q_start = q_starts[n];
  const int kv_len = kv_lens[n];
  const int QH = KH * G;

  for (int r = 0; r < rows; ++r) {
    const int t = t_begin + r / G, g = r % G;
    q_s[r * D + d] = q[(((size_t)n * Tq + t) * QH + h * G + g) * D + d];
  }
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
  const size_t base = (size_t)layer * num_pages * page_stride + (size_t)h * TP * D;
  const int* row_pages = page_tables + (size_t)n * maxp;
  const int qpos_lo = q_start + t_begin;
  const int qpos_hi = q_start + t_begin + n_tok - 1;
  const int kv_hi = min(kv_len, qpos_hi + 1);  // block-causal limit
  const int kv_lo = window > 0 ? max(qpos_lo - window + 1, 0) : 0;

  for (int t0 = kv_lo; t0 < kv_hi; t0 += TILE) {
    const int nk = min(TILE, kv_hi - t0);
#pragma unroll  // all TILE rows' loads in flight at once
    for (int t = 0; t < TILE; ++t) {
      if (t < nk) {
        const int pos = t0 + t;
        const int pi = min(pos / TP, maxp - 1);
        const size_t src = base + (size_t)row_pages[pi] * page_stride +
                           (size_t)(pos % TP) * D + d;
        k_s[t * (D + 1) + d] = k_pool[src];
        v_s[t * D + d] = v_pool[src];
      }
    }
    __syncthreads();
    // keys below kv_hi <= kv_len: the tile step's causal and window mask
    // is the whole mask
    f32_attend_tile<kCap, D>(q_s, k_s, v_s, p_s, m_s, l_s, a_s, acc, rows, G, qpos_lo,
                             t0, nk, window, sm_scale, softcap);
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows) {
      const int t = t_begin + r / G, g = r % G;
      const float l = l_s[r];
      out[(((size_t)n * Tq + t) * QH + h * G + g) * D + d] = acc[r] / (l == 0.f ? 1.f : l);
    }
  }
}


// ---- bfloat16 and byte pools: tensor cores (mma.sync m16n8k16) -----------

constexpr int MMA_KT = kMmaKeys;    // keys per tile
constexpr int MMA_LD = D + 8;       // padded smem row (bf16 elements)
// head_dim 256: the K and V tiles and the block's query rows, in dynamic
// shared memory
constexpr size_t kMmaSmem256 = sizeof(__nv_bfloat16) * (2 * MMA_KT + ROWS) * MMA_LD;

// 8 consecutive pool values at p as 8 bf16 (one 16-byte vector)
template <typename P>
__device__ __forceinline__ uint4 load8_bf16(const P* p) {
  if constexpr (sizeof(P) == 2) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    return widen8<P>(*reinterpret_cast<const uint2*>(p));
  }
}

// P: the pool's type (bf16, int8 or e4m3); q is bf16, the output
// Types<P>::Out (bf16, or float32 for byte pools); kCap: the soft-capping
// instance.
template <typename P, bool kCap>
__global__ void __launch_bounds__(THREADS) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // [N, Tq, KH*G, D]
    const P* __restrict__ k_pool,              // [L, P, KH, TP, D]
    const P* __restrict__ v_pool,
    const int* __restrict__ page_tables,       // [N, maxp]
    const int* __restrict__ q_starts,          // [N]
    const int* __restrict__ kv_lens,           // [N]
    const float* __restrict__ k_scales,        // [L, KH] int8, else null
    const float* __restrict__ v_scales,
    typename Types<P>::Out* __restrict__ out,  // [N, Tq, KH*G, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale, float softcap) {
#if KVC_HEAD_DIM == 128
  __shared__ __align__(16) __nv_bfloat16 k_s[MMA_KT][MMA_LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[MMA_KT][MMA_LD];
#else
  extern __shared__ uint4 smem_mma[];  // kMmaSmem256 bytes: K, V, Q
  __nv_bfloat16* const tiles = reinterpret_cast<__nv_bfloat16*>(smem_mma);
  auto& k_s = *reinterpret_cast<__nv_bfloat16(*)[MMA_KT][MMA_LD]>(tiles);
  auto& v_s = *reinterpret_cast<__nv_bfloat16(*)[MMA_KT][MMA_LD]>(tiles + MMA_KT * MMA_LD);
  auto& q_s = *reinterpret_cast<__nv_bfloat16(*)[ROWS][MMA_LD]>(tiles + 2 * MMA_KT * MMA_LD);
#endif

  const int n = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32, gq = lane / 4, tq = lane % 4;
  const int QT = ROWS / G;
  const int t_begin = blockIdx.z * QT;
  const int n_tok = min(QT, Tq - t_begin);
  const int rows = n_tok * G;
  const int q_start = q_starts[n];
  const int kv_len = kv_lens[n];
  const int QH = KH * G;

  // this lane's two query rows: r[0] = 16*warp + gq, r[1] = r[0] + 8
  int qpos[2];
  bool live[2];
#if KVC_HEAD_DIM == 128
  uint32_t qa[D / 16][4];
#endif
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gq + 8 * i;
    live[i] = r < rows;
    qpos[i] = q_start + t_begin + r / G;
  }
#if KVC_HEAD_DIM == 128
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = 16 * warp + gq + 8 * i;
      uint32_t lo = 0, hi = 0;
      if (live[i]) {
        const __nv_bfloat16* qr =
            q + (((size_t)n * Tq + t_begin + r / G) * QH + h * G + r % G) * D;
        lo = *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 2 * tq);
        hi = *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 2 * tq + 8);
      }
      qa[ks][i] = lo;       // a0 / a1: columns 2tq, 2tq+1
      qa[ks][2 + i] = hi;   // a2 / a3: columns 2tq+8, 2tq+9
    }
  }
#else
  // the block's query rows into shared memory (zeros past `rows`); the
  // first tile's barrier publishes them
  for (int idx = tid; idx < ROWS * (D / 8); idx += THREADS) {
    const int r = idx / (D / 8), c = (idx % (D / 8)) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r < rows)
      v = *reinterpret_cast<const uint4*>(
          q + (((size_t)n * Tq + t_begin + r / G) * QH + h * G + r % G) * D + c);
    *reinterpret_cast<uint4*>(&q_s[r][c]) = v;
  }
  const auto& qa = *reinterpret_cast<const __nv_bfloat16(*)[16][MMA_LD]>(q_s[16 * warp]);
#endif

  float o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const size_t page_stride = (size_t)KH * TP * D;
  const size_t base = (size_t)layer * num_pages * page_stride + (size_t)h * TP * D;
  const int* row_pages = page_tables + (size_t)n * maxp;
  const int qpos_lo = q_start + t_begin;
  const int kv_hi = min(kv_len, q_start + t_begin + n_tok);  // block-causal limit
  const int kv_lo = window > 0 ? max(qpos_lo - window + 1, 0) : 0;
  const float ksc = head_scale(k_scales, layer, KH, h);
  const float vsc = head_scale(v_scales, layer, KH, h);

  for (int t0 = kv_lo; t0 < kv_hi; t0 += MMA_KT) {
    const int nk = min(MMA_KT, kv_hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < MMA_KT * (D / 8); idx += THREADS) {
      const int kr = idx / (D / 8), c = (idx % (D / 8)) * 8;
      uint4 kv4 = make_uint4(0, 0, 0, 0), vv4 = make_uint4(0, 0, 0, 0);
      if (kr < nk) {
        const int pos = t0 + kr;
        const int pi = min(pos / TP, maxp - 1);
        const size_t src = base + (size_t)row_pages[pi] * page_stride +
                           (size_t)(pos % TP) * D + c;
        kv4 = load8_bf16(k_pool + src);
        vv4 = load8_bf16(v_pool + src);
      }
      *reinterpret_cast<uint4*>(&k_s[kr][c]) = kv4;
      *reinterpret_cast<uint4*>(&v_s[kr][c]) = vv4;
    }
    __syncthreads();
    // keys below kv_hi <= kv_len: the tile step's causal and window mask
    // is the whole mask
    mma_attend_tile<kCap, D>(qa, live, qpos, k_s, v_s, t0, nk, window, sm_scale, ksc,
                             softcap, o, m, l);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    if (!live[i]) continue;
    const int r = 16 * warp + gq + 8 * i;
    auto* orow = out + (((size_t)n * Tq + t_begin + r / G) * QH + h * G + r % G) * D;
    if constexpr (sizeof(P) == 2) {
      const float inv = 1.f / (li == 0.f ? 1.f : li);
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * tq) =
            pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
      }
    } else {
      const float den = li == 0.f ? 1.f : li;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        *reinterpret_cast<float2*>(orow + dn * 8 + 2 * tq) =
            make_float2(o[dn][2 * i] * vsc / den, o[dn][2 * i + 1] * vsc / den);
      }
    }
  }
}

template <bool kCap>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* page_tables, const void* q_starts,
               const void* kv_lens, void* out, int N, int layer, int num_pages,
               int KH, int G, int TP, int maxp, int Tq, int window,
               float sm_scale, float softcap, cudaStream_t stream) {
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<kCap>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kF32SmemBytes<D>);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int QT = ROWS / G;
  dim3 grid(N, KH, (Tq + QT - 1) / QT);
  paged_prefill_kernel<kCap><<<grid, F32_THREADS, kF32SmemBytes<D>, stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)page_tables, (const int*)q_starts, (const int*)kv_lens,
      (float*)out, layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

template <typename P, bool kCap>
int launch_mma(const void* q, const void* k_pool, const void* v_pool,
               const void* page_tables, const void* q_starts,
               const void* kv_lens, const float* k_scales,
               const float* v_scales, void* out, int N, int layer,
               int num_pages, int KH, int G, int TP, int maxp, int Tq,
               int window, float sm_scale, float softcap, cudaStream_t stream) {
  const int QT = ROWS / G;
  dim3 grid(N, KH, (Tq + QT - 1) / QT);
  size_t smem = 0;
  if constexpr (D != 128) {
    static bool configured = false;  // dynamic shared memory above 48 KB
    if (!configured) {
      const cudaError_t e = cudaFuncSetAttribute(
          paged_prefill_mma_kernel<P, kCap>,
          cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem256);
      if (e != cudaSuccess) return (int)e;
      configured = true;
    }
    smem = kMmaSmem256;
  }
  paged_prefill_mma_kernel<P, kCap><<<grid, THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const P*)k_pool, (const P*)v_pool,
      (const int*)page_tables, (const int*)q_starts, (const int*)kv_lens,
      k_scales, v_scales, (typename Types<P>::Out*)out, layer, num_pages, KH,
      G, TP, maxp, Tq, window, sm_scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace

// head_dim: the pools' width, which must be this library's (D); q is in
// the pool's type for float32 and bf16 pools and bf16 for int8 and e4m3
// pools, whose output is float32; k_scales / v_scales: an int8 pool's
// [L, KH] float32 scales (null: 1); softcap: the logit soft-cap (0: off).
extern "C" int kvc_paged_prefill(
    int dtype, int head_dim, const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* q_starts, const void* kv_lens,
    const float* k_scales, const float* v_scales, void* out, int N,
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale, float softcap, void* stream) {
  if (head_dim != D || G < 1 || ROWS % G) return (int)cudaErrorInvalidValue;
  if (N == 0 || Tq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kvc::kF32)
    return (softcap > 0.f ? launch_f32<true> : launch_f32<false>)(
        q, k_pool, v_pool, page_tables, q_starts, kv_lens, out, N, layer,
        num_pages, KH, G, TP, maxp, Tq, window, sm_scale, softcap, s);
#define KVC_MMA(P)                                                           \
  return (softcap > 0.f ? launch_mma<P, true> : launch_mma<P, false>)(       \
      q, k_pool, v_pool, page_tables, q_starts, kv_lens, k_scales, v_scales, \
      out, N, layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale,       \
      softcap, s)
  switch (dtype) {
    case kvc::kBF16: KVC_MMA(__nv_bfloat16);
    case kvc::kI8: KVC_MMA(int8_t);
    case kvc::kE4M3: KVC_MMA(kvc::e4m3);
  }
#undef KVC_MMA
  return (int)cudaErrorInvalidValue;
}
