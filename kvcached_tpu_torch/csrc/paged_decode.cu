// K1 / K1r: fused decode-token write + flash-decode over the paged pool.
//
// Replaces the Pallas kernels of kvcached_tpu/ops/paged_attention.py:
// _decode_write_kernel (write_kv=1) and _readonly_kernel (write_kv=0), both
// over _attn_body.  Semantics kept exactly:
//   - each row stores its current token's K/V at (slot_page, slot_offset)
//     of `layer`; slot page 0 is the zero page and the write is discarded;
//   - the row attends over tokens [win_start, seq_len), seq_len including
//     the current token, win_start = max(seq_len - window, 0);
//   - GQA: q head h*G + g reads kv head h;
//   - scores are (q . k) * sm_scale in float32, then, when softcap > 0,
//     softcap * tanh(score / softcap) before the mask (Gemma2's
//     attn_logit_softcapping, the reference's logit_softcap; 0 is off; the
//     launch picks a capping or a plain instance of pass 1),
//     online softmax in float32;
//   - a row with no tokens yields zeros;
//   - page-table entries past the row's last page are never read (the
//     loops stop at seq_len instead of clamping the index);
//   - byte pools (int8, e4m3): the token is quantized on write as the
//     reference does (kv_common.cuh store_f), q and the softmax weights are
//     rounded to bf16 operands, an int8 pool's K scale multiplies the
//     scores after sm_scale and its V scale the output.
//
// What bounds it on an H100: device-memory bytes.  Each (row, kv head)
// reads its seq_len x D keys and values once; the FLOPs per byte are ~G,
// far below the ~295 FLOP/byte ridge.  Design (split-K flash decoding):
//   - pass 1, grid (row, kv head, split): each block takes SPLIT tokens of
//     one row and one kv head; each of its 4 warps walks its share in
//     groups of U tokens, a lane holding EPL = D / 32 of the D head_dim
//     lanes, so a token's K or V row is one coalesced warp load and U rows
//     are in flight per warp.  Dots are reduced with warp shuffles, the softmax is
//     online per warp, and the warps merge in shared memory into one
//     (max, sum, acc) partial per split;
//   - pass 2, grid (row, kv head): merges the splits' partials.
//   The split count follows the page-table width, so the 8 x 8 (row, kv
//   head) pairs of an 8B decode batch become hundreds of blocks.
// The token write is done by the split-0 block; every block that meets the
// slot (slot_page, slot_offset) in its range takes k_new / v_new from
// registers instead of reading the slot back, so no block waits on
// another's store.  A row's pages are its own (prefix-cache pages are full
// pages, never written; padded rows aim at page 0).
// head_dim: 128, or 256 when built with -DKVC_HEAD_DIM=256 (the
// paged_decode_d256 library; the wrapper picks the library by the pools'
// width).  At 256 a lane holds 8 lanes of each row (one 16-byte bf16
// vector, two float32 ones, one 8-byte word of a byte pool) and a warp
// keeps U = 4 tokens in flight, the bytes in flight of U = 8 at 128, so
// that K and V stay at 64 registers a lane; the GQA group's q and
// accumulators take 16 registers a head (64 at G <= 4, Gemma2's group of
// 2; a group past 8 spills).  The warps merge through 32 KB of shared
// memory, 8 group heads at a time.
#include "kv_common.cuh"

namespace {

#ifndef KVC_HEAD_DIM
#define KVC_HEAD_DIM 128
#endif
constexpr int D = KVC_HEAD_DIM;   // head_dim of this library
static_assert(D == 128 || D == 256, "head_dim 128 or 256");
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int EPL = D / 32;       // head_dim lanes per thread
constexpr int U = D == 128 ? 8 : 4;  // tokens in flight per warp step
constexpr int SPLIT = 256;        // tokens per block (ops/paged_attention.py)
// group heads whose warp partials shared memory holds at once (32 KB)
constexpr int MERGE_HEADS = 32768 / (WARPS * D * (int)sizeof(float));

// This lane's EPL values at p, widened to float: one 8- (head_dim 128) or
// 16-byte (256) bf16 vector, one or two 16-byte float32 vectors, one 4- or
// 8-byte word of a byte pool.
template <typename T>
__device__ __forceinline__ void load_lanes(const T* p, float (&x)[EPL]) {
  if constexpr (sizeof(T) == 1) {  // int8, e4m3
    uint32_t w[EPL / 4];
    if constexpr (EPL == 4) {
      w[0] = *reinterpret_cast<const uint32_t*>(p);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < EPL; ++i) x[i] = kvc::byte_f<T>(w[i / 4], i % 4);
  } else if constexpr (sizeof(T) == 4) {  // float32
#pragma unroll
    for (int j = 0; j < EPL / 4; ++j) {
      const float4 v = reinterpret_cast<const float4*>(p)[j];
      x[4 * j] = v.x; x[4 * j + 1] = v.y; x[4 * j + 2] = v.z; x[4 * j + 3] = v.w;
    }
  } else {  // bf16
    uint32_t w[EPL / 2];
    if constexpr (EPL == 4) {
      const uint2 v = *reinterpret_cast<const uint2*>(p);
      w[0] = v.x;
      w[1] = v.y;
    } else {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
    }
#pragma unroll
    for (int j = 0; j < EPL / 2; ++j) {
      const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[j]));
      x[2 * j] = a.x;
      x[2 * j + 1] = a.y;
    }
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Pass 1.  T is the pool's type (kv_common.cuh Types gives q's, the
// tokens' and the operands'); GT >= G is the compile-time bound of the GQA
// group; kCap: the soft-capping instance.
template <typename T, int GT, bool kCap>
__global__ void __launch_bounds__(THREADS) decode_split_kernel(
    const typename kvc::Types<T>::Q* __restrict__ q,      // [B, KH*G, D]
    T* k_pool, T* v_pool,                                 // [L, P, KH, TP, D]
    const int* __restrict__ page_tables,                  // [B, maxp]
    const int* __restrict__ seq_lens,                     // [B]
    const typename kvc::Types<T>::New* __restrict__ k_new,  // [B, KH, D]
    const typename kvc::Types<T>::New* __restrict__ v_new,
    const int* __restrict__ slot_pages,                   // [B]
    const int* __restrict__ slot_offsets,
    const float* __restrict__ k_scales,                   // [L, KH] int8, else null
    const float* __restrict__ v_scales,
    float* __restrict__ part_m,                           // [B, KH, S, GT]
    float* __restrict__ part_l,
    float* __restrict__ part_acc,                         // [B, KH, S, GT, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int window,
    float sm_scale, float softcap, int write_kv) {
  using namespace kvc;
  using Q = typename Types<T>::Q;
  using New = typename Types<T>::New;
  using Op = typename Types<T>::Op;
  constexpr int GM = GT < MERGE_HEADS ? GT : MERGE_HEADS;  // heads a merge round
  __shared__ float m_w[WARPS][GT], l_w[WARPS][GT];
  __shared__ float acc_w[WARPS][GM][D];

  const int b = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int S = gridDim.z;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int e0 = lane * EPL;
  const size_t page_stride = (size_t)KH * TP * D;
  const size_t base = (size_t)layer * num_pages * page_stride + (size_t)h * TP * D;
  const float ksc = head_scale(k_scales, layer, KH, h);

  // the current token: split 0 stores it, every split keeps the stored
  // value to use in place of the slot's memory
  int slot_page = -1, slot_off = -1;
  float kn[EPL] = {0.f, 0.f, 0.f, 0.f}, vn[EPL] = {0.f, 0.f, 0.f, 0.f};
  if (write_kv && slot_pages[b] != 0) {
    slot_page = slot_pages[b];
    slot_off = slot_offsets[b];
    const size_t src = ((size_t)b * KH + h) * D + e0;
    load_lanes<New>(k_new + src, kn);
    load_lanes<New>(v_new + src, vn);
    T ks[EPL], vs[EPL];
    const float vsc = head_scale(v_scales, layer, KH, h);
#pragma unroll
    for (int i = 0; i < EPL; ++i) {
      ks[i] = store_f<T>(kn[i], ksc);
      vs[i] = store_f<T>(vn[i], vsc);
      kn[i] = to_f<T>(ks[i]);
      vn[i] = to_f<T>(vs[i]);
    }
    if (split == 0 && warp == 0) {
      const size_t dst = base + (size_t)slot_page * page_stride +
                         (size_t)slot_off * D + e0;
#pragma unroll
      for (int i = 0; i < EPL; ++i) {
        k_pool[dst + i] = ks[i];
        v_pool[dst + i] = vs[i];
      }
    }
  }

  float qv[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    if (g < G) load_lanes<Q>(q + (((size_t)b * KH + h) * G + g) * D + e0, qv[g]);
  }
  float m[GT], l[GT], acc[GT][EPL];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int i = 0; i < EPL; ++i) acc[g][i] = 0.f;
  }

  const int s_len = seq_lens[b];
  const int lo = max(window > 0 ? s_len - window : 0, split * SPLIT);
  const int hi = min(s_len, (split + 1) * SPLIT);
  const int* row_pages = page_tables + (size_t)b * maxp;
  for (int t0 = lo + warp * U; t0 < hi; t0 += WARPS * U) {
    float kx[U][EPL], vx[U][EPL];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int pos = t0 + u;
      const int page = pos < hi ? row_pages[pos / TP] : 0;
      const int off = pos % TP;
      if (pos >= hi) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) { kx[u][i] = 0.f; vx[u][i] = 0.f; }
      } else if (page == slot_page && off == slot_off) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) { kx[u][i] = kn[i]; vx[u][i] = vn[i]; }
      } else {
        const size_t src = base + (size_t)page * page_stride + (size_t)off * D + e0;
        load_lanes<T>(k_pool + src, kx[u]);
        load_lanes<T>(v_pool + src, vx[u]);
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      if (g < G) {
        float s[U];
        float mt = -INFINITY;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float dot = 0.f;
#pragma unroll
          for (int i = 0; i < EPL; ++i) dot = fmaf(qv[g][i], kx[u][i], dot);
          dot = warp_sum(dot);
          s[u] = t0 + u < hi ? soft_cap<kCap>(dot * sm_scale * ksc, softcap) : -INFINITY;
          mt = fmaxf(mt, s[u]);
        }
        const float m_new = fmaxf(m[g], mt);  // finite: t0 < hi
        const float alpha = expf(m[g] - m_new);
        float psum = 0.f;
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc[g][i] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const float p = t0 + u < hi ? expf(s[u] - m_new) : 0.f;
          psum += p;
          const float pr = round_op<Op>(p);
#pragma unroll
          for (int i = 0; i < EPL; ++i) acc[g][i] = fmaf(pr, vx[u][i], acc[g][i]);
        }
        l[g] = l[g] * alpha + psum;
        m[g] = m_new;
      }
    }
  }

  // merge the warps' partials into the block's
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g) { m_w[warp][g] = m[g]; l_w[warp][g] = l[g]; }
  }
  const size_t prow = (((size_t)b * KH + h) * S + split) * GT;
  // head_dim 128 keeps the merge it had (one lane a thread, one round): the
  // rounds below, written for both widths, made the uncapped 128 instances
  // 2-3% slower on the H100
  if constexpr (D == THREADS) {
#pragma unroll
    for (int g = 0; g < GT; ++g) {
#pragma unroll
      for (int i = 0; i < EPL; ++i) acc_w[warp][g][e0 + i] = acc[g][i];
    }
    __syncthreads();
    for (int g = 0; g < G; ++g) {
      float M = -INFINITY;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_w[w][g]);
      float Lsum = 0.f, A = 0.f;
#pragma unroll
      for (int w = 0; w < WARPS; ++w) {
        const float wt = m_w[w][g] == -INFINITY ? 0.f : expf(m_w[w][g] - M);
        Lsum += l_w[w][g] * wt;
        A += acc_w[w][g][tid] * wt;
      }
      part_acc[(prow + g) * D + tid] = A;
      if (tid == 0) {
        part_m[prow + g] = M;
        part_l[prow + g] = Lsum;
      }
    }
  } else {  // head_dim 256: D / THREADS lanes a thread, GM group heads a round
#pragma unroll
    for (int g0 = 0; g0 < GT; g0 += GM) {
      if (g0 > 0) __syncthreads();  // the previous round's partials are read
#pragma unroll
      for (int g = 0; g < GM; ++g) {
#pragma unroll
        for (int i = 0; i < EPL; ++i) acc_w[warp][g][e0 + i] = acc[g0 + g][i];
      }
      __syncthreads();
      for (int g = g0; g < min(G, g0 + GM); ++g) {
        float M = -INFINITY, wt[WARPS];
#pragma unroll
        for (int w = 0; w < WARPS; ++w) M = fmaxf(M, m_w[w][g]);
        float Lsum = 0.f;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
          wt[w] = m_w[w][g] == -INFINITY ? 0.f : expf(m_w[w][g] - M);
          Lsum += l_w[w][g] * wt[w];
        }
        for (int d = tid; d < D; d += THREADS) {
          float A = 0.f;
#pragma unroll
          for (int w = 0; w < WARPS; ++w) A += acc_w[w][g - g0][d] * wt[w];
          part_acc[(prow + g) * D + d] = A;
        }
        if (tid == 0) {
          part_m[prow + g] = M;
          part_l[prow + g] = Lsum;
        }
      }
    }
  }
}

// Pass 2: merge the splits of one (row, kv head); an int8 pool's V scale
// multiplies the merged output.
template <typename T, int GT>
__global__ void __launch_bounds__(D) decode_merge_kernel(
    const float* __restrict__ part_m, const float* __restrict__ part_l,
    const float* __restrict__ part_acc, const float* __restrict__ v_scales,
    typename kvc::Types<T>::Out* __restrict__ out, int layer, int KH, int G,
    int S) {
  using namespace kvc;
  const int b = blockIdx.x, h = blockIdx.y, d = threadIdx.x;
  const float vsc = head_scale(v_scales, layer, KH, h);
  const size_t prow = ((size_t)b * KH + h) * S * GT;
  for (int g = 0; g < G; ++g) {
    float M = -INFINITY;
    for (int s = 0; s < S; ++s) M = fmaxf(M, part_m[prow + s * GT + g]);
    float Lsum = 0.f, A = 0.f;
    for (int s = 0; s < S; ++s) {
      const float ms = part_m[prow + s * GT + g];
      const float wt = ms == -INFINITY ? 0.f : expf(ms - M);
      Lsum += part_l[prow + s * GT + g] * wt;
      A += part_acc[(prow + s * GT + g) * D + d] * wt;
    }
    out[(((size_t)b * KH + h) * G + g) * D + d] =
        from_f<typename Types<T>::Out>(A * vsc / (Lsum == 0.f ? 1.f : Lsum));
  }
}

template <typename T, int GT>
int launch(const void* q, void* k_pool, void* v_pool, const void* page_tables,
           const void* seq_lens, const void* k_new, const void* v_new,
           const void* slot_pages, const void* slot_offsets,
           const float* k_scales, const float* v_scales, void* out,
           void* scratch, int B, int layer, int num_pages, int KH, int G,
           int TP, int maxp, int window, float sm_scale, float softcap,
           int write_kv, cudaStream_t stream) {
  using Ty = kvc::Types<T>;
  const int S = (maxp * TP + SPLIT - 1) / SPLIT;
  float* part_m = (float*)scratch;
  float* part_l = part_m + (size_t)B * KH * S * GT;
  float* part_acc = part_l + (size_t)B * KH * S * GT;
  auto split_kernel = softcap > 0.f ? decode_split_kernel<T, GT, true>
                                    : decode_split_kernel<T, GT, false>;
  split_kernel<<<dim3(B, KH, S), THREADS, 0, stream>>>(
      (const typename Ty::Q*)q, (T*)k_pool, (T*)v_pool, (const int*)page_tables,
      (const int*)seq_lens, (const typename Ty::New*)k_new,
      (const typename Ty::New*)v_new, (const int*)slot_pages,
      (const int*)slot_offsets, k_scales, v_scales, part_m, part_l, part_acc,
      layer, num_pages, KH, G, TP, maxp, window, sm_scale, softcap, write_kv);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  decode_merge_kernel<T, GT><<<dim3(B, KH), D, 0, stream>>>(
      part_m, part_l, part_acc, v_scales, (typename Ty::Out*)out, layer, KH, G, S);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int G, const void* q, void* k_pool, void* v_pool,
             const void* page_tables, const void* seq_lens, const void* k_new,
             const void* v_new, const void* slot_pages,
             const void* slot_offsets, const float* k_scales,
             const float* v_scales, void* out, void* scratch, int B,
             int layer, int num_pages, int KH, int TP, int maxp, int window,
             float sm_scale, float softcap, int write_kv, cudaStream_t s) {
#define KVC_DECODE(GT)                                                      \
  return launch<T, GT>(q, k_pool, v_pool, page_tables, seq_lens, k_new,     \
                       v_new, slot_pages, slot_offsets, k_scales, v_scales, \
                       out, scratch, B, layer, num_pages, KH, G, TP, maxp,  \
                       window, sm_scale, softcap, write_kv, s)
  if (G <= 4) KVC_DECODE(4);
  if (G <= 8) KVC_DECODE(8);
  KVC_DECODE(16);
#undef KVC_DECODE
}

}  // namespace

// head_dim: the pools' width, which must be this library's (D).  scratch:
// B * KH * S * GT * (D + 2) floats, S = ceil(maxp * TP / 256),
// GT = 4, 8 or 16 (the smallest >= G); the wrapper allocates it.  q, the
// tokens and out are in the pool's type for float32 and bf16 pools; for
// int8 and e4m3 pools q is bf16, the tokens and out float32.  k_scales /
// v_scales: an int8 pool's [L, KH] float32 scales (null: 1); softcap: the
// logit soft-cap (0: off).
extern "C" int kvc_paged_decode(
    int dtype, int head_dim, const void* q, void* k_pool, void* v_pool,
    const void* page_tables, const void* seq_lens, const void* k_new,
    const void* v_new, const void* slot_pages, const void* slot_offsets,
    const float* k_scales, const float* v_scales, void* out, void* scratch,
    int B, int layer, int num_pages, int KH, int G, int TP, int maxp,
    int window, float sm_scale, float softcap, int write_kv, void* stream) {
  if (head_dim != D || G < 1 || G > 16) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
#define KVC_DTYPE(T)                                                          \
  return dispatch<T>(G, q, k_pool, v_pool, page_tables, seq_lens, k_new,      \
                     v_new, slot_pages, slot_offsets, k_scales, v_scales, out, \
                     scratch, B, layer, num_pages, KH, TP, maxp, window,       \
                     sm_scale, softcap, write_kv, s)
  switch (dtype) {
    case kvc::kF32: KVC_DTYPE(float);
    case kvc::kBF16: KVC_DTYPE(__nv_bfloat16);
    case kvc::kI8: KVC_DTYPE(int8_t);
    case kvc::kE4M3: KVC_DTYPE(kvc::e4m3);
  }
#undef KVC_DTYPE
  return (int)cudaErrorInvalidValue;
}
