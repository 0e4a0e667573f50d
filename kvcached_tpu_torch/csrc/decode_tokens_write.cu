// K7 / K8: one decode token per (kv layer, row) into the paged pools, the
// dp-replica equalizer's writer.
//
// K7 replaces the Pallas kernel _decode_tokens_write_kernel of
// kvcached_tpu/ops/paged_attention.py (entry point write_decode_tokens):
// token (li, b) of k_new/v_new [Lk, B, KH, D] is stored at slot
// slot_offsets[b] of page slot_pages[li, b] of pool layer pool_layers[li],
// all KH heads; page 0 is the zero page and the token is discarded.  K8
// (_decode_tokens_write_single_kernel, write_decode_tokens_single) is the
// same store into the one latent pool of the MLA family: null V pointers.
//
// Under a (dp, tp) mesh each replica's fused kernel (K1, K4, K5) writes only
// its own rows into its own copy of the pool; after the step every replica
// stores every row's token through this kernel, so the copies stay
// bit-identical.  That needs the stored bits to equal the fused kernels':
// float32 and bf16 tokens arrive in the pool's type and are copied as they
// are; byte pools take float32 or bf16 tokens (the bf16 model's, widened
// exactly in the kernel) and quantize them with the fused kernels' own
// function (kv_common.cuh store4 / store_f: the int8
// clip(round(x / scale), -127, 127) with an IEEE divide, e4m3 rounded to
// nearest even without saturation), so a slot rewritten here keeps its
// bytes.  int8 scales are [L, KH] keyed by pool layer, or [Lk, KH] keyed by
// kv layer (scales_by_kv_layer: the hybrid arena's per-model-layer scales,
// where two model layers share each arena layer).
//
// What bounds it on an H100: device-memory bytes, KH x D values read and
// written a token (2 MiB for Llama-3-8B's 32 layers x 8 rows at bf16), far
// below a launch's cost.  Design: one block per (row, kv layer); its threads
// move the token's KH contiguous D-value slabs as 16-byte vectors.  It is
// width-generic (D a multiple of 16 values): Llama's 128, Gemma-2-9B's 256
// and the MLA latent's 640 come from one build.
#include "kv_common.cuh"

namespace {

constexpr int THREADS = 128;

// 16 consecutive token values as float32: four float4 loads, or two
// 16-byte loads of bf16 widened (exactly)
template <typename In>
__device__ __forceinline__ void load16(const In* p, float4 (&f)[4]);
template <>
__device__ __forceinline__ void load16<float>(const float* p, float4 (&f)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) f[i] = reinterpret_cast<const float4*>(p)[i];
}
template <>
__device__ __forceinline__ void load16<__nv_bfloat16>(const __nv_bfloat16* p,
                                                      float4 (&f)[4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const uint4 w = reinterpret_cast<const uint4*>(p)[h];
    const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&w);
    const float2 a = __bfloat1622float2(b[0]), c = __bfloat1622float2(b[1]),
                 d = __bfloat1622float2(b[2]), e = __bfloat1622float2(b[3]);
    f[2 * h] = make_float4(a.x, a.y, c.x, c.y);
    f[2 * h + 1] = make_float4(d.x, d.y, e.x, e.y);
  }
}

// In: the tokens' type, P's own for float32 and bf16 pools, float32 or
// bf16 for byte pools
template <typename P, typename In, bool TWO>
__global__ void __launch_bounds__(THREADS) decode_tokens_write_kernel(
    const In* __restrict__ k_new,       // [Lk, B, KH, D]
    const In* __restrict__ v_new,
    P* __restrict__ k_pool,             // [L, pages, KH, TP, D]
    P* __restrict__ v_pool,
    const int* __restrict__ pool_layers,   // [Lk]
    const int* __restrict__ slot_pages,    // [Lk, B] (0 = discard)
    const int* __restrict__ slot_offsets,  // [B]
    const float* __restrict__ k_scales,    // [L or Lk, KH] (int8), else null
    const float* __restrict__ v_scales,
    int B, int L, int num_pages, int KH, int TP, int D, int scales_by_kv_layer) {
  const int b = blockIdx.x, li = blockIdx.y;
  const int page = slot_pages[(size_t)li * B + b];
  if (page == 0) return;  // zero page: discard, as the fused kernels do
  const int layer = pool_layers[li];
  const int off = slot_offsets[b];
  // a malformed slot writes nothing rather than outside the pool
  if (page < 0 || page >= num_pages || layer < 0 || layer >= L || off < 0 || off >= TP)
    return;
  const int sc_row = scales_by_kv_layer ? li : layer;
  constexpr int EPV = 16 / (int)sizeof(P);  // values a 16-byte pool vector
  const int per_head = D / EPV;
  const size_t token = (size_t)li * B + b;
  for (int i = threadIdx.x; i < KH * per_head; i += THREADS) {
    const int h = i / per_head, e0 = (i % per_head) * EPV;
    const size_t dst = ((((size_t)layer * num_pages + page) * KH + h) * TP + off) * D + e0;
    const size_t src = (token * KH + h) * D + e0;
    if constexpr (sizeof(P) == 1) {
#pragma unroll
      for (int kv = 0; kv < (TWO ? 2 : 1); ++kv) {
        const float* scales = kv ? v_scales : k_scales;
        const float sc = scales ? scales[sc_row * KH + h] : 1.f;
        float4 in[4];
        load16<In>((kv ? v_new : k_new) + src, in);
        *reinterpret_cast<uint4*>((kv ? v_pool : k_pool) + dst) =
            make_uint4(kvc::store4<P>(in[0], sc), kvc::store4<P>(in[1], sc),
                       kvc::store4<P>(in[2], sc), kvc::store4<P>(in[3], sc));
      }
    } else {
      *reinterpret_cast<uint4*>(k_pool + dst) = *reinterpret_cast<const uint4*>(k_new + src);
      if constexpr (TWO)
        *reinterpret_cast<uint4*>(v_pool + dst) = *reinterpret_cast<const uint4*>(v_new + src);
    }
  }
}

template <typename P, typename In>
int launch(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
           const int* pool_layers, const int* slot_pages, const int* slot_offsets,
           const float* k_scales, const float* v_scales, int Lk, int B, int L,
           int num_pages, int KH, int TP, int D, int by_kv, cudaStream_t s) {
  const dim3 grid(B, Lk);
  if (v_pool)
    decode_tokens_write_kernel<P, In, true><<<grid, THREADS, 0, s>>>(
        (const In*)k_new, (const In*)v_new, (P*)k_pool, (P*)v_pool, pool_layers, slot_pages,
        slot_offsets, k_scales, v_scales, B, L, num_pages, KH, TP, D, by_kv);
  else
    decode_tokens_write_kernel<P, In, false><<<grid, THREADS, 0, s>>>(
        (const In*)k_new, nullptr, (P*)k_pool, nullptr, pool_layers, slot_pages, slot_offsets,
        k_scales, nullptr, B, L, num_pages, KH, TP, D, by_kv);
  return (int)cudaGetLastError();
}

}  // namespace

// K7 (v_new, v_pool non-null) or K8 (both null).  dtype: kvc::DType of the
// pools; k_new / v_new [Lk, B, KH, D] in the pool's type, for byte pools
// float32 or (bf16_new) bf16; pool_layers [Lk], slot_pages [Lk, B] and
// slot_offsets [B] int32; k_scales / v_scales the int8 scales, [L, KH], or
// [Lk, KH] with scales_by_kv_layer (null for other pools); D * itemsize
// and, for byte pools, D a multiple of 16; every pointer 16-byte aligned
// (the wrapper checks both).
extern "C" int kvc_decode_tokens_write(int dtype, int bf16_new, const void* k_new,
                                       const void* v_new, void* k_pool, void* v_pool,
                                       const void* pool_layers, const void* slot_pages,
                                       const void* slot_offsets,
                                       const float* k_scales, const float* v_scales, int Lk,
                                       int B, int L, int num_pages, int KH, int TP, int D,
                                       int scales_by_kv_layer, void* stream) {
  if (Lk == 0 || B == 0) return 0;
  if (Lk > 65535) return (int)cudaErrorInvalidValue;
  const auto* pl = (const int*)pool_layers;
  const auto* sp = (const int*)slot_pages;
  const auto* so = (const int*)slot_offsets;
  cudaStream_t s = (cudaStream_t)stream;
#define KVC_DTW(P, In)                                                                \
  launch<P, In>(k_new, v_new, k_pool, v_pool, pl, sp, so, k_scales, v_scales, Lk, B, L, \
                num_pages, KH, TP, D, scales_by_kv_layer, s)
  switch (dtype) {
    case kvc::kF32: return KVC_DTW(float, float);
    case kvc::kBF16: return KVC_DTW(__nv_bfloat16, __nv_bfloat16);
    case kvc::kI8:
      return bf16_new ? KVC_DTW(int8_t, __nv_bfloat16) : KVC_DTW(int8_t, float);
    case kvc::kE4M3:
      return bf16_new ? KVC_DTW(kvc::e4m3, __nv_bfloat16) : KVC_DTW(kvc::e4m3, float);
    default: return (int)cudaErrorInvalidValue;
  }
#undef KVC_DTW
}
