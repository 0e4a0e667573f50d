// K2: page-chunk writer for prefill K/V.
//
// Replaces the Pallas kernel _prefill_write_kernel of
// kvcached_tpu/ops/paged_attention.py (entry point write_prefill_kv).  A
// page-aligned chunk k_new/v_new [KH, T, D] (T a multiple of the page's TP
// tokens) is copied into the listed physical pages of one layer: chunk j of
// head h lands in pool[layer, pages[j], h].  Page 0 is the zero page: a
// chunk aimed at it is discarded.  The copy is of raw bytes, so the pool
// bytes equal the source bytes exactly.
//
// K6, kvc_prefill_write_single, is the same copy for the single pool of the
// MLA family (replaces _prefill_write_single_kernel, entry point
// write_prefill_kv_single): the latent chunk [KH, T, D] and no V.
//
// kvc_prefill_write_quant is K2 into a byte pool: the chunk comes as
// float32 and each value is quantized in the same pass, as the reference's
// write_prefill_kv does before its copy (int8: clip(round(x / scale),
// -127, 127) with head h's scale; e4m3: round to nearest even, NaN past
// 464), so the pool bytes equal the reference's.  K6 into a byte latent
// pool is the same entry with null V pointers (the reference's
// write_prefill_kv_single quantizes with the latent's K scale).
//
// What bounds it on an H100: device-memory bytes (one read and one write of
// each element, no arithmetic).  Design: one block per (chunk, kv head),
// whose TP x D slab is contiguous on both sides; threads move it as 16-byte
// vectors, neighbouring threads on neighbouring addresses (the quantizing
// writer reads four 16-byte float32 vectors for each 16 bytes it stores).
#include "kv_common.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) prefill_write_kernel(
    const uint4* __restrict__ k_new,  // [KH, n_chunks, slab]
    const uint4* __restrict__ v_new,
    uint4* __restrict__ k_pool,       // [L, P, KH, slab]
    uint4* __restrict__ v_pool,
    const int* __restrict__ pages,    // [n_chunks]
    int layer, int num_pages, int KH, int n_chunks, int slab_vec) {
  // v_pool null: the single-pool writer (K6)
  const int j = blockIdx.x, h = blockIdx.y;
  const int page = pages[j];
  if (page == 0) return;  // zero page: discard
  const size_t src = ((size_t)h * n_chunks + j) * slab_vec;
  const size_t dst = (((size_t)layer * num_pages + page) * KH + h) * slab_vec;
  for (int i = threadIdx.x; i < slab_vec; i += THREADS) {
    k_pool[dst + i] = k_new[src + i];
    if (v_pool) v_pool[dst + i] = v_new[src + i];
  }
}

// K2 into a byte pool of P: thread i quantizes 16 float32 values (four
// float4 loads) into one 16-byte store.  v_pool null: K6, no V.
template <typename P>
__global__ void __launch_bounds__(THREADS) prefill_write_quant_kernel(
    const float4* __restrict__ k_new,  // [KH, n_chunks, slab] float32
    const float4* __restrict__ v_new,
    uint4* __restrict__ k_pool,        // [L, P, KH, slab] bytes
    uint4* __restrict__ v_pool,
    const int* __restrict__ pages,     // [n_chunks]
    const float* __restrict__ k_scale, // [KH] (int8), else null
    const float* __restrict__ v_scale,
    int layer, int num_pages, int KH, int n_chunks, int slab_vec) {
  const int j = blockIdx.x, h = blockIdx.y;
  const int page = pages[j];
  if (page == 0) return;  // zero page: discard
  const float ksc = k_scale ? k_scale[h] : 1.f;
  const float vsc = v_scale ? v_scale[h] : 1.f;
  const size_t src = ((size_t)h * n_chunks + j) * slab_vec * 4;
  const size_t dst = (((size_t)layer * num_pages + page) * KH + h) * slab_vec;
  for (int i = threadIdx.x; i < slab_vec; i += THREADS) {
#pragma unroll
    for (int kv = 0; kv < 2; ++kv) {
      if (kv && !v_pool) break;
      const float4* in = (kv ? v_new : k_new) + src + (size_t)i * 4;
      const float sc = kv ? vsc : ksc;
      (kv ? v_pool : k_pool)[dst + i] =
          make_uint4(kvc::store4<P>(in[0], sc), kvc::store4<P>(in[1], sc),
                     kvc::store4<P>(in[2], sc), kvc::store4<P>(in[3], sc));
    }
  }
}

int launch(const void* k_new, const void* v_new, void* k_pool, void* v_pool,
           const void* pages, int layer, int num_pages, int KH, int n_chunks,
           int slab_bytes, void* stream) {
  if (slab_bytes % 16) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  dim3 grid(n_chunks, KH);
  prefill_write_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint4*)k_new, (const uint4*)v_new, (uint4*)k_pool,
      (uint4*)v_pool, (const int*)pages, layer, num_pages, KH, n_chunks,
      slab_bytes / 16);
  return (int)cudaGetLastError();
}

}  // namespace

// slab_bytes = TP * D * itemsize, a multiple of 16; every pointer 16-byte
// aligned (the wrapper checks both).
extern "C" int kvc_prefill_write(const void* k_new, const void* v_new,
                                 void* k_pool, void* v_pool, const void* pages,
                                 int layer, int num_pages, int KH,
                                 int n_chunks, int slab_bytes, void* stream) {
  return launch(k_new, v_new, k_pool, v_pool, pages, layer, num_pages, KH,
                n_chunks, slab_bytes, stream);
}

// K2 into an int8 (dtype 2) or e4m3 (dtype 3) pool: k_new / v_new are
// float32 [KH, n_chunks * TP, D], slab_elems = TP * D (a multiple of 16),
// k_scale / v_scale the layer's [KH] int8 scales (null for e4m3).  K6 into
// a byte latent pool passes null v_new, v_pool and v_scale.
extern "C" int kvc_prefill_write_quant(int dtype, const void* k_new,
                                       const void* v_new, void* k_pool,
                                       void* v_pool, const void* pages,
                                       const float* k_scale,
                                       const float* v_scale, int layer,
                                       int num_pages, int KH, int n_chunks,
                                       int slab_elems, void* stream) {
  if (slab_elems % 16) return (int)cudaErrorInvalidValue;
  if (n_chunks == 0) return 0;
  dim3 grid(n_chunks, KH);
  cudaStream_t s = (cudaStream_t)stream;
  const float4* kn = (const float4*)k_new;
  const float4* vn = (const float4*)v_new;
  if (dtype == kvc::kI8)
    prefill_write_quant_kernel<int8_t><<<grid, THREADS, 0, s>>>(
        kn, vn, (uint4*)k_pool, (uint4*)v_pool, (const int*)pages, k_scale,
        v_scale, layer, num_pages, KH, n_chunks, slab_elems / 16);
  else if (dtype == kvc::kE4M3)
    prefill_write_quant_kernel<kvc::e4m3><<<grid, THREADS, 0, s>>>(
        kn, vn, (uint4*)k_pool, (uint4*)v_pool, (const int*)pages, nullptr,
        nullptr, layer, num_pages, KH, n_chunks, slab_elems / 16);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

// K6: the single (MLA latent) pool; the same layout without V.
extern "C" int kvc_prefill_write_single(const void* k_new, void* k_pool,
                                        const void* pages, int layer,
                                        int num_pages, int KH, int n_chunks,
                                        int slab_bytes, void* stream) {
  return launch(k_new, nullptr, k_pool, nullptr, pages, layer, num_pages, KH,
                n_chunks, slab_bytes, stream);
}
