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
// What bounds it on an H100: device-memory bytes (one read and one write of
// each element, no arithmetic).  Design: one block per (chunk, kv head),
// whose TP x D slab is contiguous on both sides; threads move it as 16-byte
// vectors, neighbouring threads on neighbouring addresses.
#include <cuda_runtime.h>
#include <stdint.h>

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

// K6: the single (MLA latent) pool; the same layout without V.
extern "C" int kvc_prefill_write_single(const void* k_new, void* k_pool,
                                        const void* pages, int layer,
                                        int num_pages, int KH, int n_chunks,
                                        int slab_bytes, void* stream) {
  return launch(k_new, nullptr, k_pool, nullptr, pages, layer, num_pages, KH,
                n_chunks, slab_bytes, stream);
}
