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
//   - scores (q . k) * sm_scale in float32, online softmax in float32; a
//     bfloat16 pool multiplies bf16 operands (q, k, the softmax weights, v)
//     with float32 accumulation, a float32 pool multiplies in float32;
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
//   - bfloat16 pools (the serving path): 4 warps, 16 query rows each, run
//     Q.K^T and P.V on the tensor cores with mma.sync m16n8k16 (bf16 in,
//     float32 accumulate), FlashAttention-2 style: Q stays in registers as
//     A fragments, each 64-key tile of K and V is staged in shared memory
//     (rows padded to dodge bank conflicts), the score fragments are
//     softmaxed in registers (row max and sum reduced across the 4 lanes
//     that share a row) and reused directly as the A fragments of P.V.
//   - float32 pools: one thread per head_dim lane on the CUDA cores, 32-key
//     tiles, float32 throughout (the tensor cores have no full-float32
//     path).
// Not yet done: wgmma, a TMA ring, and overlap of the next tile's loads
// with the current tile's math.
#include "kv_common.cuh"

namespace {

constexpr int D = 128;     // head_dim; one thread per lane
constexpr int THREADS = D;
constexpr int ROWS = 64;   // query rows (token x group head) per block
constexpr int TILE = 32;   // keys staged per step

constexpr size_t kSmemBytes =
    sizeof(float) * ((size_t)ROWS * D + (size_t)TILE * (D + 1) +
                     (size_t)TILE * D + (size_t)ROWS * TILE + 3 * ROWS);

template <typename T>
__global__ void __launch_bounds__(THREADS) paged_prefill_kernel(
    const T* __restrict__ q,              // [N, Tq, KH*G, D]
    const T* __restrict__ k_pool,         // [L, P, KH, TP, D]
    const T* __restrict__ v_pool,
    const int* __restrict__ page_tables,  // [N, maxp]
    const int* __restrict__ q_starts,     // [N]
    const int* __restrict__ kv_lens,      // [N]
    T* __restrict__ out,                  // [N, Tq, KH*G, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale) {
  using namespace kvc;
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
    q_s[r * D + d] = to_f<T>(q[(((size_t)n * Tq + t) * QH + h * G + g) * D + d]);
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
        k_s[t * (D + 1) + d] = to_f<T>(k_pool[src]);
        v_s[t * D + d] = to_f<T>(v_pool[src]);
      }
    }
    __syncthreads();
    for (int i = d; i < ROWS * TILE; i += THREADS) {
      const int r = i / TILE, t = i % TILE;
      float s = -INFINITY;
      if (r < rows && t < nk) {
        const int kv = t0 + t;
        const int qp = q_start + t_begin + r / G;
        if (kv <= qp && kv < kv_len && (window <= 0 || kv > qp - window)) {
          float dot = 0.f;
          const float* qr = q_s + r * D;
          const float* kr = k_s + t * (D + 1);
#pragma unroll 16
          for (int e = 0; e < D; ++e) dot = fmaf(qr[e], kr[e], dot);
          s = dot * sm_scale;
        }
      }
      p_s[i] = s;
    }
    __syncthreads();
    if (d < rows) {
      float mt = -INFINITY;
      for (int t = 0; t < nk; ++t) mt = fmaxf(mt, p_s[d * TILE + t]);
      const float m_new = fmaxf(m_s[d], mt);
      // a row with nothing visible yet keeps m = -inf and scale 1
      a_s[d] = m_new == -INFINITY ? 1.f : expf(m_s[d] - m_new);
      m_s[d] = m_new;
    }
    __syncthreads();
    for (int i = d; i < ROWS * TILE; i += THREADS) {
      const float s = p_s[i];
      p_s[i] = s == -INFINITY ? 0.f : expf(s - m_s[i / TILE]);
    }
    __syncthreads();
    if (d < rows) {
      float sum = 0.f;
      for (int t = 0; t < nk; ++t) sum += p_s[d * TILE + t];
      l_s[d] = l_s[d] * a_s[d] + sum;
    }
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      if (r < rows) {
        float pv = 0.f;
        const float* pr = p_s + r * TILE;
        for (int t = 0; t < nk; ++t) pv = fmaf(round_op<T>(pr[t]), v_s[t * D + d], pv);
        acc[r] = acc[r] * a_s[r] + pv;
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (r < rows) {
      const int t = t_begin + r / G, g = r % G;
      const float l = l_s[r];
      out[(((size_t)n * Tq + t) * QH + h * G + g) * D + d] =
          from_f<T>(acc[r] / (l == 0.f ? 1.f : l));
    }
  }
}


// ---- bfloat16: tensor cores (mma.sync m16n8k16) ---------------------------

constexpr int MMA_KT = 64;          // keys per tile
constexpr int MMA_LD = D + 8;       // padded smem row (bf16 elements)

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_halves(const __nv_bfloat16* lo,
                                                const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

__global__ void __launch_bounds__(THREADS) paged_prefill_mma_kernel(
    const __nv_bfloat16* __restrict__ q,       // [N, Tq, KH*G, D]
    const __nv_bfloat16* __restrict__ k_pool,  // [L, P, KH, TP, D]
    const __nv_bfloat16* __restrict__ v_pool,
    const int* __restrict__ page_tables,       // [N, maxp]
    const int* __restrict__ q_starts,          // [N]
    const int* __restrict__ kv_lens,           // [N]
    __nv_bfloat16* __restrict__ out,           // [N, Tq, KH*G, D]
    int layer, int num_pages, int KH, int G, int TP, int maxp, int Tq,
    int window, float sm_scale) {
  __shared__ __align__(16) __nv_bfloat16 k_s[MMA_KT][MMA_LD];
  __shared__ __align__(16) __nv_bfloat16 v_s[MMA_KT][MMA_LD];

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
  uint32_t qa[D / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = 16 * warp + gq + 8 * i;
    live[i] = r < rows;
    qpos[i] = q_start + t_begin + r / G;
  }
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
        kv4 = *reinterpret_cast<const uint4*>(k_pool + src);
        vv4 = *reinterpret_cast<const uint4*>(v_pool + src);
      }
      *reinterpret_cast<uint4*>(&k_s[kr][c]) = kv4;
      *reinterpret_cast<uint4*>(&v_s[kr][c]) = vv4;
    }
    __syncthreads();

    // S = Q K^T: 8 column tiles of 8 keys
    float s[MMA_KT / 8][4];
#pragma unroll
    for (int nt = 0; nt < MMA_KT / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const __nv_bfloat16* kr = &k_s[nt * 8 + gq][ks * 16 + 2 * tq];
        mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
                 *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // scale, mask, online softmax (rows gq and gq+8 of this warp)
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < MMA_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const int key = t0 + nt * 8 + 2 * tq + (e % 2);
        const bool ok = live[i] && key < t0 + nk && key <= qpos[i] &&
                        key < kv_len && (window <= 0 || key > qpos[i] - window);
        s[nt][e] = ok ? s[nt][e] * sm_scale : -INFINITY;
        mx[i] = fmaxf(mx[i], s[nt][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float m_new = fmaxf(m[i], mx[i]);
      // a row that has seen nothing yet keeps m = -inf and scale 1
      alpha[i] = m_new == -INFINITY ? 1.f : expf(m[i] - m_new);
      m[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < MMA_KT / 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e / 2;
        const float p = s[nt][e] == -INFINITY ? 0.f : expf(s[nt][e] - m[i]);
        s[nt][e] = p;
        psum[i] += p;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + psum[i];
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[j][0] *= alpha[0];
      o[j][1] *= alpha[0];
      o[j][2] *= alpha[1];
      o[j][3] *= alpha[1];
    }
    // O += P V: the score fragments of key tiles 2j, 2j+1 are the A
    // fragment of key step j (weights rounded to bf16)
#pragma unroll
    for (int j = 0; j < MMA_KT / 16; ++j) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
          pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
          pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
      const int k0 = 16 * j + 2 * tq;
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const int col = dn * 8 + gq;
        mma_bf16(o[dn], pa, pack_halves(&v_s[k0][col], &v_s[k0 + 1][col]),
                 pack_halves(&v_s[k0 + 8][col], &v_s[k0 + 9][col]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / (li == 0.f ? 1.f : li);
    if (!live[i]) continue;
    const int r = 16 * warp + gq + 8 * i;
    __nv_bfloat16* orow =
        out + (((size_t)n * Tq + t_begin + r / G) * QH + h * G + r % G) * D;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      *reinterpret_cast<uint32_t*>(orow + dn * 8 + 2 * tq) =
          pack_bf16(o[dn][2 * i] * inv, o[dn][2 * i + 1] * inv);
    }
  }
}

int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               const void* page_tables, const void* q_starts,
               const void* kv_lens, void* out, int N, int layer, int num_pages,
               int KH, int G, int TP, int maxp, int Tq, int window,
               float sm_scale, cudaStream_t stream) {
  static bool configured = false;  // dynamic shared memory above 48 KB
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_prefill_kernel<float>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    configured = true;
  }
  const int QT = ROWS / G;
  dim3 grid(N, KH, (Tq + QT - 1) / QT);
  paged_prefill_kernel<float><<<grid, THREADS, kSmemBytes, stream>>>(
      (const float*)q, (const float*)k_pool, (const float*)v_pool,
      (const int*)page_tables, (const int*)q_starts, (const int*)kv_lens,
      (float*)out, layer, num_pages, KH, G, TP, maxp, Tq, window, sm_scale);
  return (int)cudaGetLastError();
}

int launch_bf16(const void* q, const void* k_pool, const void* v_pool,
                const void* page_tables, const void* q_starts,
                const void* kv_lens, void* out, int N, int layer,
                int num_pages, int KH, int G, int TP, int maxp, int Tq,
                int window, float sm_scale, cudaStream_t stream) {
  const int QT = ROWS / G;
  dim3 grid(N, KH, (Tq + QT - 1) / QT);
  paged_prefill_mma_kernel<<<grid, THREADS, 0, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k_pool,
      (const __nv_bfloat16*)v_pool, (const int*)page_tables,
      (const int*)q_starts, (const int*)kv_lens, (__nv_bfloat16*)out, layer,
      num_pages, KH, G, TP, maxp, Tq, window, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int kvc_paged_prefill(
    int dtype, const void* q, const void* k_pool, const void* v_pool,
    const void* page_tables, const void* q_starts, const void* kv_lens,
    void* out, int N, int layer, int num_pages, int KH, int G, int TP,
    int maxp, int Tq, int window, float sm_scale, void* stream) {
  if (G < 1 || ROWS % G) return (int)cudaErrorInvalidValue;
  if (N == 0 || Tq == 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == kvc::kF32)
    return launch_f32(q, k_pool, v_pool, page_tables, q_starts, kv_lens, out,
                      N, layer, num_pages, KH, G, TP, maxp, Tq, window,
                      sm_scale, s);
  if (dtype == kvc::kBF16)
    return launch_bf16(q, k_pool, v_pool, page_tables, q_starts, kv_lens, out,
                       N, layer, num_pages, KH, G, TP, maxp, Tq, window,
                       sm_scale, s);
  return (int)cudaErrorInvalidValue;
}
