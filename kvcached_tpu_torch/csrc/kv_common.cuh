// Shared helpers for the paged-KV kernels: element conversions, the dtype
// switch of the plain C entry points, and the flash-attention tile steps of
// K3 and K4 (bf16 on the tensor cores, float32 on the CUDA cores).
//
// Pools hold float32 or bfloat16.  A bfloat16 pool is multiplied as bf16
// operands with float32 accumulation: operands are widened to float32 (a
// bf16 x bf16 product is exact in float32) and the softmax weights are
// rounded to bf16 before they multiply V, as the TPU kernels round them
// for their bf16 matrix unit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvc {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// value of x after a round trip through the operand type T
template <typename T>
__device__ __forceinline__ float round_op(float x) {
  return to_f<T>(from_f<T>(x));
}

// c += a b on the tensor cores: a is a 16x16 bf16 A fragment, (b0, b1) a
// 16x8 bf16 B fragment, c the 16x8 float32 accumulator fragment
// (mma.sync m16n8k16, row.col).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 and packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values from two addresses, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_halves(const __nv_bfloat16* lo,
                                                const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// ---- the tile step of the flash-attention kernels (K3, K4) ---------------

constexpr int kHeadDim = 128;  // head_dim of every kernel
constexpr int kThreads = 128;  // 4 warps; one thread per head_dim lane (f32)
constexpr int kMmaKeys = 64;   // keys per bf16 tile
constexpr int kF32Keys = 32;   // keys per float32 tile
constexpr int kF32Rows = 64;   // query rows per float32 block

// One tile of keys t0 + [0, nk) for the 16 query rows of a warp on the
// tensor cores (mma.sync m16n8k16, FlashAttention-2 register layout).  This
// lane holds query rows gq and gq + 8 of the warp (gq = lane / 4): their A
// fragments qa, their output fragments o, their running max m and their
// running sum l over this lane's columns.  The tile is staged in shared
// memory, k_s / v_s (rows past nk zero); taking them as arrays of a known
// row length, not as pointers, keeps K3 at its own code's speed (a pointer
// interface cost it 8% and 32 registers).  Query row i sees a key <=
// qpos[i], and > qpos[i] - window with a window; the softmax weights are
// rounded to bf16 before they multiply V.
template <int LD>
__device__ __forceinline__ void mma_attend_tile(
    const uint32_t (&qa)[kHeadDim / 16][4], const bool (&live)[2],
    const int (&qpos)[2], const __nv_bfloat16 (&k_s)[kMmaKeys][LD],
    const __nv_bfloat16 (&v_s)[kMmaKeys][LD], int t0, int nk, int window,
    float sm_scale, float (&o)[kHeadDim / 8][4], float (&m)[2], float (&l)[2]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  // S = Q K^T: 8 column tiles of 8 keys
  float s[kMmaKeys / 8][4];
#pragma unroll
  for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      const __nv_bfloat16* kr = &k_s[nt * 8 + gq][ks * 16 + 2 * tq];
      mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
  // scale, mask, online softmax (rows gq and gq+8 of this warp)
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e / 2;
      const int key = t0 + nt * 8 + 2 * tq + (e % 2);
      const bool ok = live[i] && key < t0 + nk && key <= qpos[i] &&
                      (window <= 0 || key > qpos[i] - window);
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
  for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
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
  for (int j = 0; j < kHeadDim / 8; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }
  // O += P V: the score fragments of key tiles 2j, 2j+1 are the A fragment
  // of key step j
#pragma unroll
  for (int j = 0; j < kMmaKeys / 16; ++j) {
    const uint32_t pa[4] = {
        pack_bf16(s[2 * j][0], s[2 * j][1]), pack_bf16(s[2 * j][2], s[2 * j][3]),
        pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
        pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
    const int k0 = 16 * j + 2 * tq;
#pragma unroll
    for (int dn = 0; dn < kHeadDim / 8; ++dn) {
      const int col = dn * 8 + gq;
      mma_bf16(o[dn], pa, pack_halves(&v_s[k0][col], &v_s[k0 + 1][col]),
               pack_halves(&v_s[k0 + 8][col], &v_s[k0 + 9][col]));
    }
  }
}

// shared memory of a float32 block: q_s, k_s, v_s, p_s, m_s, l_s, a_s as
// f32_attend_tile lays them out
constexpr size_t kF32SmemBytes =
    sizeof(float) * ((size_t)kF32Rows * kHeadDim + (size_t)kF32Keys * (kHeadDim + 1) +
                     (size_t)kF32Keys * kHeadDim + (size_t)kF32Rows * kF32Keys + 3 * kF32Rows);

// One tile of keys t0 + [0, nk) for `rows` query rows on the CUDA cores in
// float32, one thread per head_dim lane d = threadIdx.x.  Shared memory
// holds q_s [rows][kHeadDim], k_s [kF32Keys][kHeadDim + 1] and v_s
// [kF32Keys][kHeadDim] (staged by the caller, then a barrier), the scores
// p_s [kF32Rows][kF32Keys] and the softmax state m_s / l_s / a_s
// [kF32Rows]; acc is this lane's unnormalised output per query row.  Query
// row r sits at qpos0 + r / G and sees a key <= it, and > it - window with
// a window.  The caller puts a barrier before restaging k_s / v_s.
__device__ __forceinline__ void f32_attend_tile(
    const float* q_s, const float* k_s, const float* v_s, float* p_s,
    float* m_s, float* l_s, float* a_s, float (&acc)[kF32Rows], int rows,
    int G, int qpos0, int t0, int nk, int window, float sm_scale) {
  constexpr int D = kHeadDim, TILE = kF32Keys;
  const int d = threadIdx.x;
  for (int i = d; i < rows * TILE; i += kThreads) {
    const int r = i / TILE, t = i % TILE;
    float s = -INFINITY;
    if (t < nk) {
      const int kv = t0 + t, qp = qpos0 + r / G;
      if (kv <= qp && (window <= 0 || kv > qp - window)) {
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
  for (int i = d; i < rows * TILE; i += kThreads) {
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
  for (int r = 0; r < kF32Rows; ++r) {
    if (r < rows) {
      float pv = 0.f;
      const float* pr = p_s + r * TILE;
      for (int t = 0; t < nk; ++t) pv = fmaf(pr[t], v_s[t * D + d], pv);
      acc[r] = acc[r] * a_s[r] + pv;
    }
  }
}

}  // namespace kvc
