// Shared helpers for the paged-KV kernels: element conversions, the dtype
// switch of the plain C entry points, and the flash-attention tile steps of
// K3 and K4 (bf16 on the tensor cores, float32 on the CUDA cores).
//
// Pools hold float32, bfloat16, int8 or float8 e4m3.  A bfloat16 pool is
// multiplied as bf16 operands with float32 accumulation: operands are
// widened to float32 (a bf16 x bf16 product is exact in float32) and the
// softmax weights are rounded to bf16 before they multiply V, as the TPU
// kernels round them for their bf16 matrix unit.  Byte pools (int8, e4m3)
// run the same bf16 path on their values widened to bf16 (exact for both),
// with q in bf16 and a float32 output; the kernels quantize what they
// write as the reference does (quantize_i8, e4m3_bits) and fold the int8
// per-(layer, kv head) scales into the scores (K) and the output (V).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace kvc {

// dtype codes passed by the Python wrappers
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2, kE4M3 = 3 };

using e4m3 = __nv_fp8_e4m3;

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <>
__device__ __forceinline__ float to_f<int8_t>(int8_t x) { return (float)x; }
template <>
__device__ __forceinline__ float to_f<e4m3>(e4m3 x) {  // exact
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(x.__x, __NV_E4M3)));
}

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// The int8 value the reference stores for x: clip(round(x / scale), -127,
// 127) in float32, an IEEE divide (never the reciprocal: x * (1 / scale)
// rounds differently) and round half to even; NaN becomes 0, as XLA
// converts it.  Needs a build without --use_fast_math, which would make
// the divide approximate.
__device__ __forceinline__ int8_t quantize_i8(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  if (r != r) return 0;
  return (int8_t)fminf(fmaxf(r, -127.f), 127.f);
}

// The e4m3 bits the reference stores for x: round to nearest even WITHOUT
// saturation, as its float32 -> float8_e4m3fn conversion does.  Past 464
// (which ties to 448) and for inf or NaN that is NaN, with x's sign;
// below, the hardware's saturating conversion gives the same bits.
__device__ __forceinline__ uint8_t e4m3_bits(float x) {
  if (!(fabsf(x) <= 464.f)) return signbit(x) ? 0xFF : 0x7F;
  return __nv_cvt_float_to_fp8(x, __NV_SATFINITE, __NV_E4M3);
}

// The value a pool of type P stores for x (`scale`: the int8 scale of the
// row's layer and kv head; other types ignore it)
template <typename P>
__device__ __forceinline__ P store_f(float x, float scale);
template <>
__device__ __forceinline__ float store_f<float>(float x, float) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 store_f<__nv_bfloat16>(float x, float) {
  return __float2bfloat16(x);
}
template <>
__device__ __forceinline__ int8_t store_f<int8_t>(float x, float scale) {
  return quantize_i8(x, scale);
}
template <>
__device__ __forceinline__ e4m3 store_f<e4m3>(float x, float) {
  e4m3 r;
  r.__x = e4m3_bits(x);
  return r;
}

// Four values as a byte pool of P stores them, packed into one 32-bit word
// (value e in byte e), for 16-byte vector stores of 16 values.
template <typename P>
__device__ __forceinline__ uint32_t store4(float4 x, float scale) {
  const float xs[4] = {x.x, x.y, x.z, x.w};
  uint32_t w = 0;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const P b = store_f<P>(xs[e], scale);
    w |= (uint32_t)(*reinterpret_cast<const uint8_t*>(&b)) << (8 * e);
  }
  return w;
}

// The kernels' types around a pool of P: q (Q), the output (Out), the
// written tokens (New) and the matmul operands (Op).  float32 and bf16
// pools use their own type throughout; byte pools take bf16 q, float32
// tokens (quantized in the kernel) and give a float32 output.
template <typename P>
struct Types {
  using Q = P;
  using Out = P;
  using New = P;
  using Op = P;
};
template <>
struct Types<int8_t> {
  using Q = __nv_bfloat16;
  using Out = float;
  using New = float;
  using Op = __nv_bfloat16;
};
template <>
struct Types<e4m3> : Types<int8_t> {};

// value `i` (0..3) of a 32-bit word of byte-pool values, as float
template <typename P>
__device__ __forceinline__ float byte_f(uint32_t w, int i);
template <>
__device__ __forceinline__ float byte_f<int8_t>(uint32_t w, int i) {
  return (float)((int)(w << (24 - 8 * i)) >> 24);  // sign-extend byte i
}
template <>
__device__ __forceinline__ float byte_f<e4m3>(uint32_t w, int i) {
  const __nv_fp8_storage_t b = (__nv_fp8_storage_t)((w >> (8 * i)) & 0xFFu);
  return __half2float(__half(__nv_cvt_fp8_to_halfraw(b, __NV_E4M3)));
}

// int8 scale of (layer, kv head h), 1 without scales (other pools)
__device__ __forceinline__ float head_scale(const float* scales, int layer,
                                            int KH, int h) {
  return scales ? scales[layer * KH + h] : 1.f;
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

// 8 byte-pool values (one 64-bit word) widened to 8 bf16 (one 16-byte
// vector): int8 and e4m3 values are exact in bf16
template <typename P>
__device__ __forceinline__ uint4 widen8(uint2 v) {
  uint4 r;
  r.x = pack_bf16(byte_f<P>(v.x, 0), byte_f<P>(v.x, 1));
  r.y = pack_bf16(byte_f<P>(v.x, 2), byte_f<P>(v.x, 3));
  r.z = pack_bf16(byte_f<P>(v.y, 0), byte_f<P>(v.y, 1));
  r.w = pack_bf16(byte_f<P>(v.y, 2), byte_f<P>(v.y, 3));
  return r;
}

// two bf16 values from two addresses, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_halves(const __nv_bfloat16* lo,
                                                const __nv_bfloat16* hi) {
  return (uint32_t)(*reinterpret_cast<const uint16_t*>(lo)) |
         ((uint32_t)(*reinterpret_cast<const uint16_t*>(hi)) << 16);
}

// 16 bytes from device memory into shared memory without passing through
// registers (cp.async, Ampere and later); completes at cp_async_wait.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A score after Gemma2's logit soft-capping, cap * tanh(s / cap), in a
// kernel instance that caps (kCap), as the reference computes it: s * (1 /
// cap), the accurate tanhf (never tanh.approx, whose ~2^-11 relative error
// is ~0.025 of a score at cap 50), times cap.  The result is bounded by
// cap, so a row keeps finite maxima; masked lanes are set to -inf after it.
// The cap reaches the kernels as one float (0: off) and the launch picks
// the instance from it, so an uncapped launch runs code without the cap: a
// runtime test on the cap inside the tile step made K3's uncapped byte-pool
// instances 17-19% slower on the H100.
template <bool kCap>
__device__ __forceinline__ float soft_cap(float s, float cap) {
  if constexpr (kCap) {
    return cap * tanhf(s * (1.f / cap));
  } else {
    return s;
  }
}

// ---- the tile step of the flash-attention kernels (K3, K4) ---------------
//
// The head dim D is a template parameter (128 or 256; csrc/*.cu build each
// width into a library of its own, KVC_HEAD_DIM), so each width's
// instances are compiled for it and the 128 instances keep their code.

constexpr int kThreads = 128;  // a tensor-core block: 4 warps of 16 query rows
constexpr int kMmaKeys = 64;   // keys per bf16 tile
constexpr int kF32Keys = 32;   // keys per float32 tile
constexpr int kF32Rows = 64;   // query rows per float32 block

// S = Q K^T for a warp's 16 query rows over a 64-key tile, Q held as this
// lane's A fragments qa in registers (head_dim 128: 32 registers).
template <int D, int LD>
__device__ __forceinline__ void mma_scores(const uint32_t (&qa)[D / 16][4],
                                           const __nv_bfloat16 (&k_s)[kMmaKeys][LD],
                                           float (&s)[kMmaKeys / 8][4]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const __nv_bfloat16* kr = &k_s[nt * 8 + gq][ks * 16 + 2 * tq];
      mma_bf16(s[nt], qa[ks], *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

// The same with the warp's 16 query rows read from shared memory, q_w
// [16][LD] bf16, one k-step's A fragment at a time (head_dim 256: held in
// registers, Q's fragments (64) and the output's (128) beside the scores'
// (32) would pass the 255 registers a thread can have, and spill).
template <int D, int LD>
__device__ __forceinline__ void mma_scores(const __nv_bfloat16 (&q_w)[16][LD],
                                           const __nv_bfloat16 (&k_s)[kMmaKeys][LD],
                                           float (&s)[kMmaKeys / 8][4]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
#pragma unroll
  for (int nt = 0; nt < kMmaKeys / 8; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * tq;
    const uint32_t qa[4] = {*reinterpret_cast<const uint32_t*>(&q_w[gq][c]),
                            *reinterpret_cast<const uint32_t*>(&q_w[gq + 8][c]),
                            *reinterpret_cast<const uint32_t*>(&q_w[gq][c + 8]),
                            *reinterpret_cast<const uint32_t*>(&q_w[gq + 8][c + 8])};
#pragma unroll
    for (int nt = 0; nt < kMmaKeys / 8; ++nt) {
      const __nv_bfloat16* kr = &k_s[nt * 8 + gq][c];
      mma_bf16(s[nt], qa, *reinterpret_cast<const uint32_t*>(kr),
               *reinterpret_cast<const uint32_t*>(kr + 8));
    }
  }
}

// One tile of keys t0 + [0, nk) for the 16 query rows of a warp on the
// tensor cores (mma.sync m16n8k16, FlashAttention-2 register layout).  This
// lane holds query rows gq and gq + 8 of the warp (gq = lane / 4): their
// query operand q (:func:`mma_scores`: A fragments, or the warp's rows in
// shared memory), their output fragments o, their running max m and their
// running sum l over this lane's columns.  The tile is staged in shared
// memory, k_s / v_s (rows past nk zero); taking them as arrays of a known
// row length, not as pointers, keeps K3 at its own code's speed (a pointer
// interface cost it 8% and 32 registers).  Query row i sees a key <=
// qpos[i], and > qpos[i] - window with a window; a score is (q . k) *
// sm_scale * k_scale (k_scale: an int8 pool's K scale, else 1), then, in
// an instance that caps (kCap), softcap * tanh(score / softcap) before the
// mask (Gemma2's logit soft-capping); the softmax weights are rounded to
// bf16 before they multiply V.
template <bool kCap, int D, int LD, typename QOp>
__device__ __forceinline__ void mma_attend_tile(
    const QOp& q, const bool (&live)[2],
    const int (&qpos)[2], const __nv_bfloat16 (&k_s)[kMmaKeys][LD],
    const __nv_bfloat16 (&v_s)[kMmaKeys][LD], int t0, int nk, int window,
    float sm_scale, float k_scale, float softcap, float (&o)[D / 8][4],
    float (&m)[2], float (&l)[2]) {
  const int lane = threadIdx.x % 32, gq = lane / 4, tq = lane % 4;
  // S = Q K^T: 8 column tiles of 8 keys
  float s[kMmaKeys / 8][4];
  mma_scores<D, LD>(q, k_s, s);
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
      s[nt][e] = ok ? soft_cap<kCap>(s[nt][e] * sm_scale * k_scale, softcap) : -INFINITY;
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
  for (int j = 0; j < D / 8; ++j) {
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
    for (int dn = 0; dn < D / 8; ++dn) {
      const int col = dn * 8 + gq;
      mma_bf16(o[dn], pa, pack_halves(&v_s[k0][col], &v_s[k0 + 1][col]),
               pack_halves(&v_s[k0 + 8][col], &v_s[k0 + 9][col]));
    }
  }
}

// shared memory of a float32 block of head dim D: q_s, k_s, v_s, p_s, m_s,
// l_s, a_s as f32_attend_tile lays them out (65 KB at 128, 137 KB at 256)
template <int D>
constexpr size_t kF32SmemBytes =
    sizeof(float) * ((size_t)kF32Rows * D + (size_t)kF32Keys * (D + 1) +
                     (size_t)kF32Keys * D + (size_t)kF32Rows * kF32Keys + 3 * kF32Rows);

// One tile of keys t0 + [0, nk) for `rows` query rows on the CUDA cores in
// float32, a block of D threads, one thread per head_dim lane d =
// threadIdx.x.  Shared memory holds q_s [rows][D], k_s [kF32Keys][D + 1]
// and v_s [kF32Keys][D] (staged by the caller, then a barrier), the scores
// p_s [kF32Rows][kF32Keys] and the softmax state m_s / l_s / a_s
// [kF32Rows]; acc is this lane's unnormalised output per query row.  Query
// row r sits at qpos0 + r / G and sees a key <= it, and > it - window with
// a window; kCap and softcap as in mma_attend_tile.  The caller puts a
// barrier before restaging k_s / v_s.
template <bool kCap, int D>
__device__ __forceinline__ void f32_attend_tile(
    const float* q_s, const float* k_s, const float* v_s, float* p_s,
    float* m_s, float* l_s, float* a_s, float (&acc)[kF32Rows], int rows,
    int G, int qpos0, int t0, int nk, int window, float sm_scale,
    float softcap) {
  constexpr int TILE = kF32Keys;
  const int d = threadIdx.x;
  for (int i = d; i < rows * TILE; i += D) {
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
        s = soft_cap<kCap>(dot * sm_scale, softcap);
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
  for (int i = d; i < rows * TILE; i += D) {
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
