// Flash-attention forward with a runtime query offset (GQA, causal / window /
// prefix masks).
//
// Replaces the TPU kernel src/repro/kernels/flash_attention/kernel.py::
// flash_attention_fwd (bodies _fwd_kernel and _fwd_kernel_dyn over the shared
// _fwd_body and _mask).  q [B, Sq, H, D]; k, v [B, Sk, G, D] with H % G == 0;
// returns o [B, Sq, H, D] in q's type and lse [B, H, Sq] in fp32.  Query row
// i sits at absolute position q_offset + i, key j at position j.  q_offset,
// window and prefix are plain launch arguments, so one kernel serves the
// static-offset (training) and the dynamic-offset (chunked prefill) call.
//
// Numerics follow the TPU kernel and ref.py: q, k, v are widened to fp32 and
// both products run in fp32; masked scores are set to the finite
// NEG_INF = -2^30 (so a row with no visible key averages v exactly like the
// reference); the running sum is clamped at 1e-30 before the division and in
// lse = m + log(l).  Key positions >= Sk carry no weight at all (ref.py has
// no padding).
//
// Bound on the H100: at the serving shape (q [1, 64, 32, 64] against a
// [1, 512, 4, 64] bf16 cache) the whole buffer is ~2.7e8 flops over ~1.1 MB,
// about 250 flops per byte, just under the card's ~295 bf16 flops per byte of
// memory, so bytes bound it on paper and the two bounds are both ~0.3 us.
// This first version computes in fp32 on the CUDA cores, not the tensor
// cores, so it will sit well above that bound.  Design: one CTA of 256
// threads per (batch * q-head, 64-row q tile); four threads share a q row,
// each owning every fourth channel, so the four lanes read neighbouring
// shared-memory words and the 8 rows of a warp broadcast.  K and V tiles of
// 32 rows are staged in shared memory as fp32; the KV head is indexed as
// h / (H / G), never repeated in memory.  The running max, sum and the
// accumulator live in registers.  For causal masks the CTA stops at the last
// key any of its rows can see; that skip is exact (see k_hi below).
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference
constexpr int kBlockQ = 64;                // q rows per CTA
constexpr int kTpr = 4;                    // threads per q row
constexpr int kThreads = kBlockQ * kTpr;
constexpr int kBlockK = 32;                // kv rows per shared-memory tile

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window,
                                        int prefix) {
  bool ok = causal ? (kp <= qp) : true;
  if (prefix) ok = ok || (kp < prefix);
  if (window) ok = ok && (qp - kp < window);
  return ok;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int G,
                 float scale, int causal, int window, int prefix,
                 int q_offset) {
  static_assert(D % kTpr == 0, "head dim must split over the row's threads");
  constexpr int E = D / kTpr;
  __shared__ float ks[kBlockK][D];
  __shared__ float vs[kBlockK][D];

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int q0 = blockIdx.y * kBlockQ;
  const int row = threadIdx.x / kTpr, part = threadIdx.x % kTpr;
  const int qi = q0 + row;
  const bool row_ok = qi < Sq;
  const int q_pos = q_offset + qi;

  float qr[E], acc[E];
  const T* qrow = q + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = row_ok ? to_f32(qrow[e * kTpr + part]) : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;

  // Keys this CTA visits.  Under a causal mask, when every row of the tile
  // sits inside the buffer (0 <= q_pos < Sk), each row sees its own diagonal
  // key, so its running max is a real score before any key beyond the tile's
  // last row (and beyond the prefix) comes up.  Those later keys are masked
  // for every row: each would add exp(-2^30 - m) == 0 to the sum and scale
  // the accumulator by exp(0) == 1, so stopping before them changes no bit.
  int k_hi = Sk;
  const int q_last = q_offset + min(q0 + kBlockQ, Sq) - 1;
  if (causal && q_offset + q0 >= 0 && q_last < Sk)
    k_hi = min(Sk, max(q_last + 1, prefix));

  const size_t kv_row = (size_t)G * D;
  const T* kb = k + (size_t)b * Sk * kv_row + (size_t)g * D;
  const T* vb = v + (size_t)b * Sk * kv_row + (size_t)g * D;

  for (int kt = 0; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = kt + j;
      float kx = 0.f, vx = 0.f;
      if (kp < k_hi) {
        kx = to_f32(kb[kp * kv_row + c]);
        vx = to_f32(vb[kp * kv_row + c]);
      }
      ks[j][c] = kx;
      vs[j][c] = vx;
    }
    __syncthreads();

    float s[kBlockK];
    float tile_max = -CUDART_INF_F;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) dot += qr[e] * ks[j][e * kTpr + part];
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int kp = kt + j;
      float sc;
      if (kp >= k_hi)
        sc = -CUDART_INF_F;  // past the buffer (or the exact causal stop)
      else
        sc = visible(q_pos, kp, causal, window, prefix) ? dot * scale
                                                          : kNegInf;
      s[j] = sc;
      tile_max = fmaxf(tile_max, sc);
    }
    const float m_new = fmaxf(m, tile_max);
    const float corr = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] *= corr;
#pragma unroll
    for (int j = 0; j < kBlockK; ++j) {
      const float p = expf(s[j] - m_new);
      psum += p;
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] += p * vs[j][e * kTpr + part];
    }
    l = l * corr + psum;
    m = m_new;
  }

  if (row_ok) {
    const float lc = fmaxf(l, 1e-30f);
    T* orow = o + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * kTpr + part] = from_f32<T>(acc[e] / lc);
    if (part == 0) lse[(size_t)(b * H + h) * Sq + qi] = m + logf(lc);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int Sq, int Sk, int H, int G, float scale, int causal,
           int window, int prefix, int q_offset, cudaStream_t s) {
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ), block(kThreads);
  flash_fwd_kernel<T, D><<<grid, block, 0, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, H, G, scale, causal, window, prefix, q_offset);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(int D, const void* q, const void* k, const void* v, void* o,
             void* lse, int B, int Sq, int Sk, int H, int G, float scale,
             int causal, int window, int prefix, int q_offset,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                           window, prefix, q_offset, s);
    case 32:
      return launch<T, 32>(q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                           window, prefix, q_offset, s);
    case 64:
      return launch<T, 64>(q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                           window, prefix, q_offset, s);
    case 128:
      return launch<T, 128>(q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                            window, prefix, q_offset, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int G, int D, float scale, int causal, int window,
    int prefix, int q_offset, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32)
    return launch_d<float>(D, q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                           window, prefix, q_offset, s);
  if (dtype == DTYPE_BF16)
    return launch_d<__nv_bfloat16>(D, q, k, v, o, lse, B, Sq, Sk, H, G, scale,
                                   causal, window, prefix, q_offset, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
