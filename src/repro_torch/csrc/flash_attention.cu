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
// Numerics shared by both kernels below, as in the TPU kernel and ref.py:
// scores are dot(q, k) * scale in fp32; masked scores are set to the finite
// NEG_INF = -2^30 and the running max starts there, so a row with no visible
// key averages v over all Sk keys exactly like the reference; the running
// sum is clamped at 1e-30 before the division and in lse = m + log(l).  Key
// positions >= Sk carry no weight at all (ref.py has no padding).
//
// Bound on the H100.  Training shape (q [1, 2048, 32, 64], kv [1, 2048, 4,
// 64], causal): 17.2 GFLOP over ~17 MB, so the tensor cores bound it (17.4
// us at 989 TFLOP/s bf16); the ~67 M exponentials take ~17 us more on the
// SFUs at 16 per SM and clock, which this design does not overlap with the
// products.  Serving shape (q [1, 64, 32, 64] over a [1, 512, 4, 64] cache):
// ~0.2 us either way, so latency and filling the card decide.
//
// bf16 inputs: flash_fwd_kernel_mma, a FlashAttention-2 forward on the
// tensor cores (mma.sync m16n8k16, bf16 operands, fp32 accumulators).
//   * Each warp owns 16 q rows; a CTA holds NW warps (16 * NW rows).  Q
//     fragments are loaded from device memory into registers once.
//   * K and V tiles of 64 rows stay bf16 in shared memory, in a two-stage
//     ring filled by 16-byte cp.async, so tile t+1's copy overlaps tile t's
//     math.  Rows past the keys the CTA visits are zero-filled (source size
//     0), never read.  16-byte chunks are XOR-swizzled per row, so that the
//     8 row addresses of each ldmatrix (K) and ldmatrix.trans (V) phase hit
//     8 distinct bank groups.
//   * S = Q K^T: products of bf16 values are exact in fp32, so S differs from
//     the TPU kernel's fp32 dot only in summation order.  The online softmax
//     runs on the S accumulator fragments (each row's max across the 4
//     lanes that share it by two xor shuffles); the running sum l adds the
//     fp32 p, before p is rounded to bf16 and packed straight from the
//     accumulator fragments into the A operand of P V (the C fragment of two
//     n8 tiles is the A fragment of one k16 step).
//   * The mask is evaluated only on tiles that straddle the diagonal, the
//     window edge, the prefix or the last key; other tiles skip it.  Under
//     the exact causal stop (k_hi below) a warp skips tiles wholly above
//     its rows, which changes no bit for the same reason.
//   * Causal q tiles are launched heaviest (last) first; where the grid of
//     64-row tiles would not fill the SMs (the serving shape: 32 CTAs),
//     CTAs of one warp (16 rows) are launched instead.
//   * Head dim 256 (paligemma-3b) changes the CTA's shape: Q fragments held
//     in registers would take 64 registers a lane beside the 128 of the
//     fp32 O accumulators, so at D > 128 the CTA's Q tile is staged once in
//     shared memory (cp.async, same swizzle) and each k16 step's fragment
//     is read by ldmatrix; K/V tiles are 32 rows, so S takes 16 registers
//     and the two-stage ring 64 KB (plus 32 KB of Q at 4 warps).  Bound at
//     paligemma's training shape (q [1, 2304, 8, 256], kv [1, 2304, 1,
//     256], prefix 256, causal): 2.688 M visible pairs a head, 22.0 GFLOP,
//     22.3 us at 989 TFLOP/s; 21 MB, 6.3 us: the tensor cores bound it.
// fp32 inputs: flash_fwd_kernel, fp32 FMAs on the CUDA cores, four threads
// per q row, K and V staged as fp32 in tiles of 32 rows (16 at D = 256, so
// that the static tiles stay within 48 KB).  fp32 attention appears only in checks,
// whose 2e-5 tolerances are the TPU kernel's fp32 arithmetic, which the
// tensor cores' bf16 or TF32 operands would not meet.
#include <math_constants.h>

#include "common.cuh"

namespace {

constexpr float kNegInf = -1073741824.0f;  // -2^30, finite as in the reference
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ bool visible(int qp, int kp, int causal, int window,
                                        int prefix) {
  bool ok = causal ? (kp <= qp) : true;
  if (prefix) ok = ok || (kp < prefix);
  if (window) ok = ok && (qp - kp < window);
  return ok;
}

// Keys a CTA whose rows are [q0, q0 + rows) has to visit, and whether the
// exact causal stop holds.  Under a causal mask, when every row of the tile
// sits inside the buffer (0 <= q_pos < Sk), each row sees its own diagonal
// key, so its running max is a real score before any key beyond the tile's
// last row (and beyond the prefix) comes up.  Those later keys are masked
// for every row: each would add exp(-2^30 - m) == 0 to the sum and scale
// the accumulator by exp(0) == 1, so stopping before them changes no bit.
__device__ __forceinline__ int keys_to_visit(int q0, int rows, int Sq, int Sk,
                                             int causal, int prefix,
                                             int q_offset, bool* exact) {
  const int q_last = q_offset + min(q0 + rows, Sq) - 1;
  *exact = causal && q_offset + q0 >= 0 && q_last < Sk;
  return *exact ? min(Sk, max(q_last + 1, prefix)) : Sk;
}

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kBlockQ = 64;  // q rows per CTA
constexpr int kTpr = 4;      // threads per q row
constexpr int kThreads = kBlockQ * kTpr;
// kv rows per shared-memory tile: 2 x kBlockK x D fp32 stay within the 48 KB
// of static shared memory
template <int D>
__host__ __device__ constexpr int block_k_f32() {
  return D > 128 ? 16 : 32;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int Sq, int Sk, int H, int G,
                 float scale, int causal, int window, int prefix,
                 int q_offset) {
  static_assert(D % kTpr == 0, "head dim must split over the row's threads");
  constexpr int E = D / kTpr;
  constexpr int kBlockK = block_k_f32<D>();
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
  const float* qrow = q + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    qr[e] = row_ok ? qrow[e * kTpr + part] : 0.f;
    acc[e] = 0.f;
  }
  float m = kNegInf, l = 0.f;
  bool exact;
  const int k_hi =
      keys_to_visit(q0, kBlockQ, Sq, Sk, causal, prefix, q_offset, &exact);

  const size_t kv_row = (size_t)G * D;
  const float* kb = k + (size_t)b * Sk * kv_row + (size_t)g * D;
  const float* vb = v + (size_t)b * Sk * kv_row + (size_t)g * D;

  for (int kt = 0; kt < k_hi; kt += kBlockK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = threadIdx.x; idx < kBlockK * D; idx += kThreads) {
      const int j = idx / D, c = idx % D;
      const int kp = kt + j;
      float kx = 0.f, vx = 0.f;
      if (kp < k_hi) {
        kx = kb[kp * kv_row + c];
        vx = vb[kp * kv_row + c];
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
    float* orow = o + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
    for (int e = 0; e < E; ++e) orow[e * kTpr + part] = acc[e] / lc;
    if (part == 0) lse[(size_t)(b * H + h) * Sq + qi] = m + logf(lc);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int G, float scale,
               int causal, int window, int prefix, int q_offset,
               cudaStream_t s) {
  const dim3 grid(B * H, (Sq + kBlockQ - 1) / kBlockQ), block(kThreads);
  flash_fwd_kernel<D><<<grid, block, 0, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o),
      static_cast<float*>(lse), Sq, Sk, H, G, scale, causal, window, prefix,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bf16: tensor-core kernel
// ---------------------------------------------------------------------------

// Warps (16 q rows each) per CTA where the grid of such CTAs fills the SMs:
// 4 was faster than 2 or 8 at the training shape on an H100 (PERF.md, PR 14)
constexpr int kWarps = 4;

// kv rows per shared-memory tile: 64, or 32 at D > 128 where S shares the
// registers with the 128 O accumulators
template <int D>
__host__ __device__ constexpr int block_n() {
  return D > 128 ? 32 : 64;
}
// Q staged in shared memory and read by ldmatrix per k16 step (D > 128),
// else held as register fragments for the whole kv loop
template <int D>
__host__ __device__ constexpr bool q_in_smem() {
  return D > 128;
}
// dynamic shared memory of flash_fwd_kernel_mma<D, NW>: the two-stage K/V
// ring, and the Q tile where it is staged
template <int D, int NW>
__host__ __device__ constexpr int mma_smem_bytes() {
  return (2 * 2 * block_n<D>() + (q_in_smem<D>() ? 16 * NW : 0)) * D *
         (int)sizeof(__nv_bfloat16);
}

using bf16 = __nv_bfloat16;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Element offset of 16-byte chunk c of row r in a [rows][D] bf16 tile whose
// chunks are XOR-swizzled: the 8 rows an ldmatrix phase reads at one logical
// chunk land in 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int r, int c) {
  constexpr int kChunks = D / 8;                          // per row
  constexpr int kRowsPerLine = kChunks >= 8 ? 1 : 8 / kChunks;  // 128 B
  constexpr int kMask = (kChunks >= 8 ? 8 : kChunks) - 1;
  return r * D + ((c ^ ((r / kRowsPerLine) & kMask)) << 3);
}

template <int D, int NW>
__global__ void __launch_bounds__(NW * 32)
flash_fwd_kernel_mma(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int G,
                     float scale, int causal, int window, int prefix,
                     int q_offset) {
  static_assert(D % 16 == 0, "head dim must be a multiple of 16");
  constexpr int BM = 16 * NW, BN = block_n<D>();
  constexpr bool kQs = q_in_smem<D>();
  constexpr int KS = D / 16;   // k16 steps of Q K^T; d16 pairs of P V
  constexpr int NT = BN / 8;   // n8 tiles of S
  constexpr int DT = D / 8;    // n8 tiles of O
  constexpr int CH = D / 8;    // 16-byte chunks per row
  constexpr int TILE = BN * D;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  // [stage][K, V][BN * D], then (kQs) the Q tile [BM * D]
  bf16* smem = reinterpret_cast<bf16*>(smem_raw);
  bf16* qsm = smem + 2 * 2 * TILE;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = h / (H / G);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BM;  // heaviest first
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gr = lane >> 2, tg = lane & 3;  // fragment row, column pair
  const int q0w = q0 + warp * 16;
  bool exact;
  const int k_hi =
      keys_to_visit(q0, BM, Sq, Sk, causal, prefix, q_offset, &exact);
  const int n_tiles = (k_hi + BN - 1) / BN;

  const size_t kv_row = (size_t)G * D;
  const bf16* kb = k + (size_t)b * Sk * kv_row + (size_t)g * D;
  const bf16* vb = v + (size_t)b * Sk * kv_row + (size_t)g * D;
  auto load_tile = [&](int it) {
    bf16* ks = smem + (it & 1) * 2 * TILE;
    bf16* vs = ks + TILE;
    const int kt = it * BN;
    for (int idx = threadIdx.x; idx < BN * CH; idx += NW * 32) {
      const int r = idx / CH, c = idx % CH, kp = kt + r;
      const bool ok = kp < k_hi;
      const size_t off = (ok ? (size_t)kp * kv_row : 0) + c * 8;
      const int so = swz<D>(r, c);
      cp_async16(smem_u32(ks + so), kb + off, ok);
      cp_async16(smem_u32(vs + so), vb + off, ok);
    }
  };
  if constexpr (kQs) {
    // the CTA's Q rows, swizzled as the K/V tiles; rows past Sq are zero
    const bf16* qb = q + ((size_t)b * Sq * H + h) * D;
    for (int idx = threadIdx.x; idx < BM * CH; idx += NW * 32) {
      const int r = idx / CH, c = idx % CH, qi = q0 + r;
      const bool ok = qi < Sq;
      cp_async16(smem_u32(qsm + swz<D>(r, c)),
                 qb + (ok ? (size_t)qi * H * D : 0) + c * 8, ok);
    }
  }
  load_tile(0);
  cp_async_commit();

  // Q fragments (A operand, 16 x D): rows gr and gr + 8, columns
  // 16 ks + 2 tg + {0, 1} and + 8; rows past Sq are zero (held here only
  // where Q is not staged in shared memory)
  uint32_t qa[kQs ? 1 : KS][4];
  if constexpr (!kQs) {
    const size_t qs = (size_t)H * D;
    const bf16* q_lo = q + ((size_t)b * Sq * H + h) * D;
    const int r0 = q0w + gr, r1 = r0 + 8;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const int c = ks * 16 + tg * 2;
      auto ld = [&](int r, int col) -> uint32_t {
        return r < Sq ? __ldg(reinterpret_cast<const unsigned int*>(
                            q_lo + r * qs + col))
                      : 0u;
      };
      qa[ks][0] = ld(r0, c);
      qa[ks][1] = ld(r1, c);
      qa[ks][2] = ld(r0, c + 8);
      qa[ks][3] = ld(r1, c + 8);
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
    oacc[j][0] = oacc[j][1] = oacc[j][2] = oacc[j][3] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  const bool warp_on = q0w < Sq;
  const int wq_lo = q_offset + q0w;                     // first row's position
  const int wq_hi = q_offset + min(q0w + 16, Sq) - 1;   // last valid row's
  // ldmatrix lane roles: lane supplies row (lane & 7) of matrix (lane >> 3)
  const int lm_m = lane >> 3, lm_r = lane & 7;

  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) load_tile(it + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const int kt = it * BN;
    const bool skip = !warp_on || (exact && kt > wq_hi && kt >= prefix);
    if (!skip) {
      const bf16* ks = smem + (it & 1) * 2 * TILE;
      const bf16* vs = ks + TILE;
      float s[NT][4];
#pragma unroll
      for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      // S = Q K^T: matrices (keys 16np + {0..7, 8..15}) x (d 16ks + {0..7,
      // 8..15}) -> B fragments of n8 tiles 2np and 2np + 1
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        // this k16 step's Q fragment: matrices (rows {0..7, 8..15}) x (d
        // 16kk + {0..7, 8..15}) of the warp's 16 rows
        uint32_t qf[4];
        if constexpr (kQs) {
          ldsm_x4(qf, smem_u32(qsm + swz<D>(warp * 16 + (lm_m & 1) * 8 + lm_r,
                                            kk * 2 + (lm_m >> 1))));
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e) qf[e] = qa[kk][e];
        }
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, smem_u32(ks + swz<D>(np * 16 + (lm_m >> 1) * 8 + lm_r,
                                          kk * 2 + (lm_m & 1))));
          mma_bf16(s[2 * np], qf, r[0], r[1]);
          mma_bf16(s[2 * np + 1], qf, r[2], r[3]);
        }
      }
      const bool full =
          kt + BN <= k_hi &&
          (!causal || kt + BN - 1 < max(prefix, wq_lo + 1)) &&
          (!window || wq_hi - kt < window);
      if (full) {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] *= scale;
      } else {
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int kp = kt + j * 8 + tg * 2 + (e & 1);
            const int qp = wq_lo + gr + (e >> 1) * 8;
            s[j][e] = kp >= k_hi ? -CUDART_INF_F
                      : visible(qp, kp, causal, window, prefix)
                          ? s[j][e] * scale
                          : kNegInf;
          }
      }
      // online softmax on rows gr (e = 0, 1) and gr + 8 (e = 2, 3)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        float mx = -CUDART_INF_F;
#pragma unroll
        for (int j = 0; j < NT; ++j)
          mx = fmaxf(mx, fmaxf(s[j][2 * hh], s[j][2 * hh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[hh], mx);
        const float corr = ex2((m[hh] - m_new) * kLog2e);
        m[hh] = m_new;
        float psum = 0.f;
#pragma unroll
        for (int j = 0; j < NT; ++j)
#pragma unroll
          for (int e = 2 * hh; e < 2 * hh + 2; ++e) {
            const float p = ex2((s[j][e] - m_new) * kLog2e);
            s[j][e] = p;
            psum += p;
          }
        l[hh] = l[hh] * corr + psum;
#pragma unroll
        for (int j = 0; j < DT; ++j) {
          oacc[j][2 * hh] *= corr;
          oacc[j][2 * hh + 1] *= corr;
        }
      }
      // O += P V: P's A fragment for keys 16kk.. from S tiles 2kk, 2kk + 1;
      // V matrices (keys 16kk + {0..7, 8..15}) x (d 16dp + {0..7, 8..15}),
      // transposed -> B fragments of n8 tiles 2dp and 2dp + 1
#pragma unroll
      for (int kk = 0; kk < NT / 2; ++kk) {
        const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                                pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                                pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                                pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
        for (int dp = 0; dp < KS; ++dp) {
          uint32_t r[4];
          ldsm_x4_t(r, smem_u32(vs + swz<D>(kk * 16 + (lm_m & 1) * 8 + lm_r,
                                            dp * 2 + (lm_m >> 1))));
          mma_bf16(oacc[2 * dp], pa, r[0], r[1]);
          mma_bf16(oacc[2 * dp + 1], pa, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this stage is consumed before it is refilled
  }

  if (warp_on) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float lt = l[hh] + __shfl_xor_sync(0xffffffffu, l[hh], 1);
      lt += __shfl_xor_sync(0xffffffffu, lt, 2);
      const float lc = fmaxf(lt, 1e-30f);
      const int qi = q0w + gr + hh * 8;
      if (qi < Sq) {
        bf16* orow = o + ((size_t)(b * Sq + qi) * H + h) * D;
#pragma unroll
        for (int j = 0; j < DT; ++j)
          *reinterpret_cast<uint32_t*>(orow + j * 8 + tg * 2) =
              pack_bf16(oacc[j][2 * hh] / lc, oacc[j][2 * hh + 1] / lc);
        if (tg == 0) lse[(size_t)(b * H + h) * Sq + qi] = m[hh] + logf(lc);
      }
    }
  }
}

template <int D, int NW>
int launch_mma(const void* q, const void* k, const void* v, void* o,
               void* lse, int B, int Sq, int Sk, int H, int G, float scale,
               int causal, int window, int prefix, int q_offset,
               cudaStream_t s) {
  constexpr int smem = mma_smem_bytes<D, NW>();
  static bool attr_set = false;  // above 48 KB the launch needs the opt-in
  if (smem > 48 * 1024 && !attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel_mma<D, NW>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid(B * H, (Sq + 16 * NW - 1) / (16 * NW)), block(NW * 32);
  flash_fwd_kernel_mma<D, NW><<<grid, block, smem, s>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<bf16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, G, scale, causal, window, prefix,
      q_offset);
  return static_cast<int>(cudaGetLastError());
}

// Warps per CTA of the bf16 kernel: kWarps where the grid of such CTAs
// fills the card, else one-warp CTAs (16 rows each)
int cta_warps(int B, int Sq, int H) {
  const long big = (long)B * H * ((Sq + 16 * kWarps - 1) / (16 * kWarps));
  return big >= sm_count() ? kWarps : 1;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                void* lse, int B, int Sq, int Sk, int H, int G, float scale,
                int causal, int window, int prefix, int q_offset,
                cudaStream_t s) {
  if (cta_warps(B, Sq, H) == kWarps)
    return launch_mma<D, kWarps>(q, k, v, o, lse, B, Sq, Sk, H, G, scale,
                                 causal, window, prefix, q_offset, s);
  return launch_mma<D, 1>(q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal,
                          window, prefix, q_offset, s);
}

}  // namespace

extern "C" int flash_attention_fwd_launch(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int Sq, int Sk, int H, int G, int D, float scale, int causal, int window,
    int prefix, int q_offset, int dtype, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || G <= 0 || H % G != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) & 15)
    return static_cast<int>(cudaErrorMisalignedAddress);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FLASH_ARGS q, k, v, o, lse, B, Sq, Sk, H, G, scale, causal, window, \
                   prefix, q_offset, s
  if (dtype == DTYPE_F32) {
    switch (D) {
      case 16: return launch_f32<16>(FLASH_ARGS);
      case 32: return launch_f32<32>(FLASH_ARGS);
      case 64: return launch_f32<64>(FLASH_ARGS);
      case 128: return launch_f32<128>(FLASH_ARGS);
      case 256: return launch_f32<256>(FLASH_ARGS);
    }
  } else if (dtype == DTYPE_BF16) {
    switch (D) {
      case 16: return launch_bf16<16>(FLASH_ARGS);
      case 32: return launch_bf16<32>(FLASH_ARGS);
      case 64: return launch_bf16<64>(FLASH_ARGS);
      case 128: return launch_bf16<128>(FLASH_ARGS);
      case 256: return launch_bf16<256>(FLASH_ARGS);
    }
  }
#undef FLASH_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}

// Warps per CTA that flash_attention_fwd_launch gives these sizes: 0 for
// fp32 (the CUDA-core flash_fwd_kernel), else NW of flash_fwd_kernel_mma
extern "C" int flash_attention_fwd_warps(int B, int Sq, int H, int dtype) {
  return dtype == DTYPE_BF16 ? cta_warps(B, Sq, H) : 0;
}
