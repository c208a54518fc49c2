// Mamba-2 SSD chunk scan: y and the final state h of the recurrence
//
//   h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t (outer) B_t,   y_t = C_t . h_t
//
// evaluated chunk by chunk (chunk length Q), per (batch, head), from h = h0
// (the carried state of a serving prefill chunk) or from h = 0:
//
//   cum  = cumsum(dt * A)           (inclusive, within the chunk)
//   L    = tril(exp(cum_i - cum_j)) * dt_j
//   y    = (C B^T o L) x + exp(cum) * (C h^T)
//   h   <- exp(cum_end) h + (x * exp(cum_end - cum) * dt)^T B
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _kernel).  x [B, S, H, P]; Bc and Cc [B, S, N] of x's type (one
// group: every head shares them); dt [B, S, H] and A [H] fp32; h0 [B, H, P,
// N] fp32 or null; y [B, S, H, P] and h [B, H, P, N] are written in fp32.
// S is a multiple of Q (the wrapper pads with dt = 0 rows, which leave the
// state as it is).  The TPU kernel always starts from zero (the reference
// sends a carried state to its XLA scan); here h0 only seeds the carry:
// pass b's running state, or the CUDA-core kernel's shared state rows.  An
// h0 of zeros therefore gives bitwise the result of a null h0.
//
// Bound on the H100, at x [1, 2048, 80, 64] bf16, Q = 128, N = 128: bytes.
// The call must read x (21 MB), B, C and dt (1.7 MB) and write y in fp32
// (42 MB) and h (2.6 MB): 67.2 MB, 20.07 us at 3.35 TB/s, against ~7 GFLOP
// of needed arithmetic (~7 us at the bf16 tensor-core rate).
//
// Two routes, chosen by dtype in the wrapper (kernels/ssd_scan/ops.py):
//
// bf16 x, B, C: three passes on the tensor cores, the chunk-parallel form
// the TPU kernel's docstring names for GPUs (the TPU runs the chunks as a
// sequential grid axis with h in VMEM; here nothing carries between CTAs).
//   a. ssd_scan_kernel_states, one CTA per (batch * chunk, head, 64 head-dim
//      columns): the chunk's cum by a warp scan (stored, so pass c reads
//      the same values), then its contribution to the state,
//      (x o exp(cum_end - cum) dt)^T B -> [P, N] fp32, into a scratch
//      [B, nc, H, P, N] (42 MB at the training shape).
//   b. ssd_scan_kernel_pass, one thread per state element: runs over the
//      chunks from h_in[0] = h0 (or 0), h_in[c] = exp(cum_end[c-1])
//      h_in[c-1] + add[c-1], writing h_in in place over the
//      contributions, and the final h.
//   c. ssd_scan_kernel_out, one CTA per (batch * chunk, head, 64 head-dim
//      columns), the flash forward's shape: y = exp(cum_i) (C h_in^T) +
//      (C B^T o L) x, each warp owning 16 rows of the chunk.  C B^T stays
//      in registers as accumulator fragments, 32 columns at a time (tiles
//      above the diagonal are skipped), is scaled by L (the exponentials
//      taken only on and below the diagonal, once per head and chunk), and
//      is repacked into A fragments for the product with x (ldmatrix.trans),
//      as flash_attention.cu does with P V.  y is written with 16-byte
//      stores (lane pairs exchange halves of their fragments).
// This answers the CUDA-core kernel's four costs: C B^T is a tensor-core
// product (~1 us a CTA) instead of 2.1 M fp32 FMAs; every product runs on
// the tensor cores from bf16 operands; the grid is 1280 CTAs per pass at
// the training shape (two pass-c CTAs per SM), none walking the chunks;
// tiles move as 16-byte cp.async copies and y as 16-byte stores.  The
// design's own traffic adds the state scratch (written by a, read and
// written by b, read by c) to the 67.2 MB the call must move.
//
// Precision.  Each product has one operand exact in bf16 (x, B or C) and
// one fp32 operand (x o decay * dt, C B^T o L, or h_in).  The fp32 operand
// a enters mma.sync m16n8k16 as hi = bf16(a) and lo = bf16(a - hi), two
// products accumulated in fp32: a relative error of ~2^-17 per term, where
// one bf16 rounding (~2^-9) would break the 1e-4 tolerance the scan is held
// to.  Products of bf16 values are exact in fp32 (C B^T).
//
// fp32 x, B, C: ssd_scan_kernel, fp32 FMAs on the CUDA cores.  One CTA per
// (batch * head, 16 head-dim columns) loops over the chunks with its rows
// of the state in shared memory and recomputes its chunk's C B^T; fp32
// scans appear only in checks, which the TPU kernel's fp32 dots set.
#include "common.cuh"

namespace {

// ---------------------------------------------------------------------------
// fp32: CUDA-core kernel
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;
constexpr int kMaxQ = 128;  // chunk rows
constexpr int kPT = 16;     // head-dim columns (state rows) per CTA
constexpr int kNT = 16;     // state columns per staged B / C tile
constexpr int kMaxN = 256;  // state width
constexpr int kCS = kNT + 1;    // row stride of Cs, Bs
constexpr int kHS = kMaxN + 1;  // row stride of hs
constexpr int kSmemFloats =
    4 * kMaxQ + kMaxQ * kMaxQ + 2 * kMaxQ * kCS + kMaxQ * kPT + kPT * kHS;
constexpr size_t kSmemBytes = kSmemFloats * sizeof(float);

static_assert(kThreads == kPT * 16 && kThreads == kNT * 16,
              "thread roles assume 16 x 16 threads");
static_assert(kMaxQ == 8 * 16, "the score micro-tiles cover 128 x 128");

// Inclusive cumsum of dt * a_h over kMaxQ rows on one warp: four
// consecutive rows per lane, then a shuffle scan of the lane totals (rows
// >= Q carry dt = 0).  Both routes take cum from here.
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a_h,
                                             float* cum, int lane) {
  constexpr int E = kMaxQ / 32;
  float v[E];
  float run = 0.f;
#pragma unroll
  for (int e = 0; e < E; ++e) {
    run += dts[lane * E + e] * a_h;
    v[e] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float t = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += t;
  }
  const float base = tot - run;
#pragma unroll
  for (int e = 0; e < E; ++e) cum[lane * E + e] = base + v[e];
}

__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const float* __restrict__ x, const float* __restrict__ Bm,
                const float* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ h0,
                float* __restrict__ y, float* __restrict__ hout, int S, int H,
                int P, int N, int Q) {
  extern __shared__ float smem[];
  float* cum = smem;
  float* dts = cum + kMaxQ;
  float* dec = dts + kMaxQ;   // exp(cum_end - cum) * dt
  float* ecum = dec + kMaxQ;  // exp(cum)
  float* Ss = ecum + kMaxQ;
  float* Cs = Ss + kMaxQ * kMaxQ;
  float* Bs = Cs + kMaxQ * kCS;
  float* xs = Bs + kMaxQ * kCS;
  float* hs = xs + kMaxQ * kPT;

  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int p0 = blockIdx.y * kPT;
  const int tid = threadIdx.x;
  const float a_h = A[h];
  const int nchunks = S / Q;

  // thread roles (16 x 16): score micro-tile rows ty + 16 r, columns
  // tx + 16 c; output (row i = oi + 16 r, column op); state entry (sp, sn)
  // of the current N tile
  const int tx = tid % 16, ty = tid / 16;
  const int op = tid % kPT, oi = tid / kPT;
  const int sn = tid % kNT, sp = tid / kNT;

  // the state rows p0 .. p0 + kPT - 1 start from h0 (or 0)
  for (int i = tid; i < kPT * kHS; i += kThreads) {
    const int p = i / kHS, n = i % kHS;
    float v = 0.f;
    if (h0 != nullptr && n < N && p0 + p < P)
      v = h0[((static_cast<size_t>(b) * H + h) * P + p0 + p) * N + n];
    hs[i] = v;
  }

  for (int c = 0; c < nchunks; ++c) {
    const size_t row0 =
        static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
    for (int i = tid; i < kMaxQ; i += kThreads)
      dts[i] = i < Q ? dt[(row0 + i) * H + h] : 0.f;
    for (int e = tid; e < kMaxQ * kPT; e += kThreads) {
      const int i = e / kPT, p = e % kPT;
      float v = 0.f;
      if (i < Q && p0 + p < P) v = x[((row0 + i) * H + h) * P + p0 + p];
      xs[e] = v;
    }
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, a_h, cum, tid);
    __syncthreads();
    const float cend = cum[Q - 1];
    const float eend = expf(cend);
    for (int i = tid; i < kMaxQ; i += kThreads) {
      dec[i] = expf(cend - cum[i]) * dts[i];
      ecum[i] = expf(cum[i]);
    }

    float acc[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r)
#pragma unroll
      for (int q = 0; q < 8; ++q) acc[r][q] = 0.f;
    float yin[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) yin[r] = 0.f;

    for (int n0 = 0; n0 < N; n0 += kNT) {
      for (int e = tid; e < kMaxQ * kNT; e += kThreads) {
        const int i = e / kNT, n = e % kNT;
        float bv = 0.f, cv = 0.f;
        if (i < Q && n0 + n < N) {
          const size_t off = (row0 + i) * N + n0 + n;
          bv = Bm[off];
          cv = Cm[off];
        }
        Bs[i * kCS + n] = bv;
        Cs[i * kCS + n] = cv;
      }
      __syncthreads();  // also publishes dec / ecum on the first tile

      // C B^T over this tile
#pragma unroll 4
      for (int k = 0; k < kNT; ++k) {
        float cr[8], br[8];
#pragma unroll
        for (int r = 0; r < 8; ++r) cr[r] = Cs[(ty + 16 * r) * kCS + k];
#pragma unroll
        for (int q = 0; q < 8; ++q) br[q] = Bs[(tx + 16 * q) * kCS + k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
#pragma unroll
          for (int q = 0; q < 8; ++q)
            acc[r][q] = fmaf(cr[r], br[q], acc[r][q]);
      }
      // C h^T with the state before this chunk's update
      const int nt = min(kNT, N - n0);
      for (int k = 0; k < nt; ++k) {
        const float hv = hs[op * kHS + n0 + k];
#pragma unroll
        for (int r = 0; r < 8; ++r)
          yin[r] = fmaf(Cs[(oi + 16 * r) * kCS + k], hv, yin[r]);
      }
      __syncthreads();  // every read of this tile's old state is done

      if (sn < nt) {
        float s = 0.f;
        for (int q = 0; q < Q; ++q)
          s = fmaf(xs[q * kPT + sp] * dec[q], Bs[q * kCS + sn], s);
        float* hv = hs + sp * kHS + n0 + sn;
        *hv = eend * *hv + s;
      }
      __syncthreads();  // before the next tile overwrites Bs / Cs
    }

    // scores o L: (C B^T)_ij * (exp(cum_i - cum_j) * dt_j) on and below the
    // diagonal, 0 above
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = ty + 16 * r;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        const int j = tx + 16 * q;
        float v = 0.f;
        if (j <= i && i < Q) v = acc[r][q] * (expf(cum[i] - cum[j]) * dts[j]);
        Ss[i * kMaxQ + j] = v;
      }
    }
    __syncthreads();

    if (p0 + op < P) {
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        const int i = oi + 16 * r;
        if (i >= Q) continue;
        float s = 0.f;
        for (int j = 0; j <= i; ++j)
          s = fmaf(Ss[i * kMaxQ + j], xs[j * kPT + op], s);
        y[((row0 + i) * H + h) * P + p0 + op] = s + ecum[i] * yin[r];
      }
    }
    __syncthreads();  // before the next chunk restages dt, x and the scores
  }

  for (int e = tid; e < kPT * N; e += kThreads) {
    const int p = e / N, n = e % N;
    if (p0 + p < P)
      hout[((static_cast<size_t>(b) * H + h) * P + p0 + p) * N + n] =
          hs[p * kHS + n];
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor-core passes
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;

constexpr int kTcThreads = 256;  // 8 warps
constexpr int kWarpsTc = kTcThreads / 32;
constexpr int kPB = 64;          // head-dim columns per CTA
constexpr int kBatch = 4;        // global loads a thread issues together

__host__ __device__ __forceinline__ int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// Element offset of 16-byte chunk c of row r in a bf16 tile of `width`
// elements per row (a multiple of 64: whole 128-byte lines).  Chunks are
// XOR-swizzled by (r & 7) within their line, so the 8 rows of an ldmatrix
// phase (rows 8k .. 8k + 7, one logical chunk) hit 8 distinct bank groups.
__device__ __forceinline__ int toff(int r, int c, int width) {
  return r * width + ((c ^ (r & 7)) << 3);
}

// Rows [0, rows_p) x columns [0, cols_p) of a bf16 tile into shared memory
// (row width `width`, swizzled); element (r, c) is src[r * ld + c], zero
// for r >= rows or c >= cols.  With `vec` (cols and ld multiples of 8, src
// 16-byte aligned) by 16-byte cp.async (commit and wait are the caller's),
// else element by element.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t ld, int rows, int cols,
                                          int rows_p, int cols_p, int width,
                                          bool vec) {
  const int chunks = cols_p / 8;
  for (int idx = threadIdx.x; idx < rows_p * chunks; idx += blockDim.x) {
    const int r = idx / chunks, c = idx % chunks;
    bf16* d = dst + toff(r, c, width);
    if (vec) {
      const bool ok = r < rows && c * 8 < cols;
      cp_async16(smem_u32(d), ok ? src + r * ld + c * 8 : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        d[e] = (r < rows && c * 8 + e < cols) ? src[r * ld + c * 8 + e]
                                              : __float2bfloat16(0.f);
    }
  }
}

// fp32 a, b -> packed bf16x2 hi = bf16(a, b) and lo = bf16(a - hi, b - hi):
// hi + lo carries a and b to a relative ~2^-17
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(a - hf.x, b - hf.y);
}

// One m16n8 fp32 accumulator tile c of a warp (rows r0 + gr and r0 + gr + 8,
// columns n0 + 2 tg, + 1) into the row-major dst (row stride ld): lane pairs
// swap halves so that an even lane stores four columns of row gr and an odd
// lane four of row gr + 8, as one 16-byte store where `vec` (ld a multiple
// of 4, dst 16-byte aligned) and all four columns are < cols; else element
// by element.  Rows >= rows and columns >= cols are not written.
__device__ __forceinline__ void store_tile(float* dst, size_t ld, int r0,
                                           int n0, int rows, int cols,
                                           const float (&c)[4], bool vec,
                                           int lane) {
  const int gr = lane >> 2, tg = lane & 3;
  const bool odd = tg & 1;
  const float t0 = __shfl_xor_sync(0xffffffffu, odd ? c[0] : c[2], 1);
  const float t1 = __shfl_xor_sync(0xffffffffu, odd ? c[1] : c[3], 1);
  const float4 v = odd ? make_float4(t0, t1, c[2], c[3])
                       : make_float4(c[0], c[1], t0, t1);
  const int row = r0 + gr + (odd ? 8 : 0);
  const int col = n0 + 2 * (tg & ~1);
  if (row >= rows) return;
  float* p = dst + row * ld + col;
  if (vec && col + 4 <= cols) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    const float w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int e = 0; e < 4; ++e)
      if (col + e < cols) p[e] = w[e];
  }
}

// Sizes shared by the three passes
struct TcDims {
  int S, H, P, N, Q, nc;
  int Qp, Np, Nw;  // Q and N rounded up to 16; N rounded up to 64
};

// Pass a: cum and dt (stored to cdt [B, nc, H, 2, Q]) and the chunk's
// state contribution (x o w)^T B, w = exp(cum_end - cum) dt, into states
// [B, nc, H, P, N].  Shared memory: B [Qp][Nw], x o w as hi and lo
// [Qp][64], and dt, cum, w [128] fp32.
__global__ void __launch_bounds__(kTcThreads)
ssd_scan_kernel_states(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       float* __restrict__ states, float* __restrict__ cdt,
                       TcDims d, int vec_x, int vec_bc, int vec_n) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Bs = reinterpret_cast<bf16*>(smem_raw);
  bf16* xh = Bs + d.Qp * d.Nw;
  bf16* xl = xh + d.Qp * kPB;
  float* dts = reinterpret_cast<float*>(xl + d.Qp * kPB);
  float* cum = dts + kMaxQ;
  float* w = cum + kMaxQ;

  const int b = blockIdx.x / d.nc, c = blockIdx.x % d.nc, h = blockIdx.y;
  const int p0 = blockIdx.z * kPB;
  const int pw = min(kPB, d.P - p0);           // valid columns of the block
  const int Pp = round_up(pw, 16);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = static_cast<size_t>(b) * d.S +
                      static_cast<size_t>(c) * d.Q;
  const size_t bch = (static_cast<size_t>(b) * d.nc + c) * d.H + h;

  load_tile(Bs, Bm + row0 * d.N, d.N, d.Q, d.N, d.Qp, d.Np, d.Nw, vec_bc);
  cp_async_commit();

  for (int i = tid; i < kMaxQ; i += kTcThreads)
    dts[i] = i < d.Q ? dt[(row0 + i) * d.H + h] : 0.f;
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, A[h], cum, lane);
  __syncthreads();
  const float cend = cum[d.Q - 1];
  for (int i = tid; i < kMaxQ; i += kTcThreads) {
    w[i] = i < d.Q ? expf(cend - cum[i]) * dts[i] : 0.f;
    if (blockIdx.z == 0 && i < d.Q) {
      cdt[bch * 2 * d.Q + i] = cum[i];
      cdt[bch * 2 * d.Q + d.Q + i] = dts[i];
    }
  }
  __syncthreads();

  // x o w, split into bf16 hi and lo, one 8-column chunk per step
  const bf16* xb = x + (row0 * d.H + h) * d.P + p0;
  const size_t ldx = static_cast<size_t>(d.H) * d.P;
  // (all of a thread's loads are issued before the first is used)
  const int xtasks = d.Qp * (kPB / 8);
  for (int base = tid; base < xtasks; base += kBatch * kTcThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kTcThreads;
      const int r = idx / (kPB / 8), ch = idx % (kPB / 8);
      const bool row_ok = idx < xtasks && r < d.Q;
      if (vec_x && row_ok && ch * 8 < pw) {
        const uint4 u =
            *reinterpret_cast<const uint4*>(xb + r * ldx + ch * 8);
        const bf16* e8 = reinterpret_cast<const bf16*>(&u);
#pragma unroll
        for (int e = 0; e < 8; ++e) v[k][e] = __bfloat162float(e8[e]);
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[k][e] = (row_ok && ch * 8 + e < pw)
                        ? __bfloat162float(xb[r * ldx + ch * 8 + e])
                        : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kTcThreads;
      if (idx >= xtasks) break;
      const int r = idx / (kPB / 8), ch = idx % (kPB / 8);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(v[k][2 * e] * w[r], v[k][2 * e + 1] * w[r], hi[e], lo[e]);
      const int o = toff(r, ch, kPB);
      *reinterpret_cast<uint4*>(xh + o) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(xl + o) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // (x o w)^T B: M = p (16-row tiles mt), K = q, N = n (64-column blocks nb)
  const int lm_m = lane >> 3, lm_r = lane & 7;
  const int mts = Pp / 16, nbs = (d.Np + 63) / 64;
  float* st = states + bch * d.P * d.N + static_cast<size_t>(p0) * d.N;
  for (int u = warp; u < mts * nbs; u += kWarpsTc) {
    const int mt = u % mts, nb = u / mts;
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
    for (int ks = 0; ks < d.Qp / 16; ++ks) {
      // A = (x o w)^T from the [q][p] tiles, transposed: matrix lm_m holds
      // rows p 16 mt + (lm_m & 1) 8, columns q 16 ks + (lm_m >> 1) 8
      uint32_t ah[4], al[4];
      const int ar = ks * 16 + (lm_m >> 1) * 8 + lm_r;
      const int ac = mt * 2 + (lm_m & 1);
      ldsm_x4_t(ah, smem_u32(xh + toff(ar, ac, kPB)));
      ldsm_x4_t(al, smem_u32(xl + toff(ar, ac, kPB)));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (nb * 64 + np * 16 >= d.Np) break;
        // B from the [q][n] tile, transposed: matrices (q 0-7, 8-15) x
        // (n 0-7, 8-15) -> B fragments of n8 tiles 2 np and 2 np + 1
        uint32_t r[4];
        ldsm_x4_t(r, smem_u32(Bs + toff(ks * 16 + (lm_m & 1) * 8 + lm_r,
                                        nb * 8 + np * 2 + (lm_m >> 1),
                                        d.Nw)));
        mma_bf16(acc[2 * np], ah, r[0], r[1]);
        mma_bf16(acc[2 * np], al, r[0], r[1]);
        mma_bf16(acc[2 * np + 1], ah, r[2], r[3]);
        mma_bf16(acc[2 * np + 1], al, r[2], r[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (nb * 64 + j * 8 < d.Np)
        store_tile(st, d.N, mt * 16, nb * 64 + j * 8, pw, d.N, acc[j],
                   vec_n, lane);
  }
}

// Pass b: per state element, from h = h0 (or 0), over the chunks:
// states[c] <- h_in[c] (the state before chunk c), h <- exp(cum_end[c]) h +
// add[c]; hout <- h.  The loads of kPassBatch chunks are issued before any
// is used.
constexpr int kPassBatch = 8;

__global__ void __launch_bounds__(kTcThreads)
ssd_scan_kernel_pass(float* __restrict__ states,
                     const float* __restrict__ cdt,
                     const float* __restrict__ h0, float* __restrict__ hout,
                     long long total, TcDims d) {
  const long long pn = static_cast<long long>(d.P) * d.N;
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long bh = e / pn, r = e % pn;
    const long long b = bh / d.H, h = bh % d.H;
    float s = h0 != nullptr ? h0[e] : 0.f;  // h0 [B, H, P, N]: element e
    for (int c0 = 0; c0 < d.nc; c0 += kPassBatch) {
      float add[kPassBatch], cend[kPassBatch];
#pragma unroll
      for (int k = 0; k < kPassBatch; ++k) {
        const long long bch = (b * d.nc + c0 + k) * d.H + h;
        if (c0 + k < d.nc) {
          add[k] = states[bch * pn + r];
          cend[k] = cdt[bch * 2 * d.Q + d.Q - 1];
        }
      }
#pragma unroll
      for (int k = 0; k < kPassBatch; ++k) {
        if (c0 + k >= d.nc) break;
        const long long bch = (b * d.nc + c0 + k) * d.H + h;
        states[bch * pn + r] = s;
        s = expf(cend[k]) * s + add[k];
      }
    }
    hout[e] = s;
  }
}

// Pass c: y = exp(cum_i) (C h_in^T) + (C B^T o L) x for 16 chunk rows per
// warp and 64 head-dim columns per CTA.  Shared memory: C and B [Qp][Nw],
// x [Qp][64], h_in as hi and lo [64][Nw], all bf16, then cum and dt [128]
// fp32 (at Q = N = 128: 113 KB, two CTAs per SM).
__global__ void __launch_bounds__(kTcThreads, 2)
ssd_scan_kernel_out(const bf16* __restrict__ x, const bf16* __restrict__ Bm,
                    const bf16* __restrict__ Cm,
                    const float* __restrict__ states,
                    const float* __restrict__ cdt, float* __restrict__ y,
                    TcDims d, int vec_x, int vec_bc, int vec_n, int vec_y) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Cs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Bs = Cs + d.Qp * d.Nw;
  bf16* xs = Bs + d.Qp * d.Nw;
  bf16* hh = xs + d.Qp * kPB;
  bf16* hl = hh + kPB * d.Nw;
  float* cums = reinterpret_cast<float*>(hl + kPB * d.Nw);
  float* dts = cums + kMaxQ;

  const int b = blockIdx.x / d.nc, c = blockIdx.x % d.nc, h = blockIdx.y;
  const int p0 = blockIdx.z * kPB;
  const int pw = min(kPB, d.P - p0);
  const int Pp = round_up(pw, 16);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t row0 = static_cast<size_t>(b) * d.S +
                      static_cast<size_t>(c) * d.Q;
  const size_t bch = (static_cast<size_t>(b) * d.nc + c) * d.H + h;
  const size_t ldx = static_cast<size_t>(d.H) * d.P;

  load_tile(Cs, Cm + row0 * d.N, d.N, d.Q, d.N, d.Qp, d.Np, d.Nw, vec_bc);
  load_tile(Bs, Bm + row0 * d.N, d.N, d.Q, d.N, d.Qp, d.Np, d.Nw, vec_bc);
  load_tile(xs, x + (row0 * d.H + h) * d.P + p0, ldx, d.Q, pw, d.Qp, Pp,
            kPB, vec_x);
  cp_async_commit();

  for (int i = tid; i < d.Q; i += kTcThreads) {
    cums[i] = cdt[bch * 2 * d.Q + i];
    dts[i] = cdt[bch * 2 * d.Q + d.Q + i];
  }
  // h_in rows p0 .. p0 + pw of this (batch, chunk, head), split hi / lo
  // (all of a thread's loads are issued before the first is used)
  const float* hin = states + bch * d.P * d.N + static_cast<size_t>(p0) * d.N;
  const int htasks = Pp * (d.Np / 8);
  for (int base = tid; base < htasks; base += kBatch * kTcThreads) {
    float v[kBatch][8];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kTcThreads;
      const int r = idx / (d.Np / 8), n0 = idx % (d.Np / 8) * 8;
      const bool row_ok = idx < htasks && r < pw;
      if (vec_n && row_ok && n0 + 8 <= d.N) {
        const float4 u0 =
            *reinterpret_cast<const float4*>(hin + r * d.N + n0);
        const float4 u1 =
            *reinterpret_cast<const float4*>(hin + r * d.N + n0 + 4);
        v[k][0] = u0.x; v[k][1] = u0.y; v[k][2] = u0.z; v[k][3] = u0.w;
        v[k][4] = u1.x; v[k][5] = u1.y; v[k][6] = u1.z; v[k][7] = u1.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[k][e] = (row_ok && n0 + e < d.N) ? hin[r * d.N + n0 + e] : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int idx = base + k * kTcThreads;
      if (idx >= htasks) break;
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        split_bf16(v[k][2 * e], v[k][2 * e + 1], hi[e], lo[e]);
      const int o = toff(idx / (d.Np / 8), idx % (d.Np / 8), d.Nw);
      *reinterpret_cast<uint4*>(hh + o) =
          make_uint4(hi[0], hi[1], hi[2], hi[3]);
      *reinterpret_cast<uint4*>(hl + o) =
          make_uint4(lo[0], lo[1], lo[2], lo[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  const int gr = lane >> 2, tg = lane & 3;
  const int lm_m = lane >> 3, lm_r = lane & 7;
  const int KS = d.Np / 16;
  for (int mt = warp; mt < d.Qp / 16; mt += kWarpsTc) {
    const int i0 = mt * 16;
    const int ia = i0 + gr, ib = ia + 8;       // this lane's two rows
    // rows >= Q are padding (zero C rows); clamp so every exponent below is
    // of a difference <= 0
    const float cum_a = cums[min(ia, d.Q - 1)];
    const float cum_b = cums[min(ib, d.Q - 1)];
    // A fragments of C (rows i0 .. i0 + 15) for k16 step ks: matrix lm_m
    // holds rows i0 + (lm_m & 1) 8, columns 16 ks + (lm_m >> 1) 8
    auto c_frag = [&](uint32_t (&a)[4], int ks) {
      ldsm_x4(a, smem_u32(Cs + toff(i0 + (lm_m & 1) * 8 + lm_r,
                                    ks * 2 + (lm_m >> 1), d.Nw)));
    };

    float yacc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      yacc[j][0] = yacc[j][1] = yacc[j][2] = yacc[j][3] = 0.f;

    // C h_in^T: B fragments from the [p][n] tiles (rows p = output
    // columns, as K in flash_attention.cu), hi and lo
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t a[4];
      c_frag(a, ks);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np * 16 >= Pp) break;
        const int o = toff(np * 16 + (lm_m >> 1) * 8 + lm_r,
                           ks * 2 + (lm_m & 1), d.Nw);
        uint32_t r[4];
        ldsm_x4(r, smem_u32(hh + o));
        mma_bf16(yacc[2 * np], a, r[0], r[1]);
        mma_bf16(yacc[2 * np + 1], a, r[2], r[3]);
        ldsm_x4(r, smem_u32(hl + o));
        mma_bf16(yacc[2 * np], a, r[0], r[1]);
        mma_bf16(yacc[2 * np + 1], a, r[2], r[3]);
      }
    }
    const float ea = expf(cum_a), eb = expf(cum_b);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yacc[j][0] *= ea; yacc[j][1] *= ea;
      yacc[j][2] *= eb; yacc[j][3] *= eb;
    }

    // (C B^T o L) x, 32 columns j of the scores at a time, up to the
    // diagonal block
    for (int j0 = 0; j0 <= i0 + 15 && j0 < d.Qp; j0 += 32) {
      float s[4][4];
#pragma unroll
      for (int t = 0; t < 4; ++t) s[t][0] = s[t][1] = s[t][2] = s[t][3] = 0.f;
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t a[4];
        c_frag(a, ks);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int jc = j0 + np * 16;
          if (jc >= d.Qp || jc > i0 + 15) break;
          uint32_t r[4];
          ldsm_x4(r, smem_u32(Bs + toff(jc + (lm_m >> 1) * 8 + lm_r,
                                        ks * 2 + (lm_m & 1), d.Nw)));
          mma_bf16(s[2 * np], a, r[0], r[1]);
          mma_bf16(s[2 * np + 1], a, r[2], r[3]);
        }
      }
      // o L: exp(cum_i - cum_j) dt_j on and below the diagonal, 0 above
      // and past the chunk
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int e2 = 0; e2 < 2; ++e2) {
          const int j = j0 + t * 8 + tg * 2 + e2;
          float cj = 0.f, dj = 0.f;
          if (j < d.Q && j <= ib) {
            cj = cums[j];
            dj = dts[j];
          }
          s[t][e2] = (j <= ia && j < d.Q) ? s[t][e2] * (expf(cum_a - cj) * dj)
                                          : 0.f;
          s[t][2 + e2] = (j <= ib && j < d.Q)
                             ? s[t][2 + e2] * (expf(cum_b - cj) * dj)
                             : 0.f;
        }
      }
      // repack into A fragments (k16 step kk: S tiles 2 kk and 2 kk + 1),
      // hi and lo, and multiply by x: B fragments from the [j][p] tile,
      // transposed (as V in flash_attention.cu)
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const int jk = j0 + kk * 16;
        if (jk >= d.Qp || jk > i0 + 15) break;
        uint32_t ah[4], al[4];
        split_bf16(s[2 * kk][0], s[2 * kk][1], ah[0], al[0]);
        split_bf16(s[2 * kk][2], s[2 * kk][3], ah[1], al[1]);
        split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ah[2], al[2]);
        split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ah[3], al[3]);
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          if (np * 16 >= Pp) break;
          uint32_t r[4];
          ldsm_x4_t(r, smem_u32(xs + toff(jk + (lm_m & 1) * 8 + lm_r,
                                          np * 2 + (lm_m >> 1), kPB)));
          mma_bf16(yacc[2 * np], ah, r[0], r[1]);
          mma_bf16(yacc[2 * np], al, r[0], r[1]);
          mma_bf16(yacc[2 * np + 1], ah, r[2], r[3]);
          mma_bf16(yacc[2 * np + 1], al, r[2], r[3]);
        }
      }
    }

    float* yb = y + (row0 * d.H + h) * d.P + p0;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j * 8 < Pp)
        store_tile(yb, ldx, i0, j * 8, d.Q, pw, yacc[j], vec_y, lane);
  }
}

constexpr int kSmemStatesMax =
    (kMaxQ * kMaxN + 2 * kMaxQ * kPB) * 2 + 3 * kMaxQ * 4;
constexpr int kSmemOutMax = (2 * kMaxQ * kMaxN + kMaxQ * kPB +
                             2 * kPB * kMaxN) * 2 + 2 * kMaxQ * 4;
static_assert(kSmemOutMax <= 227 * 1024, "pass c must fit one SM");

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

cudaError_t launch_tc(const bf16* x, const bf16* Bc, const bf16* Cc,
                      const float* dt, const float* A, const float* h0,
                      float* y, float* h, float* states, float* cum,
                      int batch, int S, int H, int P, int N, int Q,
                      cudaStream_t s) {
  // above 48 KB the launch needs the opt-in; the whole unified L1 as
  // shared memory lets two pass-c CTAs (three pass-a CTAs) share an SM
  static bool attr_set = false;
  if (!attr_set) {
    const cudaFuncAttribute bytes =
        cudaFuncAttributeMaxDynamicSharedMemorySize;
    const cudaFuncAttribute carve =
        cudaFuncAttributePreferredSharedMemoryCarveout;
    cudaError_t e;
    if ((e = cudaFuncSetAttribute(ssd_scan_kernel_states, bytes,
                                  kSmemStatesMax)) != cudaSuccess ||
        (e = cudaFuncSetAttribute(ssd_scan_kernel_states, carve,
                                  cudaSharedmemCarveoutMaxShared)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(ssd_scan_kernel_out, bytes, kSmemOutMax)) !=
            cudaSuccess ||
        (e = cudaFuncSetAttribute(ssd_scan_kernel_out, carve,
                                  cudaSharedmemCarveoutMaxShared)) !=
            cudaSuccess)
      return e;
    attr_set = true;
  }
  TcDims d;
  d.S = S; d.H = H; d.P = P; d.N = N; d.Q = Q; d.nc = S / Q;
  d.Qp = round_up(Q, 16); d.Np = round_up(N, 16); d.Nw = round_up(N, 64);
  const int vec_x = P % 8 == 0 && aligned16(x);
  const int vec_bc = N % 8 == 0 && aligned16(Bc) && aligned16(Cc);
  const int vec_n = N % 4 == 0;   // states: fresh torch allocations
  const int vec_y = P % 4 == 0;
  const dim3 grid(batch * d.nc, H, (P + kPB - 1) / kPB), block(kTcThreads);
  const int smem_a = (d.Qp * d.Nw + 2 * d.Qp * kPB) * 2 + 3 * kMaxQ * 4;
  ssd_scan_kernel_states<<<grid, block, smem_a, s>>>(
      x, Bc, dt, A, states, cum, d, vec_x, vec_bc, vec_n);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long total = static_cast<long long>(batch) * H * P * N;
  const long long need = (total + kTcThreads - 1) / kTcThreads;
  const long long blocks = need < 64LL * sm_count() ? need : 64LL * sm_count();
  ssd_scan_kernel_pass<<<static_cast<int>(blocks), kTcThreads, 0, s>>>(
      states, cum, h0, h, total, d);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const int smem_c =
      (2 * d.Qp * d.Nw + d.Qp * kPB + 2 * kPB * d.Nw) * 2 + 2 * kMaxQ * 4;
  ssd_scan_kernel_out<<<grid, block, smem_c, s>>>(
      x, Bc, Cc, states, cum, y, d, vec_x, vec_bc, vec_n, vec_y);
  return cudaGetLastError();
}

bool sizes_ok(int batch, int S, int H, int P, int N, int Q) {
  return batch > 0 && S > 0 && H > 0 && P > 0 && N > 0 && Q > 0 &&
         Q <= kMaxQ && N <= kMaxN && S % Q == 0;
}

}  // namespace

// fp32 x, B, C: the CUDA-core kernel.  h0 [batch, H, P, N] fp32, or null
// for a scan from zero.
extern "C" int ssd_scan_f32_launch(const void* x, const void* Bc,
                                   const void* Cc, const void* dt,
                                   const void* A, const void* h0, void* y,
                                   void* h, int batch, int S, int H, int P,
                                   int N, int Q, void* stream) {
  if (!sizes_ok(batch, S, H, P, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(batch * H, (P + kPT - 1) / kPT), block(kThreads);
  ssd_scan_kernel<<<grid, block, kSmemBytes, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(Bc),
      static_cast<const float*>(Cc), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h), S, H, P, N, Q);
  return static_cast<int>(cudaGetLastError());
}

// bf16 x, B, C: the three tensor-core passes.  h0 [batch, H, P, N] fp32,
// or null for a scan from zero.  states [batch, S / Q, H, P, N] and cum
// [batch, S / Q, H, 2, Q] (each chunk's cum, then its dt) are fp32 scratch
// from the caller.
extern "C" int ssd_scan_bf16_launch(const void* x, const void* Bc,
                                    const void* Cc, const void* dt,
                                    const void* A, const void* h0, void* y,
                                    void* h, void* states, void* cum,
                                    int batch, int S, int H, int P, int N,
                                    int Q, void* stream) {
  if (!sizes_ok(batch, S, H, P, N, Q) || states == nullptr || cum == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch_tc(
      static_cast<const bf16*>(x), static_cast<const bf16*>(Bc),
      static_cast<const bf16*>(Cc), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const float*>(h0),
      static_cast<float*>(y), static_cast<float*>(h),
      static_cast<float*>(states),
      static_cast<float*>(cum), batch, S, H, P, N, Q,
      static_cast<cudaStream_t>(stream)));
}
