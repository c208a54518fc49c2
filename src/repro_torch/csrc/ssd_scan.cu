// Mamba-2 SSD chunk scan: y and the final state h of the recurrence
//
//   h_t = exp(dt_t * A) h_{t-1} + dt_t * x_t (outer) B_t,   y_t = C_t . h_t
//
// evaluated chunk by chunk (chunk length Q), per (batch, head), from h = 0:
//
//   cum  = cumsum(dt * A)           (inclusive, within the chunk)
//   L    = tril(exp(cum_i - cum_j)) * dt_j
//   y    = (C B^T o L) x + exp(cum) * (C h^T)
//   h   <- exp(cum_end) h + (x * exp(cum_end - cum) * dt)^T B
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan/kernel.py::ssd_scan
// (body _kernel).  x [B, S, H, P] is fp32 or bf16, Bc and Cc [B, S, N] are of
// x's type, dt [B, S, H] and A [H] are fp32; y [B, S, H, P] and h [B, H, P, N]
// are written in fp32.  S is a multiple of Q (the wrapper pads with dt = 0
// rows, which leave the state as it is).  Every product runs in fp32 on the
// CUDA cores, as the TPU kernel's fp32 dots do.
//
// The TPU kernel runs the chunks as a sequential grid axis and keeps h in
// VMEM scratch between grid steps.  Here one CTA loops over all chunks of
// its (batch, head) and keeps its slice of h in shared memory for the whole
// sequence; nothing carries between CTAs.  Rows of h are independent in p,
// so the grid is (batch * head, P / 16): each CTA owns 16 columns of x, y
// and rows of h (at mamba2-2.7b's training shape, 80 * 4 = 320 CTAs for the
// 132 SMs), and recomputes its chunk's C B^T, which every p-tile and head of
// a batch row shares.  B and C are read by batch index, never copied per
// head (the TPU wrapper broadcasts them to B * H copies).
//
// Bound on the H100, at x [1, 2048, 80, 64] bf16, Q = 128, N = 128: bytes.
// The call must read x (21 MB), B, C and dt (1.7 MB) and write y in fp32
// (42 MB) and h (2.6 MB): ~67 MB, ~20 us at 3.35 TB/s, against ~7 GFLOP of
// needed arithmetic (~7 us at the bf16 tensor-core rate).  This first
// version stays well above that: it does ~3 M fp32 FMAs per chunk and CTA
// from shared memory (C B^T recomputed per CTA is two thirds of them), with
// no tensor cores.  Shared memory per CTA (~107 KB, two CTAs per SM):
//
//   S   [128][128]   the chunk's scores, C B^T o L              64 KB
//   Cs, Bs [128][17] one 16-column tile of C and B at a time    17 KB
//   xs  [128][16]    the CTA's x tile, widened to fp32           8 KB
//   hs  [16][257]    the CTA's rows of the state                16 KB
//   cum, dt, decay-to-end, exp(cum)  [128] each                  2 KB
//
// C B^T accumulates in registers (an 8 x 8 strided micro-tile per thread)
// over the 16-column tiles of N; each tile also feeds C h^T (with the state
// before this chunk's update) and then that tile's state update, so h is
// read and written in place.  Odd row strides (17, 257) keep the column
// reads of neighbouring threads on distinct banks.
#include "common.cuh"

namespace {

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

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
ssd_scan_kernel(const T* __restrict__ x, const T* __restrict__ Bm,
                const T* __restrict__ Cm, const float* __restrict__ dt,
                const float* __restrict__ A, float* __restrict__ y,
                float* __restrict__ hout, int S, int H, int P, int N, int Q) {
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

  for (int i = tid; i < kPT * kHS; i += kThreads) hs[i] = 0.f;

  for (int c = 0; c < nchunks; ++c) {
    const size_t row0 =
        static_cast<size_t>(b) * S + static_cast<size_t>(c) * Q;
    for (int i = tid; i < kMaxQ; i += kThreads)
      dts[i] = i < Q ? dt[(row0 + i) * H + h] : 0.f;
    for (int e = tid; e < kMaxQ * kPT; e += kThreads) {
      const int i = e / kPT, p = e % kPT;
      float v = 0.f;
      if (i < Q && p0 + p < P)
        v = to_f32(x[((row0 + i) * H + h) * P + p0 + p]);
      xs[e] = v;
    }
    __syncthreads();

    // inclusive cumsum of dt * A on warp 0: four consecutive rows per lane,
    // then a shuffle scan of the lane totals (rows >= Q add dt = 0)
    if (tid < 32) {
      constexpr int E = kMaxQ / 32;
      float v[E];
      float run = 0.f;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        run += dts[tid * E + e] * a_h;
        v[e] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float t = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += t;
      }
      const float base = tot - run;
#pragma unroll
      for (int e = 0; e < E; ++e) cum[tid * E + e] = base + v[e];
    }
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
          bv = to_f32(Bm[off]);
          cv = to_f32(Cm[off]);
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

template <typename T>
cudaError_t launch(const void* x, const void* Bc, const void* Cc,
                   const float* dt, const float* A, float* y, float* h,
                   int batch, int S, int H, int P, int N, int Q,
                   cudaStream_t s) {
  const cudaError_t e = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(batch * H, (P + kPT - 1) / kPT), block(kThreads);
  ssd_scan_kernel<T><<<grid, block, kSmemBytes, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(Bc),
      static_cast<const T*>(Cc), dt, A, y, h, S, H, P, N, Q);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ssd_scan_launch(const void* x, const void* Bc, const void* Cc,
                               const void* dt, const void* A, void* y,
                               void* h, int batch, int S, int H, int P, int N,
                               int Q, int dtype, void* stream) {
  if (batch <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || Q <= 0 ||
      Q > kMaxQ || N > kMaxN || S % Q != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* Af = static_cast<const float*>(A);
  float* yf = static_cast<float*>(y);
  float* hf = static_cast<float*>(h);
  cudaError_t e;
  if (dtype == DTYPE_F32) {
    e = launch<float>(x, Bc, Cc, dtf, Af, yf, hf, batch, S, H, P, N, Q, s);
  } else if (dtype == DTYPE_BF16) {
    e = launch<__nv_bfloat16>(x, Bc, Cc, dtf, Af, yf, hf, batch, S, H, P, N,
                              Q, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(e);
}
