// RMSNorm over rows: y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py::rmsnorm_rows
// (body _kernel).  Statistics in fp32, result cast back to x's type, the
// same operation order as models/layers.py::rmsnorm: (x * rsqrt(var + eps))
// * scale.
//
// Bound on the H100: memory.  The function reads x once and writes y once
// (2 * R * d * bytes, plus d * bytes of scale); it does ~4 flops per
// element, far below the card's ~295 flops per byte.  Design
// (rmsnorm_rows_kernel_vec): a row is split over W warps (W = 1, 2, 4 or 8,
// the fewest whose lanes hold it at kVec = 5 16-byte vectors a lane: 8 bf16
// or 4 fp32 values per vector; d = 2560 and 5120 in bf16 fill W = 2 and 4
// exactly), 1 to 8 rows per CTA.  Each lane loads its columns of scale once
// and keeps them in registers.  The grid is one wave of CTAs (the occupancy
// the card reports), each looping over groups of rows: the 16-byte loads of
// the next group's row are issued before the current row is reduced, so
// loads stay in flight while a row is reduced and written.  Each row stays
// in registers between the reduction and the 16-byte stores, so device
// memory sees each byte of x once.  The sum of squares reduces with warp
// shuffles and, for W > 1, one shared-memory pass.  Rows per CTA shrink for
// small R (the serving shape, 64 rows) so that the grid spreads over the
// SMs.  Rows that cannot take 16-byte vectors (d not a multiple of the
// vector width, a pointer not 16-byte aligned) or that do not fit (more than
// 8 warps x 32 lanes x kVec vectors) take rmsnorm_rows_kernel, one CTA of
// 256 threads per row with scalar loads and a second pass over the row.
#include <cstdint>
#include <initializer_list>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;  // scalar kernel: threads per row
// Vector kernel tiling: 16-byte vectors a lane holds, and the most warps per
// CTA.  At [2048, 5120] bf16 on an H100, 5 vectors were faster than 3, 4, 6
// or 8, and 8 warps faster than 4 (PERF.md, PR 14).
constexpr int kVec = 5;
constexpr int kMaxWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kThreads)
rmsnorm_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                    T* __restrict__ y, int d, float eps) {
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;

  float ss = 0.f;
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]);
    ss += v * v;
  }
  // warp reduction, then one value per warp through shared memory
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  __shared__ float warp_sums[kThreads / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  float total = 0.f;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) total += warp_sums[w];

  const float inv = rsqrtf(total / static_cast<float>(d) + eps);
  for (int i = threadIdx.x; i < d; i += kThreads) {
    const float v = to_f32(xr[i]) * inv;
    yr[i] = from_f32<T>(v * to_f32(scale[i]));
  }
}

// 16 bytes of T <-> fp32 values
template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  static constexpr int kN = 4;
  __device__ static void unpack(const uint4& u, float (&f)[4]) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
  __device__ static uint4 pack(const float (&f)[4]) {
    return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]),
                      __float_as_uint(f[2]), __float_as_uint(f[3]));
  }
};
template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int kN = 8;
  __device__ static void unpack(const uint4& u, float (&f)[8]) {
    const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // element 2i in the low half (exact)
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint32_t pack2(float lo, float hi) {
    return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo))) |
           (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
  }
  __device__ static uint4 pack(const float (&f)[8]) {
    return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                      pack2(f[4], f[5]), pack2(f[6], f[7]));
  }
};

template <typename T, int W>
__global__ void __launch_bounds__(kMaxWarps * 32)
rmsnorm_rows_kernel_vec(const T* __restrict__ x, const T* __restrict__ scale,
                        T* __restrict__ y, int R, int d, float eps) {
  using V = Vec16<T>;
  constexpr int N = V::kN, tpr = 32 * W;  // W warps per row
  const int nvec = d / N;
  const int rpc = blockDim.x / tpr;  // rows per CTA and group
  const int local = threadIdx.x / tpr, t = threadIdx.x % tpr;
  const int groups = (R + rpc - 1) / rpc;
  const uint4* sr = reinterpret_cast<const uint4*>(scale);
  // a lane's vectors sit at the same columns in every row: scale once
  uint4 sv[kVec], xv[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int i = t + j * tpr;
    sv[j] = i < nvec ? __ldg(sr + i) : make_uint4(0u, 0u, 0u, 0u);
  }
  auto load_row = [&](int g, uint4(&dst)[kVec]) {
    const int row = g * rpc + local;
    const bool ok = g < groups && row < R;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = t + j * tpr;
      dst[j] = ok && i < nvec ? xr[i] : make_uint4(0u, 0u, 0u, 0u);
    }
  };
  __shared__ float warp_sums[2][kMaxWarps];  // by the group's parity
  int parity = 0;
  load_row(blockIdx.x, xv);
  for (int g = blockIdx.x; g < groups; g += gridDim.x, parity ^= 1) {
    uint4 xn[kVec];
    load_row(g + gridDim.x, xn);  // the next group's row, in flight now
    float ss = 0.f;
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      float f[N];
      V::unpack(xv[j], f);
#pragma unroll
      for (int e = 0; e < N; ++e) ss += f[e] * f[e];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      ss += __shfl_xor_sync(0xffffffffu, ss, off);
    if (W > 1) {  // the row's warps meet in shared memory
      if (threadIdx.x % 32 == 0) warp_sums[parity][threadIdx.x / 32] = ss;
      __syncthreads();
      ss = 0.f;
#pragma unroll
      for (int w = 0; w < W; ++w) ss += warp_sums[parity][local * W + w];
    }
    const float inv = rsqrtf(ss / static_cast<float>(d) + eps);
    const int row = g * rpc + local;
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      const int i = t + j * tpr;
      if (row < R && i < nvec) {
        float f[N], sc[N];
        V::unpack(xv[j], f);
        V::unpack(sv[j], sc);
#pragma unroll
        for (int e = 0; e < N; ++e) f[e] = (f[e] * inv) * sc[e];
        yr[i] = V::pack(f);
      }
      xv[j] = xn[j];
    }
  }
}

template <typename T, int W>
void launch_vec(const void* x, const void* scale, void* y, int rows, int d,
                float eps, cudaStream_t s) {
  int rpc = kMaxWarps / W;  // rows per CTA, fewer for small R
  while (rpc > 1 && (rows + rpc - 1) / rpc < sm_count()) rpc /= 2;
  static int resident[kMaxWarps + 1] = {0};  // CTAs per SM, by rpc
  if (resident[rpc] == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &resident[rpc], rmsnorm_rows_kernel_vec<T, W>, 32 * W * rpc, 0);
    resident[rpc] = resident[rpc] > 0 ? resident[rpc] : 1;
  }
  // persistent: at most one wave of CTAs, each looping over row groups
  const int groups = (rows + rpc - 1) / rpc;
  const int wave = resident[rpc] * sm_count();
  const int grid = groups < wave ? groups : wave;
  rmsnorm_rows_kernel_vec<T, W><<<grid, 32 * W * rpc, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(scale),
      static_cast<T*>(y), rows, d, eps);
}

template <typename T>
int launch(const void* x, const void* scale, void* y, int rows, int d,
           float eps, cudaStream_t s) {
  constexpr int N = 16 / sizeof(T);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) |
                         reinterpret_cast<uintptr_t>(scale) |
                         reinterpret_cast<uintptr_t>(y)) & 15) == 0;
  const int nvec = d / N;
  if (aligned && d % N == 0 && nvec <= kMaxWarps * 32 * kVec) {
    // the fewest warps per row whose lanes hold the row
    if (nvec <= 32 * kVec)
      launch_vec<T, 1>(x, scale, y, rows, d, eps, s);
    else if (nvec <= 64 * kVec)
      launch_vec<T, 2>(x, scale, y, rows, d, eps, s);
    else if (nvec <= 128 * kVec)
      launch_vec<T, 4>(x, scale, y, rows, d, eps, s);
    else
      launch_vec<T, 8>(x, scale, y, rows, d, eps, s);
  } else {
    rmsnorm_rows_kernel<T><<<rows, kThreads, 0, s>>>(
        static_cast<const T*>(x), static_cast<const T*>(scale),
        static_cast<T*>(y), d, eps);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// Split-width rows: a row's columns lie on several ranks (a tensor-parallel
// split of the Mamba-2 gated norm's d_in), so the sum of squares is reduced
// in two passes with an all-reduce of the [R] fp32 sums between them.
// rmsnorm_sumsq_kernel writes each row's fp32 sum of squares over the
// columns this rank holds; rmsnorm_scale_kernel writes
// (x * rsqrt(ss / d_full + eps)) * scale in x's type from the all-reduced
// sums.  Bound on the H100: memory (the first pass reads x once and writes
// 4 bytes a row, the second reads x and writes y once).  Design: one warp a
// row, 8 rows a CTA; 16-byte loads and stores where the row width is a
// multiple of the vector and the pointers are 16-byte aligned, else scalar
// ones.  A simple kernel: nothing is held in registers across the passes,
// since the all-reduce sits between them.
constexpr int kSplitRows = 8;  // rows (warps) per CTA

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kSplitRows * 32)
rmsnorm_sumsq_kernel(const T* __restrict__ x, float* __restrict__ ss, int R,
                     int d) {
  const int row = blockIdx.x * kSplitRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;  // the whole warp: a row is one warp's
  float s = 0.f;
  if (kVec16) {
    using V = Vec16<T>;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
    const int nvec = d / V::kN;
    for (int i = lane; i < nvec; i += 32) {
      float f[V::kN];
      V::unpack(xr[i], f);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) s += f[e] * f[e];
    }
  } else {
    const T* xr = x + (size_t)row * d;
    for (int i = lane; i < d; i += 32) {
      const float v = to_f32(xr[i]);
      s += v * v;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s += __shfl_xor_sync(0xffffffffu, s, off);
  if (lane == 0) ss[row] = s;
}

template <typename T, bool kVec16>
__global__ void __launch_bounds__(kSplitRows * 32)
rmsnorm_scale_kernel(const T* __restrict__ x, const float* __restrict__ ss,
                     const T* __restrict__ scale, T* __restrict__ y, int R,
                     int d, int d_full, float eps) {
  const int row = blockIdx.x * kSplitRows + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= R) return;
  const float inv = rsqrtf(ss[row] / static_cast<float>(d_full) + eps);
  if (kVec16) {
    using V = Vec16<T>;
    const uint4* xr = reinterpret_cast<const uint4*>(x + (size_t)row * d);
    const uint4* sr = reinterpret_cast<const uint4*>(scale);
    uint4* yr = reinterpret_cast<uint4*>(y + (size_t)row * d);
    const int nvec = d / V::kN;
    for (int i = lane; i < nvec; i += 32) {
      float f[V::kN], sc[V::kN];
      V::unpack(xr[i], f);
      V::unpack(__ldg(sr + i), sc);
#pragma unroll
      for (int e = 0; e < V::kN; ++e) f[e] = (f[e] * inv) * sc[e];
      yr[i] = V::pack(f);
    }
  } else {
    const T* xr = x + (size_t)row * d;
    T* yr = y + (size_t)row * d;
    for (int i = lane; i < d; i += 32)
      yr[i] = from_f32<T>((to_f32(xr[i]) * inv) * to_f32(scale[i]));
  }
}

template <typename T>
bool vec16_ok(int d, std::initializer_list<const void*> ptrs) {
  uintptr_t bits = 0;
  for (const void* p : ptrs) bits |= reinterpret_cast<uintptr_t>(p);
  return (bits & 15) == 0 && d % (16 / static_cast<int>(sizeof(T))) == 0;
}

template <typename T>
int launch_sumsq(const void* x, float* ss, int rows, int d, cudaStream_t s) {
  const int grid = (rows + kSplitRows - 1) / kSplitRows;
  if (vec16_ok<T>(d, {x}))
    rmsnorm_sumsq_kernel<T, true><<<grid, kSplitRows * 32, 0, s>>>(
        static_cast<const T*>(x), ss, rows, d);
  else
    rmsnorm_sumsq_kernel<T, false><<<grid, kSplitRows * 32, 0, s>>>(
        static_cast<const T*>(x), ss, rows, d);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_scale(const void* x, const float* ss, const void* scale, void* y,
                 int rows, int d, int d_full, float eps, cudaStream_t s) {
  const int grid = (rows + kSplitRows - 1) / kSplitRows;
  if (vec16_ok<T>(d, {x, scale, y}))
    rmsnorm_scale_kernel<T, true><<<grid, kSplitRows * 32, 0, s>>>(
        static_cast<const T*>(x), ss, static_cast<const T*>(scale),
        static_cast<T*>(y), rows, d, d_full, eps);
  else
    rmsnorm_scale_kernel<T, false><<<grid, kSplitRows * 32, 0, s>>>(
        static_cast<const T*>(x), ss, static_cast<const T*>(scale),
        static_cast<T*>(y), rows, d, d_full, eps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int rmsnorm_sumsq_launch(const void* x, void* ss, int rows, int d,
                                    int dtype, void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(ss);
  if (dtype == DTYPE_F32) return launch_sumsq<float>(x, out, rows, d, s);
  if (dtype == DTYPE_BF16)
    return launch_sumsq<__nv_bfloat16>(x, out, rows, d, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rmsnorm_scale_launch(const void* x, const void* ss,
                                    const void* scale, void* y, int rows,
                                    int d, int d_full, float eps, int dtype,
                                    void* stream) {
  if (rows <= 0 || d <= 0 || d_full < d)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sums = static_cast<const float*>(ss);
  if (dtype == DTYPE_F32)
    return launch_scale<float>(x, sums, scale, y, rows, d, d_full, eps, s);
  if (dtype == DTYPE_BF16)
    return launch_scale<__nv_bfloat16>(x, sums, scale, y, rows, d, d_full,
                                       eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int rmsnorm_rows_launch(const void* x, const void* scale, void* y,
                                   int rows, int d, float eps, int dtype,
                                   void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) return launch<float>(x, scale, y, rows, d, eps, s);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, scale, y, rows, d, eps, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
