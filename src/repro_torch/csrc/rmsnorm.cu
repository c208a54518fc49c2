// RMSNorm over rows: y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * scale.
//
// Replaces the TPU kernel src/repro/kernels/rmsnorm/kernel.py::rmsnorm_rows
// (body _kernel).  Statistics in fp32, result cast back to x's type, the
// same operation order as models/layers.py::rmsnorm: (x * rsqrt(var + eps))
// * scale.
//
// Bound on the H100: memory.  The function reads x once and writes y once
// (2 * R * d * bytes, plus d * bytes of scale); at d = 2048 it does ~4
// flops per element, far below the card's ~295 flops per byte.  Design:
// one CTA of 256 threads per row.  Threads walk the row with a stride of
// the block, so a warp's loads are contiguous; the sum of squares reduces
// with warp shuffles and one shared-memory pass; the second pass rereads
// the row, which at d = 2048 (4 KB in bf16) is served by L1/L2, so device
// memory sees each byte about once.  Any d is accepted (scalar loop).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

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

}  // namespace

extern "C" int rmsnorm_rows_launch(const void* x, const void* scale, void* y,
                                   int rows, int d, float eps, int dtype,
                                   void* stream) {
  if (rows <= 0 || d <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(rows), block(kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == DTYPE_F32) {
    rmsnorm_rows_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(scale),
        static_cast<float*>(y), d, eps);
  } else if (dtype == DTYPE_BF16) {
    rmsnorm_rows_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(scale),
        static_cast<__nv_bfloat16*>(y), d, eps);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* repro_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
