// Fused AdamW: one elementwise pass over a flat parameter leaf, in place.
//
//   mu' = b1 * mu + (1 - b1) * g
//   nu' = b2 * nu + ((1 - b2) * g) * g
//   w'  = w - lr * ((mu' / bc1) / (sqrt(nu' / bc2) + eps) + wd * w)
//
// Replaces the TPU kernel src/repro/kernels/fused_adamw/kernel.py::
// fused_adamw_flat (body _kernel), with its operation order.  g is fp32
// or bf16 (widened in registers); mu, nu and w are fp32 and are updated
// in place, so the update holds no second copy of the optimizer state.
// lr, bc1 and bc2 are read from a 3-float device array (the TPU kernel's
// SMEM scalars): they come from the device step counter, so the update
// needs no host sync.  b1, b2, eps and wd are launch arguments; 1 - b1
// and 1 - b2 are rounded from double on the host, as the reference
// rounds its Python constants.
//
// Every operation is written with a round-to-nearest intrinsic
// (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn, __fsqrt_rn), which nvcc
// never contracts into an FMA, so the kernel is bitwise equal to its
// plain PyTorch version (kernels/fused_adamw/ops.py), whose separate
// elementwise ops round after every step too.
//
// Bound on the H100: memory.  Each element reads g, mu, nu, w and writes
// mu, nu, w: 28 bytes with fp32 g (24 with bf16) for ~12 flops.  Design:
// a grid-stride loop over groups of 4 elements with 16-byte vector
// loads and stores (8-byte loads of bf16 g) when every pointer is
// aligned for them, then a scalar tail; misaligned leaves take the
// scalar loop throughout.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;

struct Hyper {
  float b1, omb1, b2, omb2, eps, wd;
};

__device__ __forceinline__ void adamw_elem(float g, float& mu, float& nu,
                                           float& w, float lr, float bc1,
                                           float bc2, const Hyper& h) {
  mu = __fadd_rn(__fmul_rn(h.b1, mu), __fmul_rn(h.omb1, g));
  nu = __fadd_rn(__fmul_rn(h.b2, nu), __fmul_rn(__fmul_rn(h.omb2, g), g));
  const float den = __fadd_rn(__fsqrt_rn(__fdiv_rn(nu, bc2)), h.eps);
  const float upd =
      __fadd_rn(__fdiv_rn(__fdiv_rn(mu, bc1), den), __fmul_rn(h.wd, w));
  w = __fsub_rn(w, __fmul_rn(lr, upd));
}

// four consecutive gradient values, widened to fp32
__device__ __forceinline__ float4 load_g4(const float* g, int64_t i) {
  return reinterpret_cast<const float4*>(g)[i];
}
__device__ __forceinline__ float4 load_g4(const __nv_bfloat16* g, int64_t i) {
  const uint2 raw = reinterpret_cast<const uint2*>(g)[i];
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  return make_float4(__low2float(lo), __high2float(lo), __low2float(hi),
                     __high2float(hi));
}

template <typename G>
__global__ void __launch_bounds__(kThreads)
fused_adamw_kernel(const G* __restrict__ g, float* __restrict__ mu,
                   float* __restrict__ nu, float* __restrict__ w,
                   const float* __restrict__ scalars, int64_t n,
                   int64_t nvec, Hyper h) {
  const float lr = __ldg(scalars), bc1 = __ldg(scalars + 1),
              bc2 = __ldg(scalars + 2);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  float4* mu4 = reinterpret_cast<float4*>(mu);
  float4* nu4 = reinterpret_cast<float4*>(nu);
  float4* w4 = reinterpret_cast<float4*>(w);
  for (int64_t i = tid; i < nvec; i += stride) {
    const float4 gv = load_g4(g, i);
    float4 m = mu4[i], v = nu4[i], p = w4[i];
    adamw_elem(gv.x, m.x, v.x, p.x, lr, bc1, bc2, h);
    adamw_elem(gv.y, m.y, v.y, p.y, lr, bc1, bc2, h);
    adamw_elem(gv.z, m.z, v.z, p.z, lr, bc1, bc2, h);
    adamw_elem(gv.w, m.w, v.w, p.w, lr, bc1, bc2, h);
    mu4[i] = m;
    nu4[i] = v;
    w4[i] = p;
  }
  for (int64_t i = 4 * nvec + tid; i < n; i += stride) {
    float m = mu[i], v = nu[i], p = w[i];
    adamw_elem(to_f32(g[i]), m, v, p, lr, bc1, bc2, h);
    mu[i] = m;
    nu[i] = v;
    w[i] = p;
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename G>
void launch(const void* g, float* mu, float* nu, float* w,
            const float* scalars, int64_t n, const Hyper& h,
            cudaStream_t s) {
  const bool vec = aligned(g, 4 * sizeof(G)) && aligned(mu, 16) &&
                   aligned(nu, 16) && aligned(w, 16);
  const int64_t nvec = vec ? n / 4 : 0;
  const int64_t work = nvec > 0 ? nvec : n;
  // enough CTAs to fill the 132 SMs several times over; the grid-stride
  // loop covers the rest
  const int64_t blocks = (work + kThreads - 1) / kThreads;
  const int grid = static_cast<int>(blocks < 132 * 16 ? blocks : 132 * 16);
  fused_adamw_kernel<G><<<grid, kThreads, 0, s>>>(
      static_cast<const G*>(g), mu, nu, w, scalars, n, nvec, h);
}

}  // namespace

extern "C" int fused_adamw_launch(const void* g, void* mu, void* nu, void* w,
                                  const void* scalars, long long n,
                                  float b1, float omb1, float b2, float omb2,
                                  float eps, float wd, int g_dtype,
                                  void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const Hyper h{b1, omb1, b2, omb2, eps, wd};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* m = static_cast<float*>(mu);
  float* v = static_cast<float*>(nu);
  float* p = static_cast<float*>(w);
  const float* sc = static_cast<const float*>(scalars);
  if (g_dtype == DTYPE_F32) {
    launch<float>(g, m, v, p, sc, n, h, s);
  } else if (g_dtype == DTYPE_BF16) {
    launch<__nv_bfloat16>(g, m, v, p, sc, n, h, s);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
