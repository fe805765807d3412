// Per-row symmetric int8 quantization of a GEMM's activation (sm_90a):
//   scale[m] = max(max_k |x[m,k]|, 1e-8) / 127
//   q[m,k]   = clamp(round_half_even(x[m,k] / scale[m]), -127, 127)
//
// Replaces: the activation half of the paper's packed-data path --
// src/repro/core/quant.py, quantize(x, axis=0), as src/repro/core/gemm.py,
// cgra_gemm_w8a8, calls it just before block_gemm_int8.  It is no Pallas
// kernel: under jit XLA fuses it into one pass.  Run eagerly it was about
// eight PyTorch launches and as many round trips through device memory per
// GEMM; this is one launch.
//
// What bounds it on an H100: bytes -- x read once (and once more, from
// L1/L2), q and the scales written once: M*K*(2 or 4) + M*K + 4*M bytes.
// One block per row: 16-byte vector loads (8 bf16 or 4 f32 a thread), the
// row's max |x| by a warp reduction and one across the block's warps (max
// is exact in any order), then a second pass that divides, rounds and
// stores 8 (4) int8 values a thread.
//
// Bit for bit the plain version (kernels/ref.py, quantize_rows_ref) and
// so JAX's quantize: every step is one correctly rounded f32 operation --
// IEEE division (__fdiv_rn), round half to even (rintf), never roundf (it
// rounds halves away from zero).  Inputs are finite: a NaN would be
// dropped by fmaxf where PyTorch's amax keeps it.
#include "common.cuh"

namespace repro {

constexpr int QZ_THREADS = 256;

__device__ __forceinline__ int8_t quant1(float x, float scale) {
  const float r = fminf(fmaxf(rintf(__fdiv_rn(x, scale)), -127.f), 127.f);
  return static_cast<int8_t>(__float2int_rn(r));
}

// vec: K is a multiple of 16 / sizeof(T) and x is 16-byte aligned
template <typename T>
__global__ void __launch_bounds__(QZ_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, int K, int vec) {
  constexpr int V = 16 / sizeof(T);  // values in a 16-byte load
  __shared__ float wmax[QZ_THREADS / 32];
  __shared__ float s_scale;
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;

  float m = 0.f;
  if (vec) {
    for (int i = tid; i < K / V; i += QZ_THREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + (size_t)i * V);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int u = 0; u < V; ++u) m = fmaxf(m, fabsf(to_f(e[u])));
    }
  } else {
    for (int i = tid; i < K; i += QZ_THREADS) m = fmaxf(m, fabsf(to_f(xr[i])));
  }
  m = warp_max(m);
  if ((tid & 31) == 0) wmax[tid >> 5] = m;
  __syncthreads();
  if (tid == 0) {
    float a = wmax[0];
#pragma unroll
    for (int w = 1; w < QZ_THREADS / 32; ++w) a = fmaxf(a, wmax[w]);
    s_scale = __fdiv_rn(fmaxf(a, 1e-8f), 127.f);
    scale[blockIdx.x] = s_scale;
  }
  __syncthreads();
  const float s = s_scale;

  if (vec) {
    for (int i = tid; i < K / V; i += QZ_THREADS) {
      const uint4 raw = *reinterpret_cast<const uint4*>(xr + (size_t)i * V);
      const T* e = reinterpret_cast<const T*>(&raw);
      alignas(8) int8_t out[V];
#pragma unroll
      for (int u = 0; u < V; ++u) out[u] = quant1(to_f(e[u]), s);
      if (V == 8)
        *reinterpret_cast<uint2*>(qr + (size_t)i * V) = *reinterpret_cast<const uint2*>(out);
      else
        *reinterpret_cast<uint32_t*>(qr + (size_t)i * V) =
            *reinterpret_cast<const uint32_t*>(out);
    }
  } else {
    for (int i = tid; i < K; i += QZ_THREADS) qr[i] = quant1(to_f(xr[i]), s);
  }
}

}  // namespace repro

// x [M, K] f32 or (is_bf16) bf16, rows contiguous; q [M, K] int8; scale [M]
// f32.  Returns cudaGetLastError() after the launch.
extern "C" int repro_quantize_rows(const void* x, void* q, void* scale, int M, int K,
                                   int is_bf16, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (is_bf16) {
    const int vec = aligned && K % 8 == 0;
    repro::quantize_rows_kernel<__nv_bfloat16><<<M, repro::QZ_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, K, vec);
  } else {
    const int vec = aligned && K % 4 == 0;
    repro::quantize_rows_kernel<float><<<M, repro::QZ_THREADS, 0, s>>>(
        static_cast<const float*>(x), qp, sp, K, vec);
  }
  return static_cast<int>(cudaGetLastError());
}
