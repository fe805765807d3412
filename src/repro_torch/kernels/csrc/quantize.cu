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
// Split in two for a row whose K is cut over the ranks of a mesh (the
// row-parallel w8a8 GEMM, core/gemm.py): repro_row_amax stores each row's
// max |x| (the first pass alone; bounded by bytes: M*K*(2 or 4) in, 4*M out),
// the ranks' maxima are joined by a max all-reduce, and
// repro_quantize_rows_given quantizes with that max (the second pass;
// M*K*(2 or 4) + 4*M in, M*K + 4*M out).  Max is exact, so the two give
// repro_quantize_rows's q and scale bit for bit.
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

// What one launch does with each row: MODE_BOTH takes its max |x| and
// quantizes it (repro_quantize_rows); MODE_AMAX stores the max alone;
// MODE_GIVEN quantizes with the max it is given (amax[row]).
enum QuantMode { MODE_BOTH = 0, MODE_AMAX = 1, MODE_GIVEN = 2 };

// vec: K is a multiple of 16 / sizeof(T) and x is 16-byte aligned
template <typename T, int MODE>
__global__ void __launch_bounds__(QZ_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ q,
                     float* __restrict__ scale, float* __restrict__ amax, int K, int vec) {
  constexpr int V = 16 / sizeof(T);  // values in a 16-byte load
  __shared__ float wmax[QZ_THREADS / 32];
  __shared__ float s_scale;
  const int tid = threadIdx.x;
  const T* xr = x + (size_t)blockIdx.x * K;
  int8_t* qr = q + (size_t)blockIdx.x * K;

  if (MODE == MODE_GIVEN) {
    if (tid == 0) {
      s_scale = __fdiv_rn(fmaxf(amax[blockIdx.x], 1e-8f), 127.f);
      scale[blockIdx.x] = s_scale;
    }
  } else {
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
      if (MODE == MODE_AMAX) {
        amax[blockIdx.x] = a;
      } else {
        s_scale = __fdiv_rn(fmaxf(a, 1e-8f), 127.f);
        scale[blockIdx.x] = s_scale;
      }
    }
    if (MODE == MODE_AMAX) return;
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

template <int MODE>
int launch_quantize(const void* x, void* q, void* scale, void* amax, int M, int K, int is_bf16,
                    cudaStream_t s) {
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  float* ap = static_cast<float*>(amax);
  const bool aligned = reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (is_bf16) {
    const int vec = aligned && K % 8 == 0;
    quantize_rows_kernel<__nv_bfloat16, MODE><<<M, QZ_THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), qp, sp, ap, K, vec);
  } else {
    const int vec = aligned && K % 4 == 0;
    quantize_rows_kernel<float, MODE><<<M, QZ_THREADS, 0, s>>>(static_cast<const float*>(x),
                                                                qp, sp, ap, K, vec);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace repro

// x [M, K] f32 or (is_bf16) bf16, rows contiguous; q [M, K] int8; scale [M]
// f32.  Returns cudaGetLastError() after the launch.
extern "C" int repro_quantize_rows(const void* x, void* q, void* scale, int M, int K,
                                   int is_bf16, void* stream) {
  return repro::launch_quantize<repro::MODE_BOTH>(x, q, scale, nullptr, M, K, is_bf16,
                                                  static_cast<cudaStream_t>(stream));
}

// amax [M] f32: max_k |x[m, k]| of x [M, K] (f32 or bf16).
extern "C" int repro_row_amax(const void* x, void* amax, int M, int K, int is_bf16,
                              void* stream) {
  return repro::launch_quantize<repro::MODE_AMAX>(x, nullptr, nullptr, amax, M, K, is_bf16,
                                                  static_cast<cudaStream_t>(stream));
}

// q [M, K] int8 and scale [M] f32 from x [M, K] with the given row maxima
// amax [M] f32: scale = max(amax, 1e-8) / 127, q = clip(rint(x / scale)).
extern "C" int repro_quantize_rows_given(const void* x, const void* amax, void* q, void* scale,
                                         int M, int K, int is_bf16, void* stream) {
  return repro::launch_quantize<repro::MODE_GIVEN>(x, q, scale, const_cast<void*>(amax), M, K,
                                                   is_bf16, static_cast<cudaStream_t>(stream));
}
