// K1: fused LayerNorm (over channels, eps) + ReLU on a (rows, C) view.
//
// Replaces the Pallas TPU kernel adunet/kernels/fused_norm.py:48
// `_pallas_forward` (pl.pallas_call at :59, body `_kernel` at :39). Same
// function: float32 mean and biased variance over C, (x-mean)*rsqrt(var+eps)
// *gamma+beta, ReLU, cast back to the input type (float32 or bf16).
//
// Bound on an H100: bytes. It does ~8 operations per element and moves
// 2*sizeof(T) bytes per element, far below the card's ~20 FLOP/byte (f32
// SIMT) ridge, so its floor is (read x + write y) / 3.35 TB/s.
//
// Design: one warp per row, eight rows per 256-thread block. The row stays
// in registers between the two warp reductions (the mean, then the mean of
// squared deviations, as the reference computes them), so x is read from
// device memory once and y written once. Each lane loads V contiguous
// elements (8-16 bytes) so a warp's load is one coalesced run; C is a
// compile-time constant (64..2048), so the loops fully unroll.
#include "common.cuh"

namespace adunet {
namespace {

constexpr int kWarpsPerBlock = 8;

template <typename Tr, int V, int K>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_relu_kernel(const typename Tr::storage* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       typename Tr::storage* __restrict__ y,
                       long long rows, float eps) {
  constexpr int C = 32 * V * K;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;  // warp-uniform: the shuffles below see full warps

  const typename Tr::storage* xr = x + row * C;
  float v[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) load_vec<Tr, V>(xr + (k * 32 + lane) * V, v[k]);

  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[k][i];
  const float mean = warp_sum(s) / C;

  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[k][i] - mean;
      q += d * d;
    }
  const float rstd = rsqrtf(warp_sum(q) / C + eps);

  typename Tr::storage* yr = y + row * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (k * 32 + lane) * V;
    float g[V], b[V], o[V];
    load_vec<F32, V>(gamma + c0, g);
    load_vec<F32, V>(beta + c0, b);
#pragma unroll
    for (int i = 0; i < V; ++i) o[i] = fmaxf((v[k][i] - mean) * rstd * g[i] + b[i], 0.f);
    store_vec<Tr, V>(yr + c0, o);
  }
}

template <typename Tr, int C>
void launch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
            float eps, cudaStream_t stream) {
  constexpr int kMaxV = 16 / static_cast<int>(sizeof(typename Tr::storage));
  constexpr int V = (C / 32) < kMaxV ? (C / 32) : kMaxV;
  constexpr int K = C / (32 * V);
  static_assert(32 * V * K == C, "C must be a multiple of 32*V");
  const unsigned blocks = static_cast<unsigned>((rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  layer_norm_relu_kernel<Tr, V, K><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const typename Tr::storage*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<typename Tr::storage*>(y), rows, eps);
}

template <typename Tr>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
                     int C, float eps, cudaStream_t stream) {
  switch (C) {
    case 64: launch<Tr, 64>(x, gamma, beta, y, rows, eps, stream); break;
    case 128: launch<Tr, 128>(x, gamma, beta, y, rows, eps, stream); break;
    case 256: launch<Tr, 256>(x, gamma, beta, y, rows, eps, stream); break;
    case 512: launch<Tr, 512>(x, gamma, beta, y, rows, eps, stream); break;
    case 1024: launch<Tr, 1024>(x, gamma, beta, y, rows, eps, stream); break;
    case 2048: launch<Tr, 2048>(x, gamma, beta, y, rows, eps, stream); break;
    default: return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace adunet

// x, y: contiguous (rows, C) of `dtype` (0 float32, 1 bf16); gamma, beta:
// float32 (C,). All pointers 16-byte aligned. Returns the launch's CUDA error.
extern "C" int adunet_layer_norm_relu(const void* x, const void* gamma, const void* beta, void* y,
                                      long long rows, int C, float eps, int dtype, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adunet::kFloat32:
      return adunet::dispatch<adunet::F32>(x, gamma, beta, y, rows, C, eps, st);
    case adunet::kBFloat16:
      return adunet::dispatch<adunet::BF16>(x, gamma, beta, y, rows, C, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

// Message for a code returned by any entry point of this library.
extern "C" const char* adunet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
