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
// compile-time constant (16..2048), so the loops fully unroll.
//
// Narrow rows (C = 16, 32: the vanilla segmentation U-Net's first level) are
// shorter than 32 lanes x one 16-byte vector, so there L = C / V lanes hold a
// row (V elements of 16 bytes each) and a warp holds 32 / L consecutive rows,
// still one coalesced run per load. The reductions are butterflies over
// lane offsets below L, which never cross from one row's lanes to another's.
#include "common.cuh"

namespace adunet {
namespace {

constexpr int kWarpsPerBlock = 8;

// The split of a row of C elements of type S over the lanes: L lanes per row
// (32, or fewer for a narrow row), V elements per vector load, K loads per
// lane. C >= 64 keeps one warp per row with V = min(C / 32, 16 bytes).
template <typename S, int C>
struct RowSplit {
  static constexpr int kMaxV = 16 / static_cast<int>(sizeof(S));
  static constexpr int V = C >= 64 ? ((C / 32) < kMaxV ? C / 32 : kMaxV) : (C < kMaxV ? C : kMaxV);
  static constexpr int L = C >= 64 ? 32 : C / V;
  static constexpr int K = C / (L * V);
  static_assert(L * V * K == C && 32 % L == 0, "C must split into L * V * K, L dividing 32");
};

// Sum over the L lanes of a row (lane offsets below L: the row's own lanes).
template <int L>
__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Mean and rsqrt(biased variance + eps) of a row held by L lanes, V x K
// elements per lane: the mean first, then the mean of squared deviations,
// as the reference computes them. The forward and the backward kernel both
// call this, so the backward's ReLU mask is the forward's bit for bit.
template <int V, int K, int L>
__device__ __forceinline__ void row_stats(const float (&v)[K][V], float eps, float& mean,
                                          float& rstd) {
  constexpr int C = L * V * K;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s += v[k][i];
  mean = row_sum<L>(s) / C;

  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = v[k][i] - mean;
      q += d * d;
    }
  rstd = rsqrtf(row_sum<L>(q) / C + eps);
}

template <typename Tr, int V, int K, int L>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_relu_kernel(const typename Tr::storage* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       typename Tr::storage* __restrict__ y,
                       long long rows, float eps) {
  constexpr int C = L * V * K;
  constexpr int kRowsPerWarp = 32 / L;
  const int lane = threadIdx.x & 31;
  const int sub = lane % L;  // the lane's place in its row
  const long long row0 =
      (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5)) * kRowsPerWarp;
  if (row0 >= rows) return;  // warp-uniform: the shuffles below see full warps
  const long long row = row0 + lane / L;
  // A narrow-row warp past the last row keeps its lanes for the shuffles:
  // they reduce zeros and store nothing.
  const bool live = row < rows;

  float v[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    if (live) {
      load_vec<Tr, V>(x + row * C + (k * L + sub) * V, v[k]);
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }

  float mean, rstd;
  row_stats<V, K, L>(v, eps, mean, rstd);
  if (!live) return;

  typename Tr::storage* yr = y + row * C;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c0 = (k * L + sub) * V;
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
  using Sp = RowSplit<typename Tr::storage, C>;
  constexpr long long kRowsPerBlock = kWarpsPerBlock * (32 / Sp::L);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_relu_kernel<Tr, Sp::V, Sp::K, Sp::L><<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const typename Tr::storage*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<typename Tr::storage*>(y), rows, eps);
}

template <typename Tr>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta, void* y, long long rows,
                     int C, float eps, cudaStream_t stream) {
  switch (C) {
    case 16: launch<Tr, 16>(x, gamma, beta, y, rows, eps, stream); break;
    case 32: launch<Tr, 32>(x, gamma, beta, y, rows, eps, stream); break;
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

// ------------------------------------------------------------------ backward
//
// Replaces the reference's custom-VJP backward adunet/kernels/fused_norm.py:109
// `_bwd` (jnp ops around the Pallas forward): from x, gamma, beta and the
// output cotangent g it recomputes mean and rstd, xhat and pre = xhat*gamma +
// beta in float32, masks gm = g * (pre > 0), and writes
//   dx     = rstd * (gm*gamma - mean(gm*gamma) - xhat * mean(gm*gamma*xhat)),
//   dgamma = sum over rows of gm*xhat,   dbeta = sum over rows of gm.
//
// Bound on an H100: bytes. x and g are read once and dx written once, 3 *
// sizeof(T) bytes per element (0.805 GB, 0.24 ms, at 2,097,152 x 64 bf16);
// the (2, C) parameter sums are noise beside that.
//
// Design: the forward's layout, one warp per row (or 32 / L narrow rows per
// warp) in registers at the same V / K / L split, with the statistics from
// `row_stats`, the forward's own code, so the mask is the forward kernel's.
// The two row means are two more row sums. A warp loads R row slots (R * K
// >= 4) before it reduces any of them, so enough loads are in flight to
// cover the memory latency at small C.
// dgamma / dbeta are a deterministic two-level sum without atomics: the
// grid is capped at kBwdBlocksPerSm blocks per SM (the caller's scratch
// holds one (2, C) float32 partial per block; `bwd_max_blocks` sizes both),
// each lane keeps its columns' partial sums in registers over the
// rows its warp walks, a narrow-row warp adds its row groups' partials by a
// butterfly in a fixed order, the block adds its 8 warps' partials in warp
// order in shared memory and writes them out, and a second small kernel adds
// the blocks' partials in a fixed order. (At C >= 1024 the per-lane partials
// outgrow the registers and spill; the flagship's C is at most 512.)

template <typename Tr, int V, int K, int L, int R>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_relu_bwd_rows_kernel(const typename Tr::storage* __restrict__ x,
                                const typename Tr::storage* __restrict__ g,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                typename Tr::storage* __restrict__ dx,
                                float* __restrict__ partial,  // [gridDim.x][2][C]
                                long long rows, float eps) {
  constexpr int C = L * V * K;
  constexpr int G = 32 / L;  // rows per warp in one row slot
  __shared__ float s_part[2][C];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;
  const int grp = lane / L;

  float pg[K][V], pb[K][V];
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) pg[k][i] = pb[k][i] = 0.f;

  const long long stride = static_cast<long long>(gridDim.x) * kWarpsPerBlock * R * G;
  for (long long row0 = (static_cast<long long>(blockIdx.x) * kWarpsPerBlock + warp) * R * G;
       row0 < rows; row0 += stride) {
    float v[R][K][V], gv[R][K][V];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r * G >= rows) break;  // warp-uniform
      const long long row = row0 + r * G + grp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (row < rows) {
          const long long off = row * C + (k * L + sub) * V;
          load_vec<Tr, V>(x + off, v[r][k]);
          load_vec<Tr, V>(g + off, gv[r][k]);
        } else {  // a narrow row past the end: zeros, which add 0 to every sum
#pragma unroll
          for (int i = 0; i < V; ++i) v[r][k][i] = gv[r][k][i] = 0.f;
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (row0 + r * G >= rows) break;
      const long long row = row0 + r * G + grp;
      float mean, rstd;
      row_stats<V, K, L>(v[r], eps, mean, rstd);
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c0 = (k * L + sub) * V;
        float ga[V], be[V];
        load_vec<F32, V>(gamma + c0, ga);
        load_vec<F32, V>(beta + c0, be);
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const float xh = (v[r][k][i] - mean) * rstd;
          const float pre = xh * ga[i] + be[i];  // the forward's expression
          const float gm = pre > 0.f ? gv[r][k][i] : 0.f;
          pg[k][i] += gm * xh;
          pb[k][i] += gm;
          const float gg = gm * ga[i];
          s1 += gg;
          s2 += gg * xh;
          v[r][k][i] = xh;
          gv[r][k][i] = gg;
        }
      }
      const float mg = row_sum<L>(s1) / C;
      const float mgx = row_sum<L>(s2) / C;
      if (row < rows) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          float o[V];
#pragma unroll
          for (int i = 0; i < V; ++i) o[i] = (gv[r][k][i] - mg - v[r][k][i] * mgx) * rstd;
          store_vec<Tr, V>(dx + row * C + (k * L + sub) * V, o);
        }
      }
    }
  }

  // a narrow-row warp: add its G row groups' partials of each column (lane
  // offsets L..16, a fixed butterfly), so group 0 holds the warp's sums
#pragma unroll
  for (int o = L; o < 32; o <<= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int i = 0; i < V; ++i) {
        pg[k][i] += __shfl_xor_sync(0xffffffffu, pg[k][i], o);
        pb[k][i] += __shfl_xor_sync(0xffffffffu, pb[k][i], o);
      }

  for (int w = 0; w < kWarpsPerBlock; ++w) {  // in warp order: the same sums every run
    if (warp == w && grp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          const int c = (k * L + sub) * V + i;
          s_part[0][c] = w == 0 ? pg[k][i] : s_part[0][c] + pg[k][i];
          s_part[1][c] = w == 0 ? pb[k][i] : s_part[1][c] + pb[k][i];
        }
    }
    __syncthreads();
  }
  float* out = partial + static_cast<size_t>(blockIdx.x) * 2 * C;
  for (int j = threadIdx.x; j < 2 * C; j += kWarpsPerBlock * 32) out[j] = (&s_part[0][0])[j];
}

// out[j] = sum over p < n_parts of partial[p][j], in a fixed order: a block
// of 32 x 32 threads owns 32 columns; thread (slice, lane) sums the partials
// p = slice, slice + 32, ... of column lane in order of p, and slice 0 then
// adds the 32 slices in order. (One thread per column walking every partial
// in turn is a chain of dependent loads, ~50 us at ~1,000 partials.)
constexpr int kColSlices = 32;

__global__ void __launch_bounds__(32 * kColSlices)
layer_norm_relu_bwd_cols_kernel(const float* __restrict__ partial, int n_parts, int width,
                                float* __restrict__ out) {
  __shared__ float s_sum[kColSlices][33];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int j = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (j < width) {
#pragma unroll 4
    for (int p = slice; p < n_parts; p += kColSlices) s += partial[static_cast<size_t>(p) * width + j];
  }
  s_sum[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && j < width) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kColSlices; ++i) t += s_sum[i][lane];
    out[j] = t;
  }
}

constexpr int kBwdBlocksPerSm = 8;

// The backward's grid cap on the current device, which is also the number of
// (2, C) partials its scratch must hold.
cudaError_t bwd_max_blocks(int* blocks) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *blocks = kBwdBlocksPerSm * sms;
  return e;
}

template <typename Tr, int C>
void launch_bwd(const void* x, const void* g, const void* gamma, const void* beta, void* dx,
                void* dparams, void* partial, int max_blocks, long long rows, float eps,
                cudaStream_t stream) {
  using S = typename Tr::storage;
  using Sp = RowSplit<S, C>;
  constexpr int R = Sp::K >= 4 ? 1 : 4 / Sp::K;
  constexpr long long kRowsPerBlock = kWarpsPerBlock * R * (32 / Sp::L);
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const int blocks = static_cast<int>(want < max_blocks ? want : max_blocks);
  layer_norm_relu_bwd_rows_kernel<Tr, Sp::V, Sp::K, Sp::L, R>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(g), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<S*>(dx), static_cast<float*>(partial), rows,
      eps);
  layer_norm_relu_bwd_cols_kernel<<<(2 * C + 31) / 32, 32 * kColSlices, 0, stream>>>(
      static_cast<const float*>(partial), blocks, 2 * C, static_cast<float*>(dparams));
}

template <typename Tr>
cudaError_t dispatch_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                         void* dx, void* dparams, void* partial, int max_blocks, long long rows,
                         int C, float eps, cudaStream_t stream) {
  switch (C) {
#define ADUNET_BWD_CASE(c)                                                                    \
  case c:                                                                                     \
    launch_bwd<Tr, c>(x, g, gamma, beta, dx, dparams, partial, max_blocks, rows, eps, stream); \
    break;
    ADUNET_BWD_CASE(16)
    ADUNET_BWD_CASE(32)
    ADUNET_BWD_CASE(64)
    ADUNET_BWD_CASE(128)
    ADUNET_BWD_CASE(256)
    ADUNET_BWD_CASE(512)
    ADUNET_BWD_CASE(1024)
    ADUNET_BWD_CASE(2048)
#undef ADUNET_BWD_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace
}  // namespace adunet

// Writes to *n (an int) the number of (2, C) float32 partials that
// adunet_layer_norm_relu_backward's scratch must hold on the current device.
// Returns the CUDA error.
extern "C" int adunet_layer_norm_relu_backward_partials(void* n) {
  return adunet::bwd_max_blocks(static_cast<int*>(n));
}

// x, g (the output cotangent), dx: contiguous (rows, C) of `dtype` (0
// float32, 1 bf16); gamma, beta: float32 (C,); dparams: float32 (2, C) out,
// dgamma then dbeta; partial: float32 scratch of
// (adunet_layer_norm_relu_backward_partials(), 2, C). All pointers 16-byte
// aligned. Returns the launches' CUDA error.
extern "C" int adunet_layer_norm_relu_backward(const void* x, const void* g, const void* gamma,
                                               const void* beta, void* dx, void* dparams,
                                               void* partial, long long rows, int C, float eps,
                                               int dtype, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  int max_blocks = 0;
  const cudaError_t e = adunet::bwd_max_blocks(&max_blocks);
  if (e != cudaSuccess) return e;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adunet::kFloat32:
      return adunet::dispatch_bwd<adunet::F32>(x, g, gamma, beta, dx, dparams, partial,
                                               max_blocks, rows, C, eps, st);
    case adunet::kBFloat16:
      return adunet::dispatch_bwd<adunet::BF16>(x, g, gamma, beta, dx, dparams, partial,
                                                max_blocks, rows, C, eps, st);
    default:
      return cudaErrorInvalidValue;
  }
}

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
