// Resize of an NHWC tensor as a banded product along H, then W.
//
//   out[n, i, j, c] = sum_w Ww[j, w] * (sum_h Wh[i, h] * x[n, h, w, c])
//
// Replaces no TPU kernel: the reference's resizes are XLA einsums by dense
// (out, in) sampling-weight matrices (adunet/ops/resize.py:175), and the port
// ran them as two float32 matmuls with a cast on either side. The matrices
// are banded (2 to 4 taps a row at the models' scales), so this kernel reads
// each output index's band from two tables taken from the same float32
// matrix: where the band starts, start[i], and K weights (K the widest band,
// padded with the matrix's zeros; start[i] + K never passes the input). The
// backward is this kernel on the tables of the transposed matrices: a
// gather, with no atomics, so every call gives the same bits.
//
// Bound on an H100: bytes. A tap is one multiply-add per element against 2
// (bf16) or 4 (float32) bytes per element read or written, far below the
// card's float32 ridge, so the floor is (read x + write y) / 3.35 TB/s.
//
// Design: a block owns an output tile of kRows (4) rows x TJ columns x a
// slice of up to CG channel groups of one image; a group is 8 channels (a
// 16-byte bf16 vector, two float32 ones), or 1 where C is not a multiple of 8
// (the degradation's RGB). The block first copies the tile's input footprint
// (the rows and columns its bands reach) into shared memory, every 16-byte
// piece at once (cp.async), so a block waits on device memory once; the
// tables' reads overlap that copy. A thread keeps one group throughout.
// Phase 1 (H): for each (output row, footprint column) it sums the row's band
// of the column in float32 into shared memory. Phase 2 (W): for each output
// pixel it sums the pixel's band of that intermediate; the result is written
// once, in the output type.
// TJ adapts to the shape (kernels/resize_band.py::plan): wide enough that a
// block moves ~24 KB. Float32 vectors of a pixel lie in shared memory as two
// halves, each group's 16-byte pieces beside the next group's, so the
// 16-byte accesses of a warp meet no bank twice.
#include "common.cuh"

#include <climits>
#include <cstring>

namespace adunet {
namespace {

constexpr int kThreads = 256;
constexpr int kRows = 4;               // output rows a block owns (one accumulator each)
constexpr int kMaxSmem = 96 * 1024;    // dynamic shared memory a block may take

// What the Python wrapper computes once per shape (kernels/resize_band.py::plan),
// in this order: the input (n, h, w, c), the output (oh, ow), the band widths,
// the tile (ti = kRows rows, tj columns, cg channel groups), the largest
// footprint of a tile (fh rows, fw columns), the group width (8 or 1) and the
// types.
struct Plan {
  int n, h, w, c, oh, ow, kh, kw, ti, tj, cg, fh, fw, vec, dtype_in, dtype_out;
};

struct Args {
  const void* x;
  void* y;
  const int* h_start;     // (oh,)
  const float* h_weight;  // (oh, kh)
  const int* w_start;     // (ow,)
  const float* w_weight;  // (ow, kw)
  Plan p;
  int tiles_i, tiles_j, slices;
};

__host__ __device__ __forceinline__ int round4(int v) { return (v + 3) & ~3; }

// Shared memory, in this order: the footprint (fh x fw x cg * vec elements of
// the input type, rounded up to 16 bytes), the intermediate (kRows x fw x
// cg * vec floats, rounded up to 4), the tile's H weights (kRows x kh) and W
// weights (tj x kw), then its column and row offsets in the footprint
// (tj + kRows ints).
__host__ __device__ __forceinline__ int footprint_bytes(const Plan& p, int elem) {
  return (p.fh * p.fw * p.cg * p.vec * elem + 15) & ~15;
}

inline size_t smem_bytes(const Plan& p) {
  const int elem = p.dtype_in == kBFloat16 ? 2 : 4;
  return footprint_bytes(p, elem) +
         sizeof(float) * (round4(kRows * p.fw * p.cg * p.vec) + kRows * p.kh + p.tj * p.kw) +
         sizeof(int) * (p.tj + kRows);
}

// a / b for 0 <= a < 2^22 and 0 < b < 2^24 by a float reciprocal: the
// quotient (a + 1/2) / b lies at least 1/(2b) from an integer, and the two
// roundings move it by less (a few instructions, where an integer division
// takes some twenty).
__device__ __forceinline__ int div_small(int a, int b) {
  return __float2int_rz((static_cast<float>(a) + 0.5f) * __frcp_rn(static_cast<float>(b)));
}

// Stores 8 floats as 8 bf16 (round to nearest even, as BF16::from_f) or 8
// floats; or one element.
template <typename Tr, int G>
__device__ __forceinline__ void store_group(typename Tr::storage* p, const float (&v)[G]) {
  if constexpr (G == 1) {
    *p = Tr::from_f(v[0]);
  } else if constexpr (sizeof(typename Tr::storage) == 2) {
    uint4 u;
    unsigned* w = reinterpret_cast<unsigned*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = u;
  } else {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Group g of one pixel's slice in shared memory, which starts at `t` and
// holds cs elements: a scalar at g; 8 bf16 at g * 8; or 8 floats as two
// 16-byte halves, at g * 4 and cs / 2 + g * 4.
template <typename Tr, int G>
__device__ __forceinline__ void get_group(const typename Tr::storage* t, int g, int cs,
                                          float (&v)[G]) {
  if constexpr (G == 1) {
    v[0] = Tr::to_f(t[g]);
  } else if constexpr (sizeof(typename Tr::storage) == 2) {
    const uint4 u = *reinterpret_cast<const uint4*>(t + g * 8);
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = Tr::unpack(u, e);
  } else {
    const float4 a = *reinterpret_cast<const float4*>(t + g * 4);
    const float4 b = *reinterpret_cast<const float4*>(t + (cs >> 1) + g * 4);
    v[0] = a.x, v[1] = a.y, v[2] = a.z, v[3] = a.w;
    v[4] = b.x, v[5] = b.y, v[6] = b.z, v[7] = b.w;
  }
}

template <int G>
__device__ __forceinline__ void put_group(float* t, int g, int cs, const float (&v)[G]) {
  if constexpr (G == 1) {
    t[g] = v[0];
  } else {
    static_assert(G == 8, "a group is 1 or 8 channels");
    *reinterpret_cast<float4*>(t + g * 4) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(t + (cs >> 1) + g * 4) = make_float4(v[4], v[5], v[6], v[7]);
  }
}

// Walks items a = lane, lane + lanes, ... below rows * cols as (row, col)
// pairs, with carries in place of divisions: body(row, col).
template <typename Body>
__device__ __forceinline__ void for_items(int lane, int lanes, int rows, int cols, Body body) {
  const int drow = div_small(lanes, cols), dcol = lanes - drow * cols;
  int row = div_small(lane, cols), col = lane - row * cols;
  while (row < rows) {
    body(row, col);
    row += drow;
    col += dcol;
    if (col >= cols) col -= cols, ++row;
  }
}

// A block is cg x (kThreads / cg) threads: threadIdx.x is the channel group
// (those at or past the slice's groups idle), threadIdx.y the lane that walks
// the items. The grid is (slices x column tiles, row tiles, images), the
// images walked in turn past 65535.
template <typename Tin, typename Tout, int G>
__global__ void __launch_bounds__(kThreads, 4) resize_band_kernel(const Args a) {
  using Si = typename Tin::storage;
  using So = typename Tout::storage;
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  const int cs = p.cg * G;
  Si* fbuf = reinterpret_cast<Si*>(smem);
  float* tbuf = reinterpret_cast<float*>(smem + footprint_bytes(p, sizeof(Si)));
  float* htab = tbuf + round4(kRows * p.fw * cs);  // (kRows, kh)
  float* wtab = htab + kRows * p.kh;               // (tj, kw)
  int* woff = reinterpret_cast<int*>(wtab + p.tj * p.kw);
  int* hoff = woff + p.tj;

  const int tile_j = blockIdx.x / a.slices;
  const int slice = blockIdx.x - tile_j * a.slices;
  const int i0 = blockIdx.y * kRows, j0 = tile_j * p.tj;
  const int ni = min(kRows, p.oh - i0), nj = min(p.tj, p.ow - j0);
  const int hbase = a.h_start[i0];
  const int fh = a.h_start[i0 + ni - 1] + p.kh - hbase;
  const int wbase = a.w_start[j0];
  const int fw = a.w_start[j0 + nj - 1] + p.kw - wbase;
  const int g0 = slice * p.cg;                      // the slice's first group
  const int g = threadIdx.x, lane = threadIdx.y, lanes = blockDim.y;
  const bool live = g0 + g < p.c / G;               // a group of the tensor
  const int tid = lane * blockDim.x + g, threads = lanes * blockDim.x;

  // the tables: the tile's H and W weights, and where each band starts in
  // the footprint
  for (int t = tid; t < ni * p.kh; t += threads)
    htab[t] = a.h_weight[static_cast<size_t>(i0) * p.kh + t];
  for (int t = tid; t < ni; t += threads) hoff[t] = a.h_start[i0 + t] - hbase;
  for (int t = tid; t < nj * p.kw; t += threads)
    wtab[t] = a.w_weight[static_cast<size_t>(j0) * p.kw + t];
  for (int t = tid; t < nj; t += threads) woff[t] = a.w_start[j0 + t] - wbase;

  for (int n = blockIdx.z; n < p.n; n += gridDim.z) {
    const Si* x = static_cast<const Si*>(a.x) + (static_cast<size_t>(n) * p.h + hbase) * p.w * p.c +
                  static_cast<size_t>(wbase) * p.c + static_cast<size_t>(g0 + g) * G;
    // the footprint, every piece in flight at once: group g of each pixel
    // (float32's two 16-byte halves apart, at 0 and cs / 2)
    if (live) {
      for_items(lane, lanes, fh, fw, [&](int r, int col) {
        const Si* src = x + (static_cast<size_t>(r) * p.w + col) * p.c;
        Si* dst = fbuf + (r * fw + col) * cs;
        if constexpr (G == 8) {
          if constexpr (sizeof(Si) == 2) {
            cp_async16(dst + g * 8, src);
          } else {
            cp_async16(dst + g * 4, src);
            cp_async16(dst + (cs >> 1) + g * 4, src + 4);
          }
        } else if constexpr (sizeof(Si) == 4) {
          cp_async4(dst + g, src);
        } else {
          dst[g] = *src;
        }
      });
    }
    cp_async_wait_all();
    __syncthreads();

    // phase 1: item (output row q, footprint column col): the row's band of it
    if (live) {
      for_items(lane, lanes, ni, fw, [&](int q, int col) {
        const Si* src = fbuf + (hoff[q] * fw + col) * cs;
        const float* wq = htab + q * p.kh;
        float acc[G];
#pragma unroll
        for (int e = 0; e < G; ++e) acc[e] = 0.f;
#pragma unroll 4
        for (int k = 0; k < p.kh; ++k, src += fw * cs) {
          const float wk = wq[k];
          float v[G];
          get_group<Tin, G>(src, g, cs, v);
#pragma unroll
          for (int e = 0; e < G; ++e) acc[e] = fmaf(wk, v[e], acc[e]);
        }
        put_group<G>(tbuf + (q * fw + col) * cs, g, cs, acc);
      });
    }
    __syncthreads();

    // phase 2: item (output row i, output column j): the column's band of the row
    if (live) {
      So* y = static_cast<So*>(a.y) + ((static_cast<size_t>(n) * p.oh + i0) * p.ow + j0) * p.c +
              static_cast<size_t>(g0 + g) * G;
      for_items(lane, lanes, ni, nj, [&](int i, int j) {
        const float* src = tbuf + (i * fw + woff[j]) * cs;
        const float* wj = wtab + j * p.kw;
        float out[G];
#pragma unroll
        for (int e = 0; e < G; ++e) out[e] = 0.f;
#pragma unroll 4
        for (int k = 0; k < p.kw; ++k) {
          const float wk = wj[k];
          float v[G];
          get_group<F32, G>(src + k * cs, g, cs, v);
#pragma unroll
          for (int e = 0; e < G; ++e) out[e] = fmaf(wk, v[e], out[e]);
        }
        store_group<Tout, G>(y + (static_cast<size_t>(i) * p.ow + j) * p.c, out);
      });
    }
    if (n + gridDim.z < p.n) __syncthreads();  // the next image's footprint reuses the buffers
  }
}

// The kernel for `p`'s types and group width, its dynamic shared-memory
// limit raised to kMaxSmem and its carveout to the most shared memory, once
// per device.
template <typename Tin, typename Tout, int G>
cudaError_t kernel_for(void (**kernel)(const Args)) {
  static bool done[kMaxDevices] = {};
  *kernel = resize_band_kernel<Tin, Tout, G>;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (done[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(*kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  done[dev] = e == cudaSuccess;
  return e;
}

template <typename Tin>
cudaError_t kernel_of(const Plan& p, void (**kernel)(const Args)) {
  const bool out_bf16 = p.dtype_out == kBFloat16;
  if (p.vec == 8)
    return out_bf16 ? kernel_for<Tin, BF16, 8>(kernel) : kernel_for<Tin, F32, 8>(kernel);
  return out_bf16 ? kernel_for<Tin, BF16, 1>(kernel) : kernel_for<Tin, F32, 1>(kernel);
}

cudaError_t kernel_of(const Plan& p, void (**kernel)(const Args)) {
  if ((p.dtype_in != kBFloat16 && p.dtype_in != kFloat32) ||
      (p.dtype_out != kBFloat16 && p.dtype_out != kFloat32))
    return cudaErrorInvalidValue;
  return p.dtype_in == kBFloat16 ? kernel_of<BF16>(p, kernel) : kernel_of<F32>(p, kernel);
}

bool valid(const Plan& p) {
  return p.n > 0 && p.h > 0 && p.w > 0 && p.c > 0 && p.oh > 0 && p.ow > 0 && p.kh > 0 &&
         p.kw > 0 && p.ti == kRows && p.tj > 0 && p.cg > 0 && p.cg <= kThreads && p.fh > 0 &&
         p.fw > 0 && (p.vec == 1 || p.vec == 8) && p.c % p.vec == 0 &&
         smem_bytes(p) <= static_cast<size_t>(kMaxSmem);
}

}  // namespace
}  // namespace adunet

// x: contiguous (n, h, w, c) of `plan`'s dtype_in (0 float32, 1 bf16); y:
// contiguous (n, oh, ow, c) of dtype_out; h_start (oh,) int32 and h_weight
// (oh, kh) float32, w_start (ow,) and w_weight (ow, kw) likewise: the bands'
// tables, starts nondecreasing, start + k within the input. plan: the 16 ints
// of `Plan`, on the host. With vec == 8, c % 8 == 0 and x, y 16-byte aligned.
// All device pointers on CUDA device `device`, which the call makes current
// if it is not. One launch on `stream`; past a device's first call it asks
// the runtime for nothing else, so a CUDA graph may capture it. Returns the
// launch's CUDA error.
extern "C" int adunet_resize_band(const void* x, void* y, const void* h_start, const void* h_weight,
                                  const void* w_start, const void* w_weight, const void* plan,
                                  int device, void* stream) {
  adunet::Args a{x, y, static_cast<const int*>(h_start), static_cast<const float*>(h_weight),
                 static_cast<const int*>(w_start), static_cast<const float*>(w_weight), {}, 0, 0,
                 0};
  std::memcpy(&a.p, plan, sizeof(a.p));
  const adunet::Plan& p = a.p;
  if (!adunet::valid(p)) return cudaErrorInvalidValue;
  a.tiles_i = (p.oh + p.ti - 1) / p.ti;
  a.tiles_j = (p.ow + p.tj - 1) / p.tj;
  a.slices = (p.c / p.vec + p.cg - 1) / p.cg;
  const long long columns = static_cast<long long>(a.tiles_j) * a.slices;
  if (columns > INT_MAX || a.tiles_i > 65535) return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  void (*kernel)(const adunet::Args) = nullptr;
  const cudaError_t e = adunet::kernel_of(p, &kernel);
  if (e != cudaSuccess) return e;
  const dim3 grid(static_cast<unsigned>(columns), a.tiles_i, p.n < 65535 ? p.n : 65535);
  kernel<<<grid, dim3(p.cg, adunet::kThreads / p.cg), adunet::smem_bytes(p),
           static_cast<cudaStream_t>(stream)>>>(a);
  return cudaGetLastError();
}

