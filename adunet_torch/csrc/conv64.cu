// K2: 3x3 stride-1 SAME convolution plus bias, NHWC, C_in = C_out = 64.
//
// Replaces the Pallas TPU kernel adunet/kernels/conv64.py:132
// `conv3x3_same_pallas` (pl.pallas_call at :154, body `_kernel` at :67).
// Same function: zero outside the image, float32 accumulation of the 9 taps,
// bias added, output in the input type (float32 or bf16).
//
// Halo-row mode (`halo` = 1): the input holds H + 2 rows, the output H, and
// the conv is SAME in W and VALID in H. Under a space mesh (the image height
// split over processes, adunet_torch/parallel/spatial.py) the top and bottom
// input rows are the neighbours' edge rows, or zeros at the image's border,
// so the H rows computed are the whole image's rows of this shard. Only the
// input's row origin and row count change: the f32 kernel stages rows
// y0 + r (not y0 + r - 1) of the H + 2, and the bf16 kernel's tensor map
// spans H + 2 rows with its tile origin one row lower.
//
// Bound on an H100: 2*9*64*64 = 73,728 FLOP per output pixel against
// 2*64*sizeof(T) bytes (x read once, y written once). float32 (full-precision
// FMAs, no TF32, so the serving path computes what the CPU oracle computes):
// operations, FLOP / 67 TFLOP/s. bf16: the tensor cores' 989 TFLOP/s, where
// bytes / 3.35 TB/s and operations tie (0.16 ms at 32 x 256 x 256).
//
// Two kernels, one per type:
//
// float32, `conv3x3_c64_kernel` (a direct implicit GEMM on CUDA cores): a
// block computes a 2-row x 128-column x 64-channel output tile. Per pass it
// stages 8 input channels of the tile plus its 1-pixel halo in shared
// memory, transposed to [channel][row][column] and zero outside the image,
// with the 9 taps' weights for those channels. Each of the 256 threads owns
// 8 consecutive pixels x 8 output channels (64 float32 accumulators in
// registers): for one (channel, tap row) it reads 10 staged pixels once and
// reuses them for the three column taps, so each shared-memory load feeds
// ~20 FMAs. The thread's channels are {4g..4g+3} and {32+4g..32+4g+3}, which
// keeps the weight loads of a warp free of bank conflicts.
//
// bf16, `conv3x3_c64_wgmma_kernel` (an implicit GEMM on the tensor cores):
// a persistent grid, one block per SM, walks 4-row x 64-column output tiles.
// - Input by TMA: one 4-D tensor-map box {64 ch, 66 cols, 6 rows, 1 image}
//   from (0, x0-1, y0-1, b) brings the tile and its halo; the copy engine
//   fills the out-of-image part (negative coordinates included) with zeros,
//   so SAME padding costs nothing. A row of 64 bf16 is 128 bytes, staged
//   with the 128-byte swizzle. Two stages on mbarriers: the next tile's load
//   runs under this tile's math. Each input pixel is read from device memory
//   once per tile (the halo, 1.55x the tile, mostly from L2).
// - Weights: the 9 taps' (64 co x 64 ci) bf16 matrices, 72 KB, copied to
//   shared memory once per block, already in the 128B-swizzled K-major
//   layout that wgmma's B descriptor reads (packed on the card, below).
// - A from registers: the tap (dy, dx) shifts the staged tile by whole
//   pixels, which breaks the swizzle phase an A descriptor needs, so each
//   lane computes its own swizzled row address and `ldmatrix` loads the
//   m16n8k16 A fragments that `wgmma.mma_async ... m64n64k16` takes from
//   registers. Two warpgroups each own 2 x 64 output pixels: 9 taps x 4
//   K=16 steps x 2 = 72 wgmma per tile, float32 accumulators in registers.
//   The next tap's fragments load while this tap's 8 wgmma run.
// - Epilogue: bias added in float32, rounded to bf16 (nearest-even),
//   staged through a swizzled shared buffer, stored 16 bytes per lane in
//   contiguous rows.
//
// The backward (the reference's custom VJP `_bwd`, adunet/kernels/conv64.py
// :203-227, which runs as XLA convolutions there) is three more passes,
// launched by one C call, `adunet_conv3x3_c64_backward`:
// - dx is the correlation of the cotangent g with the spatially flipped,
//   io-swapped kernel: the pack in flip mode (tap 8 - t, ci and co swapped,
//   no bias), then the forward kernel of x's type run on g. In the halo-row
//   mode dx covers all H + 2 input rows: a full correlation in H, so the
//   input row origin is a signed offset (-1 SAME, 0 the halo forward, -2
//   the halo dx) and the bf16 kernel's last 4-row tile can be ragged (H + 2
//   is 2 mod 4), its stores guarded by row.
// - dw[ky][kx][ci][co] = sum over b, y, x of x[b][y + ky + row_off][x + kx -
//   1][ci] * g[b][y][x][co], and db[co] = sum of g: a persistent grid over
//   cotangent tiles, `conv3x3_c64_wgrad_wgmma_kernel` (bf16, tensor cores)
//   or `conv3x3_c64_wgrad_kernel` (float32, CUDA cores, no TF32). Each
//   block keeps all 9 x 64 x 64 dw sums of its tiles in registers (three
//   warpgroups of three taps each), sums db from the g tiles it already
//   holds, and writes one float32 partial row; the split over tiles is fixed
//   by the shape and the SM count.
// - `conv3x3_c64_wgrad_reduce_kernel` sums the partial rows in a fixed order
//   (`column_sum`, common.cuh) and rounds dw to x's type, then to w's, and
//   db to x's type, then to the bias's, as the reference's `_bwd` rounds
//   them to the compute type and a cast's backward widens them. No atomics:
//   two calls give the same bits.
// Bound of the backward on an H100: dx reads g and writes dx (bytes and
// bf16 operations tie, as for the forward); dw + db read x and g once, and
// do 2 * 9 * 64 * 64 FLOP per cotangent pixel: in bf16 ~0.32 ms in all at 32
// x 256 x 256 x 64, in float32 operations at 67 TFLOP/s.
//
// The weight pack, `pack_conv3x3_weights_kernel`: a call hands over the
// weights and bias as the model holds them (OIHW, float32 or bf16; the bias
// float32, bf16 or absent), and one small kernel on the same stream, just
// before the conv, rounds them to the input type and lays them out as that
// type's conv kernel reads them, into scratch the wrapper allocates. So a
// launch is one C call with no host-side pack or cast, and packs exactly the
// weights it is given (nothing cached to keep in step with the parameters,
// and a CUDA graph that captures the call packs the live weights on replay).
#include <cuda.h>  // CUtensorMap and its enums; the encoder comes from libcuda at run time
#include <stdint.h>

#include <type_traits>

#include "common.cuh"

namespace adunet {
namespace {

constexpr int kC = 64;            // input and output channels

// ---------------------------------------------------------------- weight pack
constexpr int kPackElems = 9 * kC * kC;  // the packed weights; the 64 bias values follow
constexpr int kPackThreads = 256;

template <typename Tr>
__device__ __forceinline__ float load_param(const void* p, int i) {
  return Tr::to_f(static_cast<const typename Tr::storage*>(p)[i]);
}

// One thread per packed element: OIHW weights of type Tw -> the layout of the
// conv kernel for input type Tx, each value rounded to Tx (nearest even, as
// torch's cast rounds), i.e. `pack_weights` (float32: [tap][ci][co]) or
// `pack_weights_bf16` (bf16: [tap][co][ci], the 16-byte chunk j of row co
// holding the input channels of chunk j ^ (co % 8)). The first 64 threads
// also write the bias, rounded to Tx and widened to float32 (zeros without
// one), after the weights. `flip` packs the kernel of the backward's dx
// (`pack_weights_flipped*`): packed tap t, input channel ci, output channel
// co read the weight's tap 8 - t, output channel ci, input channel co.
template <typename Tx, typename Tw, typename Tb>
__global__ void __launch_bounds__(kPackThreads)
pack_conv3x3_weights_kernel(const void* __restrict__ w, const void* __restrict__ bias,
                            typename Tx::storage* __restrict__ wp, float* __restrict__ bp,
                            int flip) {
  const int i = blockIdx.x * kPackThreads + threadIdx.x;
  if (i < kPackElems) {
    const int t = i / (kC * kC);  // tap 3*dy + dx
    const int r = i - t * (kC * kC);
    int ci, co;
    if constexpr (std::is_same<Tx, BF16>::value) {
      co = r >> 6;
      ci = ((((r >> 3) & 7) ^ (co & 7)) << 3) | (r & 7);
    } else {
      ci = r >> 6;
      co = r & (kC - 1);
    }
    wp[i] = Tx::from_f(load_param<Tw>(w, flip ? (ci * kC + co) * 9 + 8 - t : (co * kC + ci) * 9 + t));
  }
  if (i < kC) bp[i] = bias == nullptr ? 0.f : Tx::to_f(Tx::from_f(load_param<Tb>(bias, i)));
}

template <typename Tx, typename Tw>
cudaError_t launch_pack_w(const void* w, const void* bias, int bias_dtype, void* packed, int flip,
                          cudaStream_t stream) {
  auto* wp = static_cast<typename Tx::storage*>(packed);
  float* bp = reinterpret_cast<float*>(wp + kPackElems);
  constexpr int blocks = (kPackElems + kPackThreads - 1) / kPackThreads;
  if (bias_dtype == kBFloat16)
    pack_conv3x3_weights_kernel<Tx, Tw, BF16><<<blocks, kPackThreads, 0, stream>>>(w, bias, wp, bp,
                                                                                  flip);
  else
    pack_conv3x3_weights_kernel<Tx, Tw, F32><<<blocks, kPackThreads, 0, stream>>>(
        w, bias_dtype == kFloat32 ? bias : nullptr, wp, bp, flip);
  return cudaGetLastError();
}

template <typename Tx>
cudaError_t launch_pack(const void* w, int w_dtype, const void* bias, int bias_dtype,
                        void* packed, int flip, cudaStream_t stream) {
  return w_dtype == kBFloat16 ? launch_pack_w<Tx, BF16>(w, bias, bias_dtype, packed, flip, stream)
                              : launch_pack_w<Tx, F32>(w, bias, bias_dtype, packed, flip, stream);
}

// Raises `kernel`'s dynamic shared-memory limit to `bytes`, once per device
// (`done` is the kernel's own record).
template <typename Kernel>
cudaError_t smem_limit_once(Kernel kernel, int bytes, int dev, bool (&done)[kMaxDevices]) {
  if (done[dev]) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             bytes);
  done[dev] = e == cudaSuccess;
  return e;
}

// ---------------------------------------------------------------- float32
constexpr int kTH = 2;            // output rows per block
constexpr int kTW = 128;          // output columns per block
constexpr int kCK = 8;            // input channels staged per pass
constexpr int kRow = kTW + 4;     // staged row; index p holds column x0 + p - 1
constexpr int kThreads = 256;
static_assert((kTH * kTW / 8) * 8 == kThreads, "one thread per 8-pixel x 8-channel tile");

// Output row r reads input rows r + dy + row_off, dy = 0..2 (zero outside
// the Hin rows): row_off -1 is SAME, 0 the halo forward, -2 the halo dx.
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_c64_kernel(const float* __restrict__ x,
                   const float* __restrict__ w,     // [9][64 ci][64 co], tap = 3*dy + dx
                   const float* __restrict__ bias,  // [64]
                   float* __restrict__ y, int H, int Hin, int W, int row_off) {
  __shared__ __align__(16) float s_in[kCK][kTH + 2][kRow];
  __shared__ __align__(16) float s_w[9][kCK][kC];

  const int tid = threadIdx.x;
  const int g = tid & 7;
  const int pg = tid >> 3;
  const int ty = pg / (kTW / 8);
  const int tx = pg % (kTW / 8);
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t img_in = static_cast<size_t>(blockIdx.z) * Hin * W * kC;
  const size_t img_out = static_cast<size_t>(blockIdx.z) * H * W * kC;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < kC; c0 += kCK) {
    for (int pos = tid; pos < (kTH + 2) * (kTW + 2); pos += kThreads) {
      const int r = pos / (kTW + 2);
      const int p = pos - r * (kTW + 2);
      const int yy = y0 + r + row_off;
      const int xx = x0 + p - 1;
      float v[kCK];
      if (yy >= 0 && yy < Hin && xx >= 0 && xx < W) {
        load_vec<F32, kCK>(x + img_in + (static_cast<size_t>(yy) * W + xx) * kC + c0, v);
      } else {
#pragma unroll
        for (int c = 0; c < kCK; ++c) v[c] = 0.f;
      }
#pragma unroll
      for (int c = 0; c < kCK; ++c) s_in[c][r][p] = v[c];
    }
    for (int i = tid; i < 9 * kCK * (kC / 4); i += kThreads) {
      const int t = i / (kCK * (kC / 4));
      const int rem = i - t * (kCK * (kC / 4));
      const int ci = rem / (kC / 4);
      const int q = rem - ci * (kC / 4);
      reinterpret_cast<float4*>(&s_w[t][ci][0])[q] =
          reinterpret_cast<const float4*>(w + (static_cast<size_t>(t) * kC + c0 + ci) * kC)[q];
    }
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kCK; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = &s_in[c][ty + dy][8 * tx];
        const float4 a0 = *reinterpret_cast<const float4*>(row);
        const float4 a1 = *reinterpret_cast<const float4*>(row + 4);
        const float2 a2 = *reinterpret_cast<const float2*>(row + 8);
        const float a[10] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = &s_w[dy * 3 + dx][c][0];
          const float4 b0 = *reinterpret_cast<const float4*>(wr + 4 * g);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + 32 + 4 * g);
          const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i + dx], b[j], acc[i][j]);
        }
      }
    }
    __syncthreads();
  }

  float blo[4], bhi[4];
  load_vec<F32, 4>(bias + 4 * g, blo);
  load_vec<F32, 4>(bias + 32 + 4 * g, bhi);
  const int yy = y0 + ty;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int xx = x0 + 8 * tx + i;
    float* out = y + img_out + (static_cast<size_t>(yy) * W + xx) * kC;
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = acc[i][j] + blo[j];
      hi[j] = acc[i][4 + j] + bhi[j];
    }
    store_vec<F32, 4>(out + 4 * g, lo);
    store_vec<F32, 4>(out + 32 + 4 * g, hi);
  }
}

// y: (B, H, W, 64) from x: (B, Hin, W, 64), input row origin `row_off`.
cudaError_t launch_f32(const void* x, const void* w, const void* bias, void* y, int B, int H,
                       int Hin, int W, int row_off, cudaStream_t stream) {
  if (H % kTH != 0 || W % kTW != 0) return cudaErrorInvalidValue;
  const dim3 grid(W / kTW, H / kTH, B);
  conv3x3_c64_kernel<<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<float*>(y), H, Hin, W, row_off);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- float32 dw + db
// `conv3x3_c64_wgrad_kernel`: a persistent grid, one block per SM, walks
// 2-row x 64-column cotangent tiles. Per tile it stages the g tile and the
// x rows and columns its taps read (4 x 66 pixels, zero outside the image)
// in shared memory as float32 [pixel][channel]. The 384 threads are three
// groups of 128, group dy owning taps (dy, 0..2); a thread owns 8 input x 4
// output channels of its three taps (96 float32 sums in registers, kept
// over all its block's tiles). Along a row of 64 pixels it slides a window
// of three x pixels: per pixel one 8-channel x load, one 4-channel g load
// and 96 FMAs. Threads 0..63 also sum their column of each g tile (db). At
// the end each block writes its partial row: [tap][ci][co] dw, then db.
namespace wg32 {
constexpr int kRows = 2;                                 // cotangent rows per tile
constexpr int kCols = 64;                                // cotangent columns per tile
constexpr int kXRows = kRows + 2;                        // staged x rows and columns
constexpr int kXCols = kCols + 2;
constexpr int kThreads = 384;
constexpr int kSmemBytes = (kXRows * kXCols + kRows * kCols) * kC * 4;  // 100,352
}  // namespace wg32

constexpr int kPartial = 9 * kC * kC + kC;  // floats of one block's partial row: dw, then db

__device__ __forceinline__ void lds8(const float* p, float (&v)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__global__ void __launch_bounds__(wg32::kThreads, 1)
conv3x3_c64_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                         float* __restrict__ partial, int H, int Hx, int W, int row_off,
                         int n_tiles, int need_dw) {
  extern __shared__ float4 smem_f4[];
  float* s_x = reinterpret_cast<float*>(smem_f4);        // [kXRows][kXCols][64]
  float* s_g = s_x + wg32::kXRows * wg32::kXCols * kC;  // [kRows][kCols][64]
  const int tid = threadIdx.x;
  const int dy = tid >> 7;
  const int ci0 = 8 * ((tid & 127) >> 4);
  const int co0 = 4 * (tid & 15);
  const int tiles_x = W / wg32::kCols;
  const int per_img = tiles_x * (H / wg32::kRows);

  float acc[3][8][4];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[t][i][j] = 0.f;
  float db = 0.f;

  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int b = tile / per_img;
    const int r = tile - b * per_img;
    const int y0 = (r / tiles_x) * wg32::kRows;
    const int x0 = (r % tiles_x) * wg32::kCols;
    if (need_dw) {
      for (int i = tid; i < wg32::kXRows * wg32::kXCols * (kC / 4); i += wg32::kThreads) {
        const int pix = i / (kC / 4);
        const int rr = pix / wg32::kXCols;
        const int yy = y0 + rr + row_off;
        const int xx = x0 + pix - rr * wg32::kXCols - 1;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (yy >= 0 && yy < Hx && xx >= 0 && xx < W)
          v = reinterpret_cast<const float4*>(
              x + ((static_cast<size_t>(b) * Hx + yy) * W + xx) * kC)[i % (kC / 4)];
        smem_f4[i] = v;
      }
    }
    for (int i = tid; i < wg32::kRows * wg32::kCols * (kC / 4); i += wg32::kThreads) {
      const int pix = i / (kC / 4);
      const int rr = pix / wg32::kCols;
      reinterpret_cast<float4*>(s_g)[i] = reinterpret_cast<const float4*>(
          g + ((static_cast<size_t>(b) * H + y0 + rr) * W + x0 + pix - rr * wg32::kCols) * kC)[i % (kC / 4)];
    }
    __syncthreads();

    if (need_dw) {
#pragma unroll 1
      for (int rr = 0; rr < wg32::kRows; ++rr) {
        const float* xr = s_x + (rr + dy) * wg32::kXCols * kC + ci0;  // staged column c: x0 + c - 1
        const float* gr = s_g + rr * wg32::kCols * kC + co0;
        float xa[8], xb[8];
        lds8(xr, xa);
        lds8(xr + kC, xb);
#pragma unroll 2
        for (int c = 0; c < wg32::kCols; ++c) {
          float xc[8];
          lds8(xr + (c + 2) * kC, xc);
          const float4 gv = *reinterpret_cast<const float4*>(gr + c * kC);
          const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              acc[0][i][j] = fmaf(xa[i], gg[j], acc[0][i][j]);
              acc[1][i][j] = fmaf(xb[i], gg[j], acc[1][i][j]);
              acc[2][i][j] = fmaf(xc[i], gg[j], acc[2][i][j]);
            }
#pragma unroll
          for (int i = 0; i < 8; ++i) {
            xa[i] = xb[i];
            xb[i] = xc[i];
          }
        }
      }
    }
    if (tid < kC) {
#pragma unroll 8
      for (int p = 0; p < wg32::kRows * wg32::kCols; ++p) db += s_g[p * kC + tid];
    }
    __syncthreads();
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * kPartial;
  if (need_dw) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        *reinterpret_cast<float4*>(out + ((3 * dy + t) * kC + ci0 + i) * kC + co0) =
            make_float4(acc[t][i][0], acc[t][i][1], acc[t][i][2], acc[t][i][3]);
  }
  if (tid < kC) out[9 * kC * kC + tid] = db;
}

cudaError_t launch_wgrad_f32(const void* x, const void* g, float* partial, int B, int H, int Hx,
                             int W, int row_off, int need_dw, cudaStream_t stream) {
  if (H % wg32::kRows != 0 || W % wg32::kCols != 0) return cudaErrorInvalidValue;
  static bool smem_set[kMaxDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t e = device_sms(&dev, &sms);
  if (e == cudaSuccess) e = smem_limit_once(conv3x3_c64_wgrad_kernel, wg32::kSmemBytes, dev, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = B * (H / wg32::kRows) * (W / wg32::kCols);
  const int grid = n_tiles < sms ? n_tiles : sms;
  conv3x3_c64_wgrad_kernel<<<grid, wg32::kThreads, wg32::kSmemBytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(g), partial, H, Hx, W, row_off,
      n_tiles, need_dw);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bf16
namespace tc {

constexpr int kTH = 4;                                   // output rows per tile
constexpr int kTW = 64;                                  // output columns per tile
constexpr int kBoxW = kTW + 2;                           // staged columns (halo included)
constexpr int kBoxH = kTH + 2;                           // staged rows
constexpr int kPixBytes = kC * 2;                        // one staged pixel: 128 bytes
constexpr int kBoxBytes = kBoxW * kBoxH * kPixBytes;     // 50,688
constexpr int kStageBytes = (kBoxBytes + 1023) / 1024 * 1024;
constexpr int kStages = 2;
constexpr int kTapBytes = kC * kC * 2;                   // one tap's 64 x 64 bf16
constexpr int kWBytes = 9 * kTapBytes;                   // 73,728
constexpr int kThreads = 256;                            // two warpgroups
constexpr int kOutBytes = kTH * kTW * kPixBytes;         // the tile's bf16 output
constexpr int kSmemBytes = 1024 + kWBytes + kStages * kStageBytes + kOutBytes + kC * 4 + kStages * 8;
static_assert(kSmemBytes <= 232448, "more shared memory than a Hopper block may use");
// dw + db: a stage holds the x box above, then the 4 x 64-pixel g tile
constexpr int kGBoxBytes = kTH * kTW * kPixBytes;        // 32,768
constexpr int kWgStageBytes = kStageBytes + kGBoxBytes;
constexpr int kWgThreads = 384;                          // three warpgroups
constexpr int kDbGroups = 8;                             // db: pixel groups of warpgroups 0-1
constexpr int kWgSmemBytes = 1024 + kStages * kWgStageBytes + kDbGroups * kC * 4 + kStages * 8;
static_assert(kWgSmemBytes <= 232448, "more shared memory than a Hopper block may use");
static_assert(kTH == 2 * (kThreads / 128) && kTW == 64, "each warpgroup owns two 64-pixel rows");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// wgmma shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (the leading offset is unused in this layout).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an MN-major operand (wgmma's transpose bit): 64 N values of a
// K row are 128 contiguous bytes, 8 K rows a 1024-byte swizzle atom, K
// groups of 8 rows 1024 bytes apart. The stride between 8-row groups and
// the one between 64-value N blocks (unused at N = 64) are both 1024 bytes.
__device__ __forceinline__ uint64_t make_desc_mn(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma's issue and wait.
__device__ __forceinline__ void fence_operands(float (&d)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// D (64 x 64, float32, in registers) += A (64 x 16 bf16, registers) x B (16 x 64 bf16, smem)
__device__ __forceinline__ void wgmma_m64n64k16(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 64, float32) += A (64 x 16 bf16, registers) x B (16 x 64 bf16,
// smem, MN-major: `make_desc_mn`)
__device__ __forceinline__ void wgmma_m64n64k16_tb(float (&d)[32], const uint32_t (&a)[4],
                                                   uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// The A fragments of one tap for this lane: two 64-pixel rows x 4 K=16 steps.
// Lane l addresses pixel column 16*warp + (l & 15) and 16-byte chunk
// 2*ks + (l >> 4) of the staged pixel the tap reads; the swizzle XORs the
// chunk with the staged pixel's index mod 8 (its 128-byte row mod 8).
__device__ __forceinline__ void load_tap(uint32_t (&a)[2][4][4], uint32_t in_base, int row0,
                                         int col, int hi, int tap) {
  const int dy = tap / 3, dx = tap % 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int p = (row0 + mt + dy) * kBoxW + col + dx;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      const uint32_t chunk = static_cast<uint32_t>((2 * ks + hi) ^ (p & 7));
      ldmatrix_x4(in_base + p * kPixBytes + (chunk << 4), a[mt][ks]);
    }
  }
}

// Output row r reads input rows r + dy + row_off (as the float32 kernel);
// the last tile row may hold fewer than kTH output rows (H % kTH != 0: the
// halo-row mode's dx), whose missing rows are computed and not stored.
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_c64_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                         const uint4* __restrict__ wpk,     // pack_weights_bf16, 72 KB
                         const float* __restrict__ bias,    // [64]
                         unsigned short* __restrict__ y, int H, int W, int row_off,
                         int n_tiles) {
  extern __shared__ unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the buffers to it
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* s_w = smem;
  unsigned char* s_in = s_w + kWBytes;
  unsigned char* s_out = s_in + kStages * kStageBytes;
  float* s_bias = reinterpret_cast<float*>(s_out + kOutBytes);
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_bias + kC);

  const int tid = threadIdx.x;
  const int tiles_x = W / kTW;
  const int per_img = tiles_x * ((H + kTH - 1) / kTH);

  auto issue = [&](int stage, int tile) {
    const int b = tile / per_img;
    const int r = tile - b * per_img;
    const int ty = r / tiles_x;
    const int tx = r - ty * tiles_x;
    const uint32_t bar = smem_u32(&s_bar[stage]);
    mbar_expect_tx(bar, kBoxBytes);
    // tile row ty's input rows start at its first output row + row_off
    tma_load_4d(smem_u32(s_in + stage * kStageBytes), &xmap, bar, 0, tx * kTW - 1,
                ty * kTH + row_off, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&s_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < n_tiles) issue(s, t);
    }
  }
  for (int i = tid; i < kWBytes / 16; i += kThreads) reinterpret_cast<uint4*>(s_w)[i] = wpk[i];
  if (tid < kC) s_bias[tid] = bias[tid];
  // the weights were written by ordinary stores; wgmma reads them through the async proxy
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();

  const int wg = tid >> 7;            // this warpgroup's output rows: 2*wg, 2*wg + 1
  const int warp = (tid >> 5) & 3;    // its 16 pixels of each 64-pixel row
  const int lane = tid & 31;
  const int a_col = 16 * warp + (lane & 15);
  const int a_hi = lane >> 4;
  const uint64_t desc_w = make_desc(smem_u32(s_w));
  unsigned char* out_buf = s_out + wg * (kOutBytes / 2);

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int stage = it % kStages;
    mbar_wait(smem_u32(&s_bar[stage]), (it / kStages) & 1);
    const uint32_t in_base = smem_u32(s_in + stage * kStageBytes);

    float acc[2][32];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[mt][i] = 0.f;
    uint32_t a[2][2][4][4];
    load_tap(a[0], in_base, 2 * wg, a_col, a_hi, 0);
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      fence_operands(acc[0]);
      fence_operands(acc[1]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks)
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
          wgmma_m64n64k16(acc[mt], a[tap & 1][mt][ks],
                          desc_w + static_cast<uint64_t>((tap * kTapBytes + ks * 32) >> 4));
      wgmma_commit();
      if (tap < 8) {
        wgmma_wait<1>();  // the previous tap's wgmma no longer read a[(tap + 1) & 1]
        load_tap(a[(tap + 1) & 1], in_base, 2 * wg, a_col, a_hi, tap + 1);
      }
    }
    wgmma_wait<0>();
    fence_operands(acc[0]);
    fence_operands(acc[1]);

    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && tile + kStages * static_cast<int>(gridDim.x) < n_tiles)
      issue(stage, tile + kStages * gridDim.x);

    // epilogue: bias, bf16, through the swizzled staging buffer
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = mt * 64 + 16 * warp + (lane >> 2) + 8 * h;
          const int col = 8 * j + 2 * (lane & 3);
          const unsigned lo = BF16::from_f(acc[mt][4 * j + 2 * h] + s_bias[col]);
          const unsigned hi = BF16::from_f(acc[mt][4 * j + 2 * h + 1] + s_bias[col + 1]);
          *reinterpret_cast<uint32_t*>(out_buf + m * kPixBytes + ((j ^ (m & 7)) << 4) +
                                       4 * (lane & 3)) = lo | (hi << 16);
        }
    bar_sync(1 + wg, 128);
    const int b = tile / per_img;
    const int r = tile - b * per_img;
    const int y0 = (r / tiles_x) * kTH + 2 * wg;
    const int x0 = (r % tiles_x) * kTW;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int q = i * 128 + (tid & 127);
      const int m = q >> 3;
      const int c = q & 7;
      if (y0 + (m >> 6) >= H) continue;  // past the last row of a ragged tile
      const uint4 v = *reinterpret_cast<const uint4*>(out_buf + m * kPixBytes + ((c ^ (m & 7)) << 4));
      const size_t pix = (static_cast<size_t>(b) * H + y0 + (m >> 6)) * W + x0 + (m & 63);
      *reinterpret_cast<uint4*>(y + pix * kC + c * 8) = v;
    }
  }
}

// `conv3x3_c64_wgrad_wgmma_kernel`: dw + db on the tensor cores. A
// persistent grid, one block per SM, walks 4-row x 64-column cotangent
// tiles; per tile one TMA pair brings the g tile (4 x 64 pixels) and the x
// rows and columns its taps read (the forward's 6 x 66 box, zero-filled
// outside the image), two stages on mbarriers. Per tap the tile is a GEMM
// dw_t (64 ci x 64 co) += x_t^T (64 ci x 256 pixels) g (256 pixels x 64
// co), in 16 K-steps of 16 pixels:
// - B = g, unshifted, read by wgmma from shared memory through an MN-major
//   descriptor (its transpose bit): a staged pixel is a K row of 64 output
//   channels, 128 bytes, as TMA's 128-byte swizzle lays it.
// - A = x_t^T, shifted by the tap by whole pixels, which breaks the swizzle
//   phase a descriptor needs: each lane addresses its staged pixel and
//   channel chunk itself and `ldmatrix.trans` turns the [pixel][channel]
//   rows into the A fragments (warp w: input channels 16w..16w+15).
// Warpgroup dy owns taps (dy, 0..2): three 64 x 64 float32 accumulators a
// thread (96 registers), kept over all the block's tiles; the three taps'
// fragments for the next K-step load while this step's wgmma run. Warpgroups
// 0-1 also sum the g tile's columns (db: lane = a pair of output channels,
// warp = one of 8 pixel groups) while the last wgmma of the tile run. At
// the end each block writes its partial row: [tap][ci][co] dw, then db.
__device__ __forceinline__ void load_wgrad_step(uint32_t (&a)[3][4], uint32_t x_base, int dy,
                                                int pix, int chunk, int ks) {
  const int row = ks >> 2;          // the K-step's tile row
  const int col = 16 * (ks & 3);    // and its first column
#pragma unroll
  for (int dx = 0; dx < 3; ++dx) {
    const int p = (row + dy) * kBoxW + col + pix + dx;  // staged x pixel of tap (dy, dx)
    ldmatrix_x4_trans(x_base + p * kPixBytes + ((chunk ^ (p & 7)) << 4), a[dx]);
  }
}

__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_c64_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap gmap,
                               float* __restrict__ partial, int H, int W, int row_off,
                               int n_tiles, int need_dw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_db = reinterpret_cast<float*>(smem + kStages * kWgStageBytes);  // [8][64]
  uint64_t* s_bar = reinterpret_cast<uint64_t*>(s_db + kDbGroups * kC);

  const int tid = threadIdx.x;
  const int tiles_x = W / kTW;
  const int per_img = tiles_x * (H / kTH);

  auto issue = [&](int stage, int tile) {
    const int b = tile / per_img;
    const int r = tile - b * per_img;
    const int ty = r / tiles_x;
    const int tx = r - ty * tiles_x;
    unsigned char* st = smem + stage * kWgStageBytes;
    const uint32_t bar = smem_u32(&s_bar[stage]);
    mbar_expect_tx(bar, need_dw ? kBoxBytes + kGBoxBytes : kGBoxBytes);
    if (need_dw)
      tma_load_4d(smem_u32(st), &xmap, bar, 0, tx * kTW - 1, ty * kTH + row_off, b);
    tma_load_4d(smem_u32(st + kStageBytes), &gmap, bar, 0, tx * kTW, ty * kTH, b);
  };

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) mbar_init(smem_u32(&s_bar[s]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      const int t = blockIdx.x + s * gridDim.x;
      if (t < n_tiles) issue(s, t);
    }
  }
  __syncthreads();

  const int wg = tid >> 7;            // dy of this warpgroup's taps
  const int warp = (tid >> 5) & 3;    // its input channels 16 * warp ...
  const int lane = tid & 31;
  const int a_pix = (lane & 7) + 8 * (lane >> 4);  // ldmatrix row: pixel of the K-step
  const int a_chunk = 2 * warp + ((lane >> 3) & 1);  // and its 8-channel chunk
  const int db_pair = tid & 31;       // db (tid < 256): output channels 2 * db_pair, + 1
  const int db_group = tid >> 5;      // over the tile's pixels p with p % 8 == db_group

  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[t][i] = 0.f;
  float db0 = 0.f, db1 = 0.f;

  auto sum_db = [&](const unsigned char* g_tile) {
#pragma unroll 8
    for (int k = 0; k < kTH * kTW / kDbGroups; ++k) {
      const int p = db_group + kDbGroups * k;  // p % 8 == db_group: the swizzle phase
      const uint32_t v = *reinterpret_cast<const uint32_t*>(
          g_tile + p * kPixBytes + (((db_pair >> 2) ^ db_group) << 4) + 4 * (db_pair & 3));
      db0 += __uint_as_float(v << 16);
      db1 += __uint_as_float(v & 0xffff0000u);
    }
  };

  int it = 0;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++it) {
    const int stage = it % kStages;
    mbar_wait(smem_u32(&s_bar[stage]), (it / kStages) & 1);
    unsigned char* st = smem + stage * kWgStageBytes;
    if (need_dw) {
      const uint32_t x_base = smem_u32(st);
      const uint64_t desc_g = make_desc_mn(smem_u32(st + kStageBytes));
      uint32_t a[2][3][4];
      load_wgrad_step(a[0], x_base, wg, a_pix, a_chunk, 0);
#pragma unroll
      for (int ks = 0; ks < kTH * kTW / 16; ++ks) {
#pragma unroll
        for (int t = 0; t < 3; ++t) fence_operands(acc[t]);
        wgmma_fence();
#pragma unroll
        for (int t = 0; t < 3; ++t)  // K-step ks: 16 pixels, 2,048 bytes of g
          wgmma_m64n64k16_tb(acc[t], a[ks & 1][t], desc_g + static_cast<uint64_t>((ks * 2048) >> 4));
        wgmma_commit();
        if (ks + 1 < kTH * kTW / 16) {
          wgmma_wait<1>();  // the previous step's wgmma no longer read a[(ks + 1) & 1]
          load_wgrad_step(a[(ks + 1) & 1], x_base, wg, a_pix, a_chunk, ks + 1);
        }
      }
      if (tid < 2 * 128) sum_db(st + kStageBytes);
      wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < 3; ++t) fence_operands(acc[t]);
    } else if (tid < 2 * 128) {
      sum_db(st + kStageBytes);
    }
    __syncthreads();  // every warp is done with this stage: refill it
    if (tid == 0 && tile + kStages * static_cast<int>(gridDim.x) < n_tiles)
      issue(stage, tile + kStages * gridDim.x);
  }

  float* out = partial + static_cast<size_t>(blockIdx.x) * kPartial;
  if (need_dw) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = 16 * warp + (lane >> 2) + 8 * h;
          const int co = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(out + ((3 * wg + t) * kC + ci) * kC + co) =
              make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
        }
  }
  if (tid < 2 * 128) {
    s_db[db_group * kC + 2 * db_pair] = db0;
    s_db[db_group * kC + 2 * db_pair + 1] = db1;
  }
  __syncthreads();
  if (tid < kC) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < kDbGroups; ++q) s += s_db[q * kC + tid];
    out[9 * kC * kC + tid] = s;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda through the runtime, so the library
// needs no link against libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return (e == cudaSuccess && q == cudaDriverEntryPointSuccess) ? reinterpret_cast<EncodeTiled>(p)
                                                                 : nullptr;
  }();
  return fn;
}

// A 4-D tensor map {64 channels, W, rows, B} over a bf16 NHWC tensor, boxes
// of {64, box_w, box_h, 1} with the 128-byte swizzle; what lies outside the
// tensor (negative coordinates included) reads as zeros (FLOAT_OOB_FILL_NONE).
cudaError_t encode_nhwc(CUtensorMap* map, const void* base, int B, int rows, int W, int box_w,
                        int box_h) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return cudaErrorSymbolNotFound;
  const cuuint64_t dims[4] = {kC, static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {kPixBytes, static_cast<cuuint64_t>(W) * kPixBytes,
                                 static_cast<cuuint64_t>(rows) * W * kPixBytes};
  const cuuint32_t box[4] = {kC, static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  if (encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides, box,
             elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  return cudaSuccess;
}

// y: (B, H, W, 64) from x: (B, Hin, W, 64), input row origin `row_off`; H
// need not be a multiple of the tile's 4 rows.
cudaError_t launch_bf16(const void* x, const void* w, const void* bias, void* y, int B, int H,
                        int Hin, int W, int row_off, cudaStream_t stream) {
  if (W % kTW != 0) return cudaErrorInvalidValue;
  CUtensorMap map;
  cudaError_t e = encode_nhwc(&map, x, B, Hin, W, kBoxW, kBoxH);
  // the SM count and the kernel's shared-memory limit, set once per device
  static bool smem_set[kMaxDevices] = {};
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = device_sms(&dev, &sms);
  if (e == cudaSuccess) e = smem_limit_once(conv3x3_c64_wgmma_kernel, kSmemBytes, dev, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = B * ((H + kTH - 1) / kTH) * (W / kTW);
  const int grid = n_tiles < sms ? n_tiles : sms;
  conv3x3_c64_wgmma_kernel<<<grid, kThreads, kSmemBytes, stream>>>(
      map, static_cast<const uint4*>(w), static_cast<const float*>(bias),
      static_cast<unsigned short*>(y), H, W, row_off, n_tiles);
  return cudaGetLastError();
}

// dw + db partials from x: (B, Hx, W, 64) and g: (B, H, W, 64), x's row
// origin `row_off` (-1 SAME, 0 halo-row mode).
cudaError_t launch_wgrad_bf16(const void* x, const void* g, float* partial, int B, int H, int Hx,
                              int W, int row_off, int need_dw, cudaStream_t stream) {
  if (H % kTH != 0 || W % kTW != 0) return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  cudaError_t e = encode_nhwc(&xmap, x, B, Hx, W, kBoxW, kBoxH);
  if (e == cudaSuccess) e = encode_nhwc(&gmap, g, B, H, W, kTW, kTH);
  static bool smem_set[kMaxDevices] = {};
  int dev = 0, sms = 0;
  if (e == cudaSuccess) e = device_sms(&dev, &sms);
  if (e == cudaSuccess)
    e = smem_limit_once(conv3x3_c64_wgrad_wgmma_kernel, kWgSmemBytes, dev, smem_set);
  if (e != cudaSuccess) return e;
  const int n_tiles = B * (H / kTH) * (W / kTW);
  const int grid = n_tiles < sms ? n_tiles : sms;
  conv3x3_c64_wgrad_wgmma_kernel<<<grid, kWgThreads, kWgSmemBytes, stream>>>(
      xmap, gmap, partial, H, W, row_off, n_tiles, need_dw);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------- dw, db: the sum
// Column j of the partial rows: dw of tap j / 4096, input channel j / 64 %
// 64, output channel j % 64 (written to OIHW), then db. Each sum rounds to
// x's type Tx, then to the gradient's own type (w's Tw, the bias's Tb).
template <typename Tx, typename Tw, typename Tb>
__global__ void __launch_bounds__(32 * kColSlices)
conv3x3_c64_wgrad_reduce_kernel(const float* __restrict__ partial, int n_parts, int col0,
                                int width, typename Tw::storage* __restrict__ dw,
                                typename Tb::storage* __restrict__ db) {
  column_sum(partial, n_parts, kPartial, col0, width, [dw, db](int j, float v) {
    const float r = Tx::to_f(Tx::from_f(v));
    if (j < 9 * kC * kC) {
      const int t = j >> 12, ci = (j >> 6) & (kC - 1), co = j & (kC - 1);
      dw[(co * kC + ci) * 9 + t] = Tw::from_f(r);
    } else {
      db[j - 9 * kC * kC] = Tb::from_f(r);
    }
  });
}

template <typename Tx, typename Tw, typename Tb>
cudaError_t launch_reduce(const float* partial, int n_parts, int need_dw, int need_db, void* dw,
                          void* db, cudaStream_t stream) {
  const int col0 = need_dw ? 0 : 9 * kC * kC;
  const int width = (need_dw ? 9 * kC * kC : 0) + (need_db ? kC : 0);
  conv3x3_c64_wgrad_reduce_kernel<Tx, Tw, Tb><<<(width + 31) / 32, 32 * kColSlices, 0, stream>>>(
      partial, n_parts, col0, width, static_cast<typename Tw::storage*>(dw),
      static_cast<typename Tb::storage*>(db));
  return cudaGetLastError();
}

template <typename Tx>
cudaError_t dispatch_reduce(const float* partial, int n_parts, int need_dw, int need_db, void* dw,
                            int w_dtype, void* db, int db_dtype, cudaStream_t stream) {
  const bool wb = w_dtype == kBFloat16, bb = db_dtype == kBFloat16;
  if (wb && bb) return launch_reduce<Tx, BF16, BF16>(partial, n_parts, need_dw, need_db, dw, db, stream);
  if (wb) return launch_reduce<Tx, BF16, F32>(partial, n_parts, need_dw, need_db, dw, db, stream);
  if (bb) return launch_reduce<Tx, F32, BF16>(partial, n_parts, need_dw, need_db, dw, db, stream);
  return launch_reduce<Tx, F32, F32>(partial, n_parts, need_dw, need_db, dw, db, stream);
}

// The backward's scratch: the flipped weights (9 * 64 * 64 of x's type,
// then 64 float32 zeros: the pack's bias) in the first kBwdPackBytes, then
// the float32 partial rows of dw + db, one per block of the wgrad grid.
constexpr size_t kBwdPackBytes = kPackElems * 4 + kC * 4;

}  // namespace
}  // namespace adunet

// x: contiguous NHWC (B, H + 2 * halo, W, 64), y: (B, H, W, 64), both of
// `dtype` (0 float32, 1 bf16); halo 0 is the SAME conv, 1 the halo-row mode
// (VALID in H, SAME in W). w: contiguous OIHW (64, 64, 3, 3) of `w_dtype`;
// bias: (64,) of `bias_dtype`, or none where `bias_dtype` is -1 (0 float32,
// 1 bf16 for both). scratch: 9 * 64 * 64 elements of `dtype` then 64
// float32, where the call packs the weights (rounded to `dtype`) and the
// bias (rounded to `dtype`, then float32) before the conv reads them. All
// pointers 16-byte aligned (w and bias: 4 bytes), on CUDA device `device`,
// which the call makes current if it is not; H % 4 == 0 and W % 128 == 0
// (the Python gate `supported` is stricter). Launches the pack and the conv
// on `stream`; returns the first CUDA error.
extern "C" int adunet_conv3x3_c64(const void* x, const void* w, int w_dtype, const void* bias,
                                  int bias_dtype, void* scratch, void* y, int B, int H, int W,
                                  int halo, int dtype, int device, void* stream) {
  using adunet::kBFloat16;
  using adunet::kFloat32;
  if (B <= 0 || H <= 0 || W <= 0 || H % 4 != 0 || (halo != 0 && halo != 1) ||
      (w_dtype != kFloat32 && w_dtype != kBFloat16) ||
      (bias_dtype != -1 && bias_dtype != kFloat32 && bias_dtype != kBFloat16) ||
      (dtype != kFloat32 && dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == kBFloat16;
  const void* bias_packed = static_cast<const char*>(scratch) +
                            adunet::kPackElems * (bf16 ? 2 : 4);
  cudaError_t e = bf16 ? adunet::launch_pack<adunet::BF16>(w, w_dtype, bias, bias_dtype, scratch, 0, st)
                       : adunet::launch_pack<adunet::F32>(w, w_dtype, bias, bias_dtype, scratch, 0, st);
  if (e != cudaSuccess) return e;
  const int Hin = H + 2 * halo, row_off = halo - 1;
  return bf16 ? adunet::tc::launch_bf16(x, scratch, bias_packed, y, B, H, Hin, W, row_off, st)
              : adunet::launch_f32(x, scratch, bias_packed, y, B, H, Hin, W, row_off, st);
}

// Writes to *n (an int) the number of float32 partial rows (9 * 64 * 64 dw
// sums, then 64 db sums, each) that adunet_conv3x3_c64_backward's scratch
// must hold on the current device: its wgrad grid's most blocks, one per SM.
// Returns the CUDA error.
extern "C" int adunet_conv3x3_c64_backward_partials(void* n) {
  int dev = 0, sms = 0;
  const cudaError_t e = adunet::device_sms(&dev, &sms);
  *static_cast<int*>(n) = sms;
  return e;
}

// The backward of adunet_conv3x3_c64 for the output cotangent g: (B, H, W,
// 64) of `dtype`, x: (B, H + 2 * halo, W, 64) of `dtype` as the forward took
// it, w: OIHW (64, 64, 3, 3) of `w_dtype` (0 float32, 1 bf16). Writes, where
// asked (need_* nonzero; the pointers of the others may be null):
// - dx: like x, the correlation of g with the flipped, io-swapped w rounded
//   to `dtype` (halo 1: all H + 2 rows);
// - dw: OIHW of `w_dtype`, the float32 sum rounded to `dtype`, then to w's;
// - db: (64,) of `db_dtype`, the float32 sum of g rounded to `dtype`, then
//   to db's.
// scratch: 147,712 bytes (the flipped weights), then, where dw or db is
// asked, adunet_conv3x3_c64_backward_partials() rows of 36,928 float32. All
// pointers 16-byte aligned (w: 4 bytes), on CUDA device `device`, which the
// call makes current if it is not; H % 4 == 0 and W % 128 == 0. Launches the
// flip pack and the dx conv, then the dw + db partials and their sum, on
// `stream`; asks the runtime for nothing a CUDA graph's capture forbids.
// Returns the first CUDA error.
extern "C" int adunet_conv3x3_c64_backward(const void* x, const void* w, int w_dtype, const void* g,
                                           int need_dx, int need_dw, int need_db, void* scratch,
                                           void* dx, void* dw, void* db, int db_dtype, int B,
                                           int H, int W, int halo, int dtype, int device,
                                           void* stream) {
  using adunet::kBFloat16;
  using adunet::kFloat32;
  if (B <= 0 || H <= 0 || W <= 0 || H % 4 != 0 || W % 128 != 0 || (halo != 0 && halo != 1) ||
      (w_dtype != kFloat32 && w_dtype != kBFloat16) || (dtype != kFloat32 && dtype != kBFloat16) ||
      (need_db && db_dtype != kFloat32 && db_dtype != kBFloat16))
    return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool bf16 = dtype == kBFloat16;
  const int Hx = H + 2 * halo;
  cudaError_t e = cudaSuccess;
  if (need_dx) {  // the forward kernel on g with the flipped kernel: Hx rows from H
    const void* zeros = static_cast<const char*>(scratch) + adunet::kPackElems * (bf16 ? 2 : 4);
    e = bf16 ? adunet::launch_pack<adunet::BF16>(w, w_dtype, nullptr, -1, scratch, 1, st)
             : adunet::launch_pack<adunet::F32>(w, w_dtype, nullptr, -1, scratch, 1, st);
    if (e != cudaSuccess) return e;
    const int row_off = halo ? -2 : -1;
    e = bf16 ? adunet::tc::launch_bf16(g, scratch, zeros, dx, B, Hx, H, W, row_off, st)
             : adunet::launch_f32(g, scratch, zeros, dx, B, Hx, H, W, row_off, st);
    if (e != cudaSuccess) return e;
  }
  if (!need_dw && !need_db) return cudaSuccess;
  float* partial = reinterpret_cast<float*>(static_cast<char*>(scratch) + adunet::kBwdPackBytes);
  int dev = 0, sms = 0;
  e = adunet::device_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  const int row_off = halo - 1;
  e = bf16 ? adunet::tc::launch_wgrad_bf16(x, g, partial, B, H, Hx, W, row_off, need_dw, st)
           : adunet::launch_wgrad_f32(x, g, partial, B, H, Hx, W, row_off, need_dw, st);
  if (e != cudaSuccess) return e;
  // the wgrad grids' blocks: one per tile up to one per SM
  const int tiles = bf16 ? B * (H / adunet::tc::kTH) * (W / adunet::tc::kTW)
                         : B * (H / adunet::wg32::kRows) * (W / adunet::wg32::kCols);
  const int n_parts = tiles < sms ? tiles : sms;
  return bf16 ? adunet::dispatch_reduce<adunet::BF16>(partial, n_parts, need_dw, need_db, dw,
                                                      w_dtype, db, db_dtype, st)
              : adunet::dispatch_reduce<adunet::F32>(partial, n_parts, need_dw, need_db, dw,
                                                     w_dtype, db, db_dtype, st);
}
