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
// bf16, `conv3x3_c64_wgmma_kernel` (an implicit GEMM on the tensor cores,
// designed for Hopper): a persistent grid, one block per SM, warp-
// specialised. Both bounds tie, so the design keeps the tensor cores and the
// loads busy at once:
// - A producer warpgroup (one thread issues, the others give their
//   registers to the consumers by setmaxnreg) loads the weights once per
//   block by bulk copy: the 9 taps' (64 co x 64 ci) bf16 matrices, 72 KB,
//   already in the 128B-swizzled K-major layout wgmma's B descriptor reads
//   (packed on the card, below). Then it keeps a ring of three TMA stages
//   of input in flight: one 4-D tensor-map box {64 ch, 66 cols, 6 rows, 1
//   image} from (0, x0-1, y0+row_off, b) brings a 4-row x 64-column tile
//   and its halo; the copy engine fills the out-of-image part (negative
//   coordinates included) with zeros, so SAME padding costs nothing. A row
//   of 64 bf16 is 128 bytes, staged with the 128-byte swizzle; each input
//   pixel comes from device memory once per tile (the halo, 1.55x the
//   tile, mostly from L2). Each stage has a full and an empty mbarrier: no
//   block-wide barrier in the loop.
// - Two consumer warpgroups take the block's tiles in turn, each a tile of
//   its own (ping-pong), so one's epilogue runs under the other's wgmma. A
//   tile is 9 taps x 4 K=16 steps x 4 rows = 144 `wgmma.mma_async ...
//   m64n64k16`, all queued before the first wait, with both operands read
//   from shared memory: the tap (dy, dx) shifts the staged tile by whole
//   pixels, a multiple of the 128-byte swizzle row, and wgmma swizzles by
//   the address bits as TMA does, so A's descriptor simply starts at the
//   shifted pixel (no ldmatrix, no register copy of A). Per output, the
//   float32 accumulation runs over taps 0..8, then K-steps 0..3, as the
//   first bf16 kernel's did, so the outputs are the same bits.
// - The stage goes back to the producer as soon as the tile's wgmma are
//   done. Epilogue from registers: bias added in float32, rounded to bf16
//   (nearest-even), three shuffles within each quad of lanes turn the
//   accumulator layout into 16-byte chunks of channels, stored with 16-byte
//   stores (a warp writes 8 pixels x 64 contiguous bytes each).
//
// The backward (the reference's custom VJP `_bwd`, adunet/kernels/conv64.py
// :203-227, which runs as XLA convolutions there) is three more passes,
// launched by one C call, `adunet_conv3x3_c64_backward`:
// - dx is the correlation of the cotangent g with the spatially flipped,
//   io-swapped kernel. float32: the pack in flip mode (tap 8 - t, ci and co
//   swapped, no bias), then the float32 forward kernel on g. bf16: the pack
//   in the forward's layout and the forward kernel's dx instantiation on g,
//   which reads B, tap t, as the pack's tap 8 - t through an MN-major
//   descriptor (wgmma's transpose bit): the pack's row co, 128 bytes of
//   input channels, is a K row of dx's GEMM. In the halo-row mode dx covers
//   all H + 2 input rows: a full correlation in H, so the input row origin
//   is a signed offset (-1 SAME, 0 the halo forward, -2 the halo dx) and the
//   bf16 kernel's last 4-row tile can be ragged (H + 2 is 2 mod 4), its
//   stores guarded by row.
// - dw[ky][kx][ci][co] = sum over b, y, x of x[b][y + ky + row_off][x + kx -
//   1][ci] * g[b][y][x][co], and db[co] = sum of g. float32:
//   `conv3x3_c64_wgrad_kernel` (CUDA cores, no TF32), a persistent grid
//   over cotangent tiles whose blocks keep all 9 x 64 x 64 dw sums of their
//   tiles in registers and write one float32 partial row each. bf16:
//   `conv3x3_c64_wgrad_wgmma_kernel` (below), warp-specialised as the
//   forward kernel, whose blocks sum their rows within a cluster of
//   kCluster blocks in distributed shared memory and write one partial row
//   a cluster. The split over tiles is fixed by the shape and the device.
// - `conv3x3_c64_wgrad_reduce_kernel` sums the partial rows in a fixed order
//   and rounds dw to x's type, then to w's, and
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

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace adunet {
namespace {

namespace cg = cooperative_groups;

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
constexpr int kTW = 64;                                  // output columns per tile: one wgmma M
constexpr int kBoxW = kTW + 2;                           // staged columns (halo included)
constexpr int kBoxH = kTH + 2;                           // staged rows
constexpr int kPixBytes = kC * 2;                        // one staged pixel: 128 bytes
constexpr int kBoxBytes = kBoxW * kBoxH * kPixBytes;     // 50,688
constexpr int kStageBytes = (kBoxBytes + 1023) / 1024 * 1024;
constexpr int kTapBytes = kC * kC * 2;                   // one tap's 64 x 64 bf16
constexpr int kWBytes = 9 * kTapBytes;                   // 73,728
// the forward (and the backward's dx): two consumer warpgroups, each on a
// tile of its own, and a producer warpgroup (the last; one thread issues
// the loads), three stages; a stage goes back to the producer as soon as
// its tile's wgmma are done (the output leaves from registers). The
// register file is four quadrants of 16K, a warp in each in turn: the
// producer gives up registers to the consumers (setmaxnreg), one producer
// and two consumer warps a quadrant.
constexpr int kConsumers = 2;
constexpr int kStages = 3;
constexpr int kThreads = 128 * (kConsumers + 1);
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
static_assert(kProducerRegs + kConsumers * kConsumerRegs <= 512, "a quadrant's registers");
constexpr int kSmemBytes = 1024 + kWBytes + kStages * kStageBytes + (2 * kStages + 1) * 8;
static_assert(kSmemBytes <= 232448, "more shared memory than a Hopper block may use");
// dw + db: 2-row x 64-column cotangent tiles; a stage holds the x rows and
// columns their taps read (4 x 66 pixels), then the 2 x 64-pixel g tile;
// three consumer warpgroups (one per dy) and a producer warpgroup, four
// stages; the registers as above, three consumer warps a quadrant
constexpr int kWgTH = 2;
constexpr int kWgBoxBytes = kBoxW * (kWgTH + 2) * kPixBytes;  // 33,792
constexpr int kWgXBytes = (kWgBoxBytes + 1023) / 1024 * 1024;
constexpr int kGBoxBytes = kWgTH * kTW * kPixBytes;      // 16,384
constexpr int kWgStageBytes = kWgXBytes + kGBoxBytes;
constexpr int kWgStages = 4;
constexpr int kWgConsumers = 3;
constexpr int kWgThreads = 128 * (kWgConsumers + 1);
constexpr int kWgConsumerRegs = 152;
static_assert(kProducerRegs + kWgConsumers * kWgConsumerRegs <= 512, "a quadrant's registers");
constexpr int kDbGroups = 8;                             // db: pixel groups of warpgroups 0-1
constexpr int kWgSmemBytes = 1024 + kWgStages * kWgStageBytes + kDbGroups * kC * 4 + 2 * kWgStages * 8;
static_assert(kWgSmemBytes <= 232448, "more shared memory than a Hopper block may use");
// the blocks of a cluster sum their dw + db in distributed shared memory:
// each parks its sums (dw rows of kParkRow floats, padded against bank
// conflicts, then db) over its stages, and the cluster writes one row
constexpr int kCluster = 4;
constexpr int kParkRow = kC + 8;
constexpr int kParkFloats = 9 * kC * kParkRow + kC;
static_assert(kParkFloats * 4 <= kWgStages * kWgStageBytes, "the parked sums fit in the stages");

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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar) : "memory");
}

// The wait's loop lies inside one asm block: a loop in C++ around try_wait
// is a divergent path to the compiler, and wgmma after one are serialized.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(bar)
      : "memory");
}

// a contiguous global -> shared copy of `bytes` (a multiple of 16) on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: K-major, 128-byte swizzle, 8-row
// groups 1024 bytes apart (the leading offset is unused in this layout). The
// swizzle is a function of the address bits, as TMA's is, so a descriptor
// may start at any 128-byte row of a 1024-byte aligned buffer: a tap's
// shift by whole pixels is an offset of the start address (base offset 0).
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3FFF) | (1ull << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// The same for an MN-major operand (wgmma's transpose bit): 64 M or N values
// of a K row are 128 contiguous bytes, 8 K rows a 1024-byte swizzle atom, K
// groups of 8 rows 1024 bytes apart. The stride between 8-row groups and
// the one between 64-value blocks (unused at 64) are both 1024 bytes.
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

// D (64 x 64, float32, in registers) += A (64 x 16 bf16) x B (16 x 64 bf16),
// both from shared memory; kTA / kTB: A / B MN-major (`make_desc_mn`)
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %35, %36;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]),
        "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTA), "n"(kTB));
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// this warpgroup's registers a thread, lowered or raised (all its warps)
template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kRegs));
}

// v[k]'s of one quad (four lanes, lane q = lane % 4) transposed by halves:
// lo's word p is lane p's v[q], hi's word p lane p's v[4 + q]. Three xor
// shuffles a half; the word indices that differ by lane are picked by
// selects, so no register array is indexed at run time.
__device__ __forceinline__ uint32_t pick4(const uint32_t* v, int k) {
  return k == 0 ? v[0] : k == 1 ? v[1] : k == 2 ? v[2] : v[3];
}
__device__ __forceinline__ void quad_transpose(const uint32_t (&v)[8], int q, uint4& lo, uint4& hi) {
  // index q keeps the lane's own word; index q ^ i receives lane q ^ i's word q
  uint32_t ta[4] = {v[0], v[1], v[2], v[3]}, tc[4] = {v[4], v[5], v[6], v[7]};
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    const uint32_t ra = __shfl_xor_sync(0xffffffffu, pick4(v, q ^ i), i);
    const uint32_t rc = __shfl_xor_sync(0xffffffffu, pick4(v + 4, q ^ i), i);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (k == (q ^ i)) {
        ta[k] = ra;
        tc[k] = rc;
      }
    }
  }
  lo = make_uint4(ta[0], ta[1], ta[2], ta[3]);
  hi = make_uint4(tc[0], tc[1], tc[2], tc[3]);
}

// `conv3x3_c64_wgmma_kernel`: K2's bf16 forward (kDx false) and the
// backward's dx (kDx true). Output row r reads input rows r + dy + row_off;
// H need not be a multiple of kTH (the halo-row mode's dx): the rows of the
// last tile past H are computed and not stored. kDx reads B, tap t, as the
// forward's packed tap 8 - t, transposed (MN-major): dx's weight for
// (cotangent channel co, input channel ci) is w[co][ci] of the flipped tap,
// which is the forward pack's row co, column ci.
template <bool kDx>
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
  uint64_t* full = reinterpret_cast<uint64_t*>(s_in + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  uint64_t* wbar = empty + kStages;

  const int tid = threadIdx.x;
  const int tiles_x = W / kTW;
  const int per_img = tiles_x * ((H + kTH - 1) / kTH);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128);  // every thread of the consumer
    }
    mbar_init(smem_u32(wbar), 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, uniform over each warp to the compiler (a branch on it
  // is not divergent, so the wgmma behind it are not serialized)
  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);
  if (wg == kConsumers) {  // the producer warpgroup: one thread issues every load
    regs_dec<kProducerRegs>();
    if (tid == 128 * kConsumers) {
      mbar_expect_tx(smem_u32(wbar), kWBytes);
#pragma unroll 1
      for (int t = 0; t < 9; ++t)
        bulk_load(smem_u32(s_w + t * kTapBytes), wpk + t * (kTapBytes / 16), kTapBytes,
                  smem_u32(wbar));
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(smem_u32(&empty[s]), (i / kStages - 1) & 1);
        const int b = tile / per_img;
        const int r = tile - b * per_img;
        const int ty = r / tiles_x;
        mbar_expect_tx(smem_u32(&full[s]), kBoxBytes);
        // tile row ty's input rows start at its first output row + row_off
        tma_load_4d(smem_u32(s_in + s * kStageBytes), &xmap, smem_u32(&full[s]), 0,
                    (r - ty * tiles_x) * kTW - 1, ty * kTH + row_off, b);
      }
    }
    return;
  }

  regs_inc<kConsumerRegs>();           // consumer wg: every kConsumers-th tile of the block's
  const int warp = (tid >> 5) & 3;    // its 16 pixels of each 64-pixel row
  const int lane = tid & 31;
  float bcol[16];                     // the bias of this lane's output channels 8j + 2(lane & 3) + e
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float2 v = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * (lane & 3));
    bcol[2 * j] = v.x;
    bcol[2 * j + 1] = v.y;
  }
  // descriptors of the weights (K-major, or MN-major for the dx) and of
  // stage 0; a tap, K-step or stage is a constant offset of their address
  const uint64_t desc_w = kDx ? make_desc_mn(smem_u32(s_w)) : make_desc(smem_u32(s_w));
  const uint64_t desc_in = make_desc(smem_u32(s_in));
  mbar_wait(smem_u32(wbar), 0);

  int i = wg;
  for (int tile = blockIdx.x + wg * gridDim.x; tile < n_tiles;
       tile += kConsumers * gridDim.x, i += kConsumers) {
    const int s = i % kStages;
    const uint64_t desc_a = desc_in + static_cast<uint64_t>(s * (kStageBytes >> 4));
    mbar_wait(smem_u32(&full[s]), (i / kStages) & 1);

    // per output row, in this order: taps 0..8, K-steps 0..3 (each 16 input
    // channels), into one float32 accumulator. A, the tile row shifted by
    // the tap, starts at its staged pixel: no register copy of it is made.
    float acc[kTH][32];
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
#pragma unroll
      for (int k = 0; k < 32; ++k) acc[r][k] = 0.f;
      fence_operands(acc[r]);
    }
    wgmma_fence();
    // a loop over the taps, not unrolled: each descriptor is made where it
    // is used (unrolled, the compiler keeps them all live over the tile loop)
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap - 3 * dy;
      const uint64_t a_tap = desc_a + (((dy * kBoxW + dx) * kPixBytes) >> 4);
      const uint64_t b_tap = desc_w + (kDx ? ((8 - tap) * kTapBytes) >> 4 : (tap * kTapBytes) >> 4);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t desc_b = b_tap + (kDx ? (ks * 2048) >> 4 : (ks * 32) >> 4);
#pragma unroll
        for (int r = 0; r < kTH; ++r)
          wgmma_ss<0, kDx ? 1 : 0>(acc[r], a_tap + ((r * kBoxW * kPixBytes + ks * 32) >> 4), desc_b);
      }
      wgmma_commit();
    }
    wgmma_wait<0>();
#pragma unroll
    for (int r = 0; r < kTH; ++r) fence_operands(acc[r]);
    mbar_arrive(smem_u32(&empty[s]));  // this thread's wgmma are done with the stage

    // epilogue, from registers: bias, bf16, and 16-byte stores. Lane q of a
    // quad holds, for its pixel, the bf16 pairs of channels 8j + 2q (j =
    // 0..7); three shuffles in the quad give it channels 8q ... 8q + 7 and
    // 32 + 8q ... 32 + 8q + 7, so a warp's store writes 8 pixels x 64 bytes.
    const int b = tile / per_img;
    const int rem = tile - b * per_img;
    const int ty = rem / tiles_x;
    const int q = lane & 3;
#pragma unroll
    for (int r = 0; r < kTH; ++r) {
      const int yy = ty * kTH + r;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t v[8];
#pragma unroll
        for (int j = 0; j < 8; ++j)
          v[j] = static_cast<uint32_t>(BF16::from_f(acc[r][4 * j + 2 * h] + bcol[2 * j])) |
                 (static_cast<uint32_t>(BF16::from_f(acc[r][4 * j + 2 * h + 1] + bcol[2 * j + 1]))
                  << 16);
        uint4 lo, hi;  // channels 8q ..., 32 + 8q ...: word p from lane p's v[q], v[4 + q]
        quad_transpose(v, q, lo, hi);
        if (yy < H) {
          const size_t pix = (static_cast<size_t>(b) * H + yy) * W + (rem - ty * tiles_x) * kTW +
                             16 * warp + (lane >> 2) + 8 * h;
          *reinterpret_cast<uint4*>(y + pix * kC + 8 * q) = lo;
          *reinterpret_cast<uint4*>(y + pix * kC + 32 + 8 * q) = hi;
        }
      }
    }
  }
}

// `conv3x3_c64_wgrad_wgmma_kernel`: dw + db on the tensor cores. A
// persistent grid of clusters walks 2-row x 64-column cotangent tiles; per
// tile the producer's TMA pair brings the g tile (2 x 64 pixels) and the x
// rows and columns its taps read (4 x 66 pixels, zero-filled outside the
// image) into one of four stages. Per tap the tile is a GEMM dw_t (64 ci x
// 64 co) += x_t^T (64 ci x 128 pixels) g (128 pixels x 64 co), in 8
// K-steps of 16 pixels, both operands read by wgmma from shared memory
// through MN-major descriptors (a staged pixel is a K row of 64 channels):
// B = g unshifted, A = x at the pixel the tap shifts to. Consumer
// warpgroup dy owns taps (dy, 0..2): three 64 x 64 float32 accumulators a
// thread (96 registers), kept over all the block's tiles. A stage goes back
// to the producer one tile late, once the next tile's wgmma are queued, so
// the tensor cores do not drain between tiles. Warpgroups 0-1 also sum the
// g tile's columns (db: lane = a pair of output channels, warp = one of 8
// pixel groups) while the wgmma run. At the end
// each block parks its sums in its shared memory and the kCluster blocks of
// a cluster add them in distributed shared memory, block q's after block q
// - 1's, block r owning 1/kCluster of the columns: one partial row a
// cluster, [tap][ci][co] dw, then db.
__global__ void __launch_bounds__(kWgThreads, 1)
conv3x3_c64_wgrad_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                               const __grid_constant__ CUtensorMap gmap,
                               float* __restrict__ partial, int H, int W, int row_off,
                               int n_tiles, int need_dw) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* s_db = reinterpret_cast<float*>(smem + kWgStages * kWgStageBytes);  // [8][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(s_db + kDbGroups * kC);
  uint64_t* empty = full + kWgStages;

  const int tid = threadIdx.x;
  const int tiles_x = W / kTW;
  const int per_img = tiles_x * (H / kWgTH);

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < kWgStages; ++s) {
      mbar_init(smem_u32(&full[s]), 1);
      mbar_init(smem_u32(&empty[s]), 128 * kWgConsumers);  // every consumer thread
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid >> 7, 0);  // dy of its taps; uniform, as above
  const int warp = (tid >> 5) & 3;    // its input channels 16 * warp ...
  const int lane = tid & 31;
  float acc[3][32];
#pragma unroll
  for (int t = 0; t < 3; ++t)
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[t][k] = 0.f;
  float db0 = 0.f, db1 = 0.f;
  const int db_pair = tid & 31;       // db (tid < 256): output channels 2 * db_pair, + 1
  const int db_group = tid >> 5;      // over the tile's pixels p with p % 8 == db_group

  if (wg == kWgConsumers) {  // the producer warpgroup
    regs_dec<kProducerRegs>();
    if (tid == 128 * kWgConsumers) {
      int i = 0;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
        const int s = i % kWgStages;
        if (i >= kWgStages) mbar_wait(smem_u32(&empty[s]), (i / kWgStages - 1) & 1);
        const int b = tile / per_img;
        const int r = tile - b * per_img;
        const int ty = r / tiles_x;
        const int tx = r - ty * tiles_x;
        unsigned char* st = smem + s * kWgStageBytes;
        const uint32_t bar = smem_u32(&full[s]);
        mbar_expect_tx(bar, need_dw ? kWgBoxBytes + kGBoxBytes : kGBoxBytes);
        if (need_dw)
          tma_load_4d(smem_u32(st), &xmap, bar, 0, tx * kTW - 1, ty * kWgTH + row_off, b);
        tma_load_4d(smem_u32(st + kWgXBytes), &gmap, bar, 0, tx * kTW, ty * kWgTH, b);
      }
    }
  } else {
    regs_inc<kWgConsumerRegs>();
    auto sum_db = [&](const unsigned char* g_tile) {
#pragma unroll 8
      for (int k = 0; k < kWgTH * kTW / kDbGroups; ++k) {
        const int p = db_group + kDbGroups * k;  // p % 8 == db_group: the swizzle phase
        const uint32_t v = *reinterpret_cast<const uint32_t*>(
            g_tile + p * kPixBytes + (((db_pair >> 2) ^ db_group) << 4) + 4 * (db_pair & 3));
        db0 += __uint_as_float(v << 16);
        db1 += __uint_as_float(v & 0xffff0000u);
      }
    };
    int i = 0, held = -1;  // held: the stage of the last tile, not yet given back
    for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x, ++i) {
      const int s = i % kWgStages;
      mbar_wait(smem_u32(&full[s]), (i / kWgStages) & 1);
      unsigned char* st = smem + s * kWgStageBytes;
      if (need_dw) {
        const uint64_t desc_x = make_desc_mn(smem_u32(st));
        const uint64_t desc_g = make_desc_mn(smem_u32(st + kWgXBytes));
        wgmma_fence();
#pragma unroll 1
        for (int row = 0; row < kWgTH; ++row) {  // K-steps 4 row ... 4 row + 3: a tile row
          const uint64_t x_row = desc_x + ((((row + wg) * kBoxW) * kPixBytes) >> 4);
          const uint64_t g_row = desc_g + ((row * 4 * 2048) >> 4);
#pragma unroll
          for (int c = 0; c < 4; ++c) {  // 16 pixels from column 16 c
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)  // the staged x pixel of tap (wg, dx) for the first
              wgmma_ss<1, 1>(acc[dx], x_row + (((16 * c + dx) * kPixBytes) >> 4),
                             g_row + ((c * 2048) >> 4));
          }
        }
        wgmma_commit();
        if (wg < 2) sum_db(st + kWgXBytes);
        wgmma_wait<1>();  // the last tile's wgmma are done: its stage may go
      } else if (wg < 2) {
        sum_db(st + kWgXBytes);
      }
      if (held >= 0) mbar_arrive(smem_u32(&empty[held]));  // this thread is done with it
      held = s;
    }
    wgmma_wait<0>();
#pragma unroll
    for (int t = 0; t < 3; ++t) fence_operands(acc[t]);

    // park: dw in padded rows over the stages (every consumer is past its
    // last tile), db's 8 pixel groups summed in order
    float* park = reinterpret_cast<float*>(smem);
    bar_sync(1, 128 * kWgConsumers);
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int ci = 16 * warp + (lane >> 2) + 8 * h;
          const int co = 8 * j + 2 * (lane & 3);
          *reinterpret_cast<float2*>(park + ((3 * wg + t) * kC + ci) * kParkRow + co) =
              make_float2(acc[t][4 * j + 2 * h], acc[t][4 * j + 2 * h + 1]);
        }
    if (wg < 2) {
      s_db[db_group * kC + 2 * db_pair] = db0;
      s_db[db_group * kC + 2 * db_pair + 1] = db1;
    }
    bar_sync(1, 128 * kWgConsumers);
    if (tid < kC) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kDbGroups; ++q) sum += s_db[q * kC + tid];
      park[9 * kC * kParkRow + tid] = sum;
    }
  }

  // the cluster's sum: block `rank` adds float4 column groups [v0, v1) of
  // every block's parked sums, block 0's first
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  {
    float* park = reinterpret_cast<float*>(smem);
    const int rank = static_cast<int>(cluster.block_rank());
    constexpr int kVecs = kPartial / 4;
    const int v0 = rank * kVecs / kCluster, v1 = (rank + 1) * kVecs / kCluster;
    float* out = partial + static_cast<size_t>(blockIdx.x / kCluster) * kPartial;
    for (int v = v0 + tid; v < v1; v += kWgThreads) {
      const int j = 4 * v;  // column j: tap j / 4096, ci j / 64 % 64, co j % 64; then db
      const int at = j < 9 * kC * kC ? (j >> 6) * kParkRow + (j & (kC - 1))
                                     : 9 * kC * kParkRow + j - 9 * kC * kC;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const float4 u = *reinterpret_cast<const float4*>(cluster.map_shared_rank(park + at, q));
        sum.x += u.x;
        sum.y += u.y;
        sum.z += u.z;
        sum.w += u.w;
      }
      *reinterpret_cast<float4*>(out + j) = sum;
    }
  }
  cluster.sync();  // no block leaves while another reads its shared memory
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

// The SM count and the kernel's shared-memory limit (set once per device),
// and the grid: one block per SM, or half a block per tile where there are
// fewer (each block's two consumers take a tile each).
template <bool kDx>
cudaError_t launch_conv(const CUtensorMap& xmap, const void* w, const void* bias, void* y, int H,
                        int W, int row_off, int n_tiles, cudaStream_t stream) {
  static bool smem_set[kMaxDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t e = device_sms(&dev, &sms);
  if (e == cudaSuccess) e = smem_limit_once(conv3x3_c64_wgmma_kernel<kDx>, kSmemBytes, dev, smem_set);
  if (e != cudaSuccess) return e;
  const int want = (n_tiles + kConsumers - 1) / kConsumers;
  conv3x3_c64_wgmma_kernel<kDx><<<want < sms ? want : sms, kThreads, kSmemBytes, stream>>>(
      xmap, static_cast<const uint4*>(w), static_cast<const float*>(bias),
      static_cast<unsigned short*>(y), H, W, row_off, n_tiles);
  return cudaGetLastError();
}

// y: (B, H, W, 64) from x: (B, Hin, W, 64), input row origin `row_off`; H
// need not be a multiple of the tile's 4 rows. `dx`: the backward's dx,
// the weights read as their flipped, io-swapped kernel.
cudaError_t launch_bf16(const void* x, const void* w, const void* bias, void* y, int B, int H,
                        int Hin, int W, int row_off, bool dx, cudaStream_t stream) {
  if (W % kTW != 0) return cudaErrorInvalidValue;
  CUtensorMap xmap;
  const cudaError_t e = encode_nhwc(&xmap, x, B, Hin, W, kBoxW, kBoxH);
  if (e != cudaSuccess) return e;
  const int n_tiles = B * ((H + kTH - 1) / kTH) * (W / kTW);
  return dx ? launch_conv<true>(xmap, w, bias, y, H, W, row_off, n_tiles, stream)
            : launch_conv<false>(xmap, w, bias, y, H, W, row_off, n_tiles, stream);
}

// The most clusters of the wgrad kernel the device runs at once (its
// shared-memory limit set first), asked once per device: the grid's
// clusters, and the partial rows the backward's scratch holds.
cudaError_t wgrad_clusters(int dev, int sms, int* n) {
  static int cache[kMaxDevices] = {};
  if (cache[dev] == 0) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_c64_wgrad_wgmma_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmemBytes);
    if (e != cudaSuccess) return e;
    cudaLaunchConfig_t cfg = {};
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.gridDim = dim3(sms / kCluster * kCluster);
    cfg.blockDim = dim3(kWgThreads);
    cfg.dynamicSmemBytes = kWgSmemBytes;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, conv3x3_c64_wgrad_wgmma_kernel, &cfg);
    if (e != cudaSuccess) return e;
    if (clusters <= 0) return cudaErrorInvalidConfiguration;
    cache[dev] = clusters;
  }
  *n = cache[dev];
  return cudaSuccess;
}

// dw + db partial rows from x: (B, Hx, W, 64) and g: (B, H, W, 64), x's row
// origin `row_off` (-1 SAME, 0 halo-row mode): one row a cluster, their
// number written to *n_parts.
cudaError_t launch_wgrad_bf16(const void* x, const void* g, float* partial, int B, int H, int Hx,
                              int W, int row_off, int need_dw, int* n_parts, cudaStream_t stream) {
  if (H % kWgTH != 0 || W % kTW != 0) return cudaErrorInvalidValue;
  CUtensorMap xmap, gmap;
  cudaError_t e = encode_nhwc(&xmap, x, B, Hx, W, kBoxW, kWgTH + 2);
  if (e == cudaSuccess) e = encode_nhwc(&gmap, g, B, H, W, kTW, kWgTH);
  int dev = 0, sms = 0, clusters = 0;
  if (e == cudaSuccess) e = device_sms(&dev, &sms);
  if (e == cudaSuccess) e = wgrad_clusters(dev, sms, &clusters);
  if (e != cudaSuccess) return e;
  const int n_tiles = B * (H / kWgTH) * (W / kTW);
  const int want = (n_tiles + kCluster - 1) / kCluster;
  *n_parts = want < clusters ? want : clusters;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(*n_parts * kCluster);
  cfg.blockDim = dim3(kWgThreads);
  cfg.dynamicSmemBytes = kWgSmemBytes;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, conv3x3_c64_wgrad_wgmma_kernel, xmap, gmap, partial, H, W,
                            row_off, n_tiles, need_dw);
}

}  // namespace tc

// ---------------------------------------------------------------- dw, db: the sum
// Column j of the partial rows: dw of tap j / 4096, input channel j / 64 %
// 64, output channel j % 64 (written to OIHW), then db. Each sum rounds to
// x's type Tx, then to the gradient's own type (w's Tw, the bias's Tb). A
// block of 32 x kSumSlices threads owns 32 groups of 4 columns from group
// `v0 + 32 * blockIdx.x`, read 16 bytes at a time; thread (slice, lane)
// adds the rows p = slice, slice + kSumSlices, ... of its group in order of
// p, and slice 0 then adds the slices in order: a fixed order, so two calls
// give the same bits. (A few dozen rows: 8 slices keep the grid small.)
constexpr int kSumSlices = 8;

template <typename Tx, typename Tw, typename Tb>
__global__ void __launch_bounds__(32 * kSumSlices)
conv3x3_c64_wgrad_reduce_kernel(const float4* __restrict__ partial, int n_parts, int v0, int v_end,
                                typename Tw::storage* __restrict__ dw,
                                typename Tb::storage* __restrict__ db) {
  __shared__ float4 s_sum[kSumSlices][32];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int v = v0 + blockIdx.x * 32 + lane;
  float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
  if (v < v_end) {
#pragma unroll 4
    for (int p = slice; p < n_parts; p += kSumSlices) {
      const float4 u = partial[static_cast<size_t>(p) * (kPartial / 4) + v];
      sum.x += u.x;
      sum.y += u.y;
      sum.z += u.z;
      sum.w += u.w;
    }
  }
  s_sum[slice][lane] = sum;
  __syncthreads();
  if (slice != 0 || v >= v_end) return;
  float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kSumSlices; ++i) {
    const float4 u = s_sum[i][lane];
    t[0] += u.x;
    t[1] += u.y;
    t[2] += u.z;
    t[3] += u.w;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int j = 4 * v + k;
    const float r = Tx::to_f(Tx::from_f(t[k]));
    if (j < 9 * kC * kC) {
      const int tap = j >> 12, ci = (j >> 6) & (kC - 1), co = j & (kC - 1);
      dw[(co * kC + ci) * 9 + tap] = Tw::from_f(r);
    } else {
      db[j - 9 * kC * kC] = Tb::from_f(r);
    }
  }
}

template <typename Tx, typename Tw, typename Tb>
cudaError_t launch_reduce(const float* partial, int n_parts, int need_dw, int need_db, void* dw,
                          void* db, cudaStream_t stream) {
  const int v0 = need_dw ? 0 : 9 * kC * kC / 4;
  const int v_end = (need_db ? kPartial : 9 * kC * kC) / 4;
  conv3x3_c64_wgrad_reduce_kernel<Tx, Tw, Tb>
      <<<(v_end - v0 + 31) / 32, 32 * kSumSlices, 0, stream>>>(
          reinterpret_cast<const float4*>(partial), n_parts, v0, v_end,
          static_cast<typename Tw::storage*>(dw), static_cast<typename Tb::storage*>(db));
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

// The backward's scratch: the packed weights (9 * 64 * 64 of x's type,
// then 64 float32 zeros: the pack's bias) in the first kBwdPackBytes, then
// the float32 partial rows of dw + db: one per block of the float32 wgrad
// grid, one per cluster of the bf16 one.
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
  return bf16 ? adunet::tc::launch_bf16(x, scratch, bias_packed, y, B, H, Hin, W, row_off, false, st)
              : adunet::launch_f32(x, scratch, bias_packed, y, B, H, Hin, W, row_off, st);
}

// Writes to *n (an int) the number of float32 partial rows (9 * 64 * 64 dw
// sums, then 64 db sums, each) that adunet_conv3x3_c64_backward's scratch
// must hold on the current device for x of `dtype` (0 float32, 1 bf16): the
// float32 wgrad grid's most blocks (one per SM), or the bf16 one's most
// clusters (as many as the device runs at once). Returns the CUDA error.
extern "C" int adunet_conv3x3_c64_backward_partials(void* n, int dtype) {
  int dev = 0, sms = 0;
  cudaError_t e = adunet::device_sms(&dev, &sms);
  if (e == cudaSuccess && dtype == adunet::kBFloat16) e = adunet::tc::wgrad_clusters(dev, sms, &sms);
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
// scratch: 147,712 bytes (the packed weights), then, where dw or db is
// asked, adunet_conv3x3_c64_backward_partials(dtype) rows of 36,928 float32.
// All pointers 16-byte aligned (w: 4 bytes), on CUDA device `device`, which
// the call makes current if it is not; H % 4 == 0 and W % 128 == 0.
// Launches the weight pack (float32: in flip mode; bf16: the forward's
// layout, which the dx kernel reads transposed) and the dx conv, then the dw
// + db partials and their sum, on `stream`; asks the runtime for nothing a
// CUDA graph's capture forbids once the device's first call is made.
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
    e = bf16 ? adunet::launch_pack<adunet::BF16>(w, w_dtype, nullptr, -1, scratch, 0, st)
             : adunet::launch_pack<adunet::F32>(w, w_dtype, nullptr, -1, scratch, 1, st);
    if (e != cudaSuccess) return e;
    const int row_off = halo ? -2 : -1;
    e = bf16 ? adunet::tc::launch_bf16(g, scratch, zeros, dx, B, Hx, H, W, row_off, true, st)
             : adunet::launch_f32(g, scratch, zeros, dx, B, Hx, H, W, row_off, st);
    if (e != cudaSuccess) return e;
  }
  if (!need_dw && !need_db) return cudaSuccess;
  float* partial = reinterpret_cast<float*>(static_cast<char*>(scratch) + adunet::kBwdPackBytes);
  const int row_off = halo - 1;
  int n_parts = 0;  // the wgrad grid's partial rows
  if (bf16) {
    e = adunet::tc::launch_wgrad_bf16(x, g, partial, B, H, Hx, W, row_off, need_dw, &n_parts, st);
  } else {  // one per block: one per tile up to one per SM
    int dev = 0, sms = 0;
    e = adunet::device_sms(&dev, &sms);
    const int tiles = B * (H / adunet::wg32::kRows) * (W / adunet::wg32::kCols);
    n_parts = tiles < sms ? tiles : sms;
    if (e == cudaSuccess)
      e = adunet::launch_wgrad_f32(x, g, partial, B, H, Hx, W, row_off, need_dw, st);
  }
  if (e != cudaSuccess) return e;
  return bf16 ? adunet::dispatch_reduce<adunet::BF16>(partial, n_parts, need_dw, need_db, dw,
                                                      w_dtype, db, db_dtype, st)
              : adunet::dispatch_reduce<adunet::F32>(partial, n_parts, need_dw, need_db, dw,
                                                     w_dtype, db, db_dtype, st);
}
