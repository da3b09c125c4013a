// K3: 3x3 stride-1 SAME convolution plus bias in float32, NHWC, at the
// channel counts K2's gate (conv64.cu: 64 -> 64) refuses: C_in % 8 == 0 and
// C_out % 64 == 0, any H and W >= 1.
//
// Replaces no TPU kernel: the reference leaves these convs to XLA
// (adunet/nn/blocks.py `conv3x3`, :59). The port sent them to cuDNN, whose
// float32 heuristics pick FFT convolutions at the served flagship's shapes
// (widths 32-256, 64-512 channels). The served program computes in full
// float32 (TF32 misses its accuracy limit), so this kernel does the same
// float32 multiply-adds on the CUDA cores (no TF32, no tensor cores).
//
// Bound on an H100: operations. 18 * C_in * C_out FLOP per output pixel
// against (C_in + C_out) * 4 bytes read and written once, over 140 FLOP a
// byte at 64 -> 128 where the card's float32 ridge is 67 TFLOP/s / 3.35 TB/s
// = 20; so the bound is FLOP / 67 TFLOP/s.
//
// Design: an implicit GEMM, M = output pixels (B * H * W), N = C_out, K =
// 9 * C_in. A block of 256 threads owns an output tile of R x WT pixels of
// one image times CO output channels: CO is 128, or 64 where C_out is not a
// multiple of 128, and the tile holds 16,384 / CO pixels (128 or 256), so
// every thread owns 8 consecutive pixels of a row x 8 output channels ({4g..
// 4g+3} and {CO/2 + 4g..+3}, which keeps a warp's weight loads free of bank
// conflicts): 64 float32 accumulators in registers. WT, the tile's width, is
// 32, 64 or 128 by the image's width, and R = pixels / WT, so one kernel
// covers every width without a knob; a ragged edge is computed on zeros and
// not stored. As in K2's float32 kernel, for one (input channel, tap row) a
// thread reads 10 staged pixels once and reuses them for the three column
// taps, so each shared-memory load feeds ~20 FMAs.
//
// The K loop walks C_in in chunks of 8 channels. Per chunk the block stages
// the input slab (R + 2 rows x WT + 2 columns, zero outside the image,
// transposed to [channel][row][column] by 4-byte copies) and the chunk's
// weights ([tap][8 ci][CO] rows of the pack) in shared memory once, and all
// 9 taps read them. Both are double-buffered with cp.async: the next chunk's
// copies are in flight while this chunk's FMAs run. The bias is added in the
// epilogue; stores are 16-byte vectors of 4 channels. The grid walks the
// output-channel tiles fastest, so the blocks that read one input slab run
// together and find it in L2.
//
// The weight pack, `pack_w3x3_f32_kernel`, lays the OIHW float32 weights out
// as (9, C_in, C_out), tap 3 * dy + dx (K2's float32 `pack_weights` layout
// at any channel count), by 32 x 32 tiles transposed through shared memory.
// It runs on the same stream just before the conv, in the same C call, so a
// call packs exactly the weights it is given (the int8 program dequantizes
// its weights in every forward).
//
// Kernel names: the benchmark classes device time by substrings of kernel
// names, so no name here holds "cudnn", "fprop", "dgrad", "wgrad",
// "convolve", "convolution", "winograd" or "fft" (its library-conv class),
// nor "conv3x3_c64" or "pack_conv3x3_weights" (K2's).
#include "common.cuh"

namespace adunet {
namespace {

constexpr int kThreads = 256;
constexpr int kCK = 8;          // input channels a chunk
constexpr int kOutputs = 16384;  // outputs a block: 256 threads x 8 pixels x 8 channels

// Floats of one staged channel: rows x row, padded to 4 mod 32, so that the
// 8 channels of 4 neighbouring pixels (one warp's 4-byte copies) fall in 32
// different banks, and every row stays 16-byte aligned.
constexpr int channel_stride(int rows, int row) {
  return rows * row + ((4 - rows * row) % 32 + 32) % 32;
}

template <int CO, int WT>
struct Tile {
  static constexpr int kPix = kOutputs / CO;              // output pixels a block
  static constexpr int kR = kPix / WT;                    // output rows a block
  static constexpr int kG = CO / 8;                       // threads across a pixel group's channels
  static constexpr int kRow = WT + 4;                     // staged row; index p holds column x0 + p - 1
  static constexpr int kChan = channel_stride(kR + 2, kRow);
  static constexpr int kIn = kCK * kChan;                 // floats of a staged input chunk
  static constexpr int kW = 9 * kCK * CO;                 // floats of a staged weight chunk
  static constexpr int kStage = kIn + kW;
  static constexpr int kSmemBytes = 2 * kStage * 4;       // double-buffered
  static_assert(kPix % WT == 0 && WT % 8 == 0, "whole 8-pixel groups in whole rows");
  static_assert((kPix / 8) * kG == kThreads, "one thread per 8-pixel x 8-channel tile");
  static_assert(kSmemBytes <= 113 * 1024, "two blocks an SM");
};

// Registers: the 64 accumulators, 10 staged pixels and 8 weights leave room
// for little else under the 128 a thread that two blocks an SM allow, so
// the loop keeps no 64-bit index: offsets within an image (and within the
// pack) are 32-bit (the C entry refuses a shape where they would not fit),
// the copies' sources advance by a chunk's stride, and the epilogue takes
// its coordinates from blockIdx again.
template <int CO, int WT>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_f32_igemm_kernel(const float* __restrict__ x,
                         const float* __restrict__ w,     // [9][C_in][C_out], tap = 3*dy + dx
                         const float* __restrict__ bias,  // [C_out] or null
                         float* __restrict__ y, int H, int W, int Cin, int Cout, int tiles_x,
                         int tiles_y) {
  using T = Tile<CO, WT>;
  extern __shared__ float4 smem_f4[];
  float* smem = reinterpret_cast<float*>(smem_f4);
  constexpr int kQ = CO / 4;                     // 16-byte pieces of a weight row
  constexpr int kWRows = kThreads / kQ;          // weight rows ([tap][ci]) a pass copies
  constexpr int kWPasses = (9 * kCK + kWRows - 1) / kWRows;
  constexpr int kSlab = (T::kR + 2) * (WT + 2);  // staged pixels

  const int tid = threadIdx.x;
  int bid = blockIdx.x;
  const int co_tiles = Cout / CO;
  const int co0 = (bid % co_tiles) * CO;
  bid /= co_tiles;
  const int x0 = (bid % tiles_x) * WT;
  bid /= tiles_x;
  const int y0 = (bid % tiles_y) * T::kR;
  const int b = bid / tiles_y;

  // the copies: this thread stages input channel tid % kCK of every kCK-th
  // slab pixel from tid / kCK, and the 16-byte piece tid % kQ of the weight
  // rows tid / kQ + kWRows * j ([tap][ci], tap = row / kCK)
  const float* xs = x + static_cast<size_t>(b) * H * W * Cin + tid % kCK;
  const int w_row = tid / kQ;
  const float* ws = w + ((w_row / kCK) * Cin + w_row % kCK) * Cout + co0 + 4 * (tid % kQ);
  const int w_step = (kWRows / kCK) * Cin * Cout;  // kWRows rows on: kWRows / kCK taps on
  float* const s_in_copy = smem + (tid % kCK) * T::kChan;
  float* const s_w_copy = smem + T::kIn + w_row * CO + 4 * (tid % kQ);

  // Issues the copies of the chunk at xs / ws into buffer `buf` and commits them.
  auto stage = [&](int buf) {
    const int off = buf * T::kStage;
    for (int pix = tid / kCK; pix < kSlab; pix += kThreads / kCK) {
      const int r = pix / (WT + 2);
      const int p = pix - r * (WT + 2);
      const int yy = y0 + r - 1;
      const int xx = x0 + p - 1;
      const bool inside = yy >= 0 && yy < H && xx >= 0 && xx < W;
      cp_async4_zfill(s_in_copy + off + r * T::kRow + p, xs + (inside ? (yy * W + xx) * Cin : 0),
                      inside ? 4 : 0);
    }
#pragma unroll
    for (int j = 0; j < kWPasses; ++j)
      if (kWRows * j + w_row < 9 * kCK) cp_async16(s_w_copy + off + j * kWRows * CO, ws + j * w_step);
    cp_async_commit();
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  // this thread's outputs: pixels 8 * tx .. + 7 of tile row ty, channels
  // {4g..4g+3} and {CO/2 + 4g..+3} of the tile
  const int a_off = (tid / T::kG / (WT / 8)) * T::kRow + 8 * (tid / T::kG % (WT / 8));
  const int b_off = 4 * (tid % T::kG);
  const int n_chunks = Cin / kCK;
  stage(0);
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) {
      xs += kCK;
      ws += kCK * Cout;
      stage((k + 1) & 1);
      cp_async_wait<1>();  // chunk k has landed; chunk k + 1 stays in flight
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* s_in = smem + (k & 1) * T::kStage + a_off;
    const float* s_w = smem + (k & 1) * T::kStage + T::kIn + b_off;
#pragma unroll 2
    for (int c = 0; c < kCK; ++c) {
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const float* row = s_in + c * T::kChan + dy * T::kRow;
        const float4 a0 = *reinterpret_cast<const float4*>(row);
        const float4 a1 = *reinterpret_cast<const float4*>(row + 4);
        const float2 a2 = *reinterpret_cast<const float2*>(row + 8);
        const float a[10] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w, a2.x, a2.y};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float* wr = s_w + ((dy * 3 + dx) * kCK + c) * CO;
          const float4 b0 = *reinterpret_cast<const float4*>(wr);
          const float4 b1 = *reinterpret_cast<const float4*>(wr + CO / 2);
          const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i + dx], bv[j], acc[i][j]);
        }
      }
    }
    __syncthreads();  // every thread is done with this buffer before it is staged again
  }

  // the epilogue: coordinates from blockIdx again, bias added, 16-byte stores
  const int g = tid % T::kG;
  const int ty = tid / T::kG / (WT / 8);
  const int tx = tid / T::kG % (WT / 8);
  bid = blockIdx.x;
  const int c0 = (bid % co_tiles) * CO + 4 * g;
  bid /= co_tiles;
  const int xx0 = (bid % tiles_x) * WT + 8 * tx;
  bid /= tiles_x;
  const int yy = (bid % tiles_y) * T::kR + ty;
  if (yy >= H) return;
  float blo[4] = {0.f, 0.f, 0.f, 0.f}, bhi[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      blo[j] = bias[c0 + j];
      bhi[j] = bias[c0 + CO / 2 + j];
    }
  }
  float* out = y + (static_cast<size_t>(bid / tiles_y) * H + yy) * W * Cout + c0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (xx0 + i < W) {
      float lo[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        lo[j] = acc[i][j] + blo[j];
        hi[j] = acc[i][4 + j] + bhi[j];
      }
      store_vec<F32, 4>(out + (xx0 + i) * Cout, lo);
      store_vec<F32, 4>(out + (xx0 + i) * Cout + CO / 2, hi);
    }
  }
}

// OIHW (C_out, C_in, 3, 3) float32 -> (9, C_in, C_out): the matrix w[co][k],
// k = 9 * ci + tap, transposed by 32 x 32 tiles through shared memory, so the
// reads run along k and the writes along co, both coalesced.
constexpr int kPackTile = 32;

__global__ void __launch_bounds__(kThreads)
pack_w3x3_f32_kernel(const float* __restrict__ w, float* __restrict__ wp, int Cin, int Cout) {
  __shared__ float tile[kPackTile][kPackTile + 1];
  const int K = 9 * Cin;
  const int k0 = blockIdx.x * kPackTile;
  const int co0 = blockIdx.y * kPackTile;
  const int lane = threadIdx.x % kPackTile;
  const int row = threadIdx.x / kPackTile;
  for (int j = row; j < kPackTile; j += kThreads / kPackTile) {
    const int k = k0 + lane;
    tile[j][lane] = k < K ? w[static_cast<size_t>(co0 + j) * K + k] : 0.f;
  }
  __syncthreads();
  for (int j = row; j < kPackTile; j += kThreads / kPackTile) {
    const int k = k0 + j;
    if (k < K) {
      const int ci = k / 9;
      const int t = k - 9 * ci;
      wp[(static_cast<size_t>(t) * Cin + ci) * Cout + co0 + lane] = tile[lane][j];
    }
  }
}

// The conv kernel for (CO, WT), its dynamic shared-memory limit raised and
// its carveout set to the most shared memory, once per device.
template <int CO, int WT>
cudaError_t launch(const float* x, const float* wp, const float* bias, float* y, int B, int H,
                   int W, int Cin, int Cout, int dev, cudaStream_t stream) {
  using T = Tile<CO, WT>;
  static bool done[kMaxDevices] = {};
  auto kernel = conv3x3_f32_igemm_kernel<CO, WT>;
  if (!done[dev]) {
    cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         T::kSmemBytes);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (e != cudaSuccess) return e;
    done[dev] = true;
  }
  const int tiles_x = (W + WT - 1) / WT;
  const int tiles_y = (H + T::kR - 1) / T::kR;
  const long long blocks = static_cast<long long>(Cout / CO) * tiles_x * tiles_y * B;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  kernel<<<static_cast<unsigned>(blocks), kThreads, T::kSmemBytes, stream>>>(
      x, wp, bias, y, H, W, Cin, Cout, tiles_x, tiles_y);
  return cudaGetLastError();
}

template <int CO>
cudaError_t launch_for_width(const float* x, const float* wp, const float* bias, float* y, int B,
                             int H, int W, int Cin, int Cout, int dev, cudaStream_t stream) {
  if (W <= 32) return launch<CO, 32>(x, wp, bias, y, B, H, W, Cin, Cout, dev, stream);
  if (W <= 64) return launch<CO, 64>(x, wp, bias, y, B, H, W, Cin, Cout, dev, stream);
  return launch<CO, 128>(x, wp, bias, y, B, H, W, Cin, Cout, dev, stream);
}

}  // namespace
}  // namespace adunet

// y: (B, H, W, C_out) float32 NHWC, the 3x3 SAME conv of x: (B, H, W, C_in)
// float32 NHWC with w: OIHW (C_out, C_in, 3, 3) float32, plus bias: (C_out,)
// float32 or null. scratch: 9 * C_in * C_out floats (the packed weights). x,
// y and scratch 16-byte aligned, w and bias 4-byte aligned, all contiguous,
// on CUDA device `device`, which the call makes current if it is not.
// C_in % 8 == 0, C_out % 64 == 0, B, H, W >= 1, H * W * max(C_in, C_out)
// and 9 * C_in * C_out below 2^31. Launches the weight pack,
// then the conv, on `stream`; returns the first CUDA error.
extern "C" int adunet_conv3x3_f32(const void* x, const void* w, const void* bias, void* scratch,
                                  void* y, int B, int H, int W, int Cin, int Cout, int device,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || Cin <= 0 || Cin % adunet::kCK != 0 || Cout <= 0 ||
      Cout % 64 != 0 || device < 0 || device >= adunet::kMaxDevices)
    return cudaErrorInvalidValue;
  // the kernels index within an image, and within the pack, in 32 bits
  const long long pixels = static_cast<long long>(H) * W;
  if (pixels * (Cin > Cout ? Cin : Cout) >= (1LL << 31) || 9LL * Cin * Cout >= (1LL << 31))
    return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto* wp = static_cast<float*>(scratch);
  const dim3 pack_grid((9 * Cin + adunet::kPackTile - 1) / adunet::kPackTile,
                       Cout / adunet::kPackTile);
  adunet::pack_w3x3_f32_kernel<<<pack_grid, adunet::kThreads, 0, st>>>(
      static_cast<const float*>(w), wp, Cin, Cout);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const auto* xf = static_cast<const float*>(x);
  const auto* bf = static_cast<const float*>(bias);
  auto* yf = static_cast<float*>(y);
  return Cout % 128 == 0
             ? adunet::launch_for_width<128>(xf, wp, bf, yf, B, H, W, Cin, Cout, device, st)
             : adunet::launch_for_width<64>(xf, wp, bf, yf, B, H, W, Cin, Cout, device, st);
}
