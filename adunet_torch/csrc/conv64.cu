// K2: 3x3 stride-1 SAME convolution plus bias, NHWC, C_in = C_out = 64.
//
// Replaces the Pallas TPU kernel adunet/kernels/conv64.py:132
// `conv3x3_same_pallas` (pl.pallas_call at :154, body `_kernel` at :67).
// Same function: zero outside the image, float32 accumulation of the 9 taps,
// bias added, output in the input type (float32 or bf16).
//
// Bound on an H100: operations. 2*9*64*64 = 73,728 FLOP per output pixel
// against 2*64*sizeof(T) bytes. In float32 (computed as full-precision FMAs,
// no TF32) the floor is FLOP / 67 TFLOP/s; for bf16 inputs the type's peak
// is the tensor cores' 989 TFLOP/s, where bytes and operations tie.
//
// Design (a direct implicit GEMM on CUDA cores, no tensor cores yet): a
// block computes a 2-row x 128-column x 64-channel output tile. Per pass it
// stages 8 input channels of the tile plus its 1-pixel halo in shared
// memory, transposed to [channel][row][column] and zero outside the image,
// with the 9 taps' weights for those channels. Each of the 256 threads owns
// 8 consecutive pixels x 8 output channels (64 float32 accumulators in
// registers): for one (channel, tap row) it reads 10 staged pixels once and
// reuses them for the three column taps, so each shared-memory load feeds
// ~20 FMAs. The thread's channels are {4g..4g+3} and {32+4g..32+4g+3}, which
// keeps the weight loads of a warp free of bank conflicts.
#include "common.cuh"

namespace adunet {
namespace {

constexpr int kC = 64;            // input and output channels
constexpr int kTH = 2;            // output rows per block
constexpr int kTW = 128;          // output columns per block
constexpr int kCK = 8;            // input channels staged per pass
constexpr int kRow = kTW + 4;     // staged row; index p holds column x0 + p - 1
constexpr int kThreads = 256;
static_assert((kTH * kTW / 8) * 8 == kThreads, "one thread per 8-pixel x 8-channel tile");

template <typename Tr>
__global__ void __launch_bounds__(kThreads, 2)
conv3x3_c64_kernel(const typename Tr::storage* __restrict__ x,
                   const float* __restrict__ w,     // [9][64 ci][64 co], tap = 3*dy + dx
                   const float* __restrict__ bias,  // [64]
                   typename Tr::storage* __restrict__ y, int H, int W) {
  using S = typename Tr::storage;
  __shared__ __align__(16) float s_in[kCK][kTH + 2][kRow];
  __shared__ __align__(16) float s_w[9][kCK][kC];

  const int tid = threadIdx.x;
  const int g = tid & 7;
  const int pg = tid >> 3;
  const int ty = pg / (kTW / 8);
  const int tx = pg % (kTW / 8);
  const int x0 = blockIdx.x * kTW;
  const int y0 = blockIdx.y * kTH;
  const size_t img = static_cast<size_t>(blockIdx.z) * H * W * kC;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int c0 = 0; c0 < kC; c0 += kCK) {
    for (int pos = tid; pos < (kTH + 2) * (kTW + 2); pos += kThreads) {
      const int r = pos / (kTW + 2);
      const int p = pos - r * (kTW + 2);
      const int yy = y0 + r - 1;
      const int xx = x0 + p - 1;
      float v[kCK];
      if (yy >= 0 && yy < H && xx >= 0 && xx < W) {
        load_vec<Tr, kCK>(x + img + (static_cast<size_t>(yy) * W + xx) * kC + c0, v);
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
    S* out = y + img + (static_cast<size_t>(yy) * W + xx) * kC;
    float lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = acc[i][j] + blo[j];
      hi[j] = acc[i][4 + j] + bhi[j];
    }
    store_vec<Tr, 4>(out + 4 * g, lo);
    store_vec<Tr, 4>(out + 32 + 4 * g, hi);
  }
}

template <typename Tr>
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int B, int H, int W,
                   cudaStream_t stream) {
  const dim3 grid(W / kTW, H / kTH, B);
  conv3x3_c64_kernel<Tr><<<grid, kThreads, 0, stream>>>(
      static_cast<const typename Tr::storage*>(x), static_cast<const float*>(w),
      static_cast<const float*>(bias), static_cast<typename Tr::storage*>(y), H, W);
  return cudaGetLastError();
}

}  // namespace
}  // namespace adunet

// x, y: contiguous NHWC (B, H, W, 64) of `dtype` (0 float32, 1 bf16); w:
// float32 [9][64][64] packed as (tap, c_in, c_out); bias: float32 (64,). All
// pointers 16-byte aligned; H % 2 == 0 and W % 128 == 0 (the Python gate
// `supported` is stricter). Returns the launch's CUDA error.
extern "C" int adunet_conv3x3_c64(const void* x, const void* w, const void* bias, void* y, int B,
                                  int H, int W, int dtype, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || H % adunet::kTH != 0 || W % adunet::kTW != 0)
    return cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case adunet::kFloat32:
      return adunet::launch<adunet::F32>(x, w, bias, y, B, H, W, st);
    case adunet::kBFloat16:
      return adunet::launch<adunet::BF16>(x, w, bias, y, B, H, W, st);
    default:
      return cudaErrorInvalidValue;
  }
}
