// Element types and vector loads shared by the port's kernels.
//
// A kernel is written once over a type trait `Tr` (F32 or BF16): `storage` is
// how the element lies in device memory, `to_f` / `from_f` convert it to and
// from the float32 the kernels compute in. bf16 is kept as raw 16-bit words
// (round-to-nearest-even on the way out, as torch's own cast does), so the
// code needs no bf16 arithmetic operators.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace adunet {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

// 32-bit word j (0..3) of a 16-byte vector; j is a constant once unrolled.
__device__ __forceinline__ unsigned word(const uint4& u, int j) {
  return j == 0 ? u.x : j == 1 ? u.y : j == 2 ? u.z : u.w;
}

// `unpack(u, i)`: element i of a 16-byte vector of raw storage words (4
// float32 or 8 bf16, as `*(const uint4*)p` loads them), as float32. A kernel
// that keeps its row as raw words holds bf16 in half the registers, and the
// conversion at each use is exact. `round(f)`: f rounded to the storage type,
// as float32.
struct F32 {
  using storage = float;
  __device__ __forceinline__ static float to_f(float v) { return v; }
  __device__ __forceinline__ static float from_f(float v) { return v; }
  __device__ __forceinline__ static float round(float v) { return v; }
  __device__ __forceinline__ static float unpack(const uint4& u, int i) {
    return __uint_as_float(word(u, i));
  }
};

struct BF16 {
  using storage = unsigned short;
  __device__ __forceinline__ static float to_f(unsigned short u) {
    return __uint_as_float(static_cast<unsigned>(u) << 16);
  }
  __device__ __forceinline__ static unsigned short from_f(float f) {
    return __bfloat16_as_ushort(__float2bfloat16_rn(f));
  }
  __device__ __forceinline__ static float round(float f) { return to_f(from_f(f)); }
  __device__ __forceinline__ static float unpack(const uint4& u, int i) {
    const unsigned w = word(u, i >> 1);  // element 2j is the low half of word j
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
};

template <int kBytes> struct RawVec;
template <> struct RawVec<4> { using type = unsigned int; };
template <> struct RawVec<8> { using type = uint2; };
template <> struct RawVec<16> { using type = uint4; };

// Load N consecutive elements as float32, in vector loads of up to 16 bytes.
// `p` must be aligned to min(16, N * sizeof(storage)) bytes.
template <typename Tr, int N>
__device__ __forceinline__ void load_vec(const typename Tr::storage* p, float (&out)[N]) {
  using S = typename Tr::storage;
  constexpr int kBytes = N * static_cast<int>(sizeof(S));
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(S));
  using R = typename RawVec<kChunk>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    union {
      R raw;
      S e[kPer];
    } u;
    u.raw = *reinterpret_cast<const R*>(p + c * kPer);
#pragma unroll
    for (int i = 0; i < kPer; ++i) out[c * kPer + i] = Tr::to_f(u.e[i]);
  }
}

// Store N float32 values as N consecutive elements (same alignment rule).
template <typename Tr, int N>
__device__ __forceinline__ void store_vec(typename Tr::storage* p, const float (&in)[N]) {
  using S = typename Tr::storage;
  constexpr int kBytes = N * static_cast<int>(sizeof(S));
  constexpr int kChunk = kBytes < 16 ? kBytes : 16;
  constexpr int kPer = kChunk / static_cast<int>(sizeof(S));
  using R = typename RawVec<kChunk>::type;
#pragma unroll
  for (int c = 0; c < N / kPer; ++c) {
    union {
      R raw;
      S e[kPer];
    } u;
#pragma unroll
    for (int i = 0; i < kPer; ++i) u.e[i] = Tr::from_f(in[c * kPer + i]);
    *reinterpret_cast<R*>(p + c * kPer) = u.raw;
  }
}

// ---------------------------------------------------------------- cp.async
// Asynchronous copies from device to shared memory (sm_80 and later): 16
// bytes through L2 only, or 4 bytes through L1; `cp_async4_zfill` copies
// `src_bytes` (4 or 0) of them and fills the rest of the 4 with zeros, so an
// element outside the image is staged as 0 with no branch around the copy.
// A thread's copies since its last commit form a group; `cp_async_wait<N>`
// waits until at most N of its groups are in flight.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// ---------------------------------------------------------------- column sums
// The second pass of K1's backward's deterministic reduction: each
// block of the first pass wrote one float32 partial row, and column j of the
// result is the sum over rows p < n_parts of partial[p * stride + j], in a
// fixed order. A block of 32 x kColSlices threads owns 32 columns from
// `col0 + 32 * blockIdx.x`; thread (slice, lane) sums the rows p = slice,
// slice + 32, ... of its column in order of p, and slice 0 then adds the 32
// slices in order and hands the sum to `store(j, sum)`. (One thread per
// column walking every partial in turn is a chain of dependent loads, ~50 us
// at ~1,000 partials.) Columns at or past `col0 + width` are skipped.
constexpr int kColSlices = 32;

template <typename Store>
__device__ __forceinline__ void column_sum(const float* __restrict__ partial, int n_parts,
                                           size_t stride, int col0, int width, Store store) {
  __shared__ float s_sum[kColSlices][33];
  const int lane = threadIdx.x & 31;
  const int slice = threadIdx.x >> 5;
  const int j = col0 + blockIdx.x * 32 + lane;
  const bool live = j < col0 + width;
  float s = 0.f;
  if (live) {
#pragma unroll 4
    for (int p = slice; p < n_parts; p += kColSlices) s += partial[static_cast<size_t>(p) * stride + j];
  }
  s_sum[slice][lane] = s;
  __syncthreads();
  if (slice == 0 && live) {
    float t = 0.f;
#pragma unroll
    for (int i = 0; i < kColSlices; ++i) t += s_sum[i][lane];
    store(j, t);
  }
}

// ---------------------------------------------------------------- host side

constexpr int kMaxDevices = 64;

// The SM count of device `dev`, queried once per device.
inline cudaError_t sm_count(int dev, int* n) {
  static int cache[kMaxDevices] = {};
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (cache[dev] == 0) {
    int sms = 0;
    const cudaError_t e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    cache[dev] = sms;
  }
  *n = cache[dev];
  return cudaSuccess;
}

// The current device (which the C entry made the tensors') and its SM count.
inline cudaError_t device_sms(int* dev, int* sms) {
  cudaError_t e = cudaGetDevice(dev);
  if (e == cudaSuccess) e = sm_count(*dev, sms);
  return e;
}

// Makes `device` (the tensors' device, which the caller passes) current for a
// launch where it is not, and the caller's device current again after: the
// Python wrappers then need no device context of their own. Where `device`
// is already current (the common case) it costs one cudaGetDevice.
class DeviceScope {
 public:
  explicit DeviceScope(int device) : error_(cudaGetDevice(&prev_)) {
    if (error_ == cudaSuccess && prev_ != device) {
      error_ = cudaSetDevice(device);
      switched_ = error_ == cudaSuccess;
    }
  }
  ~DeviceScope() {
    if (switched_) cudaSetDevice(prev_);
  }
  DeviceScope(const DeviceScope&) = delete;
  DeviceScope& operator=(const DeviceScope&) = delete;
  cudaError_t error() const { return error_; }

 private:
  int prev_ = 0;
  cudaError_t error_;
  bool switched_ = false;
};

}  // namespace adunet
