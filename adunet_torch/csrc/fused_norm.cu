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
// Design: each lane loads 16-byte vectors (V = 4 float32 or 8 bf16 values),
// so a warp's load is one coalesced run of 512 bytes. A row of C elements is
// held by L = min(32, C / V) lanes, K vectors each, and a warp holds 32 / L
// consecutive rows (C < 32 * V: C <= 64 in float32, C <= 128 in bf16), eight
// warps to a 256-thread block. The row stays in registers between the two
// warp reductions (the mean, then the mean of squared deviations, as the
// reference computes them), so x is read from device memory once and y
// written once. The reductions are butterflies over lane offsets below L,
// which never cross from one row's lanes to another's; C is a compile-time
// constant (16..2048), so the loops fully unroll.
//
// Conv bias (the `kBias` instantiations): where x is a library conv's output
// left without its bias, the kernel adds the bias (in x's type, as the conv
// would have taken it) to each 16-byte vector as it loads it (`plus_bias`),
// bit for bit as PyTorch's add after the conv did, and the backward sums dx
// over the rows as the bias's gradient. The conv's output is then read once,
// by this kernel, instead of a broadcast add's read and write first.
#include "common.cuh"

namespace adunet {
namespace {

constexpr int kWarpsPerBlock = 8;

// The split of a row of C elements of type S over the lanes: V elements per
// 16-byte vector load, L lanes per row (32, or fewer for a narrow row), K
// loads per lane. The forward and the backward kernel share it.
template <typename S, int C>
struct RowSplit {
  static constexpr int V = 16 / static_cast<int>(sizeof(S));
  static constexpr int L = C / V < 32 ? C / V : 32;
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

// A lane's K x V elements of a row, as float32 values (the forward) or as
// raw 16-byte words converted exactly at each use (the backward).
template <int K, int V>
struct FloatRow {
  const float (&v)[K][V];
  __device__ __forceinline__ float operator()(int k, int i) const { return v[k][i]; }
};

template <typename Tr, int K>
struct RawRow {
  const uint4 (&w)[K];
  __device__ __forceinline__ float operator()(int k, int i) const { return Tr::unpack(w[k], i); }
};

// Mean and rsqrt(biased variance + eps) of a row held by L lanes, V x K
// elements per lane, element (k, i) of this lane being at(k, i): the mean
// first, then the mean of squared deviations, as the reference computes
// them. The forward and the backward kernel both call this at the same split
// (one on a FloatRow, the other on a RawRow), so they add the same values in
// one order and the backward's ReLU mask is the forward kernel's bit for bit.
template <int V, int K, int L, typename At>
__device__ __forceinline__ void row_stats(const At& at, float eps, float& mean, float& rstd) {
  constexpr int C = L * V * K;
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) s += at(k, i);
  mean = row_sum<L>(s) / C;

  float q = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k)
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float d = at(k, i) - mean;
      q += d * d;
    }
  rstd = rsqrtf(row_sum<L>(q) / C + eps);
}

// A 16-byte vector of x's raw storage words plus the same vector of the
// bias's, element by element, as raw words: PyTorch's add of two tensors of
// x's type, the sum taken in float32 and rounded once to that type. In bf16
// that is one rounded bf16 add (`__hadd2`, two elements an instruction):
// where the two exponents differ by 15 or less the float32 sum is exact, and
// beyond that the smaller term lies within a quarter ulp of the larger, so
// both round to the larger. The forward and the backward kernel both add
// the bias by it, so the backward recomputes the forward's row bit for bit.
template <typename Tr>
__device__ __forceinline__ uint4 plus_bias(const uint4& w, const uint4& b) {
  uint4 out;
  unsigned* const o = reinterpret_cast<unsigned*>(&out);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if constexpr (sizeof(typename Tr::storage) == 4) {
      o[j] = __float_as_uint(__uint_as_float(word(w, j)) + __uint_as_float(word(b, j)));
    } else {  // two bf16 a word
      const unsigned wj = word(w, j), bj = word(b, j);
      const __nv_bfloat162 s = __hadd2(reinterpret_cast<const __nv_bfloat162&>(wj),
                                       reinterpret_cast<const __nv_bfloat162&>(bj));
      o[j] = reinterpret_cast<const unsigned&>(s);
    }
  }
  return out;
}

template <typename Tr, int V, int K, int L, bool kBias>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
layer_norm_relu_kernel(const typename Tr::storage* __restrict__ x,
                       const float* __restrict__ gamma,
                       const float* __restrict__ beta,
                       const typename Tr::storage* __restrict__ bias,  // kBias: (C,)
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
      const int c0 = (k * L + sub) * V;
      if constexpr (kBias) {
        const uint4 w = plus_bias<Tr>(*reinterpret_cast<const uint4*>(x + row * C + c0),
                                      *reinterpret_cast<const uint4*>(bias + c0));
#pragma unroll
        for (int i = 0; i < V; ++i) v[k][i] = Tr::unpack(w, i);
      } else {
        load_vec<Tr, V>(x + row * C + c0, v[k]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < V; ++i) v[k][i] = 0.f;
    }
  }

  float mean, rstd;
  row_stats<V, K, L>(FloatRow<K, V>{v}, eps, mean, rstd);
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

template <typename Tr, int C, bool kBias>
void launch(const void* x, const void* gamma, const void* beta, const void* bias, void* y,
            long long rows, float eps, cudaStream_t stream) {
  using Sp = RowSplit<typename Tr::storage, C>;
  constexpr long long kRowsPerBlock = kWarpsPerBlock * (32 / Sp::L);
  const unsigned blocks = static_cast<unsigned>((rows + kRowsPerBlock - 1) / kRowsPerBlock);
  layer_norm_relu_kernel<Tr, Sp::V, Sp::K, Sp::L, kBias>
      <<<blocks, kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const typename Tr::storage*>(x), static_cast<const float*>(gamma),
          static_cast<const float*>(beta), static_cast<const typename Tr::storage*>(bias),
          static_cast<typename Tr::storage*>(y), rows, eps);
}

template <typename Tr, bool kBias>
cudaError_t dispatch(const void* x, const void* gamma, const void* beta, const void* bias,
                     void* y, long long rows, int C, float eps, cudaStream_t stream) {
  switch (C) {
    case 16: launch<Tr, 16, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 32: launch<Tr, 32, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 64: launch<Tr, 64, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 128: launch<Tr, 128, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 256: launch<Tr, 256, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 512: launch<Tr, 512, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 1024: launch<Tr, 1024, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
    case 2048: launch<Tr, 2048, kBias>(x, gamma, beta, bias, y, rows, eps, stream); break;
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
//   dgamma = sum over rows of gm*xhat,   dbeta = sum over rows of gm,
// and (kBias) dbias = sum over rows of dx as stored, rounded to x's type:
// the conv bias's gradient, x being the conv's output before its bias
// (`plus_bias`).
//
// Bound on an H100: bytes. x and g are read once and dx written once, 3 *
// sizeof(T) bytes per element (0.805 GB, 0.24 ms, at 2,097,152 x 64 bf16);
// the (2, C) or (3, C) parameter sums are noise beside that.
//
// Design: the forward's split (`RowSplit`) and its statistics code
// (`row_stats`), so the ReLU mask is the forward kernel's bit for bit. A warp
// loads R row slots of x and g as raw 16-byte words (bf16 stays packed two to
// a register) before it reduces any of them, so enough loads are in flight
// to cover the memory latency; then three passes over the registers: the
// statistics, the mask with the dgamma / dbeta terms and the two row means,
// and dx, each recomputing xhat and the mask from the raw words rather than
// holding them as float32. With a conv bias, each vector of x's raw words
// has the bias added once (`plus_bias`) after the loads, so the passes
// read the forward's row as they would without one; dbias's terms are added
// in the dx pass.
// dgamma / dbeta (and dbias) are a deterministic two-level sum without atomics. Each lane
// owns its columns' partial sums over the rows its warp walks (a grid-stride
// loop over a grid sized to the blocks that fit on the card at once):
//  - C <= 512 (C <= 256 with a bias): in registers, with gamma / beta held
//    there too; a narrow-row warp adds its 32 / L row groups' partials by a
//    butterfly in a fixed order at the end, and each warp writes its sums to
//    its own slice of shared memory;
//  - C >= 1024 (32 or more columns per lane, which would not fit in
//    registers beside the row), and C = 512 with a bias (whose third sum in
//    registers took 164 of them, so one block an SM, and a third more time):
//    in the warp's own [2][C] ([3][C] with a bias) float32 slice of shared
//    memory, laid out lane-major so a lane's float4 read-modify-write
//    is free of bank conflicts, with gamma / beta staged in shared memory in
//    the same layout. The R rows' terms are added in registers first, so a
//    slot is read and written once per R rows. A block's slices and
//    parameters take 72 KB at C = 1024 and 144 KB at C = 2048 (104 and 208
//    KB with a bias), so one or two blocks fit on an SM with the registers
//    the row takes: 8 or 16 warps,
//    each with a whole row of x and g in flight. (The same sums in registers
//    took all 255 and spilled 824-880 bytes of stack a lane at C = 2048.)
// The block then adds its warps' slices in warp order (one barrier) and
// writes one (2, C) or (3, C) partial; a second small kernel adds the blocks' partials
// in a fixed order. The caller's scratch holds kBwdMaxBlocksPerSm partials
// per SM (`bwd_max_blocks`), the most the grid can have.

template <typename Tr, int C, bool kBias>
struct BwdShape {
  using Sp = RowSplit<typename Tr::storage, C>;
  static constexpr int NS = kBias ? 3 : 2;  // column sums: dgamma, dbeta (, dbias)
  static constexpr int V = Sp::V, K = Sp::K, L = Sp::L;
  static constexpr int G = 32 / L;  // rows per warp in one row slot
  static constexpr int H = V / 4;   // float4 groups per vector
  // the partials live in shared memory (above)
  static constexpr bool kShared = K * V >= (kBias ? 16 : 32);
  // row slots in flight: two where a lane's registers hold both beside the
  // rest (its raw words of x and g; at C <= 512 its parameters and partials)
  static constexpr int R = (kShared ? K <= 4 : K == 1) ? 2 : 1;
  // the warps' [NS][C] slices, then (kShared) gamma and beta
  static constexpr int kSmemBytes = (kWarpsPerBlock * NS * C + (kShared ? 2 * C : 0)) * 4;
  // __launch_bounds__'s blocks an SM (0: none, ptxas's own register
  // target). With a bias at C = 256 in float32 that target (80 registers)
  // spilled 4 bytes; two blocks an SM let it take 96 and spill none.
  static constexpr int kMinBlocks = kBias && V == 4 && C == 256 ? 2 : 0;
};

// gamma and beta of a lane's vector k, float4 group h: from the staged copy
// in shared memory (kShared) or from the lane's registers.
template <bool kShared, int KR, int V, int H>
__device__ __forceinline__ void lane_params(const float4* s_ga, const float4* s_be,
                                            const float (&ga)[KR][V], const float (&be)[KR][V],
                                            int k, int h, int lane, float (&gam)[4],
                                            float (&bet)[4]) {
  if constexpr (kShared) {
    const float4 a = s_ga[(k * H + h) * 32 + lane], b = s_be[(k * H + h) * 32 + lane];
    gam[0] = a.x, gam[1] = a.y, gam[2] = a.z, gam[3] = a.w;
    bet[0] = b.x, bet[1] = b.y, bet[2] = b.z, bet[3] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) gam[e] = ga[k][4 * h + e], bet[e] = be[k][4 * h + e];
  }
}

template <typename Tr, int C, bool kBias>
__global__ void __launch_bounds__(kWarpsPerBlock * 32, (BwdShape<Tr, C, kBias>::kMinBlocks))
layer_norm_relu_bwd_rows_kernel(const typename Tr::storage* __restrict__ x,
                                const typename Tr::storage* __restrict__ g,
                                const float* __restrict__ gamma,
                                const float* __restrict__ beta,
                                const typename Tr::storage* __restrict__ bias,  // kBias
                                typename Tr::storage* __restrict__ dx,
                                float* __restrict__ partial,  // [gridDim.x][NS][C]
                                long long rows, float eps) {
  using B = BwdShape<Tr, C, kBias>;
  constexpr int V = B::V, K = B::K, L = B::L, G = B::G, H = B::H, R = B::R, NS = B::NS;
  constexpr int W = kWarpsPerBlock;
  constexpr bool kShared = B::kShared;
  constexpr int C4 = C / 4;  // float4 slots of one [C] row of a slice
  extern __shared__ float4 smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int sub = lane % L;
  const int grp = lane / L;

  // kShared: this warp's partial slots and the staged parameters, slot
  // (k, h) of lane l at (k * H + h) * 32 + l, holding columns
  // (k * 32 + l) * V + 4h .. + 3
  float4* const s_pg = smem + warp * NS * C4;
  float4* const s_pb = s_pg + C4;
  float4* const s_pd = s_pb + C4;  // kBias
  float4* const s_ga = smem + W * NS * C4;
  float4* const s_be = s_ga + C4;
  // otherwise: this lane's parameters and partial sums in registers
  constexpr int KR = kShared ? 1 : K;
  float ga[KR][V], be[KR][V], pg[KR][V], pb[KR][V], pd[KR][V];

  if constexpr (kShared) {
#pragma unroll
    for (int j = 0; j < K * H; ++j) {
      s_pg[j * 32 + lane] = s_pb[j * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
      if constexpr (kBias) s_pd[j * 32 + lane] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
    for (int j = threadIdx.x; j < C4; j += W * 32) {
      const int c = ((j / 32 / H) * 32 + j % 32) * V + (j / 32 % H) * 4;
      s_ga[j] = *reinterpret_cast<const float4*>(gamma + c);
      s_be[j] = *reinterpret_cast<const float4*>(beta + c);
    }
    __syncthreads();
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int c0 = (k * L + sub) * V;
      load_vec<F32, V>(gamma + c0, ga[k]);
      load_vec<F32, V>(beta + c0, be[k]);
#pragma unroll
      for (int i = 0; i < V; ++i) pg[k][i] = pb[k][i] = pd[k][i] = 0.f;
    }
  }

  const long long stride = static_cast<long long>(gridDim.x) * W * R * G;
  for (long long row0 = (static_cast<long long>(blockIdx.x) * W + warp) * R * G; row0 < rows;
       row0 += stride) {
    uint4 xr[R][K], gr[R][K];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const long long row = row0 + r * G + grp;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        if (row < rows) {
          const long long off = row * C + (k * L + sub) * V;
          xr[r][k] = *reinterpret_cast<const uint4*>(x + off);
          gr[r][k] = *reinterpret_cast<const uint4*>(g + off);
        } else {  // a row past the end: zeros, which add 0 to every sum
          xr[r][k] = gr[r][k] = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    if constexpr (kBias) {
      // the forward's row; one past the end keeps its zero cotangent, so
      // its dx is 0 and it still adds 0 to every sum
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int k = 0; k < K; ++k)
          xr[r][k] = plus_bias<Tr>(xr[r][k],
                                   *reinterpret_cast<const uint4*>(bias + (k * L + sub) * V));
    }

    float mean[R], rstd[R], s1[R], s2[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      row_stats<V, K, L>(RawRow<Tr, K>{xr[r]}, eps, mean[r], rstd[r]);
      s1[r] = s2[r] = 0.f;
    }

    // the mask, the dgamma / dbeta terms and the sums of the two row means
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float gam[4], bet[4], tg[4] = {0.f, 0.f, 0.f, 0.f}, tb[4] = {0.f, 0.f, 0.f, 0.f};
        lane_params<kShared, KR, V, H>(s_ga, s_be, ga, be, k, h, lane, gam, bet);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * h + e;
            const float xh = (Tr::unpack(xr[r][k], i) - mean[r]) * rstd[r];
            const float pre = xh * gam[e] + bet[e];  // the forward's expression
            const float gm = pre > 0.f ? Tr::unpack(gr[r][k], i) : 0.f;
            if constexpr (kShared) {
              tg[e] += gm * xh;
              tb[e] += gm;
            } else {
              pg[k][i] += gm * xh;
              pb[k][i] += gm;
            }
            const float gg = gm * gam[e];
            s1[r] += gg;
            s2[r] += gg * xh;
          }
        if constexpr (kShared) {
          const int j = (k * H + h) * 32 + lane;
          float4 a = s_pg[j], b = s_pb[j];
          a.x += tg[0], a.y += tg[1], a.z += tg[2], a.w += tg[3];
          b.x += tb[0], b.y += tb[1], b.z += tb[2], b.w += tb[3];
          s_pg[j] = a, s_pb[j] = b;
        }
      }
    float mg[R], mgx[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      mg[r] = row_sum<L>(s1[r]) / C;
      mgx[r] = row_sum<L>(s2[r]) / C;
    }

    // dx, and (kBias) the dbias terms: dx as stored
#pragma unroll
    for (int k = 0; k < K; ++k) {
      float o[R][V];
#pragma unroll
      for (int h = 0; h < H; ++h) {
        float gam[4], bet[4], td[4] = {0.f, 0.f, 0.f, 0.f};
        lane_params<kShared, KR, V, H>(s_ga, s_be, ga, be, k, h, lane, gam, bet);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * h + e;
            const float xh = (Tr::unpack(xr[r][k], i) - mean[r]) * rstd[r];
            const float pre = xh * gam[e] + bet[e];
            const float gg = (pre > 0.f ? Tr::unpack(gr[r][k], i) : 0.f) * gam[e];
            o[r][i] = (gg - mg[r] - xh * mgx[r]) * rstd[r];
            if constexpr (kBias) {
              if constexpr (kShared) {
                td[e] += Tr::round(o[r][i]);
              } else {
                pd[k][i] += Tr::round(o[r][i]);
              }
            }
          }
        if constexpr (kBias && kShared) {
          const int j = (k * H + h) * 32 + lane;
          float4 d = s_pd[j];
          d.x += td[0], d.y += td[1], d.z += td[2], d.w += td[3];
          s_pd[j] = d;
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const long long row = row0 + r * G + grp;
        if (row < rows) store_vec<Tr, V>(dx + row * C + (k * L + sub) * V, o[r]);
      }
    }
  }

  float* const out = partial + static_cast<size_t>(blockIdx.x) * NS * C;
  if constexpr (kShared) {
    __syncthreads();
    for (int j = threadIdx.x; j < NS * C4; j += W * 32) {  // in warp order: the same every run
      float4 t = smem[j];
#pragma unroll
      for (int w = 1; w < W; ++w) {
        const float4 u = smem[w * NS * C4 + j];
        t.x += u.x, t.y += u.y, t.z += u.z, t.w += u.w;
      }
      const int jj = j % C4;
      const int c = ((jj / 32 / H) * 32 + jj % 32) * V + (jj / 32 % H) * 4;
      *reinterpret_cast<float4*>(out + (j / C4) * C + c) = t;
    }
  } else {
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
          if constexpr (kBias) pd[k][i] += __shfl_xor_sync(0xffffffffu, pd[k][i], o);
        }
    float* const slice = reinterpret_cast<float*>(smem) + warp * NS * C;
    if (grp == 0) {
#pragma unroll
      for (int k = 0; k < K; ++k)
#pragma unroll
        for (int i = 0; i < V; ++i) {
          slice[(k * L + sub) * V + i] = pg[k][i];
          slice[C + (k * L + sub) * V + i] = pb[k][i];
          if constexpr (kBias) slice[2 * C + (k * L + sub) * V + i] = pd[k][i];
        }
    }
    __syncthreads();
    const float* const all = reinterpret_cast<const float*>(smem);
    for (int j = threadIdx.x; j < NS * C; j += W * 32) {  // in warp order
      float t = all[j];
#pragma unroll
      for (int w = 1; w < W; ++w) t += all[w * NS * C + j];
      out[j] = t;
    }
  }
}

// dgamma / dbeta (/ dbias): the column sums of the blocks' (NS, C) partials,
// in a fixed order (`column_sum`, common.cuh): dgamma / dbeta to `out` in
// float32, dbias to `dbias` in the storage type, as the conv's bias
// gradient was.
template <typename Tr>
__global__ void __launch_bounds__(32 * kColSlices)
layer_norm_relu_bwd_cols_kernel(const float* __restrict__ partial, int n_parts, int C, int width,
                                float* __restrict__ out, typename Tr::storage* __restrict__ dbias) {
  column_sum(partial, n_parts, width, 0, width, [out, dbias, C](int j, float v) {
    if (j < 2 * C) {
      out[j] = v;
    } else {
      dbias[j - 2 * C] = Tr::from_f(v);
    }
  });
}

// The backward's grid holds at most this many blocks per SM (fewer where
// fewer fit), so its scratch holds this many (NS, C) partials per SM.
constexpr int kBwdMaxBlocksPerSm = 8;

// The number of (NS, C) partials the backward's scratch must hold on the
// current device: the most blocks its grid can have.
cudaError_t bwd_max_blocks(int* blocks) {
  int dev = 0, sms = 0;
  const cudaError_t e = device_sms(&dev, &sms);
  *blocks = kBwdMaxBlocksPerSm * sms;
  return e;
}

template <typename Tr, int C, bool kBias>
cudaError_t launch_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                       const void* bias, void* dx, void* dparams, void* dbias, void* partial,
                       long long rows, float eps, cudaStream_t stream) {
  using S = typename Tr::storage;
  using B = BwdShape<Tr, C, kBias>;
  void (*const kernel)(const S*, const S*, const float*, const float*, const S*, S*, float*,
                       long long, float) = layer_norm_relu_bwd_rows_kernel<Tr, C, kBias>;
  // blocks of this kernel that fit on one SM at once, per device (0: not yet asked)
  static int per_sm[kMaxDevices] = {};
  int dev = 0, sms = 0;
  cudaError_t e = device_sms(&dev, &sms);
  if (e != cudaSuccess) return e;
  if (per_sm[dev] == 0) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, B::kSmemBytes);
    int n = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kWarpsPerBlock * 32,
                                                        B::kSmemBytes);
    if (e != cudaSuccess) return e;
    per_sm[dev] = n < 1 ? 1 : n < kBwdMaxBlocksPerSm ? n : kBwdMaxBlocksPerSm;
  }
  constexpr long long kRowsPerBlock = kWarpsPerBlock * B::R * B::G;
  const long long want = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  const long long fit = static_cast<long long>(per_sm[dev]) * sms;
  const int blocks = static_cast<int>(want < fit ? want : fit);
  kernel<<<blocks, kWarpsPerBlock * 32, B::kSmemBytes, stream>>>(
      static_cast<const S*>(x), static_cast<const S*>(g), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<const S*>(bias), static_cast<S*>(dx),
      static_cast<float*>(partial), rows, eps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  layer_norm_relu_bwd_cols_kernel<Tr><<<(B::NS * C + 31) / 32, 32 * kColSlices, 0, stream>>>(
      static_cast<const float*>(partial), blocks, C, B::NS * C, static_cast<float*>(dparams),
      static_cast<S*>(dbias));
  return cudaGetLastError();
}

template <typename Tr, bool kBias>
cudaError_t dispatch_bwd(const void* x, const void* g, const void* gamma, const void* beta,
                         const void* bias, void* dx, void* dparams, void* dbias, void* partial,
                         long long rows, int C, float eps, cudaStream_t stream) {
  switch (C) {
#define ADUNET_BWD_CASE(c)                                                                   \
  case c:                                                                                    \
    return launch_bwd<Tr, c, kBias>(x, g, gamma, beta, bias, dx, dparams, dbias, partial, rows, \
                                    eps, stream);
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
}

}  // namespace
}  // namespace adunet

// Writes to *n (an int) the number of (2, C) float32 partials that
// adunet_layer_norm_relu_backward's scratch must hold on the current device
// (the same for every C and type). Returns the CUDA error.
extern "C" int adunet_layer_norm_relu_backward_partials(void* n) {
  return adunet::bwd_max_blocks(static_cast<int*>(n));
}

// x, g (the output cotangent), dx: contiguous (rows, C) of `dtype` (0
// float32, 1 bf16); gamma, beta: float32 (C,); bias: the conv's (C,) of
// `dtype` that x is to have added (the forward's `bias`), or null; dparams:
// float32 (2, C) out, dgamma then dbeta; dbias: (C,) of `dtype` out, the
// bias's gradient (with a bias); partial: float32 scratch of
// (adunet_layer_norm_relu_backward_partials(), NS, C), NS = 2, or 3 with a
// bias (the wrapper takes dparams and partial from one allocation). All
// pointers 16-byte aligned, on CUDA device `device`, which the call makes
// current if it is not. Returns the launches' CUDA error.
extern "C" int adunet_layer_norm_relu_backward(const void* x, const void* g, const void* gamma,
                                               const void* beta, const void* bias, void* dx,
                                               void* dparams, void* dbias, void* partial,
                                               long long rows, int C, float eps, int dtype,
                                               int device, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#define ADUNET_BWD_DTYPE(code, Tr)                                                            \
  case code:                                                                                  \
    return bias ? adunet::dispatch_bwd<Tr, true>(x, g, gamma, beta, bias, dx, dparams, dbias, \
                                                 partial, rows, C, eps, st)                   \
                : adunet::dispatch_bwd<Tr, false>(x, g, gamma, beta, bias, dx, dparams,       \
                                                  dbias, partial, rows, C, eps, st);
    ADUNET_BWD_DTYPE(adunet::kFloat32, adunet::F32)
    ADUNET_BWD_DTYPE(adunet::kBFloat16, adunet::BF16)
#undef ADUNET_BWD_DTYPE
    default:
      return cudaErrorInvalidValue;
  }
}

// x, y: contiguous (rows, C) of `dtype` (0 float32, 1 bf16); gamma, beta:
// float32 (C,); bias: a conv's (C,) of `dtype` to add to x first
// (`plus_bias`), or null. All pointers 16-byte aligned, on CUDA device
// `device`, which the call makes current if it is not. Returns the launch's
// CUDA error.
extern "C" int adunet_layer_norm_relu(const void* x, const void* gamma, const void* beta,
                                      const void* bias, void* y, long long rows, int C,
                                      float eps, int dtype, int device, void* stream) {
  if (rows <= 0) return cudaErrorInvalidValue;
  const adunet::DeviceScope scope(device);
  if (scope.error() != cudaSuccess) return scope.error();
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
#define ADUNET_FWD_DTYPE(code, Tr)                                                          \
  case code:                                                                                \
    return bias ? adunet::dispatch<Tr, true>(x, gamma, beta, bias, y, rows, C, eps, st)     \
                : adunet::dispatch<Tr, false>(x, gamma, beta, bias, y, rows, C, eps, st);
    ADUNET_FWD_DTYPE(adunet::kFloat32, adunet::F32)
    ADUNET_FWD_DTYPE(adunet::kBFloat16, adunet::BF16)
#undef ADUNET_FWD_DTYPE
    default:
      return cudaErrorInvalidValue;
  }
}

// Message for a code returned by any entry point of this library.
extern "C" const char* adunet_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
