// A probe of Hopper's wgmma, behind the design of K2's bf16 kernels
// (adunet_torch/csrc/conv64.cu). Two questions:
//
// 1. May a shared-memory matrix descriptor (128-byte swizzle) start at any
//    128-byte row of a 1024-byte aligned buffer, i.e. at a tap's pixel
//    shift? `probe_desc` runs one m64n64k16 x 4 K-steps product of a
//    64-row window of X, shifted by 0..7 rows, with W, through: SS with the
//    descriptor's base offset 0 or the start address's row bits; RS from
//    ldmatrix (K2's first bf16 design); A and B swapped; B MN-major. Each
//    `[desc]` line gives the largest error against a float64 product and
//    whether the result is bit-equal to the RS one.
// 2. What rate do the tensor cores reach for m64n64k16 with both operands
//    from shared memory, against RS with constant A and against m64n128k16?
//    `bench` keeps every SM busy with 1 or 2 warpgroups; each `[bench]`
//    line gives TFLOP/s and the share of the H100's 989.
//
// Build and run on a GPU machine from the repository root:
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -o build/wgmma_probe \
//       scripts/wgmma_probe.cu && build/wgmma_probe

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <stdio.h>
#include <math.h>
#include <stdlib.h>
#include <string.h>
__device__ __forceinline__ uint32_t smem_u32(const void* p) { return (uint32_t)__cvta_generic_to_shared(p); }
__device__ __forceinline__ void wfence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }
__device__ __forceinline__ void wcommit() { asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory"); }
template <int N> __device__ __forceinline__ void wwait() { asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory"); }
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ uint64_t desc_k(uint32_t addr, int bo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | (1ull << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)(bo & 7) << 49) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn(uint32_t addr, int bo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(1024 >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)(bo & 7) << 49) | (1ull << 62);
}
__device__ __forceinline__ void ldsm4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];" : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}
__device__ __forceinline__ void wg_ss_n64(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_ss_n64_tb(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 1;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]) : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}
__device__ __forceinline__ void wg_ss_n128(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile("{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
    "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
    : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]) : "l"(da), "l"(db), "r"(1));
}

// swizzled fill: row r of 64 bf16 at row r, chunk c -> c ^ (r & 7)
__device__ void fill(unsigned char* s, const unsigned short* g, int rows) {
  for (int i = threadIdx.x; i < rows * 8; i += blockDim.x) {
    int r = i >> 3, c = i & 7;
    *(uint4*)(s + r * 128 + ((c ^ (r & 7)) << 4)) = *(const uint4*)(g + r * 64 + c * 8);
  }
}
__device__ void store_frag(float* out, const float (&d)[32], int ld) {
  int t = threadIdx.x, w = t >> 5, l = t & 31;
  for (int j = 0; j < 8; ++j) for (int h = 0; h < 2; ++h) for (int e = 0; e < 2; ++e)
    out[(16 * w + (l >> 2) + 8 * h) * ld + 8 * j + 2 * (l & 3) + e] = d[4 * j + 2 * h + e];
}
// X: 72 x 64 bf16 (pixels), W: 64 x 64 bf16 ([n][k]).
// out layout: [variant][shift][64][64]. variant 0: SS A=X shifted, bo=0; 1: bo=(addr>>7)&7;
// 2: RS ldmatrix A (as the parent kernel); 3: orientation swap A=W, B=X shifted bo=(addr>>7)&7 (stored transposed);
// 4: orientation swap, bo=0; 5: MN-major B read of W^T (dx idea): D = X_s * (W as [k][n]) i.e. B[n][k] = W[k][n]
__global__ void probe_desc(const unsigned short* X, const unsigned short* W, float* out) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  unsigned char* sx = sm; unsigned char* sw = sm + 10240;
  fill(sx, X, 72); fill(sw, W, 64);
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  __syncthreads();
  int t = threadIdx.x, w = t >> 5, l = t & 31;
  for (int v = 0; v < 6; ++v) for (int s = 0; s < 8; ++s) {
    float d[32];
    for (int i = 0; i < 32; ++i) d[i] = 0.f;
    uint32_t xa = smem_u32(sx) + s * 128;
    fence_acc(d); wfence();
    for (int ks = 0; ks < 4; ++ks) {
      if (v == 0 || v == 1) {
        wg_ss_n64(d, desc_k(xa + ks * 32, v == 1 ? (xa >> 7) : 0), desc_k(smem_u32(sw) + ks * 32, 0));
      } else if (v == 2) {
        uint32_t a[4];
        int p = s + 16 * w + (l & 15);
        int chunk = (2 * ks + (l >> 4)) ^ (p & 7);
        ldsm4(smem_u32(sx) + p * 128 + (chunk << 4), a);
        wg_rs_n64(d, a, desc_k(smem_u32(sw) + ks * 32, 0));
      } else if (v == 3 || v == 4) {
        wg_ss_n64(d, desc_k(smem_u32(sw) + ks * 32, 0), desc_k(xa + ks * 32, v == 3 ? (xa >> 7) : 0));
      } else {
        // B MN-major: K rows = W rows 16ks.., each 128 B of 64 n values
        wg_ss_n64_tb(d, desc_k(xa + ks * 32, xa >> 7), desc_mn(smem_u32(sw) + ks * 2048, 0));
      }
    }
    wcommit(); wwait<0>(); fence_acc(d);
    float* o = out + (v * 8 + s) * 4096;
    if (v == 3 || v == 4) {  // D[m=co][n=pixel] -> store transposed
      for (int j = 0; j < 8; ++j) for (int h = 0; h < 2; ++h) for (int e = 0; e < 2; ++e)
        o[(8 * j + 2 * (l & 3) + e) * 64 + 16 * w + (l >> 2) + 8 * h] = d[4 * j + 2 * h + e];
    } else store_frag(o, d, 64);
    __syncwarp();
  }
}

// throughput: MODE 0 SS n64 x4 rows (shifted A), MODE 1 RS n64 x2 rows const A, MODE 2 SS n128 x2 (orientation B),
// MODE 3 SS n64 x4 rows with wait only at tile end
template <int MODE>
__global__ void __launch_bounds__(384, 1) bench(int iters, float* sink) {
  extern __shared__ unsigned char raw[];
  unsigned char* sm = raw + ((1024 - (smem_u32(raw) & 1023)) & 1023);
  uint32_t sx = smem_u32(sm), sw = sx + 67584;
  int wgi = threadIdx.x >> 7;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  float (&a0)[32] = *reinterpret_cast<float(*)[32]>(acc);
  float (&a1)[32] = *reinterpret_cast<float(*)[32]>(acc + 32);
  float (&a2)[32] = *reinterpret_cast<float(*)[32]>(acc + 64);
  float (&a3)[32] = *reinterpret_cast<float(*)[32]>(acc + 96);
  float (&b0)[64] = *reinterpret_cast<float(*)[64]>(acc);
  float (&b1)[64] = *reinterpret_cast<float(*)[64]>(acc + 64);
  uint32_t af[4] = {threadIdx.x, threadIdx.x * 3u, 7u, 9u};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int dy = tap / 3, dx = tap % 3;
      fence_acc(acc); wfence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        uint64_t bw = desc_k(sw + tap * 8192 + ks * 32, 0);
        if (MODE == 0 || MODE == 3) {
          uint32_t r0 = sx + ((0 + dy) * 66 + dx) * 128 + ks * 32;
          wg_ss_n64(a0, desc_k(r0, r0 >> 7), bw);
          r0 += 66 * 128; wg_ss_n64(a1, desc_k(r0, r0 >> 7), bw);
          r0 += 66 * 128; wg_ss_n64(a2, desc_k(r0, r0 >> 7), bw);
          r0 += 66 * 128; wg_ss_n64(a3, desc_k(r0, r0 >> 7), bw);
        } else if (MODE == 1) {
          wg_rs_n64(a0, af, bw); wg_rs_n64(a1, af, bw);
        } else {
          uint32_t r0 = sx + ((0 + dy) * 130 + dx) * 128 + ks * 32;
          wg_ss_n128(b0, bw, desc_k(r0, r0 >> 7));
          r0 += 130 * 128; wg_ss_n128(b1, bw, desc_k(r0, r0 >> 7));
        }
      }
      wcommit();
      if (MODE != 3) wwait<1>();
    }
    if (MODE == 3) wwait<0>();
  }
  wwait<0>(); fence_acc(acc);
  float s = 0.f;
  for (int i = 0; i < 128; ++i) s += acc[i];
  if (s == 12345.f) sink[threadIdx.x] = s;
  (void)wgi;
}

static float bf2f(unsigned short u) { unsigned x = (unsigned)u << 16; float f; memcpy(&f, &x, 4); return f; }
#define CK(x) do { cudaError_t e = (x); if (e != cudaSuccess) { printf("CUDA error %s at %d: %s\n", #x, __LINE__, cudaGetErrorString(e)); return 1; } } while (0)

template <int MODE>
int run_bench(int nwg, const char* what, double flop_per_it_per_wg) {
  int smem = 67584 + 73728 + 1024;
  CK(cudaFuncSetAttribute(bench<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
  float* sink; CK(cudaMalloc(&sink, 4096));
  int iters = 2000;
  bench<MODE><<<132, 128 * nwg, smem>>>(10, sink);
  CK(cudaDeviceSynchronize());
  cudaEvent_t a, b; cudaEventCreate(&a); cudaEventCreate(&b);
  cudaEventRecord(a);
  bench<MODE><<<132, 128 * nwg, smem>>>(iters, sink);
  cudaEventRecord(b); CK(cudaEventSynchronize(b));
  float ms; cudaEventElapsedTime(&ms, a, b);
  double tf = flop_per_it_per_wg * iters * nwg * 132 / (ms * 1e-3) / 1e12;
  printf("[bench] %s nwg=%d: %.3f ms, %.1f TFLOP/s (%.1f %% of 989)\n", what, nwg, ms, tf, tf / 9.89);
  cudaFree(sink);
  return 0;
}

int main() {
  const int nx = 72 * 64, nw = 64 * 64;
  unsigned short hx[nx], hw[nw];
  srand(1);
  for (int i = 0; i < nx; ++i) hx[i] = (unsigned short)(0x3f80 + (rand() % 256) - 128 + ((rand() & 1) << 15));
  for (int i = 0; i < nw; ++i) hw[i] = (unsigned short)(0x3f80 + (rand() % 256) - 128 + ((rand() & 1) << 15));
  unsigned short *dX, *dW; float* dO;
  CK(cudaMalloc(&dX, nx * 2)); CK(cudaMalloc(&dW, nw * 2)); CK(cudaMalloc(&dO, 6 * 8 * 4096 * 4));
  CK(cudaMemcpy(dX, hx, nx * 2, cudaMemcpyHostToDevice)); CK(cudaMemcpy(dW, hw, nw * 2, cudaMemcpyHostToDevice));
  CK(cudaFuncSetAttribute(probe_desc, cudaFuncAttributeMaxDynamicSharedMemorySize, 20480 + 1024));
  probe_desc<<<1, 128, 20480 + 1024>>>(dX, dW, dO);
  CK(cudaDeviceSynchronize());
  static float ho[6 * 8 * 4096];
  CK(cudaMemcpy(ho, dO, sizeof(ho), cudaMemcpyDeviceToHost));
  const char* names[6] = {"SS A shifted bo=0", "SS A shifted bo=addr", "RS ldmatrix A", "swap A=W B=X_s bo=addr", "swap bo=0", "B MN-major W^T"};
  for (int v = 0; v < 6; ++v) {
    for (int s = 0; s < 8; ++s) {
      double maxerr = 0;
      for (int m = 0; m < 64; ++m) for (int n = 0; n < 64; ++n) {
        double r = 0;
        for (int k = 0; k < 64; ++k) r += (double)bf2f(hx[(s + m) * 64 + k]) * (v == 5 ? bf2f(hw[k * 64 + n]) : bf2f(hw[n * 64 + k]));
        double e = fabs(r - ho[(v * 8 + s) * 4096 + m * 64 + n]);
        if (e > maxerr) maxerr = e;
      }
      int biteq_rs = 1;
      if (v != 2 && v != 5) for (int i = 0; i < 4096; ++i) if (memcmp(&ho[(v * 8 + s) * 4096 + i], &ho[(2 * 8 + s) * 4096 + i], 4)) { biteq_rs = 0; break; }
      printf("[desc] %-24s shift %d: max err %.3e %s, bit-equal to RS: %d\n", names[v], s, maxerr, maxerr < 1e-3 ? "OK" : "WRONG", biteq_rs);
    }
  }
  // flop per iteration per WG: 9 taps x 4 ks x (rows) x 2*64*N*16
  run_bench<0>(1, "SS m64n64 x4 rows, wait<1>/tap", 9 * 4 * 4 * 2.0 * 64 * 64 * 16);
  run_bench<0>(2, "SS m64n64 x4 rows, wait<1>/tap", 9 * 4 * 4 * 2.0 * 64 * 64 * 16);
  run_bench<3>(1, "SS m64n64 x4 rows, wait at tile end", 9 * 4 * 4 * 2.0 * 64 * 64 * 16);
  run_bench<3>(2, "SS m64n64 x4 rows, wait at tile end", 9 * 4 * 4 * 2.0 * 64 * 64 * 16);
  run_bench<1>(1, "RS m64n64 x2 rows const A", 9 * 4 * 2 * 2.0 * 64 * 64 * 16);
  run_bench<1>(2, "RS m64n64 x2 rows const A", 9 * 4 * 2 * 2.0 * 64 * 64 * 16);
  run_bench<2>(1, "SS m64n128 x2 (swap)", 9 * 4 * 2 * 2.0 * 64 * 128 * 16);
  run_bench<2>(2, "SS m64n128 x2 (swap)", 9 * 4 * 2 * 2.0 * 64 * 128 * 16);
  return 0;
}
