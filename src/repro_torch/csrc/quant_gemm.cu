// W8A8 GEMM for Hopper (sm_90a):
//   out[m, n] = f32(sum_k x[m, k] * w[k, n]) * x_scale * w_scale[n] (+ bias[n])
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (Pallas body `_kernel`).  Same function: x [M, K] int8 activations, w
// [K, N] int8 weights, both row-major; the int32 accumulator is exact
// (|acc| <= 128 * 128 * K, about 3.1e8 at K = 18944, inside int32); the
// epilogue is the reference's, in its order and with round-to-nearest
// multiplies and add (no FMA contraction):
//   __fadd_rn(__fmul_rn(__fmul_rn((float)acc, x_scale), w_scale[n]), bias[n])
// and without the add when no bias is given.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit): it
// moves M*K + K*N + 8*N + 4*M*N bytes (3.35 TB/s) and does 2*M*N*K integer
// operations (1,979 TOP/s int8 on the tensor cores).  At the LM's shapes
// (M = 512 prompt tokens against 3584 x 3584 ... 18944 x 3584 weights)
// operations bound it, except the narrow 3584 x 512 projections, where
// bytes do; the two are within 2x of each other, so both the int8 tensor
// cores and the bytes matter.  This first design reaches the
// tensor cores through mma.sync (m16n8k32, s8 x s8 -> s32): the TPU grid's
// sequential K axis and VMEM accumulator become a loop over K inside the
// block, with the int32 sums in registers.  One block of 4 warps owns a
// 64x64 output tile, each warp a 32x32 quarter (2 x 4 MMA tiles); per
// 64-wide K step the x tile and the transposed w tile are staged in shared
// memory (rows padded to 80 bytes, so the fragment loads hit 32 distinct
// banks), ragged M/N/K edges are zero-filled on load and masked on store
// (nothing is padded in device memory).  Staging is synchronous: wgmma,
// TMA and a multi-stage pipeline are left for later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid of 32x32 sub-tiles

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS)
quant_gemm_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                  float x_scale, const float* __restrict__ w_scale,
                  const float* __restrict__ bias, float* __restrict__ out,
                  int M, int N, int K) {
  __shared__ __align__(16) int8_t xs[BM][LDS];  // x tile: row m, k contiguous
  __shared__ __align__(16) int8_t ws[BN][LDS];  // w tile: row n, k contiguous

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // MMA fragment row group
  const int t = lane & 3;   // thread within the group
  const int wm = (warp >> 1) * 32;
  const int wn = (warp & 1) * 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.y) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.x) * BN;
  const bool x_vec = (K & 3) == 0;  // every 4-byte x word is aligned

  int acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  for (int64_t k0 = 0; k0 < K; k0 += BK) {
    // x tile: one 4-byte word of a row per thread and step
    for (int e = tid; e < BM * (BK / 4); e += THREADS) {
      const int mm = e / (BK / 4);
      const int kq = (e % (BK / 4)) * 4;
      const int64_t m = m0 + mm, k = k0 + kq;
      uint32_t v = 0u;
      if (m < M && k < K) {
        const int8_t* src = x + m * K + k;
        if (x_vec) {
          v = *reinterpret_cast<const uint32_t*>(src);
        } else {
          for (int i = 0; i < 4 && k + i < K; ++i)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(src[i])) << (8 * i);
        }
      }
      *reinterpret_cast<uint32_t*>(&xs[mm][kq]) = v;
    }
    // w tile, transposed: four k rows of one column n packed into a word
    for (int e = tid; e < (BK / 4) * BN; e += THREADS) {
      const int nn = e % BN;
      const int kq = (e / BN) * 4;
      const int64_t n = n0 + nn;
      uint32_t v = 0u;
      if (n < N) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int64_t k = k0 + kq + i;
          if (k < K)
            v |= static_cast<uint32_t>(static_cast<uint8_t>(w[k * N + n]))
                 << (8 * i);
        }
      }
      *reinterpret_cast<uint32_t*>(&ws[nn][kq]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = wm + i * 16 + g;
        a[i][0] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + t * 4]);
        a[i][1] = *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + t * 4]);
        a[i][2] = *reinterpret_cast<const uint32_t*>(&xs[r][kk + 16 + t * 4]);
        a[i][3] =
            *reinterpret_cast<const uint32_t*>(&xs[r + 8][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = wn + j * 8 + g;
        b[j][0] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + t * 4]);
        b[j][1] = *reinterpret_cast<const uint32_t*>(&ws[c][kk + 16 + t * 4]);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
    __syncthreads();  // the tiles are rewritten next step
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row g+8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int64_t n = n0 + wn + j * 8 + t * 2 + c;
          if (n >= N) continue;
          float f = __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][half * 2 + c]),
                                        x_scale),
                              w_scale[n]);
          if (bias != nullptr) f = __fadd_rn(f, bias[n]);
          out[m * N + n] = f;
        }
      }
    }
  }
}

}  // namespace

extern "C" int quant_gemm(const void* x, const void* w, float x_scale,
                          const void* w_scale, const void* bias, void* out,
                          int M, int N, int K, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  quant_gemm_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w), x_scale,
      static_cast<const float*>(w_scale), static_cast<const float*>(bias),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}
