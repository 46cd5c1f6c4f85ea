// Bit-serial GEMM for Hopper (sm_90a): out = sum_b pw[b] * (x @ plane_b).
//
// Replaces the TPU kernel repro/kernels/bitserial_matmul.py::bitserial_matmul
// (Pallas body `_kernel`).  Same function: x [M, K] 8-bit activations
// (uint8 or int8), planes [K, N] uint8 byte-packed (bit b of each byte is
// plane b), an optional per-(plane, K-block, N-block) occupancy mask, and
// either the exact int32 accumulator or the float epilogue
// f32(acc) * x_scale * w_scale[n].  Plane weights are +2^b, with the MSB
// plane at -2^(n-1) when `signed_planes` is set (two's complement weights).
// Integer arithmetic wraps modulo 2^32, like the TPU kernel's int32
// accumulator.
//
// What bounds it on the H100: it moves M*K + K*N + 4*M*N bytes (3.35 TB/s).
// The function itself is one 8-bit GEMM of 2*M*N*K integer operations
// (1,979 TOP/s int8): the plane weights and any mask fold into the decoded
// weight matrix sum_b pw[b] * plane_b before a single product, so the
// n_planes plane products this kernel runs are its own cost, not the
// function's.  Against that bound the main path's shapes sit below the
// ridge (about 590 operations per byte), so bytes bound them.  This
// first design is simple: one thread block owns one 64x64 output tile and
// walks K in 32-wide steps; the x tile and the packed weight bytes are
// staged in shared memory, edges are masked on load and store (nothing is
// padded in device memory), and each thread keeps a 4x4 int32 accumulator
// in registers.  A plane whose staged tile holds no set bit (after the
// occupancy mask is applied) is skipped for that K step.  It runs on the
// CUDA cores' integer pipes; int8 tensor cores (wgmma) and TMA staging are
// left for later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;
constexpr int TM = 4;  // outputs per thread along M
constexpr int TN = 4;  // outputs per thread along N
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
bitserial_gemm_kernel(const uint8_t* __restrict__ x, int x_signed,
                      const uint8_t* __restrict__ planes,
                      const int8_t* __restrict__ mask, int mask_bk,
                      int mask_bn, int mask_nk, int mask_nn,
                      const float* __restrict__ w_scale, float x_scale,
                      void* __restrict__ out, int out_float, int M, int N,
                      int K, int n_bits, int signed_planes) {
  __shared__ int32_t xs[BK][BM];   // x tile, transposed: xs[k][m]
  __shared__ uint8_t ps[BK][BN];   // masked packed weight bytes
  __shared__ unsigned int s_or[2];  // OR of the staged bytes, per K step

  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);  // N direction
  const int ty = tid / (BN / TN);  // M direction
  const int lane = tid & 31;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const unsigned int all_planes = (1u << n_bits) - 1u;

  uint32_t acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0u;

  if (tid < 2) s_or[tid] = 0u;
  __syncthreads();

  int step = 0;
  for (int64_t k0 = 0; k0 < K; k0 += BK, ++step) {
    // stage the x tile (zero outside M/K)
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int mm = e / BK, kk = e % BK;
      const int64_t m = m0 + mm, k = k0 + kk;
      int32_t v = 0;
      if (m < M && k < K) {
        const uint8_t b = x[m * K + k];
        v = x_signed ? static_cast<int32_t>(static_cast<int8_t>(b))
                     : static_cast<int32_t>(b);
      }
      xs[kk][mm] = v;
    }
    // stage the packed bytes, with the occupancy mask applied per element
    unsigned int local_or = 0u;
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, nn = e % BN;
      const int64_t k = k0 + kk, n = n0 + nn;
      unsigned int p = 0u;
      if (k < K && n < N) {
        unsigned int keep = all_planes;
        if (mask != nullptr) {
          keep = 0u;
          const int kb = static_cast<int>(k / mask_bk);
          const int nb = static_cast<int>(n / mask_bn);
          for (int b = 0; b < n_bits; ++b)
            if (mask[(static_cast<int64_t>(b) * mask_nk + kb) * mask_nn + nb])
              keep |= 1u << b;
        }
        p = planes[k * N + n] & keep;
      }
      ps[kk][nn] = static_cast<uint8_t>(p);
      local_or |= p;
    }
    local_or = __reduce_or_sync(0xffffffffu, local_or);
    if (lane == 0 && local_or) atomicOr(&s_or[step & 1], local_or);
    __syncthreads();
    const unsigned int tile_or = s_or[step & 1];
    // every thread has passed this step's first barrier, so the other
    // slot (last read in the previous step) is free to clear
    if (tid == 0) s_or[(step + 1) & 1] = 0u;

    for (int b = 0; b < n_bits; ++b) {
      if (!((tile_or >> b) & 1u)) continue;  // all-zero plane tile: skipped
      uint32_t part[TM][TN];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) part[i][j] = 0u;
#pragma unroll 4
      for (int kk = 0; kk < BK; ++kk) {
        uint32_t a[TM], bit[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i)
          a[i] = static_cast<uint32_t>(xs[kk][ty + i * (BM / TM)]);
#pragma unroll
        for (int j = 0; j < TN; ++j)
          bit[j] = (static_cast<uint32_t>(ps[kk][tx + j * (BN / TN)]) >> b) & 1u;
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) part[i][j] += a[i] * bit[j];
      }
      const uint32_t pw = (signed_planes && b == n_bits - 1)
                              ? static_cast<uint32_t>(-(1 << b))
                              : (1u << b);
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] += pw * part[i][j];
    }
    __syncthreads();  // the tiles are rewritten next step
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t m = m0 + ty + i * (BM / TM);
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int64_t n = n0 + tx + j * (BN / TN);
      if (n >= N) continue;
      const int32_t v = static_cast<int32_t>(acc[i][j]);
      if (out_float) {
        const float f = __fmul_rn(__fmul_rn(__int2float_rn(v), x_scale),
                                  w_scale[n]);
        static_cast<float*>(out)[m * N + n] = f;
      } else {
        static_cast<int32_t*>(out)[m * N + n] = v;
      }
    }
  }
}

}  // namespace

extern "C" int bitserial_gemm(const void* x, int x_signed, const void* planes,
                              const void* mask, int mask_bk, int mask_bn,
                              int mask_nk, int mask_nn, const void* w_scale,
                              float x_scale, void* out, int out_float, int M,
                              int N, int K, int n_bits, int signed_planes,
                              void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  bitserial_gemm_kernel<<<grid, THREADS, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), x_signed,
      static_cast<const uint8_t*>(planes), static_cast<const int8_t*>(mask),
      mask_bk, mask_bn, mask_nk, mask_nn, static_cast<const float*>(w_scale),
      x_scale, out, out_float, M, N, K, n_bits, signed_planes);
  return static_cast<int>(cudaGetLastError());
}
