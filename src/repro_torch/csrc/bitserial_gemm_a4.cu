// W4A4 bit-serial GEMM for Hopper (sm_90a), nibble-packed activations:
//   out = sum_b pw[b] * (x @ plane_b),  x unpacked from two nibbles a byte.
//
// Replaces the TPU kernel
// repro/kernels/bitserial_matmul.py::bitserial_matmul_a4 (Pallas body
// `_kernel_a4`).  Same function: x_packed [M, K2] uint8 holds two 4-bit
// activations per byte, the even element in the low nibble (unsigned, or
// two's complement over 4 bits when `x_signed`: ((b & 0xF) ^ 8) - 8);
// planes [K, N] uint8 byte-packed with n_bits <= 4 (bit b is plane b),
// K <= 2 * K2 (a dangling nibble of an odd K meets a zero weight row); an
// optional per-(plane, K-block, N-block) occupancy mask whose K-blocks span
// `mask_bk` = 2 * bk2 weight rows; the exact int32 accumulator or the float
// epilogue (f32(acc) * x_scale) * w_scale[n].  Plane weights are +2^b, the
// MSB plane -2^(n-1) when `signed_planes` is set.  Integer arithmetic wraps
// modulo 2^32, like the TPU kernel's int32 accumulator.  The TPU kernel
// splits each plane into two half-K products (even nibbles against even
// rows, odd against odd); their sum is the full-K product computed here.
//
// What bounds it on the H100: it moves M*K2 + K*N + 4*M*N bytes
// (3.35 TB/s); the function is one GEMM of 2*M*N*K operations (the plane
// weights fold into the decoded weights), and Hopper has no 4-bit tensor
// core path faster than int8 (1,979 TOP/s).  The design is the 8-bit
// kernel's (bitserial_gemm.cu): one thread block owns a 64x64 output tile
// and walks K in 32-element steps.  Each step stages 16 packed bytes per
// row of x, unpacks the two nibbles in shared memory, and stages the
// masked weight bytes; edges (M, N, odd K) are masked on load and store,
// so nothing is padded in device memory.  Each thread keeps a 4x4 int32
// accumulator in registers, and a plane whose staged tile holds no set bit
// is skipped for that step.  CUDA-core integer pipes only; tensor cores
// (wgmma) and TMA staging are later work.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 32;        // unpacked K elements per step
constexpr int BK2 = BK / 2;   // packed activation bytes per step
constexpr int TM = 4;  // outputs per thread along M
constexpr int TN = 4;  // outputs per thread along N
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
bitserial_gemm_a4_kernel(const uint8_t* __restrict__ x, int x_signed,
                         const uint8_t* __restrict__ planes,
                         const int8_t* __restrict__ mask, int mask_bk,
                         int mask_bn, int mask_nk, int mask_nn,
                         const float* __restrict__ w_scale, float x_scale,
                         void* __restrict__ out, int out_float, int M, int N,
                         int K, int K2, int n_bits, int signed_planes) {
  __shared__ int32_t xs[BK][BM];   // unpacked x tile, transposed: xs[k][m]
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
    // stage the packed x bytes and unpack both nibbles (zero outside M/K2)
    const int64_t kb0 = k0 / 2;
    for (int e = tid; e < BM * BK2; e += THREADS) {
      const int mm = e / BK2, kk2 = e % BK2;
      const int64_t m = m0 + mm, k2 = kb0 + kk2;
      int32_t lo = 0, hi = 0;
      if (m < M && k2 < K2) {
        const int32_t b = x[m * K2 + k2];
        if (x_signed) {
          lo = ((b & 0xF) ^ 8) - 8;
          hi = ((b >> 4) ^ 8) - 8;
        } else {
          lo = b & 0xF;
          hi = b >> 4;
        }
      }
      xs[2 * kk2][mm] = lo;
      xs[2 * kk2 + 1][mm] = hi;
    }
    // stage the packed weight bytes with the occupancy mask applied per
    // element; rows at or past K (an odd K's dangling row) are zero
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

extern "C" int bitserial_gemm_a4(const void* x, int x_signed,
                                 const void* planes, const void* mask,
                                 int mask_bk, int mask_bn, int mask_nk,
                                 int mask_nn, const void* w_scale,
                                 float x_scale, void* out, int out_float,
                                 int M, int N, int K, int K2, int n_bits,
                                 int signed_planes, void* stream) {
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN);
  bitserial_gemm_a4_kernel<<<grid, THREADS, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), x_signed,
      static_cast<const uint8_t*>(planes), static_cast<const int8_t*>(mask),
      mask_bk, mask_bn, mask_nk, mask_nn, static_cast<const float*>(w_scale),
      x_scale, out, out_float, M, N, K, K2, n_bits, signed_planes);
  return static_cast<int>(cudaGetLastError());
}
