// The §IV-D requantization of a whole batch, for Hopper (sm_90a), in one
// launch:
//   y = clamp(((x[b, p, c] - in_zp[b]) * mult[b] + 2^(shift[b]-1))
//             >> shift[b] + out_zp[b], 0, 255)
//   out[b, p, offset + c] = y  (uint8),  live[b] += (y != out_zp[b])
// in int64 with an arithmetic shift, products and sums wrapping as torch's
// int64 arithmetic does.  x is a convolution's int64 staging or a branch's
// uint8 activations, viewed [B, P, C]; out is [B, P, Ctot] and takes the
// values at channels offset .. offset + C - 1, so that a concatenation
// writes each branch into its slice of the block's output.
//
// Replaces no TPU kernel: the JAX package requantizes image by image in
// plain JAX.  It was added because the port did the same, about 8 small
// launches an image for each of Inception v3's 94 convolutions and 50
// concatenated branches, and that loop paced the served forward.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit):
// bytes.  It reads each value once and writes one byte: 9 bytes an element
// from int64, 2 from uint8, at 3.35 TB/s.  A multiply, a shift and a clamp
// an element are nothing beside that.
//
// Design: the grid is (blocks a row, B); a block reads its row's four
// parameters once and strides over the row.  Where C, Ctot and offset are
// multiples of 8 and the pointers aligned (every Inception layer), a thread
// takes 8 consecutive channels at once: four 16-byte loads of int64 or one
// 8-byte load of uint8, and one 8-byte store.  Otherwise one element at a
// time.  The live counts are reduced by warp shuffles and across the
// block's warps in shared memory, then added with one atomic a block into
// the parameter buffer's fifth row, which the host zeroed.  No host sync,
// no temporaries.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;  // channels a thread takes at once on the vector path

using u64 = unsigned long long;

struct Row {
  u64 in_zp, mult, round;
  int shift;
  long long out_zp;
};

__device__ __forceinline__ unsigned requant(long long v, const Row& r) {
  // (v - in_zp) * mult + 2^(shift-1), wrapping like torch's int64
  const u64 t = (static_cast<u64>(v) - r.in_zp) * r.mult + r.round;
  long long y = (static_cast<long long>(t) >> r.shift) + r.out_zp;
  y = y < 0 ? 0 : (y > 255 ? 255 : y);
  return static_cast<unsigned>(y);
}

template <typename T>
__device__ __forceinline__ void load8(const T* p, long long v[kVec]);

template <>
__device__ __forceinline__ void load8<long long>(const long long* p,
                                                 long long v[kVec]) {
  const longlong2* q = reinterpret_cast<const longlong2*>(p);
#pragma unroll
  for (int j = 0; j < kVec / 2; ++j) {
    const longlong2 w = __ldg(q + j);
    v[2 * j] = w.x;
    v[2 * j + 1] = w.y;
  }
}

template <>
__device__ __forceinline__ void load8<uint8_t>(const uint8_t* p,
                                               long long v[kVec]) {
  const uint2 w = __ldg(reinterpret_cast<const uint2*>(p));
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    v[j] = (w.x >> (8 * j)) & 0xffu;
    v[4 + j] = (w.y >> (8 * j)) & 0xffu;
  }
}

// blockIdx.y = b; blockIdx.x strides over the row's P * C values.
template <typename T, bool kVector>
__global__ void __launch_bounds__(kThreads)
requant_rows_kernel(const T* __restrict__ x, uint8_t* __restrict__ out,
                    long long* __restrict__ params, int B, int P, int C,
                    int Ctot, int offset, int count_live) {
  const int b = blockIdx.y;
  Row r;
  r.in_zp = static_cast<u64>(params[b]);
  r.mult = static_cast<u64>(params[B + b]);
  r.shift = static_cast<int>(params[2 * B + b]);
  r.round = 1ull << (r.shift - 1);
  r.out_zp = params[3 * B + b];
  const long long n = static_cast<long long>(P) * C;
  const T* row = x + b * n;
  uint8_t* orow = out + b * static_cast<long long>(P) * Ctot + offset;
  const bool dense = C == Ctot;  // out rows contiguous: no channel split

  unsigned live = 0;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  if (kVector) {
    for (long long g = blockIdx.x * kThreads + threadIdx.x; g < n / kVec;
         g += stride) {
      const long long i = g * kVec;
      long long v[kVec];
      load8<T>(row + i, v);
      unsigned lo = 0, hi = 0;
#pragma unroll
      for (int j = 0; j < kVec; ++j) {
        const unsigned y = requant(v[j], r);
        live += y != static_cast<unsigned>(r.out_zp);
        if (j < 4) lo |= y << (8 * j);
        else hi |= y << (8 * (j - 4));
      }
      const unsigned u = static_cast<unsigned>(i);  // n < 2^31
      const long long o =
          dense ? i : static_cast<long long>(u / C) * Ctot + u % C;
      *reinterpret_cast<uint2*>(orow + o) = make_uint2(lo, hi);
    }
  } else {
    for (long long i = blockIdx.x * kThreads + threadIdx.x; i < n;
         i += stride) {
      const unsigned y = requant(static_cast<long long>(row[i]), r);
      live += y != static_cast<unsigned>(r.out_zp);
      const unsigned u = static_cast<unsigned>(i);
      orow[dense ? i : static_cast<long long>(u / C) * Ctot + u % C] =
          static_cast<uint8_t>(y);
    }
  }
  if (!count_live) return;

  __shared__ unsigned s_live[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0) s_live[warp] = live;
  __syncthreads();
  if (warp != 0) return;
  live = lane < kWarps ? s_live[lane] : 0u;
  live = __reduce_add_sync(0xffffffffu, live);
  if (lane == 0 && live != 0)
    atomicAdd(reinterpret_cast<u64*>(params + 4 * B + b),
              static_cast<u64>(live));
}

template <typename T>
cudaError_t launch(const void* x, void* out, void* params, int B, int P,
                   int C, int Ctot, int offset, int blocks, int count_live,
                   cudaStream_t s) {
  const bool vector =
      C % kVec == 0 && Ctot % kVec == 0 && offset % kVec == 0 &&
      reinterpret_cast<uintptr_t>(x) % (kVec * sizeof(T) >= 16 ? 16 : 8) ==
          0 &&
      reinterpret_cast<uintptr_t>(out) % 8 == 0;
  const dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(B));
  const T* xt = static_cast<const T*>(x);
  uint8_t* o = static_cast<uint8_t*>(out);
  long long* p = static_cast<long long*>(params);
  if (vector)
    requant_rows_kernel<T, true><<<grid, kThreads, 0, s>>>(
        xt, o, p, B, P, C, Ctot, offset, count_live);
  else
    requant_rows_kernel<T, false><<<grid, kThreads, 0, s>>>(
        xt, o, p, B, P, C, Ctot, offset, count_live);
  return cudaGetLastError();
}

}  // namespace

// x: contiguous [B, P, C], int64 (x_is_u8 = 0) or uint8 (1); out: contiguous
// uint8 [B, P, Ctot], offset + C <= Ctot; params: int64 [5, B] on the card,
// rows in_zp, mult, shift (1..63), out_zp and the live counts (zeroed, added
// to when count_live); blocks: blocks a row (B <= 65535, P * C and P * Ctot
// below 2^31).
extern "C" int requant_rows(const void* x, int x_is_u8, void* out,
                            void* params, int B, int P, int C, int Ctot,
                            int offset, int blocks, int count_live,
                            void* stream) {
  if (B <= 0 || P <= 0 || C <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      x_is_u8 ? launch<uint8_t>(x, out, params, B, P, C, Ctot, offset, blocks,
                                count_live, s)
              : launch<long long>(x, out, params, B, P, C, Ctot, offset,
                                  blocks, count_live, s);
  return static_cast<int>(err);
}
