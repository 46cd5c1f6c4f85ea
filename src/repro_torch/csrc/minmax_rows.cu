// Per-row min and max of the §IV-D dynamic-range tree, for Hopper (sm_90a):
//   u = (x[r, k] + bias) & (2^bits - 1),  bias = 2^(bits-1) if signed else 0
//   mins[r] = min_k u - bias,  maxs[r] = max_k u - bias   (u unsigned)
//
// Replaces no TPU kernel: the JAX package's min/max tree
// (repro/core/bitserial.py::bitserial_minmax) is plain JAX.  It was added
// because the port ran that tree as a walk over packed bit planes, about
// 9,000 small launches a convolution, and the walk took 61-63% of the
// served Inception v3 forward on the card.  The value is the walk's exactly:
// the walk pads each row to a power of two with copies of its first lane,
// which changes neither the min nor the max, then takes the unsigned min and
// max of u bit-serially; this kernel takes them directly.  Cycles are not
// counted here: the caller charges them from the shape.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit):
// bytes.  It reads 8 * rows * K bytes once and writes 16 * rows; one add,
// one and and two compares an element are nothing beside that at 3.35 TB/s.
//
// Design: each row is cut into `chunks` ranges (the wrapper picks them so
// that rows * chunks blocks fill the 132 SMs even at one row).  A block of
// 256 threads reads its range with 16-byte vector loads (two int64 each),
// four in flight a thread, keeps its min and max of u in registers, reduces
// them by warp shuffles and then across its 8 warps in shared memory.  The
// first block of a row also folds the one element before the row's first
// 16-byte boundary and the one after its last whole pair (a row of odd K
// starts off the boundary every second row).  With one chunk a row the block
// writes the row's answer; otherwise it writes its (min, max) of u into a
// workspace of rows * chunks pairs and a second launch, one warp a row,
// reduces them.  Min and max are order-free, so the result does not depend
// on the order the blocks run in.  Two launches at most, no atomics, no
// host sync.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;  // 16-byte loads in flight per thread

using u64 = unsigned long long;

__device__ __forceinline__ void fold(u64& mn, u64& mx, long long v, u64 bias,
                                     u64 mask) {
  const u64 u = (static_cast<u64>(v) + bias) & mask;
  mn = u < mn ? u : mn;
  mx = u > mx ? u : mx;
}

__device__ __forceinline__ void warp_reduce(u64& mn, u64& mx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const u64 a = __shfl_down_sync(0xffffffffu, mn, off);
    const u64 b = __shfl_down_sync(0xffffffffu, mx, off);
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
}

// One block per (row, chunk): blockIdx.x = row * chunks + chunk.
__global__ void __launch_bounds__(kThreads)
minmax_chunk_kernel(const long long* __restrict__ x, long long* __restrict__ mins,
                    long long* __restrict__ maxs, u64* __restrict__ partial,
                    int K, int chunks, u64 bias, u64 mask) {
  const long long row = blockIdx.x / chunks;
  const int chunk = blockIdx.x % chunks;
  const long long* row_ptr = x + row * static_cast<long long>(K);
  // int64 elements are 8-byte aligned: at most one element before the
  // row's first 16-byte boundary
  const int head = (reinterpret_cast<uintptr_t>(row_ptr) & 15) != 0 ? 1 : 0;
  const long long n_pairs = (K - head) / 2;
  const longlong2* pairs = reinterpret_cast<const longlong2*>(row_ptr + head);
  const long long per = (n_pairs + chunks - 1) / chunks;
  const long long begin = chunk * per;
  const long long end = begin + per < n_pairs ? begin + per : n_pairs;

  u64 mn = ~0ull, mx = 0ull;
  long long i = begin + threadIdx.x;
  for (; i + (kUnroll - 1) * kThreads < end; i += kUnroll * kThreads) {
    longlong2 v[kUnroll];
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) v[j] = __ldg(pairs + i + j * kThreads);
#pragma unroll
    for (int j = 0; j < kUnroll; ++j) {
      fold(mn, mx, v[j].x, bias, mask);
      fold(mn, mx, v[j].y, bias, mask);
    }
  }
  for (; i < end; i += kThreads) {
    const longlong2 v = __ldg(pairs + i);
    fold(mn, mx, v.x, bias, mask);
    fold(mn, mx, v.y, bias, mask);
  }
  if (chunk == 0 && threadIdx.x == 0) {
    if (head) fold(mn, mx, row_ptr[0], bias, mask);
    if ((K - head) & 1) fold(mn, mx, row_ptr[K - 1], bias, mask);
  }

  __shared__ u64 s_mn[kWarps], s_mx[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  warp_reduce(mn, mx);
  if (lane == 0) {
    s_mn[warp] = mn;
    s_mx[warp] = mx;
  }
  __syncthreads();
  if (warp != 0) return;
  mn = lane < kWarps ? s_mn[lane] : ~0ull;
  mx = lane < kWarps ? s_mx[lane] : 0ull;
  warp_reduce(mn, mx);
  if (lane != 0) return;
  if (partial == nullptr) {  // one chunk a row: the row's answer
    mins[row] = static_cast<long long>(mn) - static_cast<long long>(bias);
    maxs[row] = static_cast<long long>(mx) - static_cast<long long>(bias);
  } else {
    partial[2 * blockIdx.x] = mn;
    partial[2 * blockIdx.x + 1] = mx;
  }
}

// One warp per row: the row's `chunks` partial (min, max) pairs of u.
__global__ void __launch_bounds__(kThreads)
minmax_combine_kernel(const u64* __restrict__ partial,
                      long long* __restrict__ mins,
                      long long* __restrict__ maxs, int rows, int chunks,
                      u64 bias) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const u64* p = partial + 2 * row * chunks;
  u64 mn = ~0ull, mx = 0ull;
  for (int c = lane; c < chunks; c += 32) {
    const u64 a = p[2 * c], b = p[2 * c + 1];
    mn = a < mn ? a : mn;
    mx = b > mx ? b : mx;
  }
  warp_reduce(mn, mx);
  if (lane == 0) {
    mins[row] = static_cast<long long>(mn) - static_cast<long long>(bias);
    maxs[row] = static_cast<long long>(mx) - static_cast<long long>(bias);
  }
}

}  // namespace

// x: contiguous int64 [rows, K], K >= 1; mins, maxs: int64 [rows];
// workspace: null when chunks == 1, else 2 * rows * chunks uint64 (no
// initial value needed); rows * chunks < 2^31; bits in 1..63.
extern "C" int minmax_rows(const void* x, void* mins, void* maxs,
                           void* workspace, int rows, int K, int chunks,
                           int bits, int is_signed, void* stream) {
  if (rows <= 0) return static_cast<int>(cudaSuccess);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const u64 mask = (1ull << bits) - 1ull;
  const u64 bias = is_signed ? 1ull << (bits - 1) : 0ull;
  u64* partial = chunks > 1 ? static_cast<u64*>(workspace) : nullptr;
  minmax_chunk_kernel<<<static_cast<unsigned>(rows) * chunks, kThreads, 0,
                        s>>>(static_cast<const long long*>(x),
                             static_cast<long long*>(mins),
                             static_cast<long long*>(maxs), partial, K,
                             chunks, bias, mask);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || partial == nullptr) return static_cast<int>(err);
  minmax_combine_kernel<<<(rows + kWarps - 1) / kWarps, kThreads, 0, s>>>(
      partial, static_cast<long long*>(mins), static_cast<long long*>(maxs),
      rows, chunks, bias);
  return static_cast<int>(cudaGetLastError());
}
