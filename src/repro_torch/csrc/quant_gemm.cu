// W8A8 GEMM for Hopper (sm_90a):
//   out[m, n] = f32(sum_k x[m, k] * w[k, n]) * x_scale * w_scale[n] (+ bias[n])
//
// Replaces the TPU kernel repro/kernels/quant_matmul.py::quant_matmul
// (Pallas body `_kernel`).  Same function: x [M, K] int8 activations, w
// [K, N] int8 weights, both row-major; the int32 accumulator is exact
// (|acc| <= 128 * 128 * K, about 3.1e8 at K = 18944, inside int32), so
// split-K partial sums added by atomics in any order give the same bits;
// the epilogue is the reference's, in its order and with round-to-nearest
// multiplies and add (no FMA contraction):
//   __fadd_rn(__fmul_rn(__fmul_rn((float)acc, x_scale), w_scale[n]), bias[n])
// and without the add when no bias is given.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit): it
// moves M*K + K*N + 8*N + 4*M*N bytes (3.35 TB/s) and does 2*M*N*K integer
// operations (1,979 TOP/s int8 on the tensor cores).  At the LM's shapes
// (M = 512 prompt tokens against 3584 x 3584 ... 18944 x 3584 weights)
// operations bound it, except the narrow 3584 x 512 projections, where
// bytes do; the head (4 positions against 3584 x 152064) is bytes-bound
// (545 MB of weights).
//
// Design: the main loop the int8 kernels share (int8_mma.cuh), with x and
// w signed, no fold, and 64x128 output tiles (a 1x4 row of warps, each
// 64x32): x tiles and w rows (n contiguous) are staged by 16-byte cp.async
// copies into a three-stage ring, and the products run on
// mma.sync.m16n8k32.s8.s8.  Where N % 16 == 0 (every LM linear and the
// head), the w rows go whole with swizzled chunks and each warp transposes
// its B fragments in registers (ldmatrix .trans and byte permutes), one
// barrier a step; otherwise they go as 16-byte aligned windows and are
// transposed once a step into a [n][k] tile in shared memory.  Where the
// tiles cannot fill the card (quant_split_k), K is split and the splits add
// into a zeroed int32 workspace, and a second launch applies the epilogue,
// bias included, in the same rounding order.  64x128 tiles beat 128x64 at
// every LM shape on the card (PERF.md).
#include "int8_mma.cuh"

namespace {

using int8_mma::Params;
using Launch = cudaError_t (*)(const Params&, cudaStream_t);

// [direct]: w rows staged as windows and transposed in shared memory, or
// (N % 16 == 0 and w aligned) staged whole and transposed in registers
constexpr Launch kTable[2] = {
    int8_mma::launch<true, true, false, false, false, 1, false>,
    int8_mma::launch<true, true, false, false, false, 1, true>};

}  // namespace

// `workspace`: null, or a zeroed int32 [M, N] buffer that the K splits of
// `k_split` rows each add into before the epilogue launch.
extern "C" int quant_gemm(const void* x, const void* w, float x_scale,
                          const void* w_scale, const void* bias, void* out,
                          void* workspace, int M, int N, int K, int k_split,
                          void* stream) {
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const uint8_t*>(w);
  p.mask = nullptr;
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = static_cast<const float*>(bias);
  p.x_scale = x_scale;
  p.out = out;
  p.out_float = 1;
  p.partial = static_cast<uint32_t*>(workspace);
  p.M = M;
  p.N = N;
  p.K = K;
  p.xld = K;
  p.k_split = workspace != nullptr ? k_split : K;
  p.n_bits = 8;
  p.x_vec = (K % 16 == 0) && int8_mma::aligned16(x);
  p.w_vec = int8_mma::aligned16(w);
  p.w_aligned = p.w_vec && N % 16 == 0;
  return static_cast<int>(
      kTable[p.w_aligned](p, static_cast<cudaStream_t>(stream)));
}
