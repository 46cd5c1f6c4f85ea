// W4A4 bit-serial GEMM for Hopper (sm_90a), nibble-packed activations:
//   out = sum_b pw[b] * (x @ plane_b),  x unpacked from two nibbles a byte.
//
// Replaces the TPU kernel
// repro/kernels/bitserial_matmul.py::bitserial_matmul_a4 (Pallas body
// `_kernel_a4`).  Same function: x_packed [M, K2] uint8 holds two 4-bit
// activations per byte, the even element in the low nibble (unsigned, or
// two's complement over 4 bits when `x_signed`: ((b & 0xF) ^ 8) - 8);
// planes [K, N] uint8 byte-packed with n_bits <= 4 (bit b is plane b),
// K <= 2 * K2 (nibbles at k >= K meet zero weight rows); an optional
// per-(plane, K-block, N-block) occupancy mask whose K-blocks span
// `mask_bk` = 2 * bk2 weight rows; the exact int32 accumulator or the float
// epilogue (f32(acc) * x_scale) * w_scale[n].  Plane weights are +2^b, the
// MSB plane -2^(n-1) when `signed_planes` is set.  Integer arithmetic wraps
// modulo 2^32, like the TPU kernel's int32 accumulator.  The TPU kernel
// splits each plane into two half-K products (even nibbles against even
// rows, odd against odd); their sum is the full-K product computed here.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit): it
// moves M*K2 + K*N + 4*M*N bytes (3.35 TB/s) and is one GEMM of 2*M*N*K
// operations (1,979 TOP/s int8): the plane weights and the mask fold into
// one decoded weight per element, which fits u8 for unsigned planes and s8
// for signed ones, and each nibble widens to a u8 or s8 operand.  Hopper's
// mma.sync with .u4/.s4 operands is no faster than int8, so the nibbles are
// widened.  Every main-path shape is bytes-bound.
//
// Design: the 8-bit kernel's (bitserial_gemm.cu), in the main loop the
// int8 kernels share (int8_mma.cuh): 128x64 tiles of 4 warps on
// mma.sync.m16n8k32, a three-stage cp.async ring, each packed weight tile
// decoded once into the transposed weight tile, ldmatrix fragments, int32
// sums that wrap, and split-K into a zeroed int32 workspace by atomic adds
// where the tiles cannot fill the card.  Only the x side differs: each
// 64-wide K step stages the 32 packed bytes of each row, half the 8-bit
// kernel's x traffic, as the 16-byte aligned window around them (so K2 =
// 360 at Conv2d_4a, whose rows start 8 bytes off a 16-byte boundary,
// still goes by cp.async), and the decode pass widens them into an [m][k]
// byte tile in shared memory, each nibble once per block, from which the
// fragments load as in the 8-bit kernel.
#include "int8_mma.cuh"

namespace {

using int8_mma::Params;
using Launch = cudaError_t (*)(const Params&, cudaStream_t);

// [x signed][planes signed][masked]
template <bool XS, bool WS, bool MASKED>
constexpr Launch kLaunch = int8_mma::launch<XS, WS, MASKED, true, true, 2, false>;
constexpr Launch kTable[2][2][2] = {
    {{kLaunch<false, false, false>, kLaunch<false, false, true>},
     {kLaunch<false, true, false>, kLaunch<false, true, true>}},
    {{kLaunch<true, false, false>, kLaunch<true, false, true>},
     {kLaunch<true, true, false>, kLaunch<true, true, true>}}};

}  // namespace

// `workspace`: null, or a zeroed int32 [M, N] buffer that the K splits of
// `k_split` weight rows each add into (it may be `out` itself when out is
// int32).
extern "C" int bitserial_gemm_a4(const void* x, int x_signed,
                                 const void* planes, const void* mask,
                                 int mask_bk, int mask_bn, int mask_nk,
                                 int mask_nn, const void* w_scale,
                                 float x_scale, void* out, int out_float,
                                 void* workspace, int M, int N, int K, int K2,
                                 int k_split, int n_bits, int signed_planes,
                                 void* stream) {
  Params p{};
  p.x = static_cast<const uint8_t*>(x);
  p.w = static_cast<const uint8_t*>(planes);
  p.mask = static_cast<const int8_t*>(mask);
  p.mask_bk = mask_bk;
  p.mask_bn = mask_bn;
  p.mask_nk = mask_nk;
  p.mask_nn = mask_nn;
  p.w_scale = static_cast<const float*>(w_scale);
  p.bias = nullptr;
  p.x_scale = x_scale;
  p.out = out;
  p.out_float = out_float;
  p.partial = static_cast<uint32_t*>(workspace);
  p.M = M;
  p.N = N;
  p.K = K;
  p.xld = K2;
  p.k_split = workspace != nullptr ? k_split : K;
  p.n_bits = n_bits;
  p.x_vec = int8_mma::aligned16(x);
  p.x_align = !p.x_vec ? 1 : (K2 % 16 == 0 ? 16 : (K2 % 4 == 0 ? 4 : 1));
  p.w_vec = int8_mma::aligned16(planes);
  p.w_aligned = p.w_vec && N % 16 == 0;
  const Launch run =
      kTable[x_signed != 0][signed_planes != 0][mask != nullptr];
  return static_cast<int>(run(p, static_cast<cudaStream_t>(stream)));
}
