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
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit): it
// moves M*K + K*N + 4*M*N bytes (3.35 TB/s) and does 2*M*N*K integer
// operations (1,979 TOP/s int8).  The function is one 8-bit GEMM: the plane
// weights and the mask fold into one decoded weight per element,
//   w[k, n] = sum_b pw[b] * bit_b(planes[k, n]) * mask[b, k/bk, n/bn],
// which fits u8 for unsigned planes (0..2^n-1) and s8 for signed ones
// (-2^(n-1)..2^(n-1)-1).  Every main-path shape sits below the ridge
// (about 590 operations per byte), so bytes bound them; the 4-bit PTQ
// sites (M = 512 against 3584-18944 wide weights) come within a few x of
// it.
//
// Design: decode once, multiply once on the int8 tensor cores, in the
// main loop this kernel shares with the W4A4 and W8A8 kernels
// (int8_mma.cuh, whose note has the details): 128x64 output tiles of 4
// warps on mma.sync.m16n8k32 with the x and w signedness as operand types,
// a three-stage cp.async ring (x rows whole when K % 16 == 0, packed rows
// as 16-byte aligned windows, so any N), each packed tile decoded once
// into the transposed u8/s8 weight tile (4x4 byte permutes without a
// mask, byte by byte in a separate instantiation with one), ldmatrix
// fragments, int32 sums that wrap (no .satfinite), and split-K into a
// zeroed int32 workspace by atomic adds where the tiles cannot fill the
// card, followed by a float epilogue launch.  Ragged edges are zero-filled
// on load and masked on store.
// What holds it above the bound at the main path's shapes: each block
// walks few K steps (5 at Conv2d_2b), so filling the ring and draining
// the int32 tile cost about as much as the steps, and the loads alone run
// at about half the card's memory rate; wgmma, TMA and a persistent grid
// are the next steps.
#include "int8_mma.cuh"

namespace {

using int8_mma::Params;
using Launch = cudaError_t (*)(const Params&, cudaStream_t);

// [x signed][planes signed][masked]
template <bool XS, bool WS, bool MASKED>
constexpr Launch kLaunch = int8_mma::launch<XS, WS, MASKED, false, true, 2, false>;
constexpr Launch kTable[2][2][2] = {
    {{kLaunch<false, false, false>, kLaunch<false, false, true>},
     {kLaunch<false, true, false>, kLaunch<false, true, true>}},
    {{kLaunch<true, false, false>, kLaunch<true, false, true>},
     {kLaunch<true, true, false>, kLaunch<true, true, true>}}};

}  // namespace

// `workspace`: null, or a zeroed int32 [M, N] buffer that the K splits of
// `k_split` rows each add into (it may be `out` itself when out is int32).
extern "C" int bitserial_gemm(const void* x, int x_signed, const void* planes,
                              const void* mask, int mask_bk, int mask_bn,
                              int mask_nk, int mask_nn, const void* w_scale,
                              float x_scale, void* out, int out_float,
                              void* workspace, int M, int N, int K,
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
  p.xld = K;
  p.k_split = workspace != nullptr ? k_split : K;
  p.n_bits = n_bits;
  p.x_vec = (K % 16 == 0) && int8_mma::aligned16(x);
  p.w_vec = int8_mma::aligned16(planes);
  p.w_aligned = p.w_vec && N % 16 == 0;
  const Launch run =
      kTable[x_signed != 0][signed_planes != 0][mask != nullptr];
  return static_cast<int>(run(p, static_cast<cudaStream_t>(stream)));
}
