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
// Design: decode once, multiply once on the int8 tensor cores.
// - One block of 4 warps owns a 128x64 output tile (each warp 64x32, 4 x 4
//   mma.sync.m16n8k32 tiles with the x and w signedness as their operand
//   types) and walks its K range in 64-wide steps, at most 170 registers a
//   thread so that three blocks share an SM.
// - Each step's x tile and packed-byte tile are staged by 16-byte cp.async
//   copies into a three-stage ring, so two steps load while one decodes
//   and multiplies.  x rows go whole when K % 16 == 0 (byte by byte
//   otherwise); a packed row goes as the 16-byte aligned window around its
//   64 bytes, so any N is copied asynchronously.
// - The packed tile is decoded into the transposed weight tile [n][k] in
//   shared memory: without a mask, 4x4 bytes a thread (the bits above
//   n_bits dropped and sign-extended per byte with SIMD ops, then a byte
//   permute transpose); with one, byte by byte, the mask looked up per
//   element, since the caller's block sizes are arbitrary (a separate
//   instantiation, so the unmasked kernel carries none of it).  x and w
//   fragments come from 80-byte padded rows through ldmatrix.
// - int32 sums stay in registers, without .satfinite, so they wrap as the
//   TPU kernel's accumulator does.
// - Split-K: where the output tiles cannot fill the card (a few rows, or
//   few tiles over a long K), the wrapper splits K into ranges of whole
//   steps (blockIdx.z); each split adds its partial sums into a zeroed
//   int32 workspace with atomic adds, which are exact and order-free
//   modulo 2^32, and a second small launch applies the float epilogue.
// - Ragged M/N/K edges are zero-filled on load and masked on store;
//   nothing is padded in device memory.
// What holds it above the bound at the main path's shapes: each block
// walks few K steps (5 at Conv2d_2b), so filling the ring and draining
// the int32 tile cost about as much as the steps, and the loads alone run
// at about half the card's memory rate; wgmma, TMA and a persistent grid
// are the next steps.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 64;
constexpr int BK = 64;
constexpr int STAGES = 3;  // depth of the cp.async ring
constexpr int THREADS = 128;  // 4 warps in a 2x2 grid of 64x32 sub-tiles
constexpr int MIN_BLOCKS = 3;  // per SM: at most 170 registers a thread
constexpr int LDS = BK + 16;  // padded shared row stride in bytes
constexpr int PLD = BN + 16;  // a packed row: a 16-byte aligned window
constexpr int EPI_THREADS = 256;

struct Smem {
  uint8_t xs[STAGES][BM][LDS];  // x tiles: row m, k contiguous
  uint8_t ps[STAGES][BK][PLD];  // packed weight rows (windows), n contiguous
  uint8_t shift[STAGES][BK];    // where column n0 sits in each window
  uint8_t ws[BN][LDS];  // decoded weights, transposed: row n, k contiguous
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy of the first src_bytes (0..16) bytes; the rest of the
// destination is zero-filled
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16x32, row) * b (32x8, col), int32 accumulation modulo 2^32
template <bool XS, bool WS>
__device__ __forceinline__ void mma_8bit(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#define BS_MMA(TA, TB)                                                       \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "    \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "              \
               "{%0, %1, %2, %3};\n"                                         \
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (XS && WS) {
    BS_MMA("s8", "s8");
  } else if constexpr (XS) {
    BS_MMA("s8", "u8");
  } else if constexpr (WS) {
    BS_MMA("u8", "s8");
  } else {
    BS_MMA("u8", "u8");
  }
#undef BS_MMA
}

// Stage the x rows [m0, m0 + BM) and packed rows [k0, k0 + BK) of one
// step; elements outside M or K are zero.  x rows go by 16-byte copies
// when K % 16 == 0 and x is aligned, else byte by byte.  A packed row
// k goes as the 16-byte aligned window around bytes [k*N + n0, +BN) (four
// or five copies, cut at the end of the tensor), with the offset of n0
// kept in `shift`, when planes is aligned; else byte by byte.
__device__ __forceinline__ void stage(Smem& sm, int buf,
                                      const uint8_t* __restrict__ x,
                                      const uint8_t* __restrict__ planes,
                                      int64_t m0, int64_t n0, int64_t k0,
                                      int M, int N, int K, bool x_vec,
                                      bool p_vec, int tid) {
  if (x_vec) {
#pragma unroll
    for (int e = tid; e < BM * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      const int64_t m = m0 + r, k = k0 + c;
      const bool in = m < M && k < K;
      cp_async_16(&sm.xs[buf][r][c], in ? x + m * K + k : x, in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < BM * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int64_t m = m0 + r, k = k0 + c;
      sm.xs[buf][r][c] = (m < M && k < K) ? x[m * K + k] : 0;
    }
  }
  if (p_vec) {
    const int chunks = (N % 16 == 0) ? BN / 16 : BN / 16 + 1;
    const int64_t total = static_cast<int64_t>(K) * N;
    for (int e = tid; e < BK * chunks; e += THREADS) {
      const int r = e / chunks, c = e % chunks;
      const int64_t k = k0 + r;
      const int64_t first = k * N + n0;
      const int64_t src = (first & ~static_cast<int64_t>(15)) + 16 * c;
      int64_t valid = k < K ? total - src : 0;
      valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
      cp_async_16(&sm.ps[buf][r][16 * c], valid ? planes + src : planes,
                  static_cast<int>(valid));
      if (c == 0) sm.shift[buf][r] = static_cast<uint8_t>(first & 15);
    }
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int64_t k = k0 + r, n = n0 + c;
      sm.ps[buf][r][c] = (k < K && n < N) ? planes[k * N + n] : 0;
      if (c == 0) sm.shift[buf][r] = 0;
    }
  }
}

template <bool XS, bool WS, bool MASKED>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
bitserial_gemm_kernel(const uint8_t* __restrict__ x,
                      const uint8_t* __restrict__ planes,
                      const int8_t* __restrict__ mask, int mask_bk,
                      int mask_bn, int mask_nk, int mask_nn,
                      const float* __restrict__ w_scale, float x_scale,
                      void* __restrict__ out, int out_float,
                      uint32_t* __restrict__ partial, int M, int N, int K,
                      int k_split, int n_bits, int x_vec, int p_vec) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // MMA fragment row group
  const int t = lane & 3;   // thread within the group
  const int wm = (warp >> 1) * 64;
  const int wn = (warp & 1) * 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * k_split;
  const int64_t k_end =
      k_begin + k_split < K ? k_begin + k_split : static_cast<int64_t>(K);
  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  const uint32_t low = (1u << n_bits) - 1u;  // bits that hold planes
  const uint32_t msb = 1u << (n_bits - 1);

  // ldmatrix rows/columns of this lane: x (A) addresses rows 0-7 / 8-15 in
  // matrices 0,2 / 1,3; w (B, rows n) addresses them in 0,1 / 2,3
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  // one commit group per step (empty past the last), so that waiting for
  // all but the newest STAGES - 2 groups always means "step s landed"
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < steps)
      stage(sm, s, x, planes, m0, n0, k_begin + static_cast<int64_t>(s) * BK,
            M, N, K, x_vec, p_vec, tid);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % STAGES;
    const int64_t k0 = k_begin + static_cast<int64_t>(s) * BK;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + STAGES - 1 < steps)
      stage(sm, (s + STAGES - 1) % STAGES, x, planes, m0, n0,
            k0 + static_cast<int64_t>(STAGES - 1) * BK, M, N, K, x_vec, p_vec,
            tid);
    cp_async_commit();

    // decode: w = sum_b pw[b] * bit_b * mask into the transposed tile
    if constexpr (!MASKED) {
      // a 4 (k) x 4 (n) block a thread: four words of packed rows, the
      // bits above n_bits dropped and (signed) sign-extended per byte,
      // then transposed so each word holds four k of one n
      const uint32_t low4 = low * 0x01010101u, msb4 = msb * 0x01010101u;
#pragma unroll
      for (int i = 0; i < (BK / 4) * (BN / 4) / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int nq = (e % (BN / 4)) * 4, kq = (e / (BN / 4)) * 4;
        const int64_t in_n = N - (n0 + nq);  // columns of the four inside N
        const uint32_t keep =
            in_n >= 4 ? 0xFFFFFFFFu
                      : (in_n <= 0 ? 0u : (1u << (8 * in_n)) - 1u);
        uint32_t r[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int at = sm.shift[buf][kq + j] + nq;
          const uint32_t* w = reinterpret_cast<const uint32_t*>(
              &sm.ps[buf][kq + j][at & ~3]);
          r[j] = __funnelshift_r(w[0], w[1], 8 * (at & 3)) & keep & low4;
          if (WS) r[j] = __vsub4(r[j] ^ msb4, msb4);
        }
        const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
        const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
        const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
        const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
        *reinterpret_cast<uint32_t*>(&sm.ws[nq][kq]) = __byte_perm(t0, t1, 0x5410);
        *reinterpret_cast<uint32_t*>(&sm.ws[nq + 1][kq]) = __byte_perm(t0, t1, 0x7632);
        *reinterpret_cast<uint32_t*>(&sm.ws[nq + 2][kq]) = __byte_perm(t2, t3, 0x5410);
        *reinterpret_cast<uint32_t*>(&sm.ws[nq + 3][kq]) = __byte_perm(t2, t3, 0x7632);
      }
    } else {
      // masked: byte by byte, the mask looked up per element
#pragma unroll 2
      for (int i = 0; i < (BK / 4) * BN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int nn = e % BN, kq = (e / BN) * 4;
        const bool n_in = n0 + nn < N;
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = kq + j;
          uint32_t p =
              n_in ? sm.ps[buf][kk][sm.shift[buf][kk] + nn] & low : 0u;
          if (p != 0u) {
            const int kb = static_cast<int>((k0 + kk) / mask_bk);
            const int nb = static_cast<int>((n0 + nn) / mask_bn);
            uint32_t keep = 0u;
            for (int b = 0; b < n_bits; ++b)
              if (mask[(static_cast<int64_t>(b) * mask_nk + kb) * mask_nn +
                       nb])
                keep |= 1u << b;
            p &= keep;
          }
          const int w = WS ? static_cast<int>(p & (msb - 1u)) -
                                 static_cast<int>(p & msb)
                           : static_cast<int>(p);
          word |= (static_cast<uint32_t>(w) & 0xFFu) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(&sm.ws[nn][kq]) = word;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ldsm_x4(a[i], &sm.xs[buf][wm + i * 16 + a_row][kk + a_col]);
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        ldsm_x4(r, &sm.ws[wn + jp * 16 + b_row][kk + b_col]);
        b[2 * jp][0] = r[0];
        b[2 * jp][1] = r[1];
        b[2 * jp + 1][0] = r[2];
        b[2 * jp + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_8bit<XS, WS>(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row
  // g+8; a pair goes as one 8-byte store when N is even
  const bool pairs = (N % 2 == 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + g + half * 8;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t n = n0 + wn + j * 8 + t * 2;
        if (n >= N) continue;
        const int v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        const int64_t o = m * N + n;
        if (partial != nullptr) {
          atomicAdd(partial + o, static_cast<uint32_t>(v0));
          if (n + 1 < N) atomicAdd(partial + o + 1, static_cast<uint32_t>(v1));
        } else if (out_float) {
          float* of = static_cast<float*>(out) + o;
          const float f0 =
              __fmul_rn(__fmul_rn(__int2float_rn(v0), x_scale), w_scale[n]);
          if (pairs) {
            *reinterpret_cast<float2*>(of) = make_float2(
                f0, __fmul_rn(__fmul_rn(__int2float_rn(v1), x_scale),
                              w_scale[n + 1]));
          } else {
            of[0] = f0;
            if (n + 1 < N)
              of[1] = __fmul_rn(__fmul_rn(__int2float_rn(v1), x_scale),
                                w_scale[n + 1]);
          }
        } else {
          int32_t* oi = static_cast<int32_t*>(out) + o;
          if (pairs) {
            *reinterpret_cast<int2*>(oi) = make_int2(v0, v1);
          } else {
            oi[0] = v0;
            if (n + 1 < N) oi[1] = v1;
          }
        }
      }
    }
  }
}

// the float epilogue of a split-K run: out = f32(acc) * x_scale * w_scale[n]
__global__ void __launch_bounds__(EPI_THREADS)
float_epilogue(const int32_t* __restrict__ acc,
               const float* __restrict__ w_scale, float x_scale,
               float* __restrict__ out, int64_t total, int N) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * EPI_THREADS +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * EPI_THREADS)
    out[i] = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), x_scale),
                       w_scale[i % N]);
}

template <bool XS, bool WS, bool MASKED>
cudaError_t launch(dim3 grid, cudaStream_t stream, const uint8_t* x,
                   const uint8_t* planes, const int8_t* mask, int mask_bk,
                   int mask_bn, int mask_nk, int mask_nn,
                   const float* w_scale, float x_scale, void* out,
                   int out_float, uint32_t* partial, int M, int N, int K,
                   int k_split, int n_bits, int x_vec, int p_vec) {
  constexpr int bytes = static_cast<int>(sizeof(Smem));
  const cudaError_t err = cudaFuncSetAttribute(
      bitserial_gemm_kernel<XS, WS, MASKED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  bitserial_gemm_kernel<XS, WS, MASKED><<<grid, THREADS, bytes, stream>>>(
      x, planes, mask, mask_bk, mask_bn, mask_nk, mask_nn, w_scale, x_scale,
      out, out_float, partial, M, N, K, k_split, n_bits, x_vec, p_vec);
  return cudaGetLastError();
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0u;
}

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
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int splits = workspace != nullptr ? (K + k_split - 1) / k_split : 1;
  const dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, splits);
  const int x_vec = (K % 16 == 0) && aligned16(x);
  const int p_vec = aligned16(planes);
  auto* partial = static_cast<uint32_t*>(workspace);
  const auto* xb = static_cast<const uint8_t*>(x);
  const auto* pb = static_cast<const uint8_t*>(planes);
  const auto* mb = static_cast<const int8_t*>(mask);
  const auto* wsc = static_cast<const float*>(w_scale);
  const int ks = workspace != nullptr ? k_split : K;
  using Launch = decltype(&launch<true, true, true>);
  // [x signed][planes signed][masked]
  constexpr Launch table[2][2][2] = {
      {{launch<false, false, false>, launch<false, false, true>},
       {launch<false, true, false>, launch<false, true, true>}},
      {{launch<true, false, false>, launch<true, false, true>},
       {launch<true, true, false>, launch<true, true, true>}}};
  const Launch run =
      table[x_signed != 0][signed_planes != 0][mask != nullptr];
  cudaError_t err = run(grid, s, xb, pb, mb, mask_bk, mask_bn, mask_nk,
                        mask_nn, wsc, x_scale, out, out_float, partial, M, N,
                        K, ks, n_bits, x_vec, p_vec);
  if (err != cudaSuccess || workspace == nullptr || !out_float)
    return static_cast<int>(err);
  const int64_t total = static_cast<int64_t>(M) * N;
  const int64_t want = (total + EPI_THREADS - 1) / EPI_THREADS;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  float_epilogue<<<blocks, EPI_THREADS, 0, s>>>(
      static_cast<const int32_t*>(workspace), wsc, x_scale,
      static_cast<float*>(out), total, N);
  return static_cast<int>(cudaGetLastError());
}
