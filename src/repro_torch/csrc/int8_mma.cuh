// The int8 tensor-core GEMM that the three int8 kernels of this directory
// share (sm_90a): bitserial_gemm.cu, bitserial_gemm_a4.cu and
// quant_gemm.cu each instantiate `int8_gemm_kernel` with their operand
// formats and keep their own extern "C" launcher.
//
//   out[m, n] = epilogue(sum_k x[m, k] * w[k, n])
//
// x is 8-bit (u8 or s8), either one byte an element in rows of K bytes or
// two 4-bit elements a byte (the even element in the low nibble) in rows of
// K2 >= ceil(K/2) bytes.  w comes as rows of N bytes, [K, N], and each byte
// is decoded into one u8/s8 weight: with FOLD, the bit-serial fold
//   w[k, n] = sum_b pw[b] * bit_b(byte) * mask[b, k/bk, n/bn]
// (pw[b] = 2^b, the MSB plane -2^(n-1) when the planes are signed), and
// without it the byte itself as an s8 weight.  The epilogue is the exact
// int32 sum (wrapping modulo 2^32, as the TPU kernels' int32 accumulators
// do) or (f32(acc) * x_scale) * w_scale[n] (+ bias[n]), each step rounded
// to nearest, no FMA contraction.
//
// Design:
// - A block of 4 warps owns a BM x BN output tile, each warp a 64x32
//   sub-tile (4 x 4 mma.sync.m16n8k32 tiles, the operand types the x and w
//   signedness) in a 2x2 grid (128x64 tiles) or a 1x4 row (64x128).  At
//   most 170 registers a thread, so that three blocks share an SM.
// - Each 64-wide K step's x tile and w rows are staged by 16-byte cp.async
//   copies into a three-stage ring.  A w row, and a nibble-packed x row,
//   goes as the 16-byte aligned window around its bytes (one copy more than
//   the bytes need, cut at the end of the tensor), with the offset of its
//   first byte kept beside it, so any N or K2 is copied asynchronously;
//   when every row starts on a 16-byte boundary, without the extra copy and
//   read without a funnel shift (word-aligned x rows too are read without
//   one).  Byte x rows go whole when K % 16 == 0, byte by byte otherwise.
//   x rows past M are not copied at all.
// - Once per staged step, the w rows are decoded into the transposed tile
//   [n][k] that the B fragments need (k contiguous): 4x4 bytes a thread
//   (funnel shift out of the window, the fold's bit mask and sign
//   extension as SIMD byte operations, then a byte permute transpose), or,
//   with a mask, byte by byte with the mask looked up per element, since
//   the caller's mask blocks match no tile (a separate instantiation).  The
//   tile's 16-byte chunks are swizzled by row (ws_at), which keeps the
//   decode's 4-byte stores to 2-way bank conflicts (8-way unswizzled).  Nibble-packed x is widened in the same pass
//   into an [m][k] byte tile: a 32-bit word of 8 nibbles becomes two words
//   of 4 bytes by masks and two byte permutes (sign extension by one
//   multiply: 8 * 0x1E = 0xF0 within each byte).  Widening in shared
//   memory, not in registers after the fragment loads, widens each nibble
//   once per block rather than once per warp that reads its row, and keeps
//   the product loop the byte kernels' own.
// - DIRECT (s8 weights, no fold, N % 16 == 0): no decode pass.  The w rows
//   are staged whole with their 16-byte chunks swizzled, and each warp
//   transposes its B fragments in registers: ldmatrix .trans hands a
//   thread two 2x2 byte blocks of rows 4t..4t+3, and two byte permutes
//   make them the words of columns 2g and 2g+1.  So one n8 tile holds a
//   chunk's even columns and the next its odd ones, and each thread stores
//   four adjacent columns at once.  This drops the decode pass and its
//   stores into the transposed tile, and one barrier a step.
// - Fragments come through ldmatrix from 80-byte padded rows; the int32
//   sums stay in registers without .satfinite, so they wrap.
// - Split-K: the launcher may split K into ranges of whole steps
//   (blockIdx.z); each split adds its partial sums into a zeroed int32
//   workspace with atomic adds, exact and order-free modulo 2^32, and
//   `float_epilogue` applies the float epilogue in a second launch.
// - Ragged M/N/K edges are zero-filled on load (w rows at or past K are
//   zero, so x bytes past K, or past K2 inside a window, meet zero weights)
//   and masked on store; nothing is padded in device memory.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8_mma {

constexpr int BK = 64;          // K elements a step
constexpr int STAGES = 3;       // depth of the cp.async ring
constexpr int THREADS = 128;    // 4 warps
constexpr int MIN_BLOCKS = 3;   // per SM: at most 170 registers a thread
constexpr int LDS = BK + 16;    // padded [m][k] / [n][k] row stride, bytes
constexpr int XPLD = BK / 2 + 16;  // a nibble-packed x row's window, bytes
constexpr int EPI_THREADS = 256;

struct Params {
  const uint8_t* x;
  const uint8_t* w;
  const int8_t* mask;  // [n_bits, mask_nk, mask_nn] or null
  int mask_bk, mask_bn, mask_nk, mask_nn;
  const float* w_scale;
  const float* bias;  // null: no bias
  float x_scale;
  void* out;
  int out_float;
  uint32_t* partial;  // null, or the zeroed int32 [M, N] split-K workspace
  int M, N, K;
  int xld;      // bytes per x row: K, or K2 for nibble-packed x
  int k_split;  // K rows of each split (a multiple of BK), K without split
  int n_bits;
  int x_vec, w_vec;  // x and w may be copied by 16-byte cp.async
  // nibble-packed x: the alignment (16, 4 or 1 bytes) of every staged row's
  // first byte in its window (K2 % 16 == 0, K2 % 4 == 0, else)
  int x_align;
  // every staged w row starts on a 16-byte boundary (N % 16 == 0, w aligned)
  int w_aligned;
};

template <int BM, int BN, bool NIB, bool DIRECT>
struct Smem {
  alignas(16) uint8_t xs[STAGES][BM][NIB ? XPLD : LDS];  // staged x rows
  alignas(16) uint8_t xshift[STAGES][NIB ? BM : 1];  // x window offsets
  // staged w rows: windows of BN + 16 bytes, or (DIRECT) BN bytes whose
  // 16-byte chunks are swizzled (direct_chunk)
  alignas(16) uint8_t ws_rows[STAGES][BK][DIRECT ? BN : BN + 16];
  alignas(16) uint8_t wshift[STAGES][DIRECT ? 1 : BK];  // column n0's offset
  alignas(16) uint8_t xw[NIB ? BM : 1][LDS];  // widened x: row m, k contiguous
  // decoded w, transposed: row n, k contiguous (not used when DIRECT)
  alignas(16) uint8_t ws[DIRECT ? 1 : BN][LDS];
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
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Where byte k of row n of the decoded tile `ws` lies in its row: the
// 16-byte chunks are XOR-swizzled by bits 3-4 of n, so that the decode's
// 4-byte stores (a warp writes one k-word of 16 or 32 rows n, 4 apart)
// spread over the banks (2-way conflicts at 64 columns, 4-way at 128,
// instead of 8- and 16-way), while the 8 consecutive rows an ldmatrix
// matrix reads keep one chunk offset and stay conflict-free.
__device__ __forceinline__ int ws_at(int n, int k) {
  return 16 * ((k >> 4) ^ ((n >> 3) & 3)) + (k & 15);
}

// DIRECT layout: where logical 16-byte chunk c of staged w row r lies in
// its row of BN bytes.  The B fragments read, per 8x8 matrix, rows r =
// 4i + {0, 1} (or + {2, 3}) for i = 0..3 of one 16-row group at one chunk;
// XOR-ing the chunk with bits 2-3 of r (and, in 128-byte rows, bit 0 into
// bit 2) puts those 8 rows in 8 distinct 16-byte bank groups.
template <int BN>
__device__ __forceinline__ int direct_chunk(int r, int c) {
  const int f = BN == 128 ? (((r >> 2) & 3) | ((r & 1) << 2)) : ((r >> 2) & 3);
  return c ^ f;
}

// c += a (16x32, row) * b (32x8, col), int32 accumulation modulo 2^32
template <bool XS, bool WS>
__device__ __forceinline__ void mma_8bit(int (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
#define INT8_MMA(TA, TB)                                                     \
  asm volatile("mma.sync.aligned.m16n8k32.row.col.s32." TA "." TB ".s32 "    \
               "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "              \
               "{%0, %1, %2, %3};\n"                                         \
               : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])              \
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1))
  if constexpr (XS && WS) {
    INT8_MMA("s8", "s8");
  } else if constexpr (XS) {
    INT8_MMA("s8", "u8");
  } else if constexpr (WS) {
    INT8_MMA("u8", "s8");
  } else {
    INT8_MMA("u8", "u8");
  }
#undef INT8_MMA
}

// four words, each four bytes of one row (k), transposed so that word j
// holds the four rows' bytes of column j
__device__ __forceinline__ void transpose4x4(const uint32_t (&r)[4],
                                             uint32_t (&c)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t2 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  c[0] = __byte_perm(t0, t1, 0x5410);
  c[1] = __byte_perm(t0, t1, 0x7632);
  c[2] = __byte_perm(t2, t3, 0x5410);
  c[3] = __byte_perm(t2, t3, 0x7632);
}

// eight nibbles (the even element low in each byte) widened to two words
// of four bytes, in element order; sign-extended from 4 bits when XS
template <bool XS>
__device__ __forceinline__ uint2 widen_nibbles(uint32_t v) {
  uint32_t lo = v & 0x0F0F0F0Fu;         // elements 0, 2, 4, 6
  uint32_t hi = (v >> 4) & 0x0F0F0F0Fu;  // elements 1, 3, 5, 7
  if constexpr (XS) {
    lo |= (lo & 0x08080808u) * 0x1Eu;
    hi |= (hi & 0x08080808u) * 0x1Eu;
  }
  return make_uint2(__byte_perm(lo, hi, 0x5140), __byte_perm(lo, hi, 0x7362));
}

// Copy rows [0, rows) of `WIDTH` bytes (a multiple of 16) starting at byte
// `col` of rows `row0`.. of a row-major [n_rows, ld] byte tensor into
// shared rows of stride `dst_ld`, each as the 16-byte aligned window
// around its bytes, CHUNKS copies a row (WIDTH / 16 when every row starts
// on a 16-byte boundary, else one more); the offset of each row's first
// byte in its window goes to shift[r].  Rows at or past n_rows, and bytes
// past the tensor's end, are zero.
template <int CHUNKS>
__device__ __forceinline__ void copy_windows(uint8_t* dst, int dst_ld,
                                             uint8_t* shift,
                                             const uint8_t* __restrict__ src,
                                             int rows, int64_t row0,
                                             int64_t n_rows, int64_t ld,
                                             int64_t col, int tid) {
  const int64_t total = n_rows * ld;
  for (int e = tid; e < rows * CHUNKS; e += THREADS) {
    const int r = e / CHUNKS, c = e % CHUNKS;
    const int64_t row = row0 + r;
    const int64_t first = row * ld + col;
    const int64_t at = (first & ~static_cast<int64_t>(15)) + 16 * c;
    int64_t valid = row < n_rows ? total - at : 0;
    valid = valid < 0 ? 0 : (valid > 16 ? 16 : valid);
    cp_async_16(dst + r * dst_ld + 16 * c, valid ? src + at : src,
                static_cast<int>(valid));
    if (c == 0) shift[r] = static_cast<uint8_t>(first & 15);
  }
}

template <int WIDTH>
__device__ __forceinline__ void stage_windows(uint8_t* dst, int dst_ld,
                                              uint8_t* shift,
                                              const uint8_t* __restrict__ src,
                                              int rows, int64_t row0,
                                              int64_t n_rows, int64_t ld,
                                              int64_t col, bool aligned,
                                              int tid) {
  if (aligned)
    copy_windows<WIDTH / 16>(dst, dst_ld, shift, src, rows, row0, n_rows, ld,
                             col, tid);
  else
    copy_windows<WIDTH / 16 + 1>(dst, dst_ld, shift, src, rows, row0, n_rows,
                                 ld, col, tid);
}

// Stage the x rows [m0, m0 + BM) and w rows [k0, k0 + BK) of one step.
// x rows at or past M are left as they are: their products land in output
// rows that are never stored.  w rows at or past K are zero, so x bytes
// past K (or past K2, inside a window) meet zero weights.
template <int BM, int BN, bool NIB, bool DIRECT>
__device__ __forceinline__ void stage(Smem<BM, BN, NIB, DIRECT>& sm, int buf,
                                      const Params& p, int64_t m0, int64_t n0,
                                      int64_t k0, int tid) {
  const int x_rows = p.M - m0 < BM ? static_cast<int>(p.M - m0) : BM;
  if constexpr (NIB) {
    if (p.x_vec) {
      stage_windows<BK / 2>(&sm.xs[buf][0][0], XPLD, sm.xshift[buf], p.x,
                            x_rows, m0, p.M, p.xld, k0 / 2, p.x_align == 16,
                            tid);
    } else {
      for (int e = tid; e < x_rows * (BK / 2); e += THREADS) {
        const int r = e / (BK / 2), c = e % (BK / 2);
        const int64_t m = m0 + r, k2 = k0 / 2 + c;
        sm.xs[buf][r][c] = k2 < p.xld ? p.x[m * p.xld + k2] : 0;
        if (c == 0) sm.xshift[buf][r] = 0;
      }
    }
  } else if (p.x_vec) {
    for (int e = tid; e < x_rows * (BK / 16); e += THREADS) {
      const int r = e / (BK / 16), c = (e % (BK / 16)) * 16;
      const int64_t m = m0 + r, k = k0 + c;
      const bool in = k < p.K;
      cp_async_16(&sm.xs[buf][r][c], in ? p.x + m * p.K + k : p.x,
                  in ? 16 : 0);
    }
  } else {
    for (int e = tid; e < x_rows * BK; e += THREADS) {
      const int r = e / BK, c = e % BK;
      const int64_t m = m0 + r, k = k0 + c;
      sm.xs[buf][r][c] = k < p.K ? p.x[m * p.K + k] : 0;
    }
  }
  if constexpr (DIRECT) {
    // N % 16 == 0 and w aligned: whole chunks, swizzled, zero past K or N
    for (int e = tid; e < BK * (BN / 16); e += THREADS) {
      const int r = e / (BN / 16), c = e % (BN / 16);
      const int64_t k = k0 + r, n = n0 + 16 * c;
      const bool in = k < p.K && n < p.N;
      cp_async_16(&sm.ws_rows[buf][r][16 * direct_chunk<BN>(r, c)],
                  in ? p.w + k * p.N + n : p.w, in ? 16 : 0);
    }
  } else if (p.w_vec) {
    stage_windows<BN>(&sm.ws_rows[buf][0][0], BN + 16, sm.wshift[buf], p.w,
                      BK, k0, p.K, p.N, n0, p.w_aligned, tid);
  } else {
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int r = e / BN, c = e % BN;
      const int64_t k = k0 + r, n = n0 + c;
      sm.ws_rows[buf][r][c] = (k < p.K && n < p.N) ? p.w[k * p.N + n] : 0;
      if (c == 0) sm.wshift[buf][r] = 0;
    }
  }
}

// Decode the staged w rows of `buf` into the transposed tile, without a
// mask: a 4 (k) x 4 (n) block a thread, four words out of the row windows
// (one load each when every window starts at its row's first byte, else
// two and a funnel shift); with FOLD the bits above n_bits dropped and
// (signed) sign-extended per byte; then transposed so each word holds
// four k of one n.
template <int BM, int BN, bool NIB, bool WS, bool FOLD, bool ALIGNED>
__device__ __forceinline__ void decode_unmasked(Smem<BM, BN, NIB, false>& sm,
                                                int buf, uint32_t low4,
                                                uint32_t msb4, int tid) {
#pragma unroll
  for (int i = 0; i < (BK / 4) * (BN / 4) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int nq = (e % (BN / 4)) * 4, kq = (e / (BN / 4)) * 4;
    uint32_t r[4], c[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (ALIGNED) {
        r[j] = *reinterpret_cast<const uint32_t*>(&sm.ws_rows[buf][kq + j][nq]);
      } else {
        const int at = sm.wshift[buf][kq + j] + nq;
        const uint32_t* v = reinterpret_cast<const uint32_t*>(
            &sm.ws_rows[buf][kq + j][at & ~3]);
        r[j] = __funnelshift_r(v[0], v[1], 8 * (at & 3));
      }
      if constexpr (FOLD) {
        r[j] &= low4;
        if (WS) r[j] = __vsub4(r[j] ^ msb4, msb4);
      }
    }
    transpose4x4(r, c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<uint32_t*>(&sm.ws[nq + j][ws_at(nq + j, kq)]) = c[j];
  }
}

// Widen the staged nibble-packed x rows of `buf` into the byte tile: one
// word of the window (8 nibbles) a pass, read at the row's offset in its
// window (ALIGN: 16, none; 4, a word-aligned one; 1, any, by funnel shift).
// Rows past M were not staged; their offsets are masked into the window,
// and what they widen to lands in output rows that are never stored.
template <int BM, int BN, bool DIRECT, bool XS, int ALIGN>
__device__ __forceinline__ void widen_x(Smem<BM, BN, true, DIRECT>& sm,
                                        int buf, int tid) {
  static_assert(BM * (BK / 8) % THREADS == 0, "widening passes");
#pragma unroll
  for (int i = 0; i < BM * (BK / 8) / THREADS; ++i) {
    const int e = tid + i * THREADS;
    const int r = e / (BK / 8), j = e % (BK / 8);
    uint32_t v;
    if constexpr (ALIGN == 16) {
      v = *reinterpret_cast<const uint32_t*>(&sm.xs[buf][r][4 * j]);
    } else if constexpr (ALIGN == 4) {
      v = *reinterpret_cast<const uint32_t*>(
          &sm.xs[buf][r][(sm.xshift[buf][r] & 12) + 4 * j]);
    } else {
      const int at = (sm.xshift[buf][r] & 15) + 4 * j;
      const uint32_t* w =
          reinterpret_cast<const uint32_t*>(&sm.xs[buf][r][at & ~3]);
      v = __funnelshift_r(w[0], w[1], 8 * (at & 3));
    }
    *reinterpret_cast<uint2*>(&sm.xw[r][8 * j]) = widen_nibbles<XS>(v);
  }
}

// XS, WS: x and w signed.  MASKED: a plane mask is given (FOLD only).
// NIB: x is nibble-packed.  FOLD: w bytes are bit planes to fold, else s8
// weights.  WM: warps along M (2: 128x64 tiles, 1: 64x128).  DIRECT: s8
// weights with N % 16 == 0 and w aligned, transposed in registers.
template <bool XS, bool WS, bool MASKED, bool NIB, bool FOLD, int WM,
          bool DIRECT>
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
int8_gemm_kernel(const Params p) {
  static_assert(!DIRECT || (!MASKED && !NIB && !FOLD),
                "the direct path takes byte x and s8 weights");
  constexpr int BM = 64 * WM;
  constexpr int BN = 32 * (4 / WM);
  using Sm = Smem<BM, BN, NIB, DIRECT>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // MMA fragment row group
  const int t = lane & 3;   // thread within the group
  const int wm = (warp / (4 / WM)) * 64;
  const int wn = (warp % (4 / WM)) * 32;
  const int64_t m0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int64_t n0 = static_cast<int64_t>(blockIdx.y) * BN;
  const int64_t k_begin = static_cast<int64_t>(blockIdx.z) * p.k_split;
  const int64_t k_end = k_begin + p.k_split < p.K
                            ? k_begin + p.k_split
                            : static_cast<int64_t>(p.K);
  const int steps = static_cast<int>((k_end - k_begin + BK - 1) / BK);
  const uint32_t low = (1u << p.n_bits) - 1u;  // bits that hold planes
  const uint32_t msb = 1u << (p.n_bits - 1);

  // ldmatrix rows/columns of this lane: x (A) addresses rows 0-7 / 8-15 in
  // matrices 0,2 / 1,3; w (B, rows n) addresses them in 0,1 / 2,3
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 16;
  const int b_row = (lane & 7) + (lane >> 4) * 8;
  const int b_col = ((lane >> 3) & 1) * 16;
  // DIRECT: the staged w row this lane addresses in a 32-row group, so that
  // .trans hands thread (g, t) rows 4t, 4t+1 (matrices 0, 2) and 4t+2,
  // 4t+3 (1, 3) of each 16-row half at columns 2g, 2g+1 of a chunk
  const int t_row = 16 * (lane >> 4) + 4 * ((lane & 7) >> 1) +
                    2 * ((lane >> 3) & 1) + (lane & 1);

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
      stage(sm, s, p, m0, n0, k_begin + static_cast<int64_t>(s) * BK, tid);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    const int buf = s % STAGES;
    const int64_t k0 = k_begin + static_cast<int64_t>(s) * BK;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // step s landed; every warp is done with step s - 1
    if (s + STAGES - 1 < steps)
      stage(sm, (s + STAGES - 1) % STAGES, p, m0, n0,
            k0 + static_cast<int64_t>(STAGES - 1) * BK, tid);
    cp_async_commit();

    if constexpr (NIB) {
      if (p.x_align == 16)
        widen_x<BM, BN, DIRECT, XS, 16>(sm, buf, tid);
      else if (p.x_align == 4)
        widen_x<BM, BN, DIRECT, XS, 4>(sm, buf, tid);
      else
        widen_x<BM, BN, DIRECT, XS, 1>(sm, buf, tid);
    }
    // decode the w rows into the transposed tile (DIRECT: nothing to do)
    if constexpr (DIRECT) {
    } else if constexpr (!MASKED) {
      const uint32_t low4 = low * 0x01010101u, msb4 = msb * 0x01010101u;
      if (p.w_aligned)
        decode_unmasked<BM, BN, NIB, WS, FOLD, true>(sm, buf, low4, msb4,
                                                      tid);
      else
        decode_unmasked<BM, BN, NIB, WS, FOLD, false>(sm, buf, low4, msb4,
                                                       tid);
    } else {
      // masked: byte by byte, the mask looked up per element
#pragma unroll 2
      for (int i = 0; i < (BK / 4) * BN / THREADS; ++i) {
        const int e = tid + i * THREADS;
        const int nn = e % BN, kq = (e / BN) * 4;
        const bool n_in = n0 + nn < p.N;
        uint32_t word = 0u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int kk = kq + j;
          uint32_t v = n_in ? sm.ws_rows[buf][kk][sm.wshift[buf][kk] + nn] & low
                            : 0u;
          if (v != 0u) {
            const int kb = static_cast<int>((k0 + kk) / p.mask_bk);
            const int nb = static_cast<int>((n0 + nn) / p.mask_bn);
            uint32_t keep = 0u;
            for (int b = 0; b < p.n_bits; ++b)
              if (p.mask[(static_cast<int64_t>(b) * p.mask_nk + kb) *
                             p.mask_nn +
                         nb])
                keep |= 1u << b;
            v &= keep;
          }
          const int wv = WS ? static_cast<int>(v & (msb - 1u)) -
                                  static_cast<int>(v & msb)
                            : static_cast<int>(v);
          word |= (static_cast<uint32_t>(wv) & 0xFFu) << (8 * j);
        }
        *reinterpret_cast<uint32_t*>(&sm.ws[nn][ws_at(nn, kq)]) = word;
      }
    }
    if constexpr (!DIRECT) __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (NIB)
          ldsm_x4(a[i], &sm.xw[wm + i * 16 + a_row][kk + a_col]);
        else
          ldsm_x4(a[i], &sm.xs[buf][wm + i * 16 + a_row][kk + a_col]);
      }
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t r[4];
        if constexpr (DIRECT) {
          // chunk (wn/16 + jp): n8 tile 2jp holds its even columns, 2jp+1
          // its odd ones; each register of b holds rows 4t..4t+3 of one
          const int row = kk + t_row;
          ldsm_x4_trans(r, &sm.ws_rows[buf][row][16 * direct_chunk<BN>(
                                                     row, wn / 16 + jp)]);
          b[2 * jp][0] = __byte_perm(r[0], r[1], 0x6420);
          b[2 * jp][1] = __byte_perm(r[2], r[3], 0x6420);
          b[2 * jp + 1][0] = __byte_perm(r[0], r[1], 0x7531);
          b[2 * jp + 1][1] = __byte_perm(r[2], r[3], 0x7531);
        } else {
          const int n = wn + jp * 16 + b_row;
          ldsm_x4(r, &sm.ws[n][ws_at(n, kk + b_col)]);
          b[2 * jp][0] = r[0];
          b[2 * jp][1] = r[1];
          b[2 * jp + 1][0] = r[2];
          b[2 * jp + 1][1] = r[3];
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          mma_8bit<XS, WS>(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }

  if constexpr (DIRECT) {
    // n8 tiles 2jp and 2jp+1 hold the even and odd columns of chunk
    // wn/16 + jp, so c0 and c1 of both give this thread four adjacent
    // columns 4t..4t+3 (inside N, which is a multiple of 16)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m0 + wm + i * 16 + g + half * 8;
        if (m >= p.M) continue;
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          const int64_t n = n0 + wn + 16 * jp + 4 * t;
          if (n >= p.N) continue;
          const int v[4] = {acc[i][2 * jp][half * 2],
                            acc[i][2 * jp + 1][half * 2],
                            acc[i][2 * jp][half * 2 + 1],
                            acc[i][2 * jp + 1][half * 2 + 1]};
          const int64_t o = m * p.N + n;
          if (p.partial != nullptr) {
#pragma unroll
            for (int c = 0; c < 4; ++c)
              atomicAdd(p.partial + o + c, static_cast<uint32_t>(v[c]));
          } else if (p.out_float) {
            float f[4];
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              f[c] = __fmul_rn(__fmul_rn(__int2float_rn(v[c]), p.x_scale),
                               p.w_scale[n + c]);
              if (p.bias != nullptr) f[c] = __fadd_rn(f[c], p.bias[n + c]);
            }
            *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) =
                make_float4(f[0], f[1], f[2], f[3]);
          } else {
            *reinterpret_cast<int4*>(static_cast<int32_t*>(p.out) + o) =
                make_int4(v[0], v[1], v[2], v[3]);
          }
        }
      }
    }
    return;
  }
  // accumulator fragment: c0, c1 at (row g, cols 2t, 2t+1), c2, c3 at row
  // g+8; a pair goes as one 8-byte store when N is even
  const bool pairs = (p.N % 2 == 0);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int64_t m = m0 + wm + i * 16 + g + half * 8;
      if (m >= p.M) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int64_t n = n0 + wn + j * 8 + t * 2;
        if (n >= p.N) continue;
        const int v0 = acc[i][j][half * 2], v1 = acc[i][j][half * 2 + 1];
        const int64_t o = m * p.N + n;
        const bool two = n + 1 < p.N;
        if (p.partial != nullptr) {
          atomicAdd(p.partial + o, static_cast<uint32_t>(v0));
          if (two) atomicAdd(p.partial + o + 1, static_cast<uint32_t>(v1));
        } else if (p.out_float) {
          float f0 = __fmul_rn(__fmul_rn(__int2float_rn(v0), p.x_scale),
                               p.w_scale[n]);
          float f1 = two ? __fmul_rn(__fmul_rn(__int2float_rn(v1), p.x_scale),
                                     p.w_scale[n + 1])
                         : 0.0f;
          if (p.bias != nullptr) {
            f0 = __fadd_rn(f0, p.bias[n]);
            if (two) f1 = __fadd_rn(f1, p.bias[n + 1]);
          }
          float* of = static_cast<float*>(p.out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(of) = make_float2(f0, f1);
          } else {
            of[0] = f0;
            if (two) of[1] = f1;
          }
        } else {
          int32_t* oi = static_cast<int32_t*>(p.out) + o;
          if (pairs) {
            *reinterpret_cast<int2*>(oi) = make_int2(v0, v1);
          } else {
            oi[0] = v0;
            if (two) oi[1] = v1;
          }
        }
      }
    }
  }
}

// the float epilogue of a split-K run:
// out = (f32(acc) * x_scale) * w_scale[n] (+ bias[n])
__global__ void __launch_bounds__(EPI_THREADS)
float_epilogue(const int32_t* __restrict__ acc,
               const float* __restrict__ w_scale,
               const float* __restrict__ bias, float x_scale,
               float* __restrict__ out, int64_t total, int N) {
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * EPI_THREADS +
                   threadIdx.x;
       i < total; i += static_cast<int64_t>(gridDim.x) * EPI_THREADS) {
    const int n = static_cast<int>(i % N);
    float f = __fmul_rn(__fmul_rn(__int2float_rn(acc[i]), x_scale),
                        w_scale[n]);
    if (bias != nullptr) f = __fadd_rn(f, bias[n]);
    out[i] = f;
  }
}

inline bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0u;
}

// Launch one instantiation over the whole output, split along K when
// p.partial is set, then (split and float output) the float epilogue.
template <bool XS, bool WS, bool MASKED, bool NIB, bool FOLD, int WM,
          bool DIRECT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int BM = 64 * WM;
  constexpr int BN = 32 * (4 / WM);
  constexpr int bytes = static_cast<int>(sizeof(Smem<BM, BN, NIB, DIRECT>));
  auto* kernel = int8_gemm_kernel<XS, WS, MASKED, NIB, FOLD, WM, DIRECT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int splits =
      p.partial != nullptr ? (p.K + p.k_split - 1) / p.k_split : 1;
  const dim3 grid((p.M + BM - 1) / BM, (p.N + BN - 1) / BN, splits);
  kernel<<<grid, THREADS, bytes, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess || p.partial == nullptr || !p.out_float) return err;
  const int64_t total = static_cast<int64_t>(p.M) * p.N;
  const int64_t want = (total + EPI_THREADS - 1) / EPI_THREADS;
  const int blocks = static_cast<int>(want < 1024 ? want : 1024);
  float_epilogue<<<blocks, EPI_THREADS, 0, stream>>>(
      reinterpret_cast<const int32_t*>(p.partial), p.w_scale, p.bias,
      p.x_scale, static_cast<float*>(p.out), total, p.N);
  return cudaGetLastError();
}

}  // namespace int8_mma
