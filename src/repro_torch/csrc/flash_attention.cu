// Flash attention (GQA, causal or full) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::flash_attention
// (Pallas body `_kernel`).  Same function and the same arithmetic: q
// [B, H, Tq, D], k and v [B, Hkv, Tk, D] (bf16 or f32), query head h reads
// KV head h / G with G = H / Hkv; q, k and v are taken to f32, scores are
// scaled by 1/sqrt(D), the causal mask keeps kpos <= qpos with both counted
// from 0 (not end-aligned), masked scores are NEG_INF = -1e30, the online
// softmax keeps a running max m and sum l in f32 with exp rescaling, and
// the output is acc / max(l, 1e-30) rounded to q's dtype.
//
// What bounds it on the H100 (SXM data-sheet peaks, 700 W power limit):
// the function moves q, k, v and the output once (a few MB at the served
// shapes, a few us at 3.35 TB/s) and does 4 * B * H * D * pairs
// operations, pairs = Tq * Tk, or about half of that under the causal
// mask: tens of GFLOP at a 2048-token prompt, so operations bound it (989
// TFLOP/s bf16 on the tensor cores).
//
// bf16 design (the served route).  Both products run on the bf16 tensor
// cores with f32 accumulation, through mma.sync.m16n8k16: its fragments
// leave each score in a register whose row and column the thread knows,
// so the online softmax runs in registers (row max and sum over a quad of
// lanes by shuffles) and the probabilities feed the P.V product as A
// operands straight from those registers, with no score tile in shared
// memory.  wgmma would read P from registers too, but needs warpgroup
// tiles of 64 rows and descriptor-addressed operands; this first
// tensor-core design does without them.
// - S = Q.K^T: bf16 x bf16 products are exact in f32, so only the order of
//   the f32 sums differs from the TPU kernel; the scale multiplies the f32
//   scores, and only tiles that reach the diagonal or Tk are masked.
//   exp(x) is taken as exp2(x * log2 e) of the same f32 difference.
// - P.V: the TPU kernel multiplies f32 p by v.  Rounding p to bf16 alone
//   (what SDPA does) would lose that, so p = hi + lo with hi = bf16(p) and
//   lo = bf16(p - hi), and both run against v (exact in bf16): the error is
//   about 2^-17 of sum p|v|.  l is summed from the f32 p.  The output is
//   rescaled only when some row's max moved (a factor of 1 is exact).
// - One block of 4 warps owns 64 query rows of one (batch, head), 16 rows
//   a warp; Q is loaded once and kept as A fragments in registers.  K and
//   V tiles of 32 keys stream through a two-stage ring in shared memory
//   with 16-byte cp.async copies, so the next tile loads while this one
//   computes; rows are padded by 16 bytes so ldmatrix hits 8 distinct bank
//   groups.  Ragged Tq/Tk rows are zero-filled by the copies themselves.
// - KV tiles wholly above the diagonal are skipped (they add exactly
//   nothing), keys past Tk are masked like causal ones, and the grid puts
//   the heaviest causal query tiles of every head first.
// What holds it above the bound: the split makes P.V two products, 1.5x
// the tensor-core work of QK^T and one P.V, and mma.sync issued by 12
// warps an SM (168 registers a thread) reaches about a quarter of the
// bf16 peak; wgmma with TMA is the next step.
//
// f32 route: no served path runs attention in f32, so it keeps the first
// design on the CUDA cores (64-row query tile per 256-thread block, Q,
// transposed K, V and the score tile in shared memory, f32 FMAs).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;

// ---------------------------------------------------------------------------
// f32: the CUDA-core kernel.
// ---------------------------------------------------------------------------
namespace f32 {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr int KLD = BKV + 1;  // padded stride of the transposed K tile
constexpr int PLD = BKV + 1;  // padded stride of the score tile

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * KLD + BKV * D + BQ * PLD + 3 * BQ;
}

template <int D>
__global__ void __launch_bounds__(THREADS)
kernel(const float* __restrict__ q, const float* __restrict__ k,
       const float* __restrict__ v, float* __restrict__ out, int H, int Hkv,
       int Tq, int Tk, int causal, float scale) {
  extern __shared__ float smem[];
  constexpr int QLD = D + 1;  // padded stride of the query tile
  float* qs = smem;               // [BQ][QLD]
  float* kt = qs + BQ * QLD;      // [D][KLD]  (K tile transposed)
  float* vs = kt + D * KLD;       // [BKV][D]
  float* ps = vs + BKV * D;       // [BQ][PLD] scores, then probabilities
  float* m_s = ps + BQ * PLD;     // [BQ] running max
  float* l_s = m_s + BQ;          // [BQ] running sum
  float* c_s = l_s + BQ;          // [BQ] this step's rescale factor

  constexpr int DJ = D / 16;  // accumulator columns per thread
  const int tid = threadIdx.x;
  const int tx = tid & 15;  // column lane: score column / output column
  const int ty = tid >> 4;  // row lane: rows ty + 16 * i
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  // heaviest causal tiles (the last query rows) first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * BQ;
  const float* qb = q + static_cast<int64_t>(bh) * Tq * D;
  const float* kb = k + static_cast<int64_t>(kvh) * Tk * D;
  const float* vb = v + static_cast<int64_t>(kvh) * Tk * D;
  float* ob = out + static_cast<int64_t>(bh) * Tq * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[r * QLD + d] =
        (q0 + r < Tq) ? qb[static_cast<int64_t>(q0 + r) * D + d] : 0.0f;
  }
  if (tid < BQ) {
    m_s[tid] = NEG_INF;
    l_s[tid] = 0.0f;
  }
  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.0f;

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  for (int k0 = 0; k0 < kv_end; k0 += BKV) {
    __syncthreads();  // the previous step is done with kt, vs and ps
    for (int e = tid; e < BKV * D; e += THREADS) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < Tk;
      const int64_t off = static_cast<int64_t>(k0 + c) * D + d;
      kt[d * KLD + c] = in ? kb[off] : 0.0f;
      vs[e] = in ? vb[off] : 0.0f;
    }
    __syncthreads();

    // scores: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * QLD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = kt[d * KLD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kpos = k0 + c;
        float val = __fmul_rn(s[i][j], scale);
        if (kpos >= Tk || (causal && kpos > q0 + r)) val = NEG_INF;
        ps[r * PLD + c] = val;
      }
    }
    __syncthreads();

    // online softmax: four threads per row, 16 columns each
    {
      const int r = tid >> 2;
      const int part = tid & 3;
      float* row = ps + r * PLD + part * 16;
      float mx = NEG_INF;
#pragma unroll
      for (int c = 0; c < 16; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_prev = m_s[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.0f;
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const float p = expf(row[c] - m_new);
        row[c] = p;
        sum += p;
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      __syncwarp();
      if (part == 0) {
        const float c = expf(m_prev - m_new);
        l_s[r] = __fadd_rn(__fmul_rn(l_s[r], c), sum);
        m_s[r] = m_new;
        c_s[r] = c;
      }
    }
    __syncthreads();

    // acc = acc * c + p @ v
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float c = c_s[ty + 16 * i];
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] = __fmul_rn(acc[i][j], c);
    }
#pragma unroll 4
    for (int kk = 0; kk < BKV; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(ty + 16 * i) * PLD + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[kk * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= Tq) continue;
    const float l = fmaxf(l_s[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < DJ; ++j)
      ob[static_cast<int64_t>(q0 + r) * D + tx + 16 * j] =
          __fdiv_rn(acc[i][j], l);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Tq, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), H, Hkv, Tq, Tk,
      causal, scale);
  return cudaGetLastError();
}

}  // namespace f32

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel.
// ---------------------------------------------------------------------------
namespace tc {

constexpr int BQ = 64;       // query rows per block, 16 per warp
constexpr int BKV = 32;      // keys per KV tile
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int STAGES = 2;    // depth of the K/V ring
constexpr int PAD = 8;       // bf16 elements (16 bytes) of row padding
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr int smem_bytes() {
  return (BQ + 2 * STAGES * BKV) * (D + PAD) *
         static_cast<int>(sizeof(__nv_bfloat16));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy; src_bytes = 0 fills the destination with zeros
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// c += a (16x16 bf16, row) * b (16x8 bf16, col), f32 accumulation
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// p0, p1 (adjacent columns) -> bf16 pairs hi = bf16(p), lo = bf16(p - hi)
__device__ __forceinline__ void split_pair(float p0, float p1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);  // .x: low half
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(__fsub_rn(p0, hf.x), __fsub_rn(p1, hf.y)));
}

// rows [row0, row0 + ROWS) of a [T, D] matrix into a padded tile; rows at
// or past T are zero-filled
template <int D, int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src, int row0,
                                          int T, int tid) {
  constexpr int CH = D / 8;  // 16-byte chunks per row
  constexpr int LD = D + PAD;
#pragma unroll
  for (int e = tid; e < ROWS * CH; e += THREADS) {
    const int r = e / CH, c = e % CH;
    const bool in = row0 + r < T;
    const __nv_bfloat16* s =
        in ? src + static_cast<int64_t>(row0 + r) * D + c * 8 : src;
    cp_async_16(smem_addr(dst + r * LD + c * 8), s, in ? 16 : 0);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
       const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
       int H, int Hkv, int Tq, int Tk, int causal, float scale) {
  constexpr int LD = D + PAD;
  constexpr int NT = BKV / 8;  // score n-tiles per KV tile
  constexpr int DT = D / 8;    // output n-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [BQ][LD]
  __nv_bfloat16* ks = qs + BQ * LD;            // [STAGES][BKV][LD]
  __nv_bfloat16* vs = ks + STAGES * BKV * LD;  // [STAGES][BKV][LD]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // fragment row group
  const int t = lane & 3;   // thread within the group
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int kvh = b * Hkv + h / (H / Hkv);
  // heaviest causal tiles (the last query rows) of every head first
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const __nv_bfloat16* qb = q + static_cast<int64_t>(bh) * Tq * D;
  const __nv_bfloat16* kb = k + static_cast<int64_t>(kvh) * Tk * D;
  const __nv_bfloat16* vb = v + static_cast<int64_t>(kvh) * Tk * D;
  __nv_bfloat16* ob = out + static_cast<int64_t>(bh) * Tq * D;

  const int q_last = min(q0 + BQ, Tq) - 1;
  const int kv_end = causal ? min(Tk, q_last + 1) : Tk;
  const int n_tiles = (kv_end + BKV - 1) / BKV;

  load_tile<D, BQ>(qs, qb, q0, Tq, tid);
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n_tiles) {
      load_tile<D, BKV>(ks + st * BKV * LD, kb, st * BKV, Tk, tid);
      load_tile<D, BKV>(vs + st * BKV * LD, vb, st * BKV, Tk, tid);
    }
    cp_async_commit();
  }

  // ldmatrix row/column of this lane: A (Q) and V (transposed) address
  // rows 0-7 / 8-15 in matrices 0,2 / 1,3; K addresses them in 0,1 / 2,3
  const int a_row = (lane & 7) + ((lane >> 3) & 1) * 8;
  const int a_col = (lane >> 4) * 8;
  const int k_row = (lane & 7) + (lane >> 4) * 8;
  const int k_col = ((lane >> 3) & 1) * 8;
  const int qrow = q0 + warp * 16 + g;  // this thread's rows: qrow, qrow + 8

  uint32_t qf[D / 16][4];
  float o[DT][4];
#pragma unroll
  for (int j = 0; j < DT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.0f;
  float m_r[2] = {NEG_INF, NEG_INF};
  float l_r[2] = {0.0f, 0.0f};

  for (int it = 0; it < n_tiles; ++it) {
    const int stage = it % STAGES;
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile it landed; every warp is done with tile it - 1
    if (it + STAGES - 1 < n_tiles) {  // later tiles stream in meanwhile
      const int nxt = ((it + STAGES - 1) % STAGES) * BKV * LD;
      load_tile<D, BKV>(ks + nxt, kb, (it + STAGES - 1) * BKV, Tk, tid);
      load_tile<D, BKV>(vs + nxt, vb, (it + STAGES - 1) * BKV, Tk, tid);
    }
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
        ldsm_x4(qf[kc], smem_addr(qs + (warp * 16 + a_row) * LD + kc * 16 +
                                  a_col));
    }
    const __nv_bfloat16* kst = ks + stage * BKV * LD;
    const __nv_bfloat16* vst = vs + stage * BKV * LD;

    // S = Q K^T in f32
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.0f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(kst + (np * 16 + k_row) * LD + kc * 16 + k_col));
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
    }

    // scale, then mask where the tile reaches the diagonal or Tk; element
    // e of n-tile j sits at row qrow + 8 * (e >> 1), key k0 + 8j + 2t + (e&1)
    const int k0 = it * BKV;
    const bool edge = k0 + BKV > Tk || (causal && k0 + BKV - 1 > q0);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float val = __fmul_rn(s[j][e], scale);
        if (edge) {
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          if (kpos >= Tk || (causal && kpos > qrow + 8 * (e >> 1)))
            val = NEG_INF;
        }
        s[j][e] = val;
      }

    // online softmax in registers; a row's 64 scores live on 4 lanes
    float c_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_r[r], mx);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          const float p = exp2f(__fmul_rn(__fsub_rn(s[j][e], m_new), LOG2E));
          s[j][e] = p;
          sum = __fadd_rn(sum, p);
        }
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 1));
      sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, 2));
      c_r[r] = exp2f(__fmul_rn(__fsub_rn(m_r[r], m_new), LOG2E));
      l_r[r] = __fadd_rn(__fmul_rn(l_r[r], c_r[r]), sum);
      m_r[r] = m_new;
    }
    // rescale only where a row's max moved (a factor of 1 changes nothing)
    if (__any_sync(0xffffffffu, c_r[0] != 1.0f || c_r[1] != 1.0f))
#pragma unroll
    for (int j = 0; j < DT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] = __fmul_rn(o[j][e], c_r[e >> 1]);

    // O += (hi + lo) V: the score C fragments of n-tiles 2kc, 2kc + 1 are
    // the A fragment of key chunk kc
#pragma unroll
    for (int kc = 0; kc < BKV / 16; ++kc) {
      uint32_t ph[4], pl[4];
      split_pair(s[2 * kc][0], s[2 * kc][1], ph[0], pl[0]);
      split_pair(s[2 * kc][2], s[2 * kc][3], ph[1], pl[1]);
      split_pair(s[2 * kc + 1][0], s[2 * kc + 1][1], ph[2], pl[2]);
      split_pair(s[2 * kc + 1][2], s[2 * kc + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(vf, smem_addr(vst + (kc * 16 + a_row) * LD + dp * 16 +
                                    a_col));
        mma_bf16(o[2 * dp], ph, vf[0], vf[1]);
        mma_bf16(o[2 * dp], pl, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], ph, vf[2], vf[3]);
        mma_bf16(o[2 * dp + 1], pl, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = qrow + 8 * r;
    if (row >= Tq) continue;
    const float l = fmaxf(l_r[r], 1e-30f);
    __nv_bfloat16* orow = ob + static_cast<int64_t>(row) * D + 2 * t;
#pragma unroll
    for (int j = 0; j < DT; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(__fdiv_rn(o[j][2 * r], l),
                                __fdiv_rn(o[j][2 * r + 1], l));
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Tq, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  constexpr int bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (Tq + BQ - 1) / BQ);
  kernel<D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      H, Hkv, Tq, Tk, causal, scale);
  return cudaGetLastError();
}

}  // namespace tc

template <bool BF16, int D>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* out,
                     int B, int H, int Hkv, int Tq, int Tk, int causal,
                     float scale, cudaStream_t stream) {
  return BF16 ? tc::launch<D>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                              stream)
              : f32::launch<D>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                               stream);
}

template <bool BF16>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int Hkv, int Tq, int Tk, int D,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch_d<BF16, 16>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                scale, stream);
    case 32:
      return launch_d<BF16, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                scale, stream);
    case 64:
      return launch_d<BF16, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                scale, stream);
    case 128:
      return launch_d<BF16, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, causal,
                                 scale, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" int flash_attention(const void* q, const void* k, const void* v,
                               void* out, int is_bf16, int B, int H, int Hkv,
                               int Tq, int Tk, int D, int causal, float scale,
                               void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? dispatch_d<true>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                 scale, s)
              : dispatch_d<false>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                  scale, s);
  return static_cast<int>(err);
}

// The tiles each route runs: query rows, keys per KV tile and the depth of
// the K/V ring in shared memory (1: loaded synchronously), as three ints.
extern "C" void flash_attention_tiles(int is_bf16, int* tiles) {
  tiles[0] = is_bf16 ? tc::BQ : f32::BQ;
  tiles[1] = is_bf16 ? tc::BKV : f32::BKV;
  tiles[2] = is_bf16 ? tc::STAGES : 1;
}
