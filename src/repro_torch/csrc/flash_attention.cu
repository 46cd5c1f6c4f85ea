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
// shapes, a few us at 3.35 TB/s) and does
// 4 * B * H * D * (pairs) operations, pairs = Tq * Tk, or about half of
// that under the causal mask: tens of GFLOP at a 2048-token prompt, so
// operations bound it (989 TFLOP/s bf16 on the tensor cores).  This first
// design keeps the TPU kernel's f32 arithmetic on the CUDA cores instead
// (a bf16 tensor-core product would round p to bf16): one block of 256
// threads owns a 64-row query tile of one (batch, head) and walks the KV
// tiles itself, the TPU grid's sequential KV axis becoming a loop.  The
// query tile, the KV tile (K transposed) and the 64x64 score tile live in
// shared memory, the running max and sum in shared memory, and each
// thread's 4 x D/16 share of the f32 output accumulator in registers, so
// the [Tq, Tk] score matrix never reaches device memory.  KV tiles wholly
// above the diagonal are skipped (they add exactly nothing), ragged Tq/Tk
// edges are zero-filled on load, keys past Tk are masked like causal ones,
// and the heaviest causal query tiles are scheduled first.  Tensor cores
// (wgmma with f32 kept where it matters), TMA and a pipelined KV ring are
// left for later work.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;
constexpr int BKV = 64;
constexpr int THREADS = 256;
constexpr int KLD = BKV + 1;  // padded stride of the transposed K tile
constexpr int PLD = BKV + 1;  // padded stride of the score tile
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  return BQ * (D + 1) + D * KLD + BKV * D + BQ * PLD + 3 * BQ;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int H,
                       int Hkv, int Tq, int Tk, int causal, float scale) {
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
  const T* qb = q + static_cast<int64_t>(bh) * Tq * D;
  const T* kb = k + static_cast<int64_t>(kvh) * Tk * D;
  const T* vb = v + static_cast<int64_t>(kvh) * Tk * D;
  T* ob = out + static_cast<int64_t>(bh) * Tq * D;

  for (int e = tid; e < BQ * D; e += THREADS) {
    const int r = e / D, d = e % D;
    qs[r * QLD + d] =
        (q0 + r < Tq) ? to_f32(qb[static_cast<int64_t>(q0 + r) * D + d]) : 0.0f;
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
      kt[d * KLD + c] = in ? to_f32(kb[off]) : 0.0f;
      vs[e] = in ? to_f32(vb[off]) : 0.0f;
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
          from_f32<T>(__fdiv_rn(acc[i][j], l));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int B, int H, int Hkv, int Tq, int Tk, int causal,
                   float scale, cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_attention_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), H, Hkv, Tq, Tk, causal,
      scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* out,
                       int B, int H, int Hkv, int Tq, int Tk, int D,
                       int causal, float scale, cudaStream_t stream) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, Hkv, Tq, Tk, causal, scale,
                            stream);
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
      is_bf16 ? dispatch_d<__nv_bfloat16>(q, k, v, out, B, H, Hkv, Tq, Tk, D,
                                          causal, scale, s)
              : dispatch_d<float>(q, k, v, out, B, H, Hkv, Tq, Tk, D, causal,
                                  scale, s);
  return static_cast<int>(err);
}
