// Flash prefill attention for Hopper (sm_90a): blocked online softmax, GQA.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py `flash_attention`
// (:535-623) and its Pallas body `_flash_kernel` (:432-526).  Computes what
// `dot_product_attention(q, k, v, causal, window)` (:42-70) computes, without
// the [Sq, Sk] score matrix ever reaching device memory.
//
// Layouts: q, o are [B, H, Sq, D]; k, v are [B, KH, Sk, D] with KH dividing H.
// Query head h reads KV head h / (H / KH) itself, so the caller never repeats
// K/V up to H heads.  Types: bf16 (the serving path) and f32 (tight checks);
// accumulation is always f32.  D is 64, 128 (Llama) or 256 (Gemma); Sq and
// Sk are multiples of 64.  At D = 256 the f32 staging takes 208 KiB of
// shared memory, so one block runs per SM.
//
// What bounds it on the H100: at the prefill buckets (S = 256..2048) the work
// is 4*S^2*D/2 operations per (batch, head) against 4*S*D*2 bytes, far above
// the card's ~295 operations per byte, so the bound is arithmetic: 989 TFLOP/s
// on the bf16 tensor cores.  This first kernel does its products on the CUDA
// cores in f32 (FMA from shared memory), so it sits well below that bound;
// wgmma tiles fed by TMA are the later step.
//
// Design: one block per (batch*head, 64-row q tile); 8 warps of 8 query rows
// each.  The TPU kernel's sequential kv-chunk grid axis becomes a loop over
// 64-key tiles inside the block: each tile of K and V is staged in shared
// memory (K rows padded to D+1 floats so the per-lane key rows hit distinct
// banks), each lane scores two keys against its warp's rows, the f32 running
// max / sum / accumulator of each row stay in registers, and the tile's
// probabilities go through a per-warp shared buffer into the P.V product,
// where each lane owns D/32 output columns.  Key tiles past the causal
// diagonal or wholly below the sliding-window band are never loaded, as the
// JAX kernel's clamped index map skips them.  Masked scores take the same
// finite -1e30 as the JAX code, so a tile that is fully masked for a row
// contributes exactly what it contributes there (wiped by the next live
// tile's alpha = exp(-1e30 - m)).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;   // query rows per block
constexpr int BK = 64;   // keys per tile
constexpr int NW = 8;    // warps per block
constexpr int RPW = BQ / NW;  // query rows per warp
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(NW * 32)
flash_prefill_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int H, int KH,
                     int Sq, int Sk, int causal, int window, float scale) {
  constexpr int KS = D + 1;  // padded K row stride (floats)
  constexpr int EPL = D / 32;  // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;             // [BQ][D]
  float* Ks = Qs + BQ * D;      // [BK][D + 1]
  float* Vs = Ks + BK * KS;     // [BK][D]
  float* Ps = Vs + BK * D;      // [NW][RPW][BK]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = blockIdx.x * BQ;

  const T* qb = q + ((size_t)bh * Sq + q0) * D;
  const T* kb = k + (size_t)(b * KH + kh) * Sk * D;
  const T* vb = v + (size_t)(b * KH + kh) * Sk * D;

  for (int i = tid; i < BQ * D; i += NW * 32) Qs[i] = to_f32(qb[i]);

  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }

  // live key tiles [kt_lo, kt_hi): nothing past the causal diagonal, nothing
  // wholly below the window band of the tile's first query row
  const int n_kt = Sk / BK;
  int kt_hi = n_kt;
  if (causal) kt_hi = min(n_kt, (q0 + BQ + BK - 1) / BK);
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;

  float* prow = Ps + warp * RPW * BK;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // previous tile's K/V/P reads are done
    const T* kt_k = kb + (size_t)kt * BK * D;
    const T* kt_v = vb + (size_t)kt * BK * D;
    for (int i = tid; i < BK * D; i += NW * 32) {
      const int j = i / D;
      const int d = i - j * D;
      Ks[j * KS + d] = to_f32(kt_k[i]);
      Vs[i] = to_f32(kt_v[i]);
    }
    __syncthreads();

    // scores: this lane's keys are lane and lane + 32 of the tile
    float s[RPW][2];
#pragma unroll
    for (int r = 0; r < RPW; ++r) s[r][0] = s[r][1] = 0.f;
    const float* k0 = Ks + lane * KS;
    const float* k1 = Ks + (lane + 32) * KS;
    const float* qw = Qs + warp * RPW * D;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float a = k0[d];
      const float c = k1[d];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float qv = qw[r * D + d];
        s[r][0] = fmaf(qv, a, s[r][0]);
        s[r][1] = fmaf(qv, c, s[r][1]);
      }
    }

#pragma unroll
    for (int r = 0; r < RPW; ++r) {
      const int qpos = q0 + warp * RPW + r;
      float val[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kt * BK + lane + 32 * c;
        bool keep = !causal || kpos <= qpos;
        if (window > 0) keep = keep && (kpos > qpos - window);
        val[c] = keep ? s[r][c] * scale : NEG_INF;
      }
      const float m_new = fmaxf(m[r], warp_max(fmaxf(val[0], val[1])));
      const float p0 = expf(val[0] - m_new);
      const float p1 = expf(val[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      l[r] = alpha * l[r] + warp_sum(p0 + p1);
      m[r] = m_new;
      prow[r * BK + lane] = p0;
      prow[r * BK + lane + 32] = p1;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

    // acc[r][:] += P[r][:] . V, lane owns columns lane + 32 * e
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vv[e] = Vs[j * D + lane + 32 * e];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = prow[r * BK + j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

  T* ob = o + ((size_t)bh * Sq + q0 + warp * RPW) * D;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) store(ob + r * D + lane + 32 * e, acc[r][e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KH, int Sq, int Sk, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + NW * RPW * BK);
  cudaError_t err = cudaFuncSetAttribute(
      flash_prefill_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, B * H);
  flash_prefill_kernel<T, D><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KH, Sq, Sk, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  window <= 0 means no sliding window.
// Returns a cudaError_t (0 = success); shapes are validated by the caller.
extern "C" int dabt_flash_prefill(const void* q, const void* k, const void* v, void* o,
                                  int dtype, int B, int H, int KH, int Sq, int Sk,
                                  int D, int causal, int window, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (H % KH != 0 || Sq % BQ != 0 || Sk % BK != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 0 && D == 256)
    return (int)launch<float, 256>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 1 && D == 256)
    return (int)launch<__nv_bfloat16, 256>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
