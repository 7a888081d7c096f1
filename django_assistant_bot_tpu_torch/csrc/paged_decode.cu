// Paged GQA decode attention for Hopper (sm_90a): one query per slot against
// a page pool through per-slot block tables.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py
// `paged_gqa_decode_attention` (:228-325), an XLA fori_loop over logical
// blocks in the JAX package.  Composing it from PyTorch ops would gather each
// slot's pages into a dense [B, KH, S, D] row first; this kernel reads every
// live key of every page in place, once.
//
// Layouts: q, out are [B, H, 1, D]; k_pool, v_pool are [P, KH, page, D];
// block_tables [B, NB] int32 (entries >= P mean "unallocated"); positions [B]
// int32; active [B] bool or null.  Types: f32 or bf16 q; pools of q's type,
// bf16 under f32 q, or fp8 (e4m3fn, e5m2: the engine's kv_cache_dtype);
// accumulation in f32.  A pool of another type than q is read as the JAX
// function reads it (:299-304): its values widened to q's type, exactly,
// since every bf16, e4m3 and e5m2 value is an f32 and a bf16 value.  With
// indot (its fp8_dot, :287-297) the query is quantized to the pool's fp8
// format first (see paged_mma_kernel).
//
// The contiguous form (dabt_chunked_decode) replaces
// `chunked_gqa_decode_attention` (:109-225, the fori_loop at :223): the
// same kernels over the legacy slot cache [B, KH, S, D] with no block
// table, chunk c of row b read in place at b*KH*S*D + kh*S*D + c*chunk*D
// (the page is the chunk; the row's NB = S / chunk chunks are its logical
// blocks; see block_index).  Nothing else differs: the same work split,
// reduction order and rounding, so a paged read whose pages hold a
// contiguous cache's chunks gives the same bytes (the contract
// tests/test_kv_paging.py:229-283 pins in the JAX package).
//
// What bounds it on the H100: each key is used by the G = H / KH query heads
// of one token, so the work is ~4 G operations per 2 D bytes of K/V read
// (per D bytes from an fp8 pool), far below the card's ~295 operations per
// byte.  The bound is the live K/V bytes over the 3.35 TB/s of HBM (0.0125
// ms for 10,208 live keys of Llama-3-8B at 8 KV heads and D = 128 from a
// bf16 pool, about half that from an fp8 one).
//
// Which keys a row reads (the same for both kernels below).  The JAX loop
// runs logical blocks [lo, hi) from the batch's largest active position (and,
// with a window, its smallest) and masks per row.  Here a row reads the keys
// of [lo * page, hi * page) that its own position and window keep: for an
// active row the blocks left out are fully masked anyway, and an inactive row
// keeps the batch range masked by its own position (so a stale long slot never
// widens the read; its output is never used by the engine).  Masked keys
// weigh exactly 0 (never the JAX code's finite -1e30: a state that has seen
// no live key keeps m = -inf and drops out of every merge with weight 0, and
// a row with no live key at all writes zeros).  Sentinel entries (>= P)
// clamp to page P - 1, exactly as the JAX code clamps, and stay masked.
//
// Numerics: the probabilities are rounded to the type of the values P.V
// takes, as the JAX function does (`p.astype(v_blk.dtype)`, :314-317): q's
// type for the dequant read, the pool's fp8 format in-dot; the normaliser l
// sums the unrounded f32 p (:313).
//
// * bf16 at D = 64 and 128 with q and the pools on 16-byte boundaries
//   (Llama; the serving path; the caller picks the route, `mma` below):
//   `paged_mma_kernel`.  Three limits of the first kernel (below), and what
//   this design does about each:
//   1. Too little in flight: one block per (slot, KV head, logical page) left
//      most blocks empty at ragged positions, and each warp waited on 2 KB of
//      loads at a time.  Here the work is cut into equal items, chunks of
//      CK = 64 keys inside a page (fewer where the page ends), and a
//      persistent grid of as many blocks as fit on the SMs (sized on the host
//      from shapes alone: no read of positions, so a CUDA graph can capture
//      it) takes an equal contiguous run of the items each (at least
//      MIN_ITEMS, so a short batch uses fewer blocks).  Every block
//      derives its items on the device from positions, active and window (a
//      prefix sum of each row's live chunk count), and keeps a ring of
//      STAGES = 3 K/V chunks (32 KB each at D = 128) in dynamic shared
//      memory, filled by `cp.async` 16 bytes a thread: two chunks are in
//      flight while one is computed.  Keys a row does not read are never
//      loaded (zero-filled instead).  Rows land swizzled by XOR of the
//      16-byte chunk index with row % 8 (as in `flash_prefill.cu`, verified
//      on the card) so `ldmatrix` reads them without bank conflicts; a
//      `cp.async.bulk` copy of the contiguous chunk would land them
//      unswizzled, and a TMA tensor map would need one descriptor per pool.
//   2. Scores on the CUDA cores through shuffles: here both products run on
//      the tensor cores (`mma.sync.m16n8k16`, bf16 in, f32 accumulate), with
//      the G query heads of a KV head as the A rows, padded to 16 (the
//      kernel is bound by bytes, so the idle rows cost nothing that
//      matters).  Each of the 4 warps takes 16 keys of a chunk: S = Q.K^T
//      with K's B fragments from `ldmatrix`, the online softmax on the
//      accumulator fragments in log2 units (`ex2.approx`), P packed to
//      bf16x2 in registers straight into the A fragment of P.V (this packing
//      is the JAX function's rounding), V's B fragments from
//      `ldmatrix.trans`.  A warp carries its (m, l, O) across the
//      consecutive chunks of one (slot, KV head) row in registers.
//   3. Two launches per call: here one.  When a block's run of a row ends,
//      its warps merge in shared memory; a run that is the whole row writes
//      the normalised output at once.  Otherwise the block writes one
//      (m, l, acc) partial to f32 scratch and adds the run's chunk count to
//      the row's counter (after `__threadfence()`), and the block that
//      completes the count merges the row's partials in chunk order (their
//      weights through shared memory, the accumulator loads of up to 32
//      runs in flight together), writes the normalised output and resets
//      the counter, so no memset is needed.  Only a block's first and last
//      runs can be part of a row (a run strictly inside its item range is a
//      whole row), so the scratch holds two partials per block.  The merge
//      order and the split depend on the inputs alone, so two calls on the
//      same inputs give bitwise-equal outputs.
//
// * f32 q (tight checks) over any pool, bf16 at D = 16, 32 and 256 (a warp's 16 x 256
//   f32 O accumulator alone would take 128 registers a lane, which spilled
//   in the flash kernel) or inputs off 16-byte boundaries:
//   `paged_decode_split_kernel`
//   plus `paged_decode_combine_kernel`, the first CUDA-core kernel: one block
//   per (slot, KV head, logical page), eight warps taking four key rows at a
//   time, each lane holding D / 32 elements of a row, an f32 online softmax
//   per query head per warp merged in shared memory, then a second kernel
//   merging the pages.  H / KH is at most 4 at D = 256 there (the per-warp
//   merge buffer of eight query heads would pass the 48 KiB of static shared
//   memory); the page is a multiple of 4.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int NW = 8;     // warps per block
constexpr int U = 4;      // key rows per warp step
constexpr int MAXG = 8;   // query heads per KV head supported

// page-pool storage formats (kernels._KV_CODE); q is KV_F32 or KV_BF16
constexpr int KV_F32 = 0, KV_BF16 = 1, KV_E4M3 = 2, KV_E5M2 = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// The fp8 conversions below convert in both formats and select (both are
// single instructions on sm_89+), so the format stays a runtime value with
// no branch in the unrolled loops that call them.

// two fp8 values (the first in the low byte) -> f16x2, exactly: every e4m3
// and e5m2 value is an f16 value
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t x, bool e4m3) {
  const unsigned short v = (unsigned short)(x & 0xffffu);
  uint32_t a, b;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(a) : "h"(v));
  asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(b) : "h"(v));
  return e4m3 ? a : b;
}

// two floats rounded to fp8 (nearest, ties to even, as torch and ml_dtypes
// cast), the first in the low byte.  The cast saturates past the format's
// largest value where ml_dtypes gives NaN or inf; no caller passes such a
// value (P <= 1, a quantized query element <= the format's largest value
// times (1 + 2^-23)).
__device__ __forceinline__ uint32_t f32x2_to_fp8x2(float lo, float hi, bool e4m3) {
  unsigned short a, b;
  asm("cvt.rn.satfinite.e4m3x2.f32 %0, %1, %2;\n" : "=h"(a) : "f"(hi), "f"(lo));
  asm("cvt.rn.satfinite.e5m2x2.f32 %0, %1, %2;\n" : "=h"(b) : "f"(hi), "f"(lo));
  return e4m3 ? a : b;
}

// an fp8 value (the low byte of x) as f32, exactly
__device__ __forceinline__ float fp8_to_f32(uint32_t x, bool e4m3) {
  return __half2float(__ushort_as_half((unsigned short)(fp8x2_to_f16x2(x, e4m3) & 0xffffu)));
}

// x / y rounded to nearest (IEEE division's bits), given r = RN(1 / y):
// Markstein's correction, one product and two fused multiply-adds.  An
// IEEE division per element of a query row, at every run a block starts,
// took about half of the in-dot read's time at Llama-3-8B's decode shape.
__device__ __forceinline__ float div_rn(float x, float y, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, y, x), r, q);
}

// the largest finite value of an fp8 format (ml_dtypes.finfo(...).max)
__device__ __forceinline__ float fp8_max(bool e4m3) { return e4m3 ? 448.f : 57344.f; }

// x rounded to the format `fmt` holds, as f32: nothing for f32, bf16, or
// fp8 (see f32x2_to_fp8x2)
__device__ __forceinline__ float round_to(float x, int fmt) {
  if (fmt == KV_F32) return x;
  if (fmt == KV_BF16) return __bfloat162float(__float2bfloat16(x));
  return fp8_to_f32(f32x2_to_fp8x2(x, 0.f, fmt == KV_E4M3), fmt == KV_E4M3);
}

// EPL consecutive elements of a row as f32 (vector loads where they fit)
template <typename T, int EPL>
__device__ __forceinline__ void load_row(const T* p, float* out) {
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = to_f32(p[e]);
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 4>(const __nv_bfloat16* p, float* out) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  out[0] = a.x; out[1] = a.y; out[2] = b.x; out[3] = b.y;
}
template <>
__device__ __forceinline__ void load_row<__nv_bfloat16, 2>(const __nv_bfloat16* p, float* out) {
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
  out[0] = a.x; out[1] = a.y;
}
template <>
__device__ __forceinline__ void load_row<float, 4>(const float* p, float* out) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
}
template <>
__device__ __forceinline__ void load_row<float, 2>(const float* p, float* out) {
  const float2 a = *reinterpret_cast<const float2*>(p);
  out[0] = a.x; out[1] = a.y;
}

// EPL consecutive pool elements at element offset `off` as f32, in the
// pool's storage format (a warp-uniform branch; the f32 and bf16 pools take
// the vector loads above)
template <int EPL>
__device__ __forceinline__ void load_pool_row(const void* pool, size_t off, int fmt, float* out) {
  if (fmt == KV_F32) {
    load_row<float, EPL>(static_cast<const float*>(pool) + off, out);
  } else if (fmt == KV_BF16) {
    load_row<__nv_bfloat16, EPL>(static_cast<const __nv_bfloat16*>(pool) + off, out);
  } else {
    const uint8_t* p = static_cast<const uint8_t*>(pool) + off;
#pragma unroll
    for (int e = 0; e < EPL; ++e) out[e] = fp8_to_f32(p[e], fmt == KV_E4M3);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// weight of a partial state with max m against the merged max mx (0 for an
// empty state, m = -inf)
__device__ __forceinline__ float rescale(float m, float mx) {
  return m == -INFINITY ? 0.f : expf(m - mx);
}

// The batch's logical-block range [lo, hi) of the JAX loop, over active rows.
__device__ __forceinline__ void batch_range(const int* positions, const uint8_t* active,
                                            int B, int page, int NB, int window, int& lo,
                                            int& hi) {
  int max_pos = 0;
  int min_pos = NB * page;
  for (int i = 0; i < B; ++i) {
    if (active == nullptr || active[i] != 0) {
      max_pos = max(max_pos, positions[i]);
      min_pos = min(min_pos, positions[i]);
    }
  }
  hi = min(max_pos / page + 1, NB);
  lo = 0;
  if (window > 0) lo = min(max(min_pos - window + 1, 0) / page, hi);
}

// The (page, KV head) block that holds logical block ci of (slot b, KV head
// kh), whose first element is at block * page * D: through the block table,
// page phys of the pool [P, KH, page, D] (sentinels >= P clamp to P - 1, as
// the JAX code clamps) -> phys * KH + kh; with no block table, chunk ci of
// row b in the contiguous slot cache [B, KH, NB * page, D] -> (b * KH + kh)
// * NB + ci.  An int, as the page index was: a 64-bit address per ring
// stage costs the D = 128, G = 8 kernel spills.
__device__ __forceinline__ int block_index(const int* block_tables, int b, int kh, int ci,
                                           int KH, int P, int NB) {
  if (block_tables == nullptr) return (b * KH + kh) * NB + ci;
  return min(max(block_tables[(size_t)b * NB + ci], 0), P - 1) * KH + kh;
}

// (min 1 block per SM: ptxas may take up to 255 registers, which keeps the
// larger variants from spilling)
//
// kfmt: the pools' storage format, q's own or a narrower one (dequant read:
// values widened exactly to f32, P rounded to q's type); indot: the fp8
// in-dot scheme (fp8 pools only): each query row quantized to the pool's
// format with its scale max(amax / max, 1e-12), the scale on the f32 score
// partials, P rounded to the pool's format.
template <typename T, int D, int G>
__global__ void __launch_bounds__(NW * 32, 1)
paged_decode_split_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                          const void* __restrict__ v_pool,
                          const int* __restrict__ block_tables,
                          const int* __restrict__ positions,
                          const uint8_t* __restrict__ active, float* __restrict__ part_m,
                          float* __restrict__ part_l, float* __restrict__ part_acc,
                          int B, int KH, int P, int page, int NB, int window,
                          float scale, int kfmt, int indot) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // elements per lane
  constexpr int LANES = D >= 32 ? 32 : D;     // lanes holding elements
  __shared__ float s_m[NW][G];
  __shared__ float s_l[NW][G];
  __shared__ float s_acc[NW][G][D];
  __shared__ int s_range[2];

  const int b = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int n_split = gridDim.z;
  const int H = KH * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int pos = positions[b];
  const bool lane_on = lane < LANES;

  if (threadIdx.x == 0) {
    int lo, hi;
    batch_range(positions, active, B, page, NB, window, lo, hi);
    if (active == nullptr || active[b] != 0) {
      hi = min(hi, min(pos / page + 1, NB));
      if (window > 0) lo = max(lo, max(pos - window + 1, 0) / page);
    }
    // this block's page of the row's range (none once past its end)
    const int c_lo = lo + split;
    s_range[0] = c_lo;
    s_range[1] = min(hi, c_lo + 1);
  }
  __syncthreads();
  const int c_lo = s_range[0];
  const int c_hi = s_range[1];

  float qf[G][EPL];
  float sscale[G];  // the score scale of each query head
#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane_on) {
      load_row<T, EPL>(q + ((size_t)b * H + kh * G + g) * D + lane * EPL, qf[g]);
    } else {
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = 0.f;
    }
    sscale[g] = scale;
    if (indot) {  // quantize_fp8 of the row, in its f32 arithmetic
      float amax = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) amax = fmaxf(amax, fabsf(qf[g][e]));
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
      const float qs = fmaxf(__fdiv_rn(amax, fp8_max(kfmt == KV_E4M3)), 1e-12f);
      const float qr = __frcp_rn(qs);
#pragma unroll
      for (int e = 0; e < EPL; ++e) qf[g][e] = round_to(div_rn(qf[g][e], qs, qr), kfmt);
      sscale[g] = __fmul_rn(qs, scale);
    }
  }
  // P in q's type for the dequant read, in the pool's fp8 format in-dot
  const int pfmt = indot ? kfmt : (sizeof(T) == 4 ? KV_F32 : KV_BF16);
  float m[G], l[G], acc[G][EPL];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }

  for (int ci = c_lo; ci < c_hi; ++ci) {
    const size_t base = (size_t)block_index(block_tables, b, kh, ci, KH, P, NB) * page * D;
    const int first = ci * page;
    for (int t0 = warp * U; t0 < page; t0 += NW * U) {
      if (first + t0 > pos) break;  // rows run in increasing t: the rest are masked
      float kr[U][EPL], vr[U][EPL];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (lane_on) {
          const size_t off = base + (size_t)(t0 + u) * D + lane * EPL;
          load_pool_row<EPL>(k_pool, off, kfmt, kr[u]);
          load_pool_row<EPL>(v_pool, off, kfmt, vr[u]);
        } else {
#pragma unroll
          for (int e = 0; e < EPL; ++e) kr[u][e] = vr[u][e] = 0.f;
        }
      }
      bool live[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int kpos = first + t0 + u;
        live[u] = kpos <= pos && (window <= 0 || kpos > pos - window);
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float sc[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < EPL; ++e) part = fmaf(qf[g][e], kr[u][e], part);
          sc[u] = warp_sum(part);
        }
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          sc[u] = live[u] ? sc[u] * sscale[g] : -INFINITY;
          mx = fmaxf(mx, sc[u]);
        }
        if (mx == -INFINITY) continue;  // nothing live yet (warp-uniform)
        const float alpha = rescale(m[g], mx);
        float psum = 0.f;
        float p[U];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          p[u] = live[u] ? expf(sc[u] - mx) : 0.f;
          psum += p[u];  // the unrounded f32 p
        }
        l[g] = alpha * l[g] + psum;
        m[g] = mx;
        float pr[U];  // P as P.V takes it
#pragma unroll
        for (int u = 0; u < U; ++u) pr[u] = round_to(p[u], pfmt);
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          float a = alpha * acc[g][e];
#pragma unroll
          for (int u = 0; u < U; ++u) a = fmaf(pr[u], vr[u][e], a);
          acc[g][e] = a;
        }
      }
    }
  }

#pragma unroll
  for (int g = 0; g < G; ++g) {
    if (lane == 0) {
      s_m[warp][g] = m[g];
      s_l[warp][g] = l[g];
    }
    if (lane_on) {
#pragma unroll
      for (int e = 0; e < EPL; ++e) s_acc[warp][g][lane * EPL + e] = acc[g][e];
    }
  }
  __syncthreads();

  // merge the warps into this split's partial state per query head
  for (int i = threadIdx.x; i < G * D; i += NW * 32) {
    const int g = i / D;
    const int d = i - g * D;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < NW; ++w) mx = fmaxf(mx, s_m[w][g]);
    float num = 0.f, den = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float f = rescale(s_m[w][g], mx);
      num = fmaf(f, s_acc[w][g][d], num);
      den = fmaf(f, s_l[w][g], den);
    }
    const size_t row = ((size_t)b * H + kh * G + g) * n_split + split;
    part_acc[row * D + d] = num;
    if (d == 0) {
      part_m[row] = mx;
      part_l[row] = den;
    }
  }
}

// out[b, h] = merge of the n_split partial states of (b, h), normalised
template <typename T, int D>
__global__ void paged_decode_combine_kernel(const float* __restrict__ part_m,
                                            const float* __restrict__ part_l,
                                            const float* __restrict__ part_acc,
                                            T* __restrict__ out, int n_split) {
  const size_t bh = blockIdx.x;
  const float* pm = part_m + bh * n_split;
  const float* pl = part_l + bh * n_split;
  float mx = -INFINITY;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, pm[s]);
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    float num = 0.f, den = 0.f;
    for (int s = 0; s < n_split; ++s) {
      const float f = rescale(pm[s], mx);
      num = fmaf(f, part_acc[(bh * n_split + s) * D + d], num);
      den = fmaf(f, pl[s], den);
    }
    store(out + bh * D + d, den > 0.f ? num / den : 0.f);
  }
}

template <typename T, int D>
cudaError_t launch_split(const void* q, const void* kk, const void* vv, void* o,
                         const int* bt, const int* pos, const uint8_t* active, float* pm,
                         float* pl, float* pacc, int B, int H, int KH, int P, int page,
                         int NB, int window, int kfmt, int indot, cudaStream_t s) {
  const int G = H / KH;
  const int n_split = NB;  // one split per logical page
  const float scale = 1.0f / sqrtf((float)D);
  dim3 grid(B, KH, n_split);
  const T* qq = static_cast<const T*>(q);
  switch (G) {
#define DABT_CASE(GG)                                                                 \
  case GG:                                                                            \
    paged_decode_split_kernel<T, D, GG><<<grid, NW * 32, 0, s>>>(                     \
        qq, kk, vv, bt, pos, active, pm, pl, pacc, B, KH, P, page, NB, window, scale, \
        kfmt, indot);                                                                 \
    break;
    DABT_CASE(1)
    DABT_CASE(2)
    DABT_CASE(4)
    case 8:
      if constexpr (D * 8 <= 1024) {
        paged_decode_split_kernel<T, D, 8><<<grid, NW * 32, 0, s>>>(
            qq, kk, vv, bt, pos, active, pm, pl, pacc, B, KH, P, page, NB, window, scale,
            kfmt, indot);
        break;
      } else {
        return cudaErrorInvalidValue;
      }
#undef DABT_CASE
    default:
      return cudaErrorInvalidValue;
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_decode_combine_kernel<T, D><<<B * H, D >= 32 ? D : 32, 0, s>>>(
      pm, pl, pacc, static_cast<T*>(o), n_split);
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16, tensor cores

constexpr int MW = 4;              // warps per block, 16 keys of a chunk each
constexpr int MT = MW * 32;
constexpr int CK = MW * 16;        // keys per chunk (one work item)
constexpr int STAGES = 3;          // K/V chunks in the shared-memory ring
// Items a block takes at the least.  Fewer blocks on a short batch mean
// fewer runs per row to merge at the end; at Llama-3-8B's decode width on an
// H100 (tools/paged_decode_ab.py, "main-path" layout), 2 was faster than 1
// and 3 or 4 no faster; long batches fill the grid either way.
constexpr int MIN_ITEMS = 2;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared dst; only the first `bytes` (16 or 0) are read,
// the rest are zero-filled
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a . b for one 16x8x16 tile: a is the 16x16 bf16 A fragment, (b0, b1)
// the 16x8 bf16 B fragment, c the 16x8 f32 accumulator fragment
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the special-function unit; flushes results below 2^-126 to 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// two floats -> bf16x2, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// bf16x2 -> two floats (the low half first), exactly
__device__ __forceinline__ float2 unpack_bf16(uint32_t x) {
  return make_float2(__uint_as_float(x << 16), __uint_as_float(x & 0xffff0000u));
}

// two fp8 values (the first in the low byte) -> bf16x2, exactly
__device__ __forceinline__ uint32_t widen_fp8x2(uint32_t x, bool e4m3) {
  const uint32_t h = fp8x2_to_f16x2(x, e4m3);
  return pack_bf16(__half2float(__ushort_as_half((unsigned short)(h & 0xffffu))),
                   __half2float(__ushort_as_half((unsigned short)(h >> 16))));
}

// two floats rounded to fp8, then as bf16x2: the in-dot scheme's
// p.astype(v_blk.dtype) (P <= 1 never saturates)
__device__ __forceinline__ uint32_t pack_fp8_bf16(float lo, float hi, bool e4m3) {
  return widen_fp8x2(f32x2_to_fp8x2(lo, hi, e4m3), e4m3);
}

// element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are swizzled by XOR with row % 8
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// The keys a row reads: [klo, khi] (none when klo > khi), and its chunks
// [c0, c0 + n) in the numbering chunk(k) = (k / page) * cpp + (k % page) / CK.
struct RowKeys {
  int klo, khi, c0, n;
};

__device__ __forceinline__ RowKeys row_keys(int pos, int lo, int hi, int page, int window,
                                            int cpp) {
  RowKeys r;
  r.klo = lo * page;
  if (window > 0) r.klo = max(r.klo, pos - window + 1);
  r.khi = min(hi * page - 1, pos);
  if (r.klo > r.khi) {
    r.c0 = 0;
    r.n = 0;
    return r;
  }
  r.c0 = (r.klo / page) * cpp + (r.klo % page) / CK;
  r.n = (r.khi / page) * cpp + (r.khi % page) / CK - r.c0 + 1;
  return r;
}

// One work item: chunk c of (slot b, KV head kh).  Items are numbered row by
// row (b major, then kh), chunks in order inside a row; s_items[b] is the
// number of items of the slots before b.
struct Item {
  int b, kh, c, n;   // slot, KV head, chunk of the row, chunks in the row
  int first;         // the row's first item
  RowKeys keys;
  int kfirst;        // position of the chunk's first key
  int off;           // offset of the chunk's first key in its page
  int pi;            // logical page of the chunk
};

__device__ __forceinline__ Item locate(int i, const int* s_items, int B, int KH,
                                       const int* positions, int lo, int hi, int page,
                                       int window, int cpp) {
  int a = 0, z = B;  // the slot b with s_items[b] <= i < s_items[b + 1]
  while (z - a > 1) {
    const int mid = (a + z) >> 1;
    if (s_items[mid] <= i) a = mid; else z = mid;
  }
  Item it;
  it.b = a;
  it.keys = row_keys(positions[a], lo, hi, page, window, cpp);
  it.n = it.keys.n;
  const int local = i - s_items[a];
  it.kh = local / it.n;
  it.c = local - it.kh * it.n;
  it.first = i - it.c;
  const int j = it.keys.c0 + it.c;
  it.pi = j / cpp;
  it.off = (j - it.pi * cpp) * CK;
  it.kfirst = it.pi * page + it.off;
  return it;
}

// the item's block (see block_index)
__device__ __forceinline__ int item_block(const Item& it, const int* block_tables, int KH, int P,
                                          int NB) {
  return block_index(block_tables, it.b, it.kh, it.pi, KH, P, NB);
}

// The blocks' item ranges: block k takes [run_start(k), run_start(k + 1)) of
// `total` items split over `nblk` blocks; run_owner(i) is the block of item i.
// A run that is part of a row is its block's first or last run: its partial
// is slot 2k of the scratch if it starts the block's range, else 2k + 1.
__device__ __forceinline__ int run_start(int k, int nblk, int total) {
  return (int)((long long)k * total / nblk);
}

__device__ __forceinline__ int run_owner(int i, int nblk, int total) {
  return (int)(((long long)(i + 1) * nblk + total - 1) / total) - 1;
}

__device__ __forceinline__ bool key_live(const Item& it, int kc, int page) {
  const int kpos = it.kfirst + kc;
  return it.off + kc < page && kpos >= it.keys.klo && kpos <= it.keys.khi;
}

// fp8 pools: the item's K and V chunks into one ring stage as they lie in
// the pool (D bytes a key row, 16 a thread), unswizzled; keys the row does
// not read are zero-filled, not loaded
template <int D>
__device__ __forceinline__ void load_item_fp8(uint8_t* ks, uint8_t* vs, const uint8_t* k_pool,
                                              const uint8_t* v_pool, const Item& it, int blk,
                                              int page, int tid) {
  constexpr int CPR = D / 16;  // 16-byte chunks per row
  const size_t base = ((size_t)blk * page + it.off) * D;
#pragma unroll
  for (int i = 0; i < CK * CPR / MT; ++i) {
    const int idx = tid + i * MT;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const bool live = key_live(it, row, page);
    const size_t src = live ? base + (size_t)row * D + ch * 16 : 0;
    const int bytes = live ? 16 : 0;
    cp_async16(smem_u32(ks + row * D + ch * 16), k_pool + src, bytes);
    cp_async16(smem_u32(vs + row * D + ch * 16), v_pool + src, bytes);
  }
}

// fp8 pools: one ring stage's chunk widened exactly to bf16 into the
// swizzled tile the products read (16 fp8 values a thread per 16 bytes,
// two swizzled 16-byte chunks out)
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, __nv_bfloat16* dst, bool kind,
                                           int tid) {
  constexpr int CPR = D / 16;
#pragma unroll
  for (int i = 0; i < CK * CPR / MT; ++i) {
    const int idx = tid + i * MT;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const uint4 r = *reinterpret_cast<const uint4*>(raw + row * D + ch * 16);
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch)) =
        make_uint4(widen_fp8x2(r.x, kind), widen_fp8x2(r.x >> 16, kind),
                   widen_fp8x2(r.y, kind), widen_fp8x2(r.y >> 16, kind));
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch + 1)) =
        make_uint4(widen_fp8x2(r.z, kind), widen_fp8x2(r.z >> 16, kind),
                   widen_fp8x2(r.w, kind), widen_fp8x2(r.w >> 16, kind));
  }
}

// the item's K and V chunks into one ring stage, swizzled; keys the row
// does not read are zero-filled, not loaded
template <int D>
__device__ __forceinline__ void load_item(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                          const __nv_bfloat16* k_pool,
                                          const __nv_bfloat16* v_pool, const Item& it,
                                          int blk, int page, int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  const size_t base = ((size_t)blk * page + it.off) * D;
#pragma unroll
  for (int i = 0; i < CK * CPR / MT; ++i) {
    const int idx = tid + i * MT;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const bool live = key_live(it, row, page);
    const size_t src = live ? base + (size_t)row * D + ch * 8 : 0;
    const int bytes = live ? 16 : 0;
    cp_async16(smem_u32(ks + swz<D>(row, ch)), k_pool + src, bytes);
    cp_async16(smem_u32(vs + swz<D>(row, ch)), v_pool + src, bytes);
  }
}

// (min 2 blocks per SM at D = 128, as many as its 96 KB ring leaves room
// for, 3 at D = 64: without a bound ptxas held the D = 128 variants to 168
// registers and spilled; with it none spills)
//
// FP8: the pools hold e4m3 or e5m2 (kfmt).  The ring then holds each item
// as it lies in the pool (1 byte a value, so half the bytes stream), and
// after it lands the block widens it exactly to bf16 into one swizzled
// K/V tile (`widen_tile`), which the unchanged products read through
// `ldmatrix`: `cp.async` moves bytes without converting them, and
// `ldmatrix.trans` takes 16-bit elements only.  The dequant read is then
// the bf16 kernel on exact bf16 copies of the pool's values.  indot (the
// JAX fp8_dot scheme): each query row is quantized to the pool's format in
// the prologue (scale max(amax / max, 1e-12), JAX's f32 arithmetic), the
// scale goes on the f32 score partials, and P is rounded to the pool's
// format before P.V.  Both products stay bf16 `mma.sync` on the widened
// values: an fp8 x fp8 product is exact in the f32 accumulator either way,
// and the kernel is bound by bytes, not by the tensor cores' rate.
template <int D, int G, bool FP8>
__global__ void __launch_bounds__(MT, D == 128 ? 2 : 3)
paged_mma_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
                 const void* __restrict__ v_pool, __nv_bfloat16* __restrict__ out,
                 const int* __restrict__ block_tables, const int* __restrict__ positions,
                 const uint8_t* __restrict__ active, float* __restrict__ part_m,
                 float* __restrict__ part_l, float* __restrict__ part_acc,
                 int* __restrict__ counters, int B, int KH, int P, int page, int NB,
                 int window, float scale_log2, float scale, int kfmt, int indot) {
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q.K^T
  constexpr int DT = D / 8;       // 8-column n-tiles of O
  constexpr int EPT = (G * D + MT - 1) / MT;  // output elements per thread in the merge
  constexpr int RB = 32;          // runs the merge takes at once
  static_assert(RB * (2 * G + 1) + 3 * G <= MW * G * D, "merge buffer");
  constexpr int ESZ = FP8 ? 1 : 2;  // bytes of a pool value
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  unsigned char* Kr = smem_bytes;              // [STAGES][CK][D] pool values
  unsigned char* Vr = Kr + STAGES * CK * D * ESZ;  // [STAGES][CK][D]
  // FP8: the item widened to bf16, K then V, [CK][D] each, swizzled
  __nv_bfloat16* Kw = reinterpret_cast<__nv_bfloat16*>(Vr + STAGES * CK * D * ESZ);
  __nv_bfloat16* Vw = Kw + (FP8 ? CK * D : 0);
  float* s_wo = reinterpret_cast<float*>(Vw + (FP8 ? CK * D : 0));  // [MW][G][D]
  float* s_wm = s_wo + MW * G * D;                                    // [MW][G]
  float* s_wl = s_wm + MW * G;                                        // [MW][G]
  int* s_items = reinterpret_cast<int*>(s_wl + MW * G);               // [B + 1]
  __shared__ int s_last;

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row (query head of the group)
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 within each 8
  const int H = KH * G;
  const int cpp = (page + CK - 1) / CK;  // chunks per page
  const bool kind = kfmt == KV_E4M3;  // else e5m2 (FP8)

  // the item's K and V into ring stage `stage`
  auto load_stage = [&](int stage, const Item& it, int blk) {
    if constexpr (FP8) {
      load_item_fp8<D>(Kr + stage * CK * D, Vr + stage * CK * D,
                       static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                       it, blk, page, tid);
    } else {
      load_item<D>(reinterpret_cast<__nv_bfloat16*>(Kr) + stage * CK * D,
                   reinterpret_cast<__nv_bfloat16*>(Vr) + stage * CK * D,
                   static_cast<const __nv_bfloat16*>(k_pool),
                   static_cast<const __nv_bfloat16*>(v_pool), it, blk, page, tid);
    }
  };

  int lo, hi;
  batch_range(positions, active, B, page, NB, window, lo, hi);

  // items per slot, then their prefix sum (warp 0, 32 slots at a time)
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) s_items[0] = 0;
    for (int base = 0; base < B; base += 32) {
      const int b = base + lane;
      int n = b < B ? KH * row_keys(positions[b], lo, hi, page, window, cpp).n : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, n, o);
        if (lane >= o) n += up;
      }
      if (b < B) s_items[b + 1] = carry + n;
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
  }
  __syncthreads();
  const int total = s_items[B];
  // blocks that take items: at least MIN_ITEMS each, so that a short batch
  // splits its rows into few runs
  const int nblk = max(1, min((int)gridDim.x, (total + MIN_ITEMS - 1) / MIN_ITEMS));

  // rows with no live key write zeros
  for (int r = blockIdx.x; r < B * KH; r += gridDim.x) {
    const int b = r / KH;
    if (s_items[b + 1] == s_items[b]) {
      __nv_bfloat16* o = out + ((size_t)b * H + (r - b * KH) * G) * D;
      for (int i = tid; i < G * D; i += MT) o[i] = __float2bfloat16(0.f);
    }
  }

  // this block's equal run of the items, [i0, i1)
  if ((int)blockIdx.x >= nblk) return;
  const int i0 = run_start(blockIdx.x, nblk, total);
  const int i1 = run_start(blockIdx.x + 1, nblk, total);
  if (i0 >= i1) return;

#define DABT_LOCATE(i) locate((i), s_items, B, KH, positions, lo, hi, page, window, cpp)

  // the first items' block-table entries are all read before any copy
  // is issued, so their latencies overlap
  Item first[STAGES - 1];
  int first_blk[STAGES - 1];
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    first[s] = DABT_LOCATE(min(i0 + s, i1 - 1));
    first_blk[s] = item_block(first[s], block_tables, KH, P, NB);
  }
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (i0 + s < i1) load_stage(s, first[s], first_blk[s]);
    cp_async_commit();
  }
  // the item after those, located one step early: its block-table read is
  // in flight while an item computes, off the path of the next refill
  Item nx = DABT_LOCATE(min(i0 + STAGES - 1, i1 - 1));
  int nx_blk = item_block(nx, block_tables, KH, P, NB);

  // ldmatrix row addresses, as in flash_prefill.cu: lane l names row
  // (l % 16) of a 16-row A tile, chunk l / 16; for K's B fragments, row
  // (l % 8) + 8 (l / 16), chunk (l / 8) % 2
  const int a_row = lane & 15;
  const int a_ch = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_ch = (lane >> 3) & 1;
  const int krow = warp * 16;  // this warp's 16 keys of a chunk

  uint32_t qf[KSTEPS][2];  // Q's A fragments (rows g; rows g + 8 are padding)
  float sl2 = scale_log2;  // row g's score scale, log2 units
  float oacc[DT][4];
  float m = -INFINITY;  // running max of row g, log2 units
  float l = 0.f;        // this lane's part of row g's running sum
  int seg = i0;         // the first item of the current run of one row

  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) % STAGES;
    if (i + STAGES - 1 < i1) {  // refill the stage the previous item used
      load_stage((i - i0 + STAGES - 1) % STAGES, nx, nx_blk);
    }
    cp_async_commit();
    if (i + STAGES < i1) {
      nx = DABT_LOCATE(i + STAGES);
      nx_blk = item_block(nx, block_tables, KH, P, NB);
    }

    const Item it = DABT_LOCATE(i);
    if (i == seg) {  // a new row: its query heads (read before the wait), an empty state
      const __nv_bfloat16* qr = q + ((size_t)it.b * H + it.kh * G + g) * D + 2 * t;
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks) {
        qf[ks][0] = g < G ? *reinterpret_cast<const uint32_t*>(qr + ks * 16) : 0u;
        qf[ks][1] = g < G ? *reinterpret_cast<const uint32_t*>(qr + ks * 16 + 8) : 0u;
      }
      if (FP8 && indot) {
        // quantize_fp8 of row g: its four lanes hold the row's D values
        float qv[KSTEPS][4];
        float amax = 0.f;
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          const float2 a = unpack_bf16(qf[ks][0]);
          const float2 c = unpack_bf16(qf[ks][1]);
          qv[ks][0] = a.x; qv[ks][1] = a.y; qv[ks][2] = c.x; qv[ks][3] = c.y;
#pragma unroll
          for (int e = 0; e < 4; ++e) amax = fmaxf(amax, fabsf(qv[ks][e]));
        }
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 1));
        amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, 2));
        const float qs = fmaxf(__fdiv_rn(amax, fp8_max(kind)), 1e-12f);
        const float qr = __frcp_rn(qs);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks) {
          qf[ks][0] = pack_fp8_bf16(div_rn(qv[ks][0], qs, qr), div_rn(qv[ks][1], qs, qr), kind);
          qf[ks][1] = pack_fp8_bf16(div_rn(qv[ks][2], qs, qr), div_rn(qv[ks][3], qs, qr), kind);
        }
        sl2 = __fmul_rn(qs, scale) * LOG2E;
      }
#pragma unroll
      for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
      m = -INFINITY;
      l = 0.f;
    }
    cp_async_wait<STAGES - 1>();
    __syncthreads();
    const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(Kr) + st * CK * D;
    const __nv_bfloat16* Vt = reinterpret_cast<const __nv_bfloat16*>(Vr) + st * CK * D;
    if constexpr (FP8) {
      widen_tile<D>(Kr + st * CK * D, Kw, kind, tid);
      widen_tile<D>(Vr + st * CK * D, Vw, kind, tid);
      __syncthreads();
      Kt = Kw;
      Vt = Vw;
    }

    // S = Q.K^T for the warp's 16 keys: n-tiles of keys krow + [0, 8) and + [8, 16)
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      uint32_t kf[4];
      ldsm_x4(smem_u32(Kt + swz<D>(krow + kb_row, ks * 2 + kb_ch)), kf);
      const uint32_t a[4] = {qf[ks][0], 0u, qf[ks][1], 0u};
      mma_bf16(s[0], a, kf[0], kf[1]);
      mma_bf16(s[1], a, kf[2], kf[3]);
    }

    // scale into log2 units, mask, online softmax of row g over the quad
    float x[2][2];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = krow + 8 * j + 2 * t + e;
        x[j][e] = key_live(it, kc, page) ? s[j][e] * sl2 : -INFINITY;
        mx = fmaxf(mx, x[j][e]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    // every row of the warp sees the same keys, so this is warp-uniform
    if (m_new != -INFINITY) {
      const float alpha = ex2(m - m_new);  // 0 while m is -inf
      float p[2][2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        p[j][0] = ex2(x[j][0] - m_new);
        p[j][1] = ex2(x[j][1] - m_new);
      }
      l = alpha * l + (p[0][0] + p[0][1]) + (p[1][0] + p[1][1]);  // unrounded f32 p
      m = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[d][0] *= alpha;
        oacc[d][1] *= alpha;
      }
      // O += P.V over the warp's 16 keys; P rounded to bf16 here (in-dot:
      // to the pool's fp8 format, then exactly to bf16)
      uint32_t pa[4] = {pack_bf16(p[0][0], p[0][1]), 0u, pack_bf16(p[1][0], p[1][1]), 0u};
      if (FP8 && indot) {
        pa[0] = pack_fp8_bf16(p[0][0], p[0][1], kind);
        pa[2] = pack_fp8_bf16(p[1][0], p[1][1], kind);
      }
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(Vt + swz<D>(krow + a_row, dp * 2 + a_ch)), vf);
        mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }

    const bool run_ends = i + 1 == i1 || i + 1 == it.first + it.n;
    if (run_ends) {
      // the warps' states of this run into one partial, in slot `ps`, or,
      // where the run is the whole row, straight into the output
      const bool whole = seg == it.first && i + 1 == it.first + it.n;
      const size_t ps = 2 * blockIdx.x + (seg != i0);
      float lq = l;
      lq += __shfl_xor_sync(0xffffffffu, lq, 1);
      lq += __shfl_xor_sync(0xffffffffu, lq, 2);
      if (g < G) {
        if (t == 0) {
          s_wm[warp * G + g] = m;
          s_wl[warp * G + g] = lq;
        }
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          s_wo[(warp * G + g) * D + d * 8 + 2 * t] = oacc[d][0];
          s_wo[(warp * G + g) * D + d * 8 + 2 * t + 1] = oacc[d][1];
        }
      }
      __syncthreads();
      for (int e = tid; e < G * D; e += MT) {
        const int gg = e / D;
        float wmx = -INFINITY;
#pragma unroll
        for (int w = 0; w < MW; ++w) wmx = fmaxf(wmx, s_wm[w * G + gg]);
        float num = 0.f, den = 0.f;
#pragma unroll
        for (int w = 0; w < MW; ++w) {
          const float wm = s_wm[w * G + gg];
          const float f = wm == -INFINITY ? 0.f : ex2(wm - wmx);
          num = fmaf(f, s_wo[w * G * D + e], num);
          den = fmaf(f, s_wl[w * G + gg], den);
        }
        if (whole) {
          out[((size_t)it.b * H + it.kh * G) * D + e] =
              __float2bfloat16(den > 0.f ? num / den : 0.f);
        } else {
          part_acc[ps * G * D + e] = num;
          if (e - gg * D == 0) {
            part_m[ps * G + gg] = wmx;
            part_l[ps * G + gg] = den;
          }
        }
      }
      const int row = it.b * KH + it.kh;
      if (!whole) {
        __threadfence();
        __syncthreads();
        if (tid == 0) {
          const int runs = i + 1 - seg;
          s_last = atomicAdd(counters + row, runs) + runs == it.n;
        }
        __syncthreads();
      }
      if (!whole && s_last) {
        // Every run of the row is in scratch: merge them in chunk order.  A
        // run is the part of the row inside one block's item range, so run
        // k is block bk = owner(first) + k's; its partial is the block's
        // first slot (2 bk) unless the row starts inside the block's range
        // (then 2 bk + 1).  RB runs at a time: their maxima and sums go
        // through shared memory (in the free warp buffer) in one round of
        // loads, then every thread folds its outputs' accumulators over
        // them with the loads unrolled.
        __threadfence();
        const int re = it.first + it.n;
        const int b0 = run_owner(it.first, nblk, total);
        const int n_runs = run_owner(re - 1, nblk, total) - b0 + 1;
        int* s_rs = reinterpret_cast<int*>(s_wo);  // [RB] the runs' slots
        float* s_f = s_wo + RB;                      // [RB][G] maxima, then weights
        float* s_pl = s_f + RB * G;                  // [RB][G] sums
        float* s_rm = s_pl + RB * G;                 // [G] running max
        float* s_a = s_rm + G;                       // [G] rescale of the batch
        float* s_den = s_a + G;                      // [G] running sum
        if (tid < G) {
          s_rm[tid] = -INFINITY;
          s_den[tid] = 0.f;
        }
        float num[EPT];
#pragma unroll
        for (int k = 0; k < EPT; ++k) num[k] = 0.f;
        for (int base = 0; base < n_runs; base += RB) {
          const int cnt = min(RB, n_runs - base);
          for (int x = tid; x < cnt * G; x += MT) {  // cnt * G reaches 256 at G = 8
            const int k = x / G;
            const int gg = x - k * G;
            const int bk = b0 + base + k;
            const int rs = 2 * bk + (it.first > run_start(bk, nblk, total));
            s_f[x] = __ldcg(part_m + (size_t)rs * G + gg);
            s_pl[x] = __ldcg(part_l + (size_t)rs * G + gg);
            if (gg == 0) s_rs[k] = rs;
          }
          __syncthreads();
          if (tid < G) {  // this batch's weights per query head
            float mnew = s_rm[tid];
            for (int r = 0; r < cnt; ++r) mnew = fmaxf(mnew, s_f[r * G + tid]);
            float a = 1.f, den = s_den[tid];
            if (mnew != -INFINITY) {
              a = ex2(s_rm[tid] - mnew);  // 0 while the running max is -inf
              den *= a;
              for (int r = 0; r < cnt; ++r) {
                const float pm = s_f[r * G + tid];
                const float f = pm == -INFINITY ? 0.f : ex2(pm - mnew);
                s_f[r * G + tid] = f;
                den = fmaf(f, s_pl[r * G + tid], den);
              }
              s_rm[tid] = mnew;
            } else {
              for (int r = 0; r < cnt; ++r) s_f[r * G + tid] = 0.f;
            }
            s_a[tid] = a;
            s_den[tid] = den;
          }
          __syncthreads();
#pragma unroll
          for (int k = 0; k < EPT; ++k) {
            const int e = min(tid + k * MT, G * D - 1);
            num[k] *= s_a[e / D];
          }
#pragma unroll 4
          for (int r = 0; r < cnt; ++r) {
            const float* acc_r = part_acc + (size_t)s_rs[r] * G * D;
#pragma unroll
            for (int k = 0; k < EPT; ++k) {
              const int e = min(tid + k * MT, G * D - 1);
              num[k] = fmaf(s_f[r * G + e / D], __ldcg(acc_r + e), num[k]);
            }
          }
          __syncthreads();
        }
#pragma unroll
        for (int k = 0; k < EPT; ++k) {
          const int e = tid + k * MT;
          if (e < G * D) {
            const float den = s_den[e / D];
            out[((size_t)it.b * H + it.kh * G) * D + e] =
                __float2bfloat16(den > 0.f ? num[k] / den : 0.f);
          }
        }
        if (tid == 0) counters[row] = 0;  // ready for the next call
      }
      seg = i + 1;
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();
#undef DABT_LOCATE
}

// dynamic shared memory of paged_mma_kernel<D, G, FP8> for B slots: the K/V
// ring, the widened tile pair (FP8), the warps' merge buffers and the
// slots' item prefix
template <int D, int G, bool FP8>
size_t mma_smem(int B) {
  return (FP8 ? 1 : 2) * 2 * STAGES * CK * D + (FP8 ? sizeof(__nv_bfloat16) * 2 * CK * D : 0) +
         sizeof(float) * MW * G * (D + 2) + sizeof(int) * (B + 1);
}

template <typename K>
cudaError_t grid_blocks_uncached(K kernel, size_t smem, int dev, int& out) {
  cudaFuncAttributes attr;
  int optin = 0, per_sm = 0, sms = 0;
  cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  // static and dynamic shared memory together stay within the opt-in limit
  const int most = optin - (int)attr.sharedSizeBytes;
  if (smem > (size_t)most) return cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, most);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, MT, smem);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  out = per_sm * sms;
  return out > 0 ? cudaSuccess : cudaErrorInvalidConfiguration;
}

// How many blocks of `kernel` fit on the card with `smem` bytes of dynamic
// shared memory.  Each answer is cached per device with the smem it was read
// for (an engine keeps one B, so the attribute and occupancy calls stay off
// the per-launch path); the kernel is opted into the most the card allows
// every time, so no thread ever lowers the limit under another's launch.  A
// failure is returned and cleared, so no later launch reports it.
template <typename K>
cudaError_t grid_blocks(K kernel, size_t smem, std::atomic<long long>* cache, int& out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess && dev < 32) {
    const long long c = cache[dev].load(std::memory_order_acquire);
    if (c > 0 && (size_t)(c >> 32) == smem) {
      out = (int)(c & 0xffffffffLL);
      return cudaSuccess;
    }
  }
  if (err == cudaSuccess) err = grid_blocks_uncached(kernel, smem, dev, out);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return err;
  }
  if (dev < 32) cache[dev].store(((long long)smem << 32) | out, std::memory_order_release);
  return cudaSuccess;
}

// paged_mma_kernel<D, G, FP8>'s grid: as many blocks as fit on the card, at
// most one per item of every row at its most (NB pages of ceil(page / CK)
// chunks)
template <int D, int G, bool FP8>
cudaError_t mma_grid(int B, int KH, int page, int NB, int& nblk) {
  static std::atomic<long long> cache[32];
  int fit = 0;
  cudaError_t err =
      grid_blocks(paged_mma_kernel<D, G, FP8>, mma_smem<D, G, FP8>(B), cache, fit);
  if (err != cudaSuccess) return err;
  const long long most = (long long)B * KH * NB * ((page + CK - 1) / CK);
  nblk = (int)(most < fit ? most : fit);
  return cudaSuccess;
}

// f32 scratch of paged_mma_kernel<D, G>: two (m, l, acc) partials per block
template <int D, int G>
long long mma_scratch(int nblk) {
  return 2LL * nblk * G * (D + 2);
}

template <int D, int G, bool FP8>
cudaError_t launch_mma_g(const void* q, const void* k, const void* v, void* o, const int* bt,
                         const int* pos, const uint8_t* active, float* scratch,
                         long long scratch_floats, int* counters, int B, int KH, int P,
                         int page, int NB, int window, int kfmt, int indot, cudaStream_t s) {
  int nblk = 0;
  cudaError_t err = mma_grid<D, G, FP8>(B, KH, page, NB, nblk);
  if (err != cudaSuccess) return err;
  if (scratch_floats < mma_scratch<D, G>(nblk)) return cudaErrorInvalidValue;
  // two partials per block (see run_start): maxima [2 nblk][G], sums
  // [2 nblk][G], accumulators [2 nblk][G][D]
  float* pm = scratch;
  float* pl = pm + 2LL * nblk * G;
  float* pacc = pl + 2LL * nblk * G;
  paged_mma_kernel<D, G, FP8><<<nblk, MT, mma_smem<D, G, FP8>(B), s>>>(
      static_cast<const __nv_bfloat16*>(q), k, v, static_cast<__nv_bfloat16*>(o), bt, pos,
      active, pm, pl, pacc, counters, B, KH, P, page, NB, window, LOG2E / sqrtf((float)D),
      1.0f / sqrtf((float)D), kfmt, indot);
  return cudaGetLastError();
}

template <int D, bool FP8>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, const int* bt,
                       const int* pos, const uint8_t* active, float* scratch,
                       long long scratch_floats, int* counters, int B, int H, int KH, int P,
                       int page, int NB, int window, int kfmt, int indot, cudaStream_t s) {
  switch (H / KH) {
#define DABT_G(GG)                                                                         \
  case GG:                                                                                 \
    return launch_mma_g<D, GG, FP8>(q, k, v, o, bt, pos, active, scratch, scratch_floats,  \
                                    counters, B, KH, P, page, NB, window, kfmt, indot, s);
    DABT_G(1)
    DABT_G(2)
    DABT_G(4)
    DABT_G(8)
#undef DABT_G
    default:
      return cudaErrorInvalidValue;
  }
}

template <int D, bool FP8>
long long mma_scratch_floats(int B, int H, int KH, int page, int NB) {
  int nblk = 0;
  switch (H / KH) {
#define DABT_G(GG)                                                             \
  case GG:                                                                     \
    if (mma_grid<D, GG, FP8>(B, KH, page, NB, nblk) != cudaSuccess) return -1; \
    return mma_scratch<D, GG>(nblk);
    DABT_G(1)
    DABT_G(2)
    DABT_G(4)
    DABT_G(8)
#undef DABT_G
    default:
      return -1;
  }
}

bool shapes_taken(int B, int H, int KH, int page, int NB) {
  return B > 0 && KH > 0 && H % KH == 0 && H / KH <= MAXG && page % U == 0 && NB > 0;
}

}  // namespace

// The f32 scratch floats that dabt_paged_decode needs for these shapes on
// the current device, by route (mma = 1: the tensor-core kernel, bf16
// queries at D = 64 or 128 over a pool in format kfmt; 0: the CUDA-core
// split + combine kernels), or -1 for shapes the route does not take.
extern "C" long long dabt_paged_decode_scratch(int mma, int kfmt, int B, int H, int KH,
                                               int page, int NB, int D) {
  if (!shapes_taken(B, H, KH, page, NB)) return -1;
  if (!mma) return (long long)B * H * NB * (D + 2);  // a partial per page split
  const bool f8 = kfmt == KV_E4M3 || kfmt == KV_E5M2;
  if (D == 64) return f8 ? mma_scratch_floats<64, true>(B, H, KH, page, NB)
                         : mma_scratch_floats<64, false>(B, H, KH, page, NB);
  if (D == 128) return f8 ? mma_scratch_floats<128, true>(B, H, KH, page, NB)
                          : mma_scratch_floats<128, false>(B, H, KH, page, NB);
  return -1;
}

namespace {

// One paged or contiguous decode read (block_tables null: the contiguous
// slot cache, see block_index); the arguments as dabt_paged_decode's.
int decode(const void* q, const void* k_pool, const void* v_pool, void* out,
           const int* bt, const int* pos, const uint8_t* act, float* sc,
           long long scratch_floats, int* cnt, int mma, int dtype, int kfmt, int indot, int B,
           int H, int KH, int P, int page, int NB, int D, int window, cudaStream_t s) {
  if (!shapes_taken(B, H, KH, page, NB)) return (int)cudaErrorInvalidValue;
  const bool f8 = kfmt == KV_E4M3 || kfmt == KV_E5M2;
  if (kfmt < KV_F32 || kfmt > KV_E5M2 || (indot && !f8) || (dtype == 1 && kfmt == KV_F32) ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (mma) {
    if (dtype != 1 || ((uintptr_t)q | (uintptr_t)k_pool | (uintptr_t)v_pool) % 16 != 0)
      return (int)cudaErrorInvalidValue;
#define DABT_M(DD, F8)                                                                      \
  if (D == DD && f8 == F8)                                                                  \
    return (int)launch_mma<DD, F8>(q, k_pool, v_pool, out, bt, pos, act, sc, scratch_floats, \
                                   cnt, B, H, KH, P, page, NB, window, kfmt, indot, s);
    DABT_M(64, false)
    DABT_M(64, true)
    DABT_M(128, false)
    DABT_M(128, true)
#undef DABT_M
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)B * H * NB;
  if (scratch_floats < n * (D + 2)) return (int)cudaErrorInvalidValue;
  float* pm = sc;
  float* pl = sc + n;
  float* pacc = sc + 2 * n;
#define DABT_D(TT, CODE, DD)                                                               \
  if (dtype == CODE && D == DD)                                                            \
    return (int)launch_split<TT, DD>(q, k_pool, v_pool, out, bt, pos, act, pm, pl, pacc, \
                                     B, H, KH, P, page, NB, window, kfmt, indot, s);
  DABT_D(float, 0, 16)
  DABT_D(float, 0, 32)
  DABT_D(float, 0, 64)
  DABT_D(float, 0, 128)
  DABT_D(float, 0, 256)
  DABT_D(__nv_bfloat16, 1, 16)
  DABT_D(__nv_bfloat16, 1, 32)
  DABT_D(__nv_bfloat16, 1, 64)
  DABT_D(__nv_bfloat16, 1, 128)
  DABT_D(__nv_bfloat16, 1, 256)
#undef DABT_D
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: q's, 0 = float32, 1 = bfloat16.  kfmt: the pools' storage format,
// 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 = float8_e5m2: q's own,
// bf16 under f32 queries, or fp8.  indot = 1: the fp8 in-dot read (fp8
// pools only); 0: the dequant read (values widened exactly to q's type, P
// rounded to q's type).  active may be null (every row active).  mma: the
// route, as for dabt_paged_decode_scratch; the tensor-core kernel copies 16
// bytes at a time, so q and the pools must lie on 16-byte boundaries for it.
// scratch: scratch_floats f32, at least what dabt_paged_decode_scratch
// asks; counters: B * KH int32, zero before the first call (each call
// leaves them zero).  window <= 0 means no sliding window.  Returns a
// cudaError_t (0 = success).
extern "C" int dabt_paged_decode(const void* q, const void* k_pool, const void* v_pool,
                                 void* out, const void* block_tables,
                                 const void* positions, const void* active, void* scratch,
                                 long long scratch_floats, void* counters, int mma, int dtype,
                                 int kfmt, int indot, int B, int H, int KH, int P, int page,
                                 int NB, int D, int window, void* stream) {
  if (block_tables == nullptr) return (int)cudaErrorInvalidValue;
  return decode(q, k_pool, v_pool, out, static_cast<const int*>(block_tables),
                static_cast<const int*>(positions), static_cast<const uint8_t*>(active),
                static_cast<float*>(scratch), scratch_floats, static_cast<int*>(counters), mma,
                dtype, kfmt, indot, B, H, KH, P, page, NB, D, window,
                static_cast<cudaStream_t>(stream));
}

// The contiguous form: k_cache, v_cache are the slot cache [B, KH, S, D]
// (one layer of the legacy KV cache), read in chunk-wide slices (chunk
// divides S; the chunk takes the page's part everywhere above).  The other
// arguments and the scratch (dabt_paged_decode_scratch with page = chunk,
// NB = S / chunk) as dabt_paged_decode's.
extern "C" int dabt_chunked_decode(const void* q, const void* k_cache, const void* v_cache,
                                   void* out, const void* positions, const void* active,
                                   void* scratch, long long scratch_floats, void* counters,
                                   int mma, int dtype, int kfmt, int indot, int B, int H, int KH,
                                   int S, int chunk, int D, int window, void* stream) {
  if (chunk <= 0 || S % chunk != 0) return (int)cudaErrorInvalidValue;
  return decode(q, k_cache, v_cache, out, nullptr, static_cast<const int*>(positions),
                static_cast<const uint8_t*>(active), static_cast<float*>(scratch),
                scratch_floats, static_cast<int*>(counters), mma, dtype, kfmt, indot, B, H, KH,
                B, chunk, S / chunk, D, window, static_cast<cudaStream_t>(stream));
}
