// Flash prefill attention for Hopper (sm_90a): blocked online softmax, GQA.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py `flash_attention`
// (:535-623) and its Pallas body `_flash_kernel` (:432-526).  Computes what
// `dot_product_attention(q, k, v, causal, window)` (:42-70) computes, without
// the [Sq, Sk] score matrix ever reaching device memory.
//
// Layouts: q, o are [B, H, Sq, D]; k, v are [B, KH, Sk, D] with KH dividing H.
// Query head h reads KV head h / (H / KH) itself, so the caller never repeats
// K/V up to H heads.  D is 64, 128 (Llama) or 256 (Gemma); Sq and Sk are
// multiples of 64.  Key tiles past the causal diagonal or wholly below the
// sliding-window band are never loaded, as the JAX kernel's clamped index
// map skips them.  Masked scores take the same finite -1e30 as the JAX code,
// so a tile that is fully masked for a row contributes exactly what it
// contributes there (wiped by the next live tile's alpha = exp(-1e30 - m)).
//
// Two kernels:
//
// * bf16 (the serving path), D = 64 and 128: `flash_mma_kernel`, on the
//   tensor cores.  What bounds it on the H100: at the main path's prefill
//   buckets (B = 4, H = 32, KH = 8, D = 128, causal) the bytes (q, k, v read
//   once, o written once, at 3.35 TB/s) outweigh the causal operations (at
//   989 TFLOP/s): 0.0063 against 0.0022 ms at S = 256, 0.0125 against
//   0.0087 ms at S = 512; from S = 1024 on the operations bound it (0.139 ms
//   at S = 2048).  What it reaches in practice is set by how fast the warps
//   feed `mma.sync` tiles between the softmax's exponentials, so the design
//   keeps the tensor cores fed and nothing but q, k, v and o in device memory:
//   - one block per (batch*head, 64-row q tile), 4 warps of 16 query rows;
//     the q tile is the grid's slow axis, walked in reverse, so the longest
//     causal tiles of every head start first and the short ones fill the tail;
//   - Q, K and V tiles reach shared memory by `cp.async.cg` (16 bytes a
//     thread), rows swizzled by XOR of the 16-byte chunk index with row % 8
//     so `ldmatrix` reads them without bank conflicts; K and V are double
//     buffered: the next key tile's copy is in flight while this one computes;
//   - S = Q.K^T and O += P.V run as `mma.sync.m16n8k16` bf16 products with
//     f32 accumulators; Q's A fragments are loaded once into registers, K's
//     B fragments come from `ldmatrix`, V's from `ldmatrix.trans`;
//   - the online softmax runs on the f32 accumulator fragments, in log2
//     units (the scale folds in log2 e; `ex2.approx` on the special-function
//     unit): a row lives in the 4 lanes of a quad (two `__shfl_xor_sync`s per
//     max), the mask is applied only on tiles that cross the diagonal or the
//     band edge, and P is packed to bf16 straight from the accumulator layout
//     into the A-fragment layout of the P.V product, with no trip through
//     shared memory;
//   - the epilogue divides by max(l, 1e-30), rounds to bf16, stages the
//     warp's 16 rows in its own rows of the Q tile and stores 16 bytes a lane.
//   Numerics: P is rounded to bf16 before P.V, as the TPU kernel does
//   (`p.astype(v_blk.dtype)`, :512-514), while the normaliser l sums the
//   unrounded f32 p (:511).  That is what holds the output within
//   2^-8 |ref| + 2^-8 A + 1e-4 of the f32 reference, A being the same
//   attention over |v| (`ops/attention.py` `flash_bf16_bound`).
//   Not at D = 256: a warp's 16 x 256 f32 O accumulator alone takes 128
//   registers a lane, and ptxas spilled 340 bytes even with Q's fragments
//   re-read from shared memory, so bf16 at D = 256 (Gemma) stays on the
//   CUDA-core kernel below.
//
// * f32 (tight checks), and bf16 at D = 256: `flash_prefill_kernel`, the
//   first CUDA-core kernel, unchanged.  One block per (batch*head, 64-row q
//   tile); 8 warps of 8 query rows each; K/V tiles staged in shared memory
//   as f32 (K rows padded to D+1 floats so the per-lane key rows hit
//   distinct banks), each lane scores two keys against its warp's rows, the
//   f32 running max / sum / accumulator of each row stay in registers, and
//   the tile's probabilities go through a per-warp shared buffer into the
//   P.V product, where each lane owns D/32 output columns.  Every product is
//   f32, so it agrees with the f32 reference to 1e-4.  At D = 256 the f32
//   staging takes 208 KiB of shared memory, so one block runs per SM.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <atomic>

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

// Opts `kernel` into `smem` bytes of dynamic shared memory once per device:
// `done` is the launcher's own flag word, one bit per device, so the
// attribute call stays off the per-launch path.
template <typename K>
cudaError_t allow_smem(K kernel, size_t smem, std::atomic<uint32_t>& done) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit, std::memory_order_release);
  return err;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int H, int KH, int Sq, int Sk, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + NW * RPW * BK);
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = allow_smem(flash_prefill_kernel<T, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(Sq / BQ, B * H);
  flash_prefill_kernel<T, D><<<grid, NW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), H, KH, Sq, Sk, causal, window, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

// ------------------------------------------------------------------ bf16, tensor cores

constexpr int MMA_WARPS = 4;  // 16 query rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(src));
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

// element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are swizzled by XOR with row % 8
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// one 64 x D bf16 tile (BQ == BK == 64 rows) from device memory into a
// swizzled shared tile, 16 bytes a thread per copy, neighbours on neighbours
template <int D>
__device__ __forceinline__ void load_tile_async(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                                int tid) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
#pragma unroll
  for (int i = 0; i < BK * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    cp_async16(smem_u32(dst + swz<D>(row, ch)), src + (size_t)row * D + ch * 8);
  }
}

template <int D>
__global__ void __launch_bounds__(MMA_THREADS)
flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int H,
                 int KH, int Sq, int Sk, int causal, int window, float scale_log2) {
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q.K^T
  constexpr int NT = BK / 8;      // 8-key n-tiles of S
  constexpr int DT = D / 8;       // 8-column n-tiles of O
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bytes);  // [BQ][D]
  __nv_bfloat16* Ks = Qs + BQ * D;                                    // [2][BK][D]
  __nv_bfloat16* Vs = Ks + 2 * BK * D;                                // [2][BK][D]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator row (and row + 8) within the warp's 16
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 within each 8
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kh = h / (H / KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;

  const __nv_bfloat16* qb = q + ((size_t)bh * Sq + q0) * D;
  const __nv_bfloat16* kb = k + (size_t)(b * KH + kh) * Sk * D;
  const __nv_bfloat16* vb = v + (size_t)(b * KH + kh) * Sk * D;

  // live key tiles [kt_lo, kt_hi), as in the f32 kernel
  const int n_kt = Sk / BK;
  int kt_hi = n_kt;
  if (causal) kt_hi = min(n_kt, (q0 + BQ + BK - 1) / BK);
  int kt_lo = 0;
  if (window > 0) kt_lo = max(0, q0 - window + 1) / BK;

  load_tile_async<D>(Qs, qb, tid);
  if (kt_lo < kt_hi) {
    load_tile_async<D>(Ks, kb + (size_t)kt_lo * BK * D, tid);
    load_tile_async<D>(Vs, vb + (size_t)kt_lo * BK * D, tid);
  }
  cp_async_commit();

  // ldmatrix row addresses: lane l names row (l % 16) of a 16-row A tile,
  // chunk l / 16; for K's B fragments, row (l % 8) + 8 (l / 16), chunk
  // (l / 8) % 2.  Every such row is congruent to l mod 8.
  const int a_row = lane & 15;
  const int a_ch = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_ch = (lane >> 3) & 1;
  const int qrow = warp * 16 + a_row;

  uint32_t qf[KSTEPS][4];  // Q's A fragments, loaded once
  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2 units) of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sums
  const int qpos0 = q0 + warp * 16 + g;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // the next tile's copy runs while this one computes
      load_tile_async<D>(Ks + (st ^ 1) * BK * D, kb + (size_t)(kt + 1) * BK * D, tid);
      load_tile_async<D>(Vs + (st ^ 1) * BK * D, vb + (size_t)(kt + 1) * BK * D, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(smem_u32(Qs + swz<D>(qrow, ks * 2 + a_ch)), qf[ks]);
    }
    const __nv_bfloat16* Kt = Ks + st * BK * D;
    const __nv_bfloat16* Vt = Vs + st * BK * D;

    // S = Q.K^T for the warp's 16 rows and the tile's 64 keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t kf[4];
        ldsm_x4(smem_u32(Kt + swz<D>(np * 16 + kb_row, ks * 2 + kb_ch)), kf);
        mma_bf16(s[2 * np], qf[ks], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[ks], kf[2], kf[3]);
      }
    }

    // scale into log2 units; mask only where the tile crosses the diagonal
    // or the lower edge of the window band
    const bool need_mask = (causal && kt * BK + BK - 1 > q0) ||
                           (window > 0 && kt * BK <= q0 + BQ - 1 - window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int qpos = qpos0 + (e >> 1) * 8;
          const int kpos = kt * BK + j * 8 + 2 * t + (e & 1);
          bool keep = !causal || kpos <= qpos;
          if (window > 0) keep = keep && (kpos > qpos - window);
          if (!keep) x = NEG_INF;
        }
        s[j][e] = x;
      }
    }

    // online softmax on the accumulator fragments; a row's 64 scores live
    // in the 4 lanes of a quad
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      mx0 = fmaxf(mx0, fmaxf(s[j][0], s[j][1]));
      mx1 = fmaxf(mx1, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float alpha0 = ex2(m0 - mx0);
    const float alpha1 = ex2(m1 - mx1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2(s[j][0] - mx0);
      s[j][1] = ex2(s[j][1] - mx0);
      s[j][2] = ex2(s[j][2] - mx1);
      s[j][3] = ex2(s[j][3] - mx1);
      sum0 += s[j][0] + s[j][1];
      sum1 += s[j][2] + s[j][3];
    }
    l0 = alpha0 * l0 + sum0;  // the unrounded f32 p, as the JAX kernel sums them
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= alpha0;
      oacc[d][1] *= alpha0;
      oacc[d][2] *= alpha1;
      oacc[d][3] *= alpha1;
    }

    // O += P.V: n-tiles 2kk, 2kk + 1 of S are the A fragment of keys
    // [16 kk, 16 kk + 16)
#pragma unroll
    for (int kk = 0; kk < NT / 2; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < DT / 2; ++dp) {
        uint32_t vf[4];
        ldsm_x4_trans(smem_u32(Vt + swz<D>(kk * 16 + a_row, dp * 2 + a_ch)), vf);
        mma_bf16(oacc[2 * dp], pa, vf[0], vf[1]);
        mma_bf16(oacc[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is refilled
  }
  cp_async_wait<0>();  // no live tile: the Q copy may still be in flight
  __syncthreads();

  // epilogue: the quad's partial sums, O / l in bf16 staged in the warp's own
  // rows of the Q tile, then 16-byte stores
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int orow = warp * 16 + g;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<uint32_t*>(Qs + swz<D>(orow, d) + 2 * t) =
        pack_bf16(oacc[d][0] * inv0, oacc[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(Qs + swz<D>(orow + 8, d) + 2 * t) =
        pack_bf16(oacc[d][2] * inv1, oacc[d][3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + ((size_t)bh * Sq + q0 + warp * 16) * D;
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + i * 32;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    *reinterpret_cast<uint4*>(ob + (size_t)row * D + ch * 8) =
        *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + row, ch));
  }
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k, const void* v, void* o, int B, int H,
                       int KH, int Sq, int Sk, int causal, int window, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (BQ * D + 4 * BK * D);
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = allow_smem(flash_mma_kernel<D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, Sq / BQ);
  flash_mma_kernel<D><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), H, KH, Sq, Sk,
      causal, window, LOG2E / sqrtf((float)D));
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
  if (dtype == 0 && D == 256)
    return (int)launch<float, 256>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  // bf16: the tensor-core kernel at Llama's head dims
  if (dtype == 1 && D == 64)
    return (int)launch_mma<64>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 1 && D == 128)
    return (int)launch_mma<128>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  if (dtype == 1 && D == 256)
    return (int)launch<__nv_bfloat16, 256>(q, k, v, o, B, H, KH, Sq, Sk, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
