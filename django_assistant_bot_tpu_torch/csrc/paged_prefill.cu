// Paged prefill attention for Hopper (sm_90a): a prefill chunk, or a wave of
// prefix suffixes, at a query offset against its rows' pages plus its own K/V.
//
// Replaces: django_assistant_bot_tpu/models/llama.py `prefill_suffix_paged`
// (:1093-1161, attention at :1134) and `prefill_chunk_paged` (:1163-, at
// :1205): `_gather_paged_rows` (:1022) of each row's whole logical view of
// S = NB * page keys, `_write_cache` (:677) of the chunk into it, then
// `gqa_dot_product_attention` (ops/attention.py :73) under the mask
// kpos <= start + i (and the sliding window), which XLA fuses on a TPU.
// Computes what the port's `paged_prefill_attention_plain` computes: the
// logical row's key at position p is the chunk's own key p - wstart when
// wstart <= p < wstart + C (wstart = min(start, S - C), the write window as
// dynamic_update_slice clamps it), else the key in page
// block_tables[b, p / page] (clamped to P - 1, as the gather clamps
// sentinels) at offset p % page.  Neither the gathered row nor the
// [C, S] scores reach device memory, and the pages are not written here
// (the caller writes the chunk's C tokens, models/llama.py
// `_write_chunk_tokens`).
//
// Layouts: q [B, H, C, D] and out [B, H, C, D] through element strides
// (batch, head, row), so the projections' [B, C, H, D] layout is read and
// written in place; the chunk's k/v [B, KH, C, D] likewise, in the pool's
// type; pools [P + 1, KH, page, D] (page P the dump page, never read);
// block_tables [B, NB] int32; starts [B] int64.  Query head h reads KV head
// h / (H / KH).  The contiguous form (the legacy slot cache [slots, KH, S,
// D], ops/attention.py `chunked_prefill_attention`) is the same kernel: the
// cache is a pool of pages of S keys with no dump page, NB 1, each row's
// block table its slot.
//
// What bounds it on the H100: at Llama-3-8B's width (H 32, KH 8, D 128) a
// 512-token chunk at start s does 4 * 32 * 128 * (512 s + 512 * 513 / 2)
// operations and reads q, the chunk and its live keys' pages once: at
// s = 3584 32.2 GFLOP, 0.033 ms at 989 TFLOP/s, against ~4 MB of bytes
// (0.0012 ms at 3.35 TB/s); at s = 0 the bytes bound it.  So the design is
// the flash kernel's (csrc/flash_prefill.cu), which keeps the tensor cores
// fed and nothing but its inputs and output in device memory, with two
// changes: where its keys come from, and where its key range ends.
//
// * Each block finds its key tiles on the device from starts[b]
//   (`key_tiles`, mirrored by ops/attention.py `paged_prefill_key_tiles`):
//   64-key tiles from position 0 up to the position of its last query row
//   (inside the row), and from the window edge of its first.  Nothing is
//   read on the host, so one CUDA graph serves every chunk.
// * A key tile's 64 rows are resolved one by one (a prefix hit's start
//   falls mid-tile, so a tile may hold pool rows and chunk rows): each row's
//   16-byte copies read the chunk row or the page row.  Rows past S are
//   zero-filled, and the mask drops them (a score of -inf).
//
// Two kernels:
//
// * bf16 queries at D = 64 and 128 (the serving path): `paged_prefill_mma_kernel`,
//   one block per (row * head, 64-query tile), 4 warps of 16 query rows,
//   the q tile the grid's slow axis walked in reverse (the longest causal
//   tiles first).  Q and the K/V tiles reach shared memory by `cp.async.cg`
//   (16 bytes a thread, rows swizzled by XOR of the 16-byte chunk index with
//   row % 8 for `ldmatrix`), K/V double buffered; S = Q.K^T and O += P.V on
//   `mma.sync.m16n8k16` bf16 with f32 accumulators; the online softmax on
//   the accumulator fragments in log2 units (`ex2.approx`), the mask only on
//   tiles that cross the diagonal, the window edge or the row's end.  fp8
//   pools (e4m3, e5m2: the chunk's K/V in the same format) land in a byte
//   ring as they lie and are widened exactly to bf16 into one swizzled K/V
//   tile before the products (the dequant read).  Numerics: P is rounded to
//   bf16 before P.V while l sums the unrounded f32 p, as the JAX kernels
//   do: within 2^-8 |ref| + 2^-8 A + 1e-4 of the f32 twin, A the same
//   attention over |v| (`paged_prefill_bf16_bound`).
// * f32 queries (over f32, bf16, e4m3 or e5m2 pools), and bf16 at the other
//   head dims (16, 32, 256): `paged_prefill_cc_kernel`, the flash kernel's
//   CUDA-core form: 8 warps of 8 query rows, K/V tiles staged in shared
//   memory as f32 (K rows padded to D + 1 floats), each row's source
//   resolved once a tile into shared memory, f32 products throughout.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
enum { KV_F32 = 0, KV_BF16 = 1, KV_E4M3 = 2, KV_E5M2 = 3 };

// what every block reads besides its pointers
struct Geo {
  int H, KH, C, P, page, NB, window;
  long long q_sb, q_sh, q_ss;  // element strides of q (batch, head, row)
  long long c_sb, c_sh, c_ss;  // of the chunk's k and v
  long long o_sb, o_sh, o_ss;  // of out
};

// the key tiles [lo, hi) of the block whose query rows are [q0, q0 + BQ)
// of a chunk at `start` in a row of S keys: up to the last query row's
// position, and from the first row's window edge.  A query whose window
// lies wholly past the row's end (a chunk running past the row, which no
// caller makes) keeps no key; the twin's softmax then weighs all S keys
// alike, so such a block reads the row from its first key.
__device__ __forceinline__ void key_tiles(int start, int C, int S, int q0, int window, int& lo,
                                          int& hi) {
  const int last = min(q0 + BQ, C) - 1;
  hi = (min(S, start + last + 1) + BK - 1) / BK;
  lo = 0;
  if (window > 0 && start + last - window + 1 < S)
    lo = min(max(start + q0 - window + 1, 0) / BK, hi);
}

// the score of a masked key: the JAX code's finite -1e30 inside the row, so
// a row that keeps no key averages the row's keys as the twin does, and
// -inf past the row's end, where the twin has no key
__device__ __forceinline__ float masked(int kpos, int S) {
  return kpos < S ? NEG_INF : __int_as_float(0xff800000);
}

// the element offset of key position p's row (KV head kh): in the chunk's
// k/v when it lies in the write window, else in its page; `in_chunk` says
// which
__device__ __forceinline__ long long key_row(int p, int wstart, const int* bt_row, int b, int kh,
                                             int D, const Geo& g, bool& in_chunk) {
  const int ci = p - wstart;
  in_chunk = ci >= 0 && ci < g.C;
  if (in_chunk) return b * g.c_sb + kh * g.c_sh + ci * g.c_ss;
  const int phys = min(max(bt_row[p / g.page], 0), g.P - 1);
  return (((long long)phys * g.KH + kh) * g.page + p % g.page) * D;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from src to shared memory, or 16 zero bytes when !live
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool live) {
  const int n = live ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

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

// c += a . b for one 16x8x16 tile (bf16 in, f32 accumulators)
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

// two floats -> bf16x2, the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp8 values (the first in the low byte) -> f16x2, exactly (every e4m3
// and e5m2 value is an f16 value); both conversions, then a select, so the
// format stays a runtime value
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t x, bool e4m3) {
  const unsigned short v = (unsigned short)(x & 0xffffu);
  uint32_t a, b;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(a) : "h"(v));
  asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(b) : "h"(v));
  return e4m3 ? a : b;
}

// two fp8 values -> bf16x2, exactly
__device__ __forceinline__ uint32_t widen_fp8x2(uint32_t x, bool e4m3) {
  const uint32_t h = fp8x2_to_f16x2(x, e4m3);
  return pack_bf16(__half2float(__ushort_as_half((unsigned short)(h & 0xffffu))),
                   __half2float(__ushort_as_half((unsigned short)(h >> 16))));
}

// element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are swizzled by XOR with row % 8
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// Opts `kernel` into `smem` bytes of dynamic shared memory once per device
// (`done`: one bit per device), so the attribute call stays off the
// per-launch path.
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

// ------------------------------------------------------------------ bf16, tensor cores

constexpr int MMA_WARPS = 4;  // 16 query rows each
constexpr int MMA_THREADS = MMA_WARPS * 32;

// one key tile's K and V rows into shared memory, 16 bytes a copy: bf16
// straight into the swizzled tiles, fp8 as they lie (D bytes a row) into the
// byte ring; rows past the row's S keys zero-filled
template <int D, bool FP8>
__device__ __forceinline__ void load_kv_tile(void* kdst, void* vdst, const uint8_t* kc,
                                             const uint8_t* vc, const uint8_t* kp,
                                             const uint8_t* vp, int kt, int S, int wstart,
                                             const int* bt_row, int b, int kh, const Geo& g,
                                             int tid) {
  constexpr int ESZ = FP8 ? 1 : 2;
  constexpr int RCH = D * ESZ / 16;  // 16-byte chunks a stored row
#pragma unroll
  for (int i = 0; i < BK * RCH / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int row = idx / RCH;
    const int ch = idx % RCH;
    const int p = kt * BK + row;
    const bool live = p < S;
    bool in_chunk = false;
    const long long off = live ? key_row(p, wstart, bt_row, b, kh, D, g, in_chunk) : 0;
    const size_t byte = (size_t)off * ESZ + ch * 16;
    const uint8_t* ks = (in_chunk ? kc : kp) + byte;
    const uint8_t* vs = (in_chunk ? vc : vp) + byte;
    if constexpr (FP8) {
      cp_async16(smem_u32(static_cast<uint8_t*>(kdst) + row * D + ch * 16), ks, live);
      cp_async16(smem_u32(static_cast<uint8_t*>(vdst) + row * D + ch * 16), vs, live);
    } else {
      cp_async16(smem_u32(static_cast<__nv_bfloat16*>(kdst) + swz<D>(row, ch)), ks, live);
      cp_async16(smem_u32(static_cast<__nv_bfloat16*>(vdst) + swz<D>(row, ch)), vs, live);
    }
  }
}

// fp8: one ring stage's rows widened exactly to bf16 into the swizzled tile
// (16 fp8 values a thread per 16 bytes, two swizzled 16-byte chunks out)
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, __nv_bfloat16* dst, bool e4m3,
                                           int tid) {
  constexpr int CPR = D / 16;
#pragma unroll
  for (int i = 0; i < BK * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const uint4 r = *reinterpret_cast<const uint4*>(raw + row * D + ch * 16);
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch)) =
        make_uint4(widen_fp8x2(r.x, e4m3), widen_fp8x2(r.x >> 16, e4m3),
                   widen_fp8x2(r.y, e4m3), widen_fp8x2(r.y >> 16, e4m3));
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch + 1)) =
        make_uint4(widen_fp8x2(r.z, e4m3), widen_fp8x2(r.z >> 16, e4m3),
                   widen_fp8x2(r.w, e4m3), widen_fp8x2(r.w >> 16, e4m3));
  }
}

template <int D, bool FP8>
__global__ void __launch_bounds__(MMA_THREADS)
paged_prefill_mma_kernel(const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ kc,
                         const uint8_t* __restrict__ vc, const uint8_t* __restrict__ kp,
                         const uint8_t* __restrict__ vp, const int* __restrict__ bt,
                         const long long* __restrict__ starts, __nv_bfloat16* __restrict__ o,
                         Geo g, int e4m3, float scale_log2) {
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q.K^T
  constexpr int NT = BK / 8;      // 8-key n-tiles of S
  constexpr int DT = D / 8;       // 8-column n-tiles of O
  constexpr int CPR = D / 8;      // 16-byte chunks per bf16 row
  constexpr int RING = FP8 ? 1 : 2;  // bf16 K/V tiles (FP8: the widened tile)
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_bytes);  // [BQ][D]
  __nv_bfloat16* Ks = Qs + BQ * D;                                    // [RING][BK][D]
  __nv_bfloat16* Vs = Ks + RING * BK * D;                             // [RING][BK][D]
  uint8_t* Kr = reinterpret_cast<uint8_t*>(Vs + RING * BK * D);       // FP8: [2][BK][D]
  uint8_t* Vr = Kr + 2 * BK * D;                                      // FP8: [2][BK][D]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int gr = lane >> 2;  // accumulator row (and row + 8) within the warp's 16
  const int t = lane & 3;    // accumulator columns 2t, 2t + 1 within each 8
  const int b = blockIdx.x / g.H;
  const int h = blockIdx.x - b * g.H;
  const int kh = h / (g.H / g.KH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  const int S = g.NB * g.page;
  const int start = (int)starts[b];
  const int wstart = min(start, S - g.C);
  const int* bt_row = bt + (size_t)b * g.NB;
  int kt_lo, kt_hi;
  key_tiles(start, g.C, S, q0, g.window, kt_lo, kt_hi);

  const __nv_bfloat16* qb = q + b * g.q_sb + h * g.q_sh;
#pragma unroll
  for (int i = 0; i < BQ * CPR / MMA_THREADS; ++i) {
    const int idx = tid + i * MMA_THREADS;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const bool live = q0 + row < g.C;
    cp_async16(smem_u32(Qs + swz<D>(row, ch)), qb + (live ? (q0 + row) * g.q_ss + ch * 8 : 0),
               live);
  }
  if (kt_lo < kt_hi)
    load_kv_tile<D, FP8>(FP8 ? (void*)Kr : (void*)Ks, FP8 ? (void*)Vr : (void*)Vs, kc, vc, kp, vp,
                         kt_lo, S, wstart, bt_row, b, kh, g, tid);
  cp_async_commit();

  // ldmatrix row addresses (flash_mma_kernel's): lane l names row l % 16 of
  // a 16-row A tile, chunk l / 16; for K's B fragments row (l % 8) + 8 (l /
  // 16), chunk (l / 8) % 2
  const int a_row = lane & 15;
  const int a_ch = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_ch = (lane >> 3) & 1;
  const int qrow = warp * 16 + a_row;

  uint32_t qf[KSTEPS][4];  // Q's A fragments, loaded once
  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float m0 = NEG_INF, m1 = NEG_INF;  // running max (log2 units) of rows gr, gr + 8
  float l0 = 0.f, l1 = 0.f;          // this lane's part of the running sums
  const int qpos0 = start + q0 + warp * 16 + gr;
  const int tile_first = start + q0;       // the block's first query position
  const int tile_last = start + q0 + BQ - 1;

  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    const int st = (kt - kt_lo) & 1;
    if (kt + 1 < kt_hi) {  // the next tile's copy runs while this one computes
      load_kv_tile<D, FP8>(FP8 ? (void*)(Kr + (st ^ 1) * BK * D)
                               : (void*)(Ks + (st ^ 1) * BK * D),
                           FP8 ? (void*)(Vr + (st ^ 1) * BK * D)
                               : (void*)(Vs + (st ^ 1) * BK * D),
                           kc, vc, kp, vp, kt + 1, S, wstart, bt_row, b, kh, g, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (FP8) {
      widen_tile<D>(Kr + st * BK * D, Ks, e4m3 != 0, tid);
      widen_tile<D>(Vr + st * BK * D, Vs, e4m3 != 0, tid);
      __syncthreads();
    }
    if (kt == kt_lo) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(smem_u32(Qs + swz<D>(qrow, ks * 2 + a_ch)), qf[ks]);
    }
    const __nv_bfloat16* Kt = Ks + (FP8 ? 0 : st * BK * D);
    const __nv_bfloat16* Vt = Vs + (FP8 ? 0 : st * BK * D);

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

    // scale into log2 units; mask only where the tile crosses the diagonal,
    // the lower edge of the window band or the end of the row
    const int k0 = kt * BK;
    const bool need_mask = k0 + BK - 1 > tile_first || k0 + BK > S ||
                           (g.window > 0 && k0 <= tile_last - g.window);
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (need_mask) {
          const int qpos = qpos0 + (e >> 1) * 8;
          const int kpos = k0 + j * 8 + 2 * t + (e & 1);
          bool keep = kpos <= qpos && kpos < S;
          if (g.window > 0) keep = keep && kpos > qpos - g.window;
          if (!keep) x = masked(kpos, S);
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
    l0 = alpha0 * l0 + sum0;  // the unrounded f32 p
    l1 = alpha1 * l1 + sum1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      oacc[d][0] *= alpha0;
      oacc[d][1] *= alpha0;
      oacc[d][2] *= alpha1;
      oacc[d][3] *= alpha1;
    }

    // O += P.V: n-tiles 2kk, 2kk + 1 of S are the A fragment of keys
    // [16 kk, 16 kk + 16), P rounded to bf16
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
  // rows of the Q tile, then 16-byte stores of the rows inside the chunk
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  const int orow = warp * 16 + gr;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    *reinterpret_cast<uint32_t*>(Qs + swz<D>(orow, d) + 2 * t) =
        pack_bf16(oacc[d][0] * inv0, oacc[d][1] * inv0);
    *reinterpret_cast<uint32_t*>(Qs + swz<D>(orow + 8, d) + 2 * t) =
        pack_bf16(oacc[d][2] * inv1, oacc[d][3] * inv1);
  }
  __syncwarp();
  __nv_bfloat16* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int i = 0; i < 16 * CPR / 32; ++i) {
    const int idx = lane + i * 32;
    const int row = idx / CPR;
    const int ch = idx % CPR;
    const int qi = q0 + warp * 16 + row;
    if (qi < g.C)
      *reinterpret_cast<uint4*>(ob + qi * g.o_ss + ch * 8) =
          *reinterpret_cast<const uint4*>(Qs + swz<D>(warp * 16 + row, ch));
  }
}

template <int D, bool FP8>
cudaError_t launch_mma(const void* q, const void* kc, const void* vc, const void* kp,
                       const void* vp, const int* bt, const long long* starts, void* o, int B,
                       const Geo& g, int e4m3, cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) * (BQ * D + 2 * (FP8 ? 1 : 2) * BK * D) +
                      (FP8 ? 4 * BK * D : 0);
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = allow_smem(paged_prefill_mma_kernel<D, FP8>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * g.H, (g.C + BQ - 1) / BQ);
  paged_prefill_mma_kernel<D, FP8><<<grid, MMA_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(kc),
      static_cast<const uint8_t*>(vc), static_cast<const uint8_t*>(kp),
      static_cast<const uint8_t*>(vp), bt, starts, static_cast<__nv_bfloat16*>(o), g, e4m3,
      LOG2E / sqrtf((float)D));
  return cudaGetLastError();
}

// ------------------------------------------------------------------ CUDA cores

constexpr int NW = 8;         // warps per block
constexpr int RPW = BQ / NW;  // query rows per warp

__device__ __forceinline__ float to_f32(float x, bool) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x, bool) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(uint8_t x, bool e4m3) {
  return __half2float(__ushort_as_half((unsigned short)(fp8x2_to_f16x2(x, e4m3) & 0xffffu)));
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// TQ: q and out (float or bf16); TK: the pools and the chunk's k/v (float,
// bf16, or uint8_t for fp8 with the format in e4m3)
template <typename TQ, typename TK, int D>
__global__ void __launch_bounds__(NW * 32)
paged_prefill_cc_kernel(const TQ* __restrict__ q, const TK* __restrict__ kc,
                        const TK* __restrict__ vc, const TK* __restrict__ kp,
                        const TK* __restrict__ vp, const int* __restrict__ bt,
                        const long long* __restrict__ starts, TQ* __restrict__ o, Geo g,
                        int e4m3, float scale) {
  constexpr int KS = D + 1;                   // padded K row stride (floats)
  constexpr int EPL = D >= 32 ? D / 32 : 1;   // output columns per lane
  extern __shared__ float smem[];
  float* Qs = smem;                // [BQ][D]
  float* Ks = Qs + BQ * D;         // [BK][D + 1]
  float* Vs = Ks + BK * KS;        // [BK][D]
  float* Ps = Vs + BK * D;         // [NW][RPW][BK]
  long long* s_off = reinterpret_cast<long long*>(Ps + NW * RPW * BK);  // [BK]
  int* s_src = reinterpret_cast<int*>(s_off + BK);  // [BK]: 0 past S, 1 chunk, 2 pool

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int b = blockIdx.y / g.H;
  const int h = blockIdx.y - b * g.H;
  const int kh = h / (g.H / g.KH);
  const int q0 = blockIdx.x * BQ;
  const int S = g.NB * g.page;
  const int start = (int)starts[b];
  const int wstart = min(start, S - g.C);
  const int* bt_row = bt + (size_t)b * g.NB;
  const bool fmt = e4m3 != 0;

  const TQ* qb = q + b * g.q_sb + h * g.q_sh;
  for (int i = tid; i < BQ * D; i += NW * 32) {
    const int r = i / D;
    const int d = i - r * D;
    Qs[i] = q0 + r < g.C ? to_f32(qb[(q0 + r) * g.q_ss + d], false) : 0.f;
  }

  float m[RPW], l[RPW], acc[RPW][EPL];
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    m[r] = NEG_INF;
    l[r] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[r][e] = 0.f;
  }
  int kt_lo, kt_hi;
  key_tiles(start, g.C, S, q0, g.window, kt_lo, kt_hi);

  float* prow = Ps + warp * RPW * BK;
  for (int kt = kt_lo; kt < kt_hi; ++kt) {
    __syncthreads();  // previous tile's K/V/P reads are done
    if (tid < BK) {
      const int p = kt * BK + tid;
      bool in_chunk = false;
      s_off[tid] = p < S ? key_row(p, wstart, bt_row, b, kh, D, g, in_chunk) : 0;
      s_src[tid] = p >= S ? 0 : in_chunk ? 1 : 2;
    }
    __syncthreads();
    for (int i = tid; i < BK * D; i += NW * 32) {
      const int j = i / D;
      const int d = i - j * D;
      const int src = s_src[j];
      float kv = 0.f, vv = 0.f;
      if (src) {
        const TK* kb = src == 1 ? kc : kp;
        const TK* vb = src == 1 ? vc : vp;
        kv = to_f32(kb[s_off[j] + d], fmt);
        vv = to_f32(vb[s_off[j] + d], fmt);
      }
      Ks[j * KS + d] = kv;
      Vs[i] = vv;
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
      const int qpos = start + q0 + warp * RPW + r;
      float val[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kpos = kt * BK + lane + 32 * c;
        bool keep = kpos <= qpos && kpos < S;
        if (g.window > 0) keep = keep && kpos > qpos - g.window;
        val[c] = keep ? s[r][c] * scale : masked(kpos, S);
      }
      float mx = fmaxf(val[0], val[1]);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      const float p0 = expf(val[0] - m_new);
      const float p1 = expf(val[1] - m_new);
      const float alpha = expf(m[r] - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[r] = alpha * l[r] + sum;
      m[r] = m_new;
      prow[r * BK + lane] = p0;
      prow[r * BK + lane + 32] = p1;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[r][e] *= alpha;
    }
    __syncwarp();

    // acc[r][:] += P[r][:] . V, lane owns columns lane + 32 e (D 16: lanes
    // past 16 own none)
    const int col0 = D >= 32 ? lane : min(lane, D - 1);
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      float vv[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vv[e] = Vs[j * D + col0 + 32 * e];
#pragma unroll
      for (int r = 0; r < RPW; ++r) {
        const float p = prow[r * BK + j];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[r][e] = fmaf(p, vv[e], acc[r][e]);
      }
    }
  }

  TQ* ob = o + b * g.o_sb + h * g.o_sh;
#pragma unroll
  for (int r = 0; r < RPW; ++r) {
    const int qi = q0 + warp * RPW + r;
    if (qi >= g.C || (D < 32 && lane >= D)) continue;
    const float inv = 1.f / fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int e = 0; e < EPL; ++e) store(ob + qi * g.o_ss + lane + 32 * e, acc[r][e] * inv);
  }
}

template <typename TQ, typename TK, int D>
cudaError_t launch_cc(const void* q, const void* kc, const void* vc, const void* kp,
                      const void* vp, const int* bt, const long long* starts, void* o, int B,
                      const Geo& g, int e4m3, cudaStream_t stream) {
  const size_t smem = sizeof(float) * (BQ * D + BK * (D + 1) + BK * D + NW * RPW * BK) +
                      BK * (sizeof(long long) + sizeof(int));
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err = allow_smem(paged_prefill_cc_kernel<TQ, TK, D>, smem, smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid((g.C + BQ - 1) / BQ, B * g.H);
  paged_prefill_cc_kernel<TQ, TK, D><<<grid, NW * 32, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TK*>(kc), static_cast<const TK*>(vc),
      static_cast<const TK*>(kp), static_cast<const TK*>(vp), bt, starts, static_cast<TQ*>(o),
      g, e4m3, 1.0f / sqrtf((float)D));
  return cudaGetLastError();
}

template <typename TQ, typename TK>
cudaError_t dispatch_cc(int D, const void* q, const void* kc, const void* vc, const void* kp,
                        const void* vp, const int* bt, const long long* starts, void* o, int B,
                        const Geo& g, int e4m3, cudaStream_t s) {
  switch (D) {
    case 16: return launch_cc<TQ, TK, 16>(q, kc, vc, kp, vp, bt, starts, o, B, g, e4m3, s);
    case 32: return launch_cc<TQ, TK, 32>(q, kc, vc, kp, vp, bt, starts, o, B, g, e4m3, s);
    case 64: return launch_cc<TQ, TK, 64>(q, kc, vc, kp, vp, bt, starts, o, B, g, e4m3, s);
    case 128: return launch_cc<TQ, TK, 128>(q, kc, vc, kp, vp, bt, starts, o, B, g, e4m3, s);
    case 256: return launch_cc<TQ, TK, 256>(q, kc, vc, kp, vp, bt, starts, o, B, g, e4m3, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mma: the tensor-core kernel (bf16 q at D 64 / 128); dtype: q's, 0 = f32,
// 1 = bf16; kfmt: the pools' (and the chunk's k/v) format, 0 f32, 1 bf16,
// 2 e4m3, 3 e5m2; P: the pages a block-table entry is clamped into (a page
// pool's pages before its dump page; every slot row of the legacy slot
// cache, read as pages of S keys); window <= 0: none.  The strides are in
// elements.  Returns a cudaError_t (0 = success); shapes are
// validated by the caller.
extern "C" int dabt_paged_prefill(const void* q, const void* k_chunk, const void* v_chunk,
                                  const void* k_pool, const void* v_pool, const void* block_tables,
                                  const void* starts, void* out, int mma, int dtype, int kfmt,
                                  int B, int H, int KH, int C, int P, int page, int NB, int D,
                                  int window, long long q_sb, long long q_sh, long long q_ss,
                                  long long c_sb, long long c_sh, long long c_ss, long long o_sb,
                                  long long o_sh, long long o_ss, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (KH <= 0 || H % KH != 0 || C < 1 || P < 1 || C > NB * page) return (int)cudaErrorInvalidValue;
  const Geo g{H, KH, C, P, page, NB, window, q_sb, q_sh, q_ss, c_sb, c_sh, c_ss, o_sb, o_sh, o_ss};
  const int* bt = static_cast<const int*>(block_tables);
  const long long* st = static_cast<const long long*>(starts);
  const int e4m3 = kfmt == KV_E4M3;
  const bool fp8 = kfmt == KV_E4M3 || kfmt == KV_E5M2;
  if (mma) {
    if (dtype != 1 || !(kfmt == KV_BF16 || fp8)) return (int)cudaErrorInvalidValue;
    if (D == 64 && !fp8)
      return (int)launch_mma<64, false>(q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, 0, s);
    if (D == 128 && !fp8)
      return (int)launch_mma<128, false>(q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, 0, s);
    if (D == 64)
      return (int)launch_mma<64, true>(q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, e4m3, s);
    if (D == 128)
      return (int)launch_mma<128, true>(q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, e4m3, s);
    return (int)cudaErrorInvalidValue;
  }
  if (dtype == 0 && kfmt == KV_F32)
    return (int)dispatch_cc<float, float>(D, q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, 0, s);
  if (dtype == 0 && kfmt == KV_BF16)
    return (int)dispatch_cc<float, __nv_bfloat16>(D, q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, 0, s);
  if (dtype == 0 && fp8)
    return (int)dispatch_cc<float, uint8_t>(D, q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, e4m3, s);
  if (dtype == 1 && kfmt == KV_BF16)
    return (int)dispatch_cc<__nv_bfloat16, __nv_bfloat16>(D, q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, 0, s);
  if (dtype == 1 && fp8)
    return (int)dispatch_cc<__nv_bfloat16, uint8_t>(D, q, k_chunk, v_chunk, k_pool, v_pool, bt, st, out, B, g, e4m3, s);
  return (int)cudaErrorInvalidValue;
}
