// Paged tree attention for Hopper (sm_90a): the speculative verify forward's
// read.  Every node of a speculation tree attends to its slot's verified
// prefix in the page pool, read in place through the block table, plus its
// own root-path ancestors among the tree's freshly projected keys.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py `paged_tree_attention`
// (:328-424), an XLA fori_loop over logical blocks (:401) followed by one
// ancestor-masked tree chunk in the JAX package.  Computes what
// `ops/attention.py` `paged_tree_attention_plain` (the port's twin of that
// function) computes, for trees of any size.
//
// Layouts: q, out are [B, H, T, D]; k_pool, v_pool are [P, KH, page, D];
// block_tables [B, NB] int32 (entries >= P are unallocated and clamp to
// page P - 1, as the JAX code clamps); lengths [B] int32, the verified
// prefix of each row (keys at positions < lengths); tree_k, tree_v
// [B, KH, T, D]; anc [T, T] bool (anc[t, u]: node u is an ancestor of node
// t, or t itself); depths [T] int32.  Node t of row b sits at position
// qpos = lengths[b] + depths[t]; with a window, prefix key kpos is kept iff
// kpos > qpos - window, tree key u iff lengths[b] + depths[u] > qpos -
// window.  The G = H / KH query heads of a KV head and the T nodes make
// G * T query rows per (slot, KV head), row r = g * T + t, contiguous in q.
//
// What bounds it on the H100: each key is read once for G * T query rows
// (68 at Llama-3-8B's G = 4 and a 17-node tree), about 4 G T operations per
// 4 D bytes of K and V: 68 operations a byte, below the card's ~295, so the
// live K/V bytes over the 3.35 TB/s of HBM bound it (0.0133 ms for 10,208
// live keys of Llama-3-8B at 8 KV heads and D = 128).
//
// Masked keys weigh exactly 0 (never the JAX code's finite -1e30: a state
// that has seen no live key keeps m = -inf and weighs 0 in every merge).
// The JAX loop's masked keys contribute exactly 0 once a live key arrives,
// and every node has one (it attends to itself), so the two agree.  A row
// with lengths == 0 reads no page; its nodes attend to their ancestors in
// the tree only.
//
// Pools of another type than q (bf16 under f32 q, or fp8 e4m3fn / e5m2: the
// engine's kv_cache_dtype) are read as the JAX function reads them (:377-
// 393): each value widened exactly to q's type.
//
// Numerics: the probabilities are rounded to q's type before P.V, as the
// JAX function does (`p.astype(v_blk.dtype)` on values in q's type, :391,
// :420), while the normaliser l sums the unrounded f32 p.
//
// * bf16 at D = 64 and 128 with every tensor on a 16-byte boundary (Llama;
//   the serving path): `paged_tree_mma_kernel`.  Four limits of the first
//   design (a fixed split of each row into equal runs of its own tiles, a
//   two-stage `cp.async` buffer, `mma.sync` at 213 registers, a [64][64]
//   mask tile), and what this one does about each (the probes named below
//   are tools/paged_tree_ab.py's, on an H100 SXM):
//   1. The split ignored lengths: a 4,096-key row's blocks walked 13 tiles
//      while a 6-key row's walked one or none.  Here, as in
//      `paged_decode.cu`, the work is cut into equal items and a persistent
//      grid takes an equal contiguous run of them each.  An item is a chunk
//      of up to BK = 64 prefix keys of one (slot, KV head, row chunk) row,
//      ending early where a page ends or the row's keys do, or a tile of TT
//      = 32 of the row's tree nodes (its ceil(T / 32) tiles come after its
//      chunks).  The grid (one block an SM, fewer for shapes with few
//      items) and the least items a block takes come from the host's plan
//      (kernels.paged_tree_plan: shapes and the SM count, no read of
//      lengths, so a CUDA graph captures the launch); every block finds its
//      items on the device from a prefix sum of each slot's items (lengths
//      and window), and blocks past the items' need exit at once.
//   2. Too little in flight: one tile loaded while one computed, each
//      16-byte chunk's page address divided out by every thread.  Here
//      every item is copied by TMA (`cp.async.bulk.tensor`, completing on
//      its stage's mbarrier) into a ring of STAGES stages, issued by thread
//      0 (the producer) STAGES - 1 items ahead of the one the warps
//      compute.  A prefix chunk of one KV head inside one page is a
//      contiguous [rows, D] box of the pool seen as a 3-D tensor [P * KH,
//      page, D]; a tree tile a [32, D] box of the tree's K / V as [B * KH,
//      T, D]; rows past a page or past T read as zeros.  The 128-byte TMA
//      swizzle is what the wgmma descriptors read (tile_off gives the
//      layout to the few generic writes).  V rows of prefix keys the row
//      does not read (before the window, at or past its length) are zeroed
//      in shared memory before P.V (stale pool values could be inf or NaN,
//      and 0 x inf is NaN), K rows are masked.  The tensor maps are encoded
//      on the host and cached under (pointer, shape) (cached_map): an
//      engine's pools live as long as it does and are cleared in place on a
//      restart, so every launch and graph capture copies maps encoded once,
//      and a replay reads the pools the capture saw.  What the loop needs
//      besides the copies is read before the first copy is issued (lengths;
//      the block tables; the tree's mask as bits, the window folded in; the
//      first run's query rows); later runs' query rows are asked of L1
//      STAGES items early.  A load behind the SM's copies waited
//      microseconds.  The block's threads locate its items in parallel, 512
//      ahead (DESC_MAX; the producer only reads them).
//      FP8 pools land as they lie in the pool (D bytes a key, unswizzled) in
//      a ring of 6 raw stages and are widened exactly to bf16 into one
//      swizzled tile pair that the products read; a tree tile (bf16, 32
//      nodes) fills a raw stage and is read in place.  bf16: 4 stages of 32
//      KB at D = 128.  The ring's depth moved nothing measurable (the
//      `shallow` / `deep` probes: 3 to 6 stages within 4%).
//   3. Products: `wgmma` (m64nNk16, bf16 in, f32 accumulators), a
//      warpgroup per 64 query rows of the row chunk, A (the query rows, P)
//      from registers in mma.sync's fragment layout, K (K-major) and V
//      (MN-major) from the tile by descriptor.  `mma.sync` with 16 rows a
//      warp was latency-bound (8 dependent products per score fragment,
//      and spills at two blocks an SM).  The score masks are bit tests on
//      64-bit masks made once an item (a chain of compares per score cost
//      ~30 us of a 73 us call, probe `no_mask`).  The online softmax runs on
//      the accumulator fragments in log2 units; P is packed to bf16
//      straight into the A fragments of P.V (the JAX function's rounding).
//      Two warpgroups a block (up to 128 query rows; more go to further row
//      chunks, each its own row of items) at up to 255 registers: one block
//      an SM.
//   4. Scratch and trees: a run of items that is a whole row writes the
//      normalised output at once.  Only a block's first and last runs can be
//      parts of a row, so at most two (acc, m, l) f32 partials a block go to
//      scratch, for the row chunk's live query rows only, and blocks with no
//      items write none.  The block's run count goes onto the row's counter
//      (after `__threadfence()`); the block that completes it merges the
//      row's partials in item order once its own items are done (a batch of
//      D / 4 runs' maxima and sums in one round of loads, then the
//      accumulators, four runs' loads in flight), writes the output and
//      resets the counter.  These merges, at the grid's tail, are the
//      largest single cost left (~18 us of a ~58 us call at 10,208 live
//      keys, probe `no_merge`); bulk-copying the partials into shared
//      memory instead was slower.  The partition and the merge order depend
//      on the inputs alone, so equal inputs give bitwise-equal outputs.  The
//      tree is walked in 32-node tiles under the ancestor mask: any T.
//
// * f32 (tight checks), other head dims, or inputs off 16-byte boundaries:
//   `paged_tree_cc_kernel`, CUDA cores, one warp per query row: 32 keys at a
//   time, a lane a key for the scores and the online softmax, each lane
//   holding D / 32 output columns for P.V.  Prefix keys in order, then the
//   tree, 32 nodes a step.  No split, no scratch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

#include "hopper_tma.cuh"

namespace {

constexpr int BK = 64;          // keys per prefix chunk (an item of the mma kernel)
constexpr int TT = 32;          // tree nodes per tree tile (an item of the mma kernel)
constexpr int MAX_WARPS = 8;    // mma kernel: two warpgroups of 64 query rows per block
constexpr int BLOCKS_PER_SM = 1;  // mma kernel (kernels.PAGED_TREE_BLOCKS_PER_SM)
constexpr int CC_WARPS = 4;     // CUDA-core kernel: warps (query rows) per block
constexpr float LOG2E = 1.4426950408889634f;
// page-pool storage formats (kernels._KV_CODE)
constexpr int KV_F32 = 0, KV_BF16 = 1, KV_E4M3 = 2, KV_E5M2 = 3;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x as q's type holds it: the JAX function's p.astype(v.dtype), v being a
// page widened to q's type or the tree's own values
__device__ __forceinline__ float round_as(float x, const float*) { return x; }
__device__ __forceinline__ float round_as(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}

// two fp8 values (the first in the low byte) -> f16x2, exactly: every e4m3
// and e5m2 value is an f16 value.  Both conversions and a select (each one
// instruction on sm_89+), so the format is a runtime value with no branch.
__device__ __forceinline__ uint32_t fp8x2_to_f16x2(uint32_t x, bool e4m3) {
  const unsigned short v = (unsigned short)(x & 0xffffu);
  uint32_t a, b;
  asm("cvt.rn.f16x2.e4m3x2 %0, %1;\n" : "=r"(a) : "h"(v));
  asm("cvt.rn.f16x2.e5m2x2 %0, %1;\n" : "=r"(b) : "h"(v));
  return e4m3 ? a : b;
}

// pool value i as f32, in the pool's storage format (exact for each)
__device__ __forceinline__ float pool_val(const void* pool, size_t i, int fmt) {
  if (fmt == KV_F32) return static_cast<const float*>(pool)[i];
  if (fmt == KV_BF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(pool)[i]);
  const uint32_t h = fp8x2_to_f16x2(static_cast<const uint8_t*>(pool)[i], fmt == KV_E4M3);
  return __half2float(__ushort_as_half((unsigned short)(h & 0xffffu)));
}

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

// the row's key range [klo, klen): below the verified length (and inside the
// logical row), above the window's lower edge for the root (the lowest qpos)
__device__ __forceinline__ void key_range(int len, int NB, int page, int window, int& klo,
                                          int& klen) {
  klen = min(max(len, 0), NB * page);
  klo = window > 0 ? min(max(len - window + 1, 0), klen) : 0;
}

// element offset of key kpos's row in a pool, through the block table
__device__ __forceinline__ size_t pool_row(const int* bt_row, int kpos, int kh, int KH, int P,
                                           int page, int D) {
  const int phys = min(max(bt_row[kpos / page], 0), P - 1);
  return (((size_t)phys * KH + kh) * page + kpos % page) * D;
}

// ------------------------------------------------------------------ f32, CUDA cores

// (pools in format kfmt: q's type, bf16 under f32 q, or fp8; the tree's
// own K/V in q's type)
template <typename T, int D>
__global__ void __launch_bounds__(CC_WARPS * 32)
paged_tree_cc_kernel(const T* __restrict__ q, const void* __restrict__ k_pool,
                     const void* __restrict__ v_pool, const int* __restrict__ block_tables,
                     const int* __restrict__ lengths, const T* __restrict__ tree_k,
                     const T* __restrict__ tree_v, const uint8_t* __restrict__ anc,
                     const int* __restrict__ depths, T* __restrict__ out, int H, int KH,
                     int T_, int P, int page, int NB, int window, float scale, int kfmt) {
  constexpr int EPL = D >= 32 ? D / 32 : 1;  // output columns per lane
  constexpr int LANES = D >= 32 ? 32 : D;    // lanes holding columns
  __shared__ float s_q[CC_WARPS][D];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int bk = blockIdx.x;
  const int b = bk / KH;
  const int kh = bk - b * KH;
  const int R = (H / KH) * T_;
  const int r = blockIdx.y * CC_WARPS + warp;
  if (r >= R) return;  // no block-wide barrier below
  const T* qr = q + ((size_t)bk * R + r) * D;
  for (int d = lane; d < D; d += 32) s_q[warp][d] = to_f32(qr[d]);
  __syncwarp();
  const int len = lengths[b];
  const int t_row = r % T_;
  const int qpos = len + depths[t_row];
  int klo, klen;
  key_range(len, NB, page, window, klo, klen);
  const int* bt_row = block_tables + (size_t)b * NB;

  float m = -INFINITY, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;

  // one online-softmax step over 32 keys: lane j scores key j (s, keep);
  // my_row is the element offset of this lane's key's V row, in the pool
  // (prefix) or in the tree's V
  auto step = [&](float s, bool keep, bool prefix, size_t my_row) {
    const float mx = warp_max(keep ? s : -INFINITY);
    const float m_new = fmaxf(m, mx);
    const float mref = m_new == -INFINITY ? 0.f : m_new;
    const float p = keep ? expf(s - mref) : 0.f;
    const float alpha = m == -INFINITY ? 0.f : expf(m - mref);
    l = alpha * l + warp_sum(p);
    m = m_new;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= alpha;
    const unsigned live = __ballot_sync(0xffffffffu, keep);
    for (int j = 0; j < 32; ++j) {
      const float pj = round_as(__shfl_sync(0xffffffffu, p, j), q);
      const unsigned long long rj = __shfl_sync(0xffffffffu, (unsigned long long)my_row, j);
      if (!((live >> j) & 1u)) continue;
      if (lane < LANES) {
#pragma unroll
        for (int e = 0; e < EPL; ++e) {
          const size_t vi = rj + lane + 32 * e;
          acc[e] = fmaf(pj, prefix ? pool_val(v_pool, vi, kfmt) : to_f32(tree_v[vi]), acc[e]);
        }
      }
    }
  };

  for (int kbase = klo; kbase < klen; kbase += 32) {
    const int kpos = kbase + lane;
    bool keep = kpos < klen && (window <= 0 || kpos > qpos - window);
    float s = 0.f;
    size_t row = 0;
    if (keep) {
      row = pool_row(bt_row, kpos, kh, KH, P, page, D);
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(s_q[warp][d], pool_val(k_pool, row + d, kfmt), s);
      s *= scale;
    }
    step(s, keep, true, row);
  }
  // the tree: 32 nodes a step under the ancestor mask
  for (int ubase = 0; ubase < T_; ubase += 32) {
    const int u = ubase + lane;
    bool keep = u < T_ && anc[t_row * T_ + u] != 0;
    if (keep && window > 0) keep = len + depths[u] > qpos - window;
    float s = 0.f;
    const size_t row = ((size_t)bk * T_ + (keep ? u : 0)) * D;
    if (keep) {
      const T* kr = tree_k + row;
#pragma unroll 8
      for (int d = 0; d < D; ++d) s = fmaf(s_q[warp][d], to_f32(kr[d]), s);
      s *= scale;
    }
    step(s, keep, false, row);
  }
  const float inv = 1.f / fmaxf(l, 1e-30f);
  T* orow = out + ((size_t)bk * R + r) * D;
  if (lane < LANES) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) store(orow + lane + 32 * e, acc[e] * inv);
  }
}

template <typename T, int D>
cudaError_t launch_cc(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                      const int* lengths, const void* tree_k, const void* tree_v,
                      const uint8_t* anc, const int* depths, void* out, int B, int H, int KH,
                      int T_, int P, int page, int NB, int window, int kfmt,
                      cudaStream_t stream) {
  const int R = (H / KH) * T_;
  dim3 grid(B * KH, (R + CC_WARPS - 1) / CC_WARPS);
  paged_tree_cc_kernel<T, D><<<grid, CC_WARPS * 32, 0, stream>>>(
      static_cast<const T*>(q), k_pool, v_pool, bt, lengths, static_cast<const T*>(tree_k),
      static_cast<const T*>(tree_v), anc, depths, static_cast<T*>(out), H, KH, T_, P, page, NB,
      window, 1.0f / sqrtf((float)D), kfmt);
  return cudaGetLastError();
}


// ------------------------------------------------------------------ bf16, tensor cores

// this thread's generic-proxy writes to shared memory, ordered before later
// TMA (async-proxy) writes to the same bytes
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// a 3-D TMA box (coordinates innermost first) into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma with A (the query rows, or P) in registers, in mma.sync's A
// fragment layout, B from shared memory by descriptor; d[4 j + r] is row
// 16 warp + lane / 4 + 8 (r >> 1), column 8 j + 2 (lane % 4) + (r & 1).
// S[64 x 32] (+)= Q[64 x 16] . K^T: K K-major (a tree tile's 32 keys)
__device__ __forceinline__ void wgmma_qk32(float (&d)[16], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// S[64 x 64] (+)= Q[64 x 16] . K^T: K K-major (a prefix chunk's 64 keys)
__device__ __forceinline__ void wgmma_qk64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// O[64 x 64] (+)= P[64 x 16] . V: V MN-major (D = 64)
__device__ __forceinline__ void wgmma_pv64(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}
// O[64 x 128] (+)= P[64 x 16] . V: V MN-major (D = 128)
__device__ __forceinline__ void wgmma_pv128(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                       int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// 2^x on the special-function unit (2^-inf = +0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two fp8 values (the first in the low byte) -> bf16x2, exactly
__device__ __forceinline__ uint32_t widen_fp8x2(uint32_t x, bool e4m3) {
  const uint32_t h = fp8x2_to_f16x2(x, e4m3);
  return pack_bf16(__half2float(__ushort_as_half((unsigned short)(h & 0xffffu))),
                   __half2float(__ushort_as_half((unsigned short)(h >> 16))));
}

// Element offset of (row, 16-byte chunk) in a bf16 [rows][D] tile as the
// TMA 128-byte swizzle lays it out: D / 64 boxes of [rows][64] (128-byte
// rows, each box 1,024-byte aligned, `box` elements apart), chunk c of a
// row at c XOR row % 8 in its box.
template <int D>
__device__ __forceinline__ int tile_off(int row, int chunk, int box) {
  return (chunk >> 3) * box + row * 64 + (((chunk & 7) ^ (row & 7)) << 3);
}

// the row's prefix keys [klo, klen) and their chunks [c0, c0 + npre), in the
// numbering chunk(k) = (k / page) * cpp + (k % page) / BK
struct Keys {
  int klo, klen, c0, npre;
};

__device__ __forceinline__ int chunk_of(int k, int page, int cpp) {
  return (k / page) * cpp + (k % page) / BK;
}

__device__ __forceinline__ Keys row_keys(int len, int NB, int page, int window, int cpp) {
  Keys r;
  key_range(len, NB, page, window, r.klo, r.klen);
  r.c0 = 0;
  r.npre = 0;
  if (r.klen > r.klo) {
    r.c0 = chunk_of(r.klo, page, cpp);
    r.npre = chunk_of(r.klen - 1, page, cpp) - r.c0 + 1;
  }
  return r;
}

// the launch's arguments (a kernel parameter: the tensor maps must be)
struct TreeArgs {
  CUtensorMap kmap, vmap;    // the pools as [P * KH, page, D] (pool_map)
  CUtensorMap tkmap, tvmap;  // the tree's K / V as bf16 [B * KH, T, D]
  const __nv_bfloat16* q;
  const int* block_tables;
  const int* lengths;
  const uint8_t* anc;
  const int* depths;
  __nv_bfloat16* out;
  float* part_m;    // [2 gridDim.x][16 W] running maxima (log2 units)
  float* part_l;    // [2 gridDim.x][16 W] sums
  float* part_acc;  // [2 gridDim.x][16 W][D] accumulators
  int* counters;    // [B KH RC] items done per row, zero between calls
  int B, H, KH, T, P, page, NB, window, kfmt, min_items, box_rows;
  float scale_log2;
};

// One work item.  Rows (slot b, KV head kh, row chunk rc) are numbered b
// major, then kh, then rc; a row's items are its prefix chunks in order,
// then its tree tiles of TT nodes.  s_items[b] is the number of items of the
// slots before b, s_len[b] slot b's length.
struct Item {
  int b, kh, rc, row;  // row = (b KH + kh) RC + rc
  int c, n, first;     // item of the row, items in the row, the row's first item
  Keys keys;
  bool tree;
  int tt;              // tree: the tile (nodes [TT tt, TT tt + TT))
  int pi, off, kfirst; // prefix: logical page, offset in it, the first key's position
};

__device__ __forceinline__ Item locate(int i, const int* s_items, const int* s_len,
                                       const TreeArgs& a, int RC, int cpp, int ntt) {
  int lo = 0, hi = a.B;  // the slot b with s_items[b] <= i < s_items[b + 1]
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (s_items[mid] <= i) lo = mid; else hi = mid;
  }
  Item it;
  it.b = lo;
  it.keys = row_keys(s_len[lo], a.NB, a.page, a.window, cpp);
  it.n = it.keys.npre + ntt;
  const int local = i - s_items[lo];
  const int rr = local / it.n;
  it.c = local - rr * it.n;
  it.kh = rr / RC;
  it.rc = rr - it.kh * RC;
  it.row = lo * a.KH * RC + rr;
  it.first = i - it.c;
  it.tree = it.c >= it.keys.npre;
  it.tt = it.c - it.keys.npre;
  const int j = it.keys.c0 + it.c;
  it.pi = j / cpp;
  it.off = (j - it.pi * cpp) * BK;
  it.kfirst = it.pi * a.page + it.off;
  return it;
}

// An item as the block's threads locate it for its loop (shared memory)
struct ItemS {
  int b, kh, rc, row;   // slot, KV head, row chunk, (b KH + kh) RC + rc
  int first, n, c;      // the row's first item, its items, this one's place in it
  int tree, tt;         // a tree tile, and which
  int kfirst, off;      // prefix: the first key's position, its offset in the page
  int klo, klen;        // the row's prefix keys [klo, klen)
  int blk;              // prefix: the block-table entry of its page
};

// an Item as ItemS (its block-table entry set apart)
__device__ __forceinline__ void to_desc(ItemS& d, const Item& it) {
  d.b = it.b;
  d.kh = it.kh;
  d.rc = it.rc;
  d.row = it.row;
  d.first = it.first;
  d.n = it.n;
  d.c = it.c;
  d.tree = it.tree;
  d.tt = it.tt;
  d.kfirst = it.kfirst;
  d.off = it.off;
  d.klo = it.keys.klo;
  d.klen = it.keys.klen;
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

// fp8 pools: a landed raw tile (D bytes a key, unswizzled) widened exactly to
// bf16 into the swizzled tile the products read; rows outside [lo, hi) (keys
// the row does not read) are written as zeros
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, __nv_bfloat16* dst, bool kind,
                                           int lo, int hi, int tid, int nthreads) {
  constexpr int CPR = D / 16;
  for (int idx = tid; idx < BK * CPR; idx += nthreads) {
    const int row = idx / CPR;
    const int ch = idx - row * CPR;
    uint4 r = make_uint4(0, 0, 0, 0);
    if (row >= lo && row < hi) r = *reinterpret_cast<const uint4*>(raw + row * D + ch * 16);
    *reinterpret_cast<uint4*>(dst + tile_off<D>(row, 2 * ch, BK * 64)) =
        make_uint4(widen_fp8x2(r.x, kind), widen_fp8x2(r.x >> 16, kind),
                   widen_fp8x2(r.y, kind), widen_fp8x2(r.y >> 16, kind));
    *reinterpret_cast<uint4*>(dst + tile_off<D>(row, 2 * ch + 1, BK * 64)) =
        make_uint4(widen_fp8x2(r.z, kind), widen_fp8x2(r.z >> 16, kind),
                   widen_fp8x2(r.w, kind), widen_fp8x2(r.w >> 16, kind));
  }
}

// rows outside [lo, hi) of a swizzled bf16 [BK][D] tile set to zero
template <int D>
__device__ __forceinline__ void zero_rows(__nv_bfloat16* tile, int lo, int hi, int tid,
                                          int nthreads) {
  constexpr int CPR = D / 8;
  for (int idx = tid; idx < BK * CPR; idx += nthreads) {
    const int row = idx / CPR;
    if (row < lo || row >= hi)
      *reinterpret_cast<uint4*>(tile + tile_off<D>(row, idx - row * CPR, BK * 64)) =
          make_uint4(0, 0, 0, 0);
  }
}

// bits [lo, hi) of 64 (lo, hi clamped to [0, 64])
__device__ __forceinline__ uint64_t key_bits(int lo, int hi) {
  lo = min(max(lo, 0), 64);
  hi = min(max(hi, 0), 64);
  if (lo >= hi) return 0;
  const uint64_t below_hi = hi == 64 ? ~0ull : (1ull << hi) - 1;
  return below_hi & ~((1ull << lo) - 1);
}

__host__ __device__ constexpr int ring_stages(bool fp8) { return fp8 ? 6 : 4; }

// the ancestor mask as bits (word w of node t: nodes [32 w, 32 w + 32)) and
// the depths go to shared memory for trees of up to ANC_SMEM_T nodes; larger
// ones are read from global memory
constexpr int ANC_SMEM_T = 256;

// the block tables go to shared memory when they hold at most this many
// entries (else each item's entry is read from global memory)
constexpr int BT_SMEM = 4096;

// the ring of a block's located items (see the kernel)
constexpr int DESC_MAX = 512;

__host__ __device__ inline int anc_words(int T) {
  return T <= ANC_SMEM_T ? T * ((T + TT - 1) / TT) : 0;
}

// shared memory of paged_tree_mma_kernel<D, FP8> for B slots and a T-node
// tree: 1,024 bytes of alignment slack, the ring (K then V each stage),
// FP8's widened tile pair, the stages' mbarriers, the slots' item prefix and
// lengths, the tree's mask bits and depths
template <int D, bool FP8>
size_t mma_smem(int B, int T) {
  const size_t tile = (FP8 ? 1 : 2) * (size_t)BK * D;
  return 1024 + ring_stages(FP8) * 2 * tile + (FP8 ? 2 * 2 * (size_t)BK * D : 0) +
         8 * ring_stages(FP8) + sizeof(int) * (2 * B + 1) +
         sizeof(int) * (anc_words(T) + (anc_words(T) ? T : 0)) + sizeof(int) * BT_SMEM +
         sizeof(ItemS) * DESC_MAX;
}

template <int D, bool FP8>
__global__ void __launch_bounds__(MAX_WARPS * 32, BLOCKS_PER_SM)
paged_tree_mma_kernel(const __grid_constant__ TreeArgs a) {
  constexpr int STAGES = ring_stages(FP8);
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q.K^T
  constexpr int DT = D / 8;       // 8-column n-tiles of O
  constexpr int TILE = BK * D;    // elements of a bf16 [BK][D] tile
  constexpr int RAW = (FP8 ? 1 : 2) * TILE;  // bytes of a K or V tile in the ring
  constexpr int NBOX = D / 64;    // 64-column TMA boxes of a bf16 tile
  constexpr int RUNB = D / 4;     // runs a merge batch takes
  constexpr int NP = D / 4;       // merge: output pairs a thread (16 W rows x D / 2 over 32 W)
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  __nv_bfloat16* Kw = reinterpret_cast<__nv_bfloat16*>(ring + STAGES * 2 * RAW);  // FP8 pair
  __nv_bfloat16* Vw = Kw + TILE;
  uint64_t* full = reinterpret_cast<uint64_t*>(Kw + (FP8 ? 2 * TILE : 0));  // [STAGES]
  int* s_items = reinterpret_cast<int*>(full + STAGES);                      // [B + 1]
  int* s_len = s_items + a.B + 1;                                            // [B]
  uint32_t* s_anc = reinterpret_cast<uint32_t*>(s_len + a.B);  // [T][ceil(T / TT)] or none
  int* s_dep = reinterpret_cast<int*>(s_anc + anc_words(a.T));  // [T] with the bits
  int* s_bt = s_dep + (anc_words(a.T) ? a.T : 0);  // [BT_SMEM] the block tables
  ItemS* s_desc = reinterpret_cast<ItemS*>(s_bt + BT_SMEM);  // [DESC_MAX] the ring of items
  __shared__ int s_last;
  // the rows whose counts this block completes (at most its first and last
  // runs'): first item, items, counter, first query row, (slot, KV head)
  __shared__ int s_pend[2][5];

  const int tid = threadIdx.x;
  const int nthreads = blockDim.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g, g + 8 of the warp's 16
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each 8
  const int RB = nthreads >> 1;  // query rows of a row chunk: 16 a warp
  const int R = (a.H / a.KH) * a.T;
  const int RC = (R + RB - 1) / RB;
  const int cpp = (a.page + BK - 1) / BK;  // chunks per page
  const int ntt = (a.T + TT - 1) / TT;     // tree tiles per row
  const int anc_w = ntt;                   // mask words a node
  const bool anc_smem = anc_words(a.T) > 0;
  const bool kind = a.kfmt == KV_E4M3;     // else e5m2 (FP8)

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) mbar_init(full + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // items per slot, then their prefix sum (warp 0, 32 slots at a time)
  if (warp == 0) {
    int carry = 0;
    if (lane == 0) s_items[0] = 0;
    for (int base = 0; base < a.B; base += 32) {
      const int b = base + lane;
      const int len = b < a.B ? __ldg(a.lengths + b) : 0;
      int n = b < a.B ? a.KH * RC * (row_keys(len, a.NB, a.page, a.window, cpp).npre + ntt) : 0;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, n, o);
        if (lane >= o) n += up;
      }
      if (b < a.B) {
        s_items[b + 1] = carry + n;
        s_len[b] = len;
      }
      carry += __shfl_sync(0xffffffffu, n, 31);
    }
  }
  // the tree's mask as bits (node u kept by node t: an ancestor, or t, and
  // with a window, lengths + depths[u] > lengths + depths[t] - window), its
  // depths, and the block tables where they are small, all read in this one
  // round (before any copy is in flight: a read in the loop waits behind the
  // SM's streaming copies, several microseconds)
  if (anc_smem) {
    for (int u = tid; u < a.T; u += nthreads) s_dep[u] = __ldg(a.depths + u);
    for (int w = tid; w < a.T * anc_w; w += nthreads) {
      const int node = w / anc_w;
      const int u0 = (w - node * anc_w) * TT;
      const int low = a.window > 0 ? __ldg(a.depths + node) - a.window : INT_MIN;
      uint32_t bits = 0;
      for (int u = u0; u < min(u0 + TT, a.T); ++u)
        bits |= (uint32_t)(__ldg(a.anc + (size_t)node * a.T + u) != 0 &&
                           (a.window <= 0 || __ldg(a.depths + u) > low)) << (u - u0);
      s_anc[w] = bits;
    }
  }
  const bool bt_smem = a.B * a.NB <= BT_SMEM;
  if (bt_smem)
    for (int x = tid; x < a.B * a.NB; x += nthreads) s_bt[x] = __ldg(a.block_tables + x);
  __syncthreads();
  const int total = s_items[a.B];
  // blocks that take items: at least min_items each
  const int nblk = max(1, min((int)gridDim.x, (total + a.min_items - 1) / a.min_items));
  if ((int)blockIdx.x >= nblk) return;
  const int i0 = run_start(blockIdx.x, nblk, total);
  const int i1 = run_start(blockIdx.x + 1, nblk, total);
  if (i0 >= i1) return;
  // The items, located by the block's threads in parallel into a ring of
  // DESC_MAX descriptors (s_desc): the block's first DESC_MAX now, then the
  // next DESC_MAX / 2 each time the warps reach the start of a half, into
  // the half they are done with (the producer reads an item STAGES ahead,
  // inside the half being computed).  Block-table entries come from shared
  // memory where the tables fit.
  auto bt_entry = [&](int b, int pi) {
    return bt_smem ? s_bt[b * a.NB + pi] : __ldg(a.block_tables + (size_t)b * a.NB + pi);
  };
  auto fill = [&](int from, int to) {
    for (int i = from + tid; i < to; i += nthreads) {
      const Item it = locate(i, s_items, s_len, a, RC, cpp, ntt);
      ItemS& d = s_desc[(i - i0) % DESC_MAX];
      to_desc(d, it);
      d.blk = it.tree ? 0 : bt_entry(it.b, it.pi);
    }
  };
  fill(i0, min(i1, i0 + DESC_MAX));
  __syncthreads();
  auto desc = [&](int i) -> const ItemS& { return s_desc[(i - i0) % DESC_MAX]; };
  auto issue = [&](int i, int stage) {
    const ItemS& it = desc(i);
    unsigned char* kd = ring + stage * 2 * RAW;
    if (it.tree) {
      const int row3 = it.b * a.KH + it.kh;
      mbar_expect_tx(full + stage, 2u * NBOX * TT * 128);
#pragma unroll
      for (int bx = 0; bx < NBOX; ++bx) {
        tma_load_3d(kd + bx * TT * 128, &a.tkmap, full + stage, bx * 64, it.tt * TT, row3);
        tma_load_3d(kd + RAW + bx * TT * 128, &a.tvmap, full + stage, bx * 64, it.tt * TT, row3);
      }
      return;
    }
    const int row3 = min(max(it.blk, 0), a.P - 1) * a.KH + it.kh;  // clamped like the JAX gather
    constexpr int PBOX = FP8 ? 1 : NBOX;  // fp8: one [rows, D] byte box
    mbar_expect_tx(full + stage, 2u * PBOX * a.box_rows * (FP8 ? D : 128));
#pragma unroll
    for (int bx = 0; bx < PBOX; ++bx) {
      tma_load_3d(kd + bx * BK * 128, &a.kmap, full + stage, bx * 64, it.off, row3);
      tma_load_3d(kd + RAW + bx * BK * 128, &a.vmap, full + stage, bx * 64, it.off, row3);
    }
  };
  uint32_t qf[KSTEPS][4];  // the warp's 16 query rows as wgmma A fragments
  float oacc[D / 2];  // O[16 rows x D] of the warp, wgmma's accumulator layout
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units) of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums
  int len = 0, r0 = 0, ra = 0, rb = 0, ta = 0, tb = 0, qpa = 0, qpb = 0;
  bool va = false, vb = false, wglive = false;
  uint32_t phase = 0;  // a bit per ring stage: the parity its next wait expects
  int seg = i0;        // the first item of the current run of one row
  int npend = 0;       // rows whose counts this block completed (s_pend)

  // a new run of a row: the warp's query rows, an empty state
  auto start_run = [&](const ItemS& it) {
    const size_t bk = (size_t)it.b * a.KH + it.kh;
    len = s_len[it.b];
    r0 = it.rc * RB;
    ra = r0 + warp * 16 + g;
    rb = ra + 8;
    va = ra < R;
    vb = rb < R;
    wglive = r0 + (warp >> 2) * 64 < R;  // the warpgroup's 64 rows: 16 warp + [0, 64)
    ta = va ? ra % a.T : 0;
    tb = vb ? rb % a.T : 0;
    qpa = len + (anc_smem ? s_dep[ta] : __ldg(a.depths + ta));
    qpb = len + (anc_smem ? s_dep[tb] : __ldg(a.depths + tb));
    const __nv_bfloat16* qa = a.q + (bk * R + ra) * D + 2 * t;
    const __nv_bfloat16* qb = a.q + (bk * R + rb) * D + 2 * t;
#pragma unroll
    for (int ks = 0; ks < KSTEPS; ++ks) {
      qf[ks][0] = va ? __ldg(reinterpret_cast<const unsigned int*>(qa + ks * 16)) : 0u;
      qf[ks][1] = vb ? __ldg(reinterpret_cast<const unsigned int*>(qb + ks * 16)) : 0u;
      qf[ks][2] = va ? __ldg(reinterpret_cast<const unsigned int*>(qa + ks * 16 + 8)) : 0u;
      qf[ks][3] = vb ? __ldg(reinterpret_cast<const unsigned int*>(qb + ks * 16 + 8)) : 0u;
    }
#pragma unroll
    for (int d = 0; d < D / 2; ++d) oacc[d] = 0.f;
    m0 = m1 = -INFINITY;
    l0 = l1 = 0.f;
  };
  // the first run's query rows are read before the first copies are issued
  // (behind them they would wait for the copies' bytes), then the copies
  start_run(desc(i0));
  __syncthreads();
  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s)
      if (i0 + s < i1) issue(i0 + s, s);
  }

  for (int i = i0; i < i1; ++i) {
    const int st = (i - i0) % STAGES;
    if (i > i0 && (i - i0) % (DESC_MAX / 2) == 0)  // the ring's next half (block-uniform)
      fill(i + DESC_MAX / 2, min(i1, i + DESC_MAX));
    if (tid == 0 && i + STAGES - 1 < i1)  // refill the stage the previous item used
      issue(i + STAGES - 1, (st + STAGES - 1) % STAGES);
    const ItemS it = desc(i);
    const size_t bk = (size_t)it.b * a.KH + it.kh;
    if (i == seg && i > i0) start_run(it);
    // warp 0 asks L1 for the query rows of a run that starts STAGES items on,
    // so its reads need not wait behind the copies then in flight
    if (warp == 0 && i + STAGES < i1) {
      const ItemS& nxt = desc(i + STAGES);
      if (nxt.c == 0) {
        const int nr = min(R - nxt.rc * RB, RB);
        const char* qrow = reinterpret_cast<const char*>(
            a.q + (((size_t)nxt.b * a.KH + nxt.kh) * R + (size_t)nxt.rc * RB) * D);
        for (int line = lane; line < nr * D * 2 / 128; line += 32)
          asm volatile("prefetch.global.L1 [%0];\n" ::"l"(qrow + 128 * (size_t)line));
      }
    }

    // the item's K and V tiles, swizzled bf16 (`box` elements between a
    // tile's boxes); [lo_r, hi_r): the tile rows of keys the row reads
    // (prefix items)
    mbar_wait(full + st, (phase >> st) & 1u);
    phase ^= 1u << st;
    unsigned char* kd = ring + st * 2 * RAW;
    const __nv_bfloat16* Kt = reinterpret_cast<const __nv_bfloat16*>(kd);
    const __nv_bfloat16* Vt = reinterpret_cast<const __nv_bfloat16*>(kd + RAW);
    int box = TT * 64, lo_r = 0, hi_r = BK;
    if (!it.tree) {
      box = BK * 64;
      lo_r = max(it.klo - it.kfirst, 0);
      hi_r = min(min(it.klen - it.kfirst, a.page - it.off), BK);
      // (the writes below are read by wgmma, in the async proxy, so each
      // writer fences them; thread 0, the producer with copies in flight,
      // writes none: its fence would wait for them)
      if constexpr (FP8) {
        if (tid > 0) {
          widen_tile<D>(kd, Kw, kind, lo_r, hi_r, tid - 1, nthreads - 1);
          widen_tile<D>(kd + RAW, Vw, kind, lo_r, hi_r, tid - 1, nthreads - 1);
          fence_proxy_async();
        }
        __syncthreads();
        Kt = Kw;
        Vt = Vw;
      } else if (lo_r > 0 || hi_r < BK) {  // block-uniform
        if (tid > 0) {
          zero_rows<D>(reinterpret_cast<__nv_bfloat16*>(kd + RAW), lo_r, hi_r, tid - 1,
                       nthreads - 1);
          fence_proxy_async();
        }
        __syncthreads();
      }
    }

    if (wglive) {  // warpgroup-uniform: a warpgroup past the row chunk's rows computes nothing
      const int kbase = it.tree ? it.tt * TT : it.kfirst;
      const int nk = it.tree ? TT : BK;  // keys of the tile
      // the keys rows g and g + 8 keep, a bit each (bit kc: key kbase + kc),
      // shifted to this lane's columns 2t, 2t + 1 of each 8: prefix keys the
      // row reads above its window's edge; tree keys under the ancestor mask
      // (window included, see above)
      uint64_t ka = 0, kb = 0;
      if (!it.tree) {
        int loa = lo_r, lob = lo_r;
        if (a.window > 0) {
          loa = max(loa, qpa - a.window + 1 - it.kfirst);
          lob = max(lob, qpb - a.window + 1 - it.kfirst);
        }
        ka = va ? key_bits(loa, hi_r) : 0;
        kb = vb ? key_bits(lob, hi_r) : 0;
      } else if (anc_smem) {
        ka = va ? s_anc[ta * anc_w + it.tt] : 0;
        kb = vb ? s_anc[tb * anc_w + it.tt] : 0;
      } else {  // a tree past ANC_SMEM_T nodes: its mask from global memory
        for (int kc = 0; kc < TT; ++kc) {
          const int u = kbase + kc;
          if (u < a.T) {
            const int du = __ldg(a.depths + u);
            if (va && __ldg(a.anc + (size_t)ta * a.T + u) &&
                (a.window <= 0 || len + du > qpa - a.window))
              ka |= 1ull << kc;
            if (vb && __ldg(a.anc + (size_t)tb * a.T + u) &&
                (a.window <= 0 || len + du > qpb - a.window))
              kb |= 1ull << kc;
          }
        }
      }
      ka >>= 2 * t;
      kb >>= 2 * t;
      // S = Q.K^T: Q from registers, K K-major from the tile (box b of 64
      // columns at b * box bytes, k16 step ks at 32 ks bytes inside it)
      float s[32];
      const uint32_t kt = smem_u32(Kt), vt = smem_u32(Vt);
      wgmma_fence();
      if (it.tree) {
        float (&s16)[16] = *reinterpret_cast<float(*)[16]>(s);
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_qk32(s16, qf[ks], gmma_desc(kt + (ks >> 2) * box * 2 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
      } else {
#pragma unroll
        for (int ks = 0; ks < KSTEPS; ++ks)
          wgmma_qk64(s, qf[ks], gmma_desc(kt + (ks >> 2) * box * 2 + (ks & 3) * 32, 16, 1024),
                     ks > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(s);

      // scale into log2 units and mask
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool keep = (((e >> 1) ? kb : ka) >> (8 * j + (e & 1))) & 1u;
          s[4 * j + e] = keep ? s[4 * j + e] * a.scale_log2 : -INFINITY;
        }
      }

      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      // a row that has seen no live key keeps m = -inf: reference 0, p = 0
      const float ref0 = mx0 == -INFINITY ? 0.f : mx0;
      const float ref1 = mx1 == -INFINITY ? 0.f : mx1;
      const float alpha0 = ex2(m0 - ref0);
      const float alpha1 = ex2(m1 - ref1);
      m0 = mx0;
      m1 = mx1;
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[4 * j] = ex2(s[4 * j] - ref0);
        s[4 * j + 1] = ex2(s[4 * j + 1] - ref0);
        s[4 * j + 2] = ex2(s[4 * j + 2] - ref1);
        s[4 * j + 3] = ex2(s[4 * j + 3] - ref1);
        sum0 += s[4 * j] + s[4 * j + 1];
        sum1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = alpha0 * l0 + sum0;  // the unrounded f32 p
      l1 = alpha1 * l1 + sum1;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        oacc[4 * d] *= alpha0;
        oacc[4 * d + 1] *= alpha0;
        oacc[4 * d + 2] *= alpha1;
        oacc[4 * d + 3] *= alpha1;
      }
      // O += P.V: P packed to bf16 (the JAX function's rounding) straight
      // into the A fragments, V MN-major from the tile (k16 step kk at 16
      // rows of 128 bytes, its 64-column boxes `box` elements apart)
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
      fence_operands(oacc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        if (kk * 16 < nk) {
          const uint64_t dv = gmma_desc(vt + kk * 16 * 128, box * 2, 1024);
          if constexpr (D == 128) wgmma_pv128(oacc, pa[kk], dv, 1);
          else wgmma_pv64(oacc, pa[kk], dv, 1);
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_operands(oacc);
    }

    if (i + 1 == i1 || i + 1 == it.first + it.n) {  // the run ends (block-uniform)
      const bool whole = seg == it.first && i + 1 == it.first + it.n;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      __nv_bfloat16* ob = a.out + bk * R * D;
      if (whole) {
        const float inv0 = 1.f / fmaxf(l0, 1e-30f);
        const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const int col = d * 8 + 2 * t;
          if (va)
            *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + col) =
                pack_bf16(oacc[4 * d] * inv0, oacc[4 * d + 1] * inv0);
          if (vb)
            *reinterpret_cast<uint32_t*>(ob + (size_t)rb * D + col) =
                pack_bf16(oacc[4 * d + 2] * inv1, oacc[4 * d + 3] * inv1);
        }
      } else {
        // this run's partial of the row chunk's live rows, in slot ps
        const size_t ps = 2 * blockIdx.x + (seg != i0);
        const int la = ra - r0, lb = rb - r0;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          const int col = d * 8 + 2 * t;
          if (va)
            *reinterpret_cast<float2*>(a.part_acc + (ps * RB + la) * D + col) =
                make_float2(oacc[4 * d], oacc[4 * d + 1]);
          if (vb)
            *reinterpret_cast<float2*>(a.part_acc + (ps * RB + lb) * D + col) =
                make_float2(oacc[4 * d + 2], oacc[4 * d + 3]);
        }
        if (t == 0) {
          if (va) {
            a.part_m[ps * RB + la] = m0;
            a.part_l[ps * RB + la] = l0;
          }
          if (vb) {
            a.part_m[ps * RB + lb] = m1;
            a.part_l[ps * RB + lb] = l1;
          }
        }
        __threadfence();
        __syncthreads();
        if (tid == 0) {
          const int runs = i + 1 - seg;
          s_last = atomicAdd(a.counters + it.row, runs) + runs == it.n;
        }
        __syncthreads();
        if (s_last) {  // merged after the loop, when the tiles' registers are free
          if (tid == 0) {
            s_pend[npend][0] = it.first;
            s_pend[npend][1] = it.n;
            s_pend[npend][2] = it.row;
            s_pend[npend][3] = r0;
            s_pend[npend][4] = (int)bk;
          }
          ++npend;
        }
      }
      seg = i + 1;
    }
    // every warp is done with this item's tiles (the zeroed V rows, the one
    // generic write into a stage, were fenced for the async proxy when made)
    __syncthreads();
  }

  // Every run of each row whose count this block completed is in scratch:
  // merge them in item order, RUNB runs a batch.  A run is the part of the
  // row inside one block's item range, so run k is block b0 + k's; its
  // partial is that block's first slot unless the row starts inside the
  // block's range (then its second).  The batch's maxima and sums are read
  // in one round of loads into shared memory (the ring, idle now), each row
  // rescales its running state there, and every thread folds its output
  // pairs' accumulators over the batch, four runs' loads in flight at once:
  // a few rounds of loads, not one a run.
  float* s_m = reinterpret_cast<float*>(ring);  // [RUNB][RB] maxima, then weights
  float* s_l = s_m + RUNB * RB;                 // [RUNB][RB] sums
  float* s_rm = s_l + RUNB * RB;                // [RB] running max
  float* s_den = s_rm + RB;                     // [RB] running sum
  float* s_a = s_den + RB;                      // [RB] the batch's rescale
  int* s_rs = reinterpret_cast<int*>(s_a + RB);  // [RUNB] the runs' slots
  for (int pm = 0; pm < npend; ++pm) {
    __threadfence();
    const int first = s_pend[pm][0];
    const int rows = min(R - s_pend[pm][3], RB);
    const int b0 = run_owner(first, nblk, total);
    const int n_runs = run_owner(first + s_pend[pm][1] - 1, nblk, total) - b0 + 1;
    __nv_bfloat16* ob = a.out + ((size_t)s_pend[pm][4] * R + s_pend[pm][3]) * D;
    __syncthreads();  // the previous merge's buffers are read
    for (int r = tid; r < rows; r += nthreads) {
      s_rm[r] = -INFINITY;
      s_den[r] = 0.f;
    }
    float num[NP][2];
#pragma unroll
    for (int e = 0; e < NP; ++e) num[e][0] = num[e][1] = 0.f;
    for (int base = 0; base < n_runs; base += RUNB) {
      const int cnt = min(RUNB, n_runs - base);
      if (tid < cnt) {
        const int bb = b0 + base + tid;
        s_rs[tid] = 2 * bb + (first > run_start(bb, nblk, total));
      }
      __syncthreads();
      for (int x = tid; x < cnt * rows; x += nthreads) {
        const int k = x / rows;
        const int r = x - k * rows;
        const size_t o = (size_t)s_rs[k] * RB + r;
        s_m[k * RB + r] = __ldcg(a.part_m + o);
        s_l[k * RB + r] = __ldcg(a.part_l + o);
      }
      __syncthreads();
      for (int r = tid; r < rows; r += nthreads) {
        float mnew = s_rm[r];
        for (int k = 0; k < cnt; ++k) mnew = fmaxf(mnew, s_m[k * RB + r]);
        float sc = 1.f, den = s_den[r];
        if (mnew != -INFINITY) {
          sc = ex2(s_rm[r] - mnew);  // 0 while the running max is -inf
          den *= sc;
          for (int k = 0; k < cnt; ++k) {
            const float mk = s_m[k * RB + r];
            const float w = mk == -INFINITY ? 0.f : ex2(mk - mnew);
            s_m[k * RB + r] = w;
            den = fmaf(w, s_l[k * RB + r], den);
          }
          s_rm[r] = mnew;
        } else {
          for (int k = 0; k < cnt; ++k) s_m[k * RB + r] = 0.f;
        }
        s_a[r] = sc;
        s_den[r] = den;
      }
      __syncthreads();
#pragma unroll
      for (int e = 0; e < NP; ++e) {
        const int r = min((tid + e * nthreads) / (D / 2), rows - 1);
        num[e][0] *= s_a[r];
        num[e][1] *= s_a[r];
      }
#pragma unroll 4
      for (int k = 0; k < cnt; ++k) {
        const float2* acc = reinterpret_cast<const float2*>(a.part_acc + (size_t)s_rs[k] * RB * D);
#pragma unroll
        for (int e = 0; e < NP; ++e) {
          const int p = tid + e * nthreads;  // output pair p: row p / (D / 2)
          const int r = p / (D / 2);
          if (r < rows) {
            const float2 v = __ldcg(acc + p);
            const float w = s_m[k * RB + r];
            num[e][0] = fmaf(w, v.x, num[e][0]);
            num[e][1] = fmaf(w, v.y, num[e][1]);
          }
        }
      }
      __syncthreads();  // this batch's weights and slots are read
    }
#pragma unroll
    for (int e = 0; e < NP; ++e) {
      const int p = tid + e * nthreads;
      const int r = p / (D / 2);
      if (r < rows) {
        const float inv = 1.f / fmaxf(s_den[r], 1e-30f);
        *reinterpret_cast<uint32_t*>(ob + 2 * (size_t)p) = pack_bf16(num[e][0] * inv, num[e][1] * inv);
      }
    }
    if (tid == 0) a.counters[s_pend[pm][2]] = 0;  // ready for the next call
  }
}

// Tensor maps, cached under what they are a function of: (pointer, type,
// shape, box).  A 3-D map [d2, d1, d0] (d0 contiguous) with box [1, b1, b0];
// bf16 with the 128-byte swizzle, bytes (fp8) unswizzled; rows past a dim
// read as zeros.  The pools live as long as their engine, so each launch
// and each graph capture copies their maps, encoded once; a tree's K / V
// are new tensors each eager forward (often at a recycled address), a
// graph's are fixed.
struct MapEntry {
  CUtensorMap map;
  const void* ptr;
  uint64_t d0, d1, d2;
  uint32_t b0, b1;
  bool bf16, used;
};

bool cached_map(CUtensorMap* out, const void* ptr, bool bf16, uint64_t d0, uint64_t d1,
                uint64_t d2, uint32_t b0, uint32_t b1) {
  constexpr int N = 32;
  static std::mutex mu;
  static MapEntry cache[N];
  static int next = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (const MapEntry& e : cache) {
    if (e.used && e.ptr == ptr && e.bf16 == bf16 && e.d0 == d0 && e.d1 == d1 && e.d2 == d2 &&
        e.b0 == b0 && e.b1 == b1) {
      *out = e.map;
      return true;
    }
  }
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return false;
  const uint64_t esz = bf16 ? 2 : 1;
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {d0 * esz, d0 * d1 * esz};
  const cuuint32_t box[3] = {b0, b1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  MapEntry& e = cache[next];
  e.used = false;
  if (fn(&e.map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_UINT8, 3,
         const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
         bf16 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  e.ptr = ptr;
  e.bf16 = bf16;
  e.d0 = d0;
  e.d1 = d1;
  e.d2 = d2;
  e.b0 = b0;
  e.b1 = b1;
  e.used = true;
  next = (next + 1) % N;
  *out = e.map;
  return true;
}

// Opts `kernel` into the most dynamic shared memory the device allows, once
// per device (a bit per device in `done`), off the per-launch path; `most`
// is that limit.
template <typename K>
cudaError_t allow_smem(K kernel, std::atomic<uint32_t>& done, std::atomic<int>& most) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const uint32_t bit = dev < 32 ? 1u << dev : 0u;
  if (bit && (done.load(std::memory_order_acquire) & bit)) return cudaSuccess;
  cudaFuncAttributes attr;
  int optin = 0;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const int limit = optin - (int)attr.sharedSizeBytes;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err != cudaSuccess) return err;
  most.store(limit, std::memory_order_relaxed);
  done.fetch_or(bit, std::memory_order_release);
  return cudaSuccess;
}

template <int D, bool FP8>
cudaError_t launch_mma(TreeArgs& a, const void* k_pool, const void* v_pool, const void* tree_k,
                       const void* tree_v, float* scratch, long long scratch_floats, int blocks,
                       int warps, cudaStream_t stream) {
  static std::atomic<uint32_t> smem_set{0};
  static std::atomic<int> smem_most{0};
  const long long rows = 16LL * warps;  // query rows of a row chunk
  if (scratch_floats < 2LL * blocks * rows * (D + 2)) return cudaErrorInvalidValue;
  a.part_m = scratch;
  a.part_l = a.part_m + 2LL * blocks * rows;
  a.part_acc = a.part_l + 2LL * blocks * rows;
  a.box_rows = a.page < BK ? a.page : BK;
  const uint64_t prow = (uint64_t)a.P * a.KH, trow = (uint64_t)a.B * a.KH;
  const uint32_t pbox = FP8 ? D : 64;
  if (!cached_map(&a.kmap, k_pool, !FP8, D, a.page, prow, pbox, a.box_rows) ||
      !cached_map(&a.vmap, v_pool, !FP8, D, a.page, prow, pbox, a.box_rows) ||
      !cached_map(&a.tkmap, tree_k, true, D, a.T, trow, 64, TT) ||
      !cached_map(&a.tvmap, tree_v, true, D, a.T, trow, 64, TT))
    return cudaErrorInvalidValue;
  a.scale_log2 = LOG2E / sqrtf((float)D);
  cudaError_t err = allow_smem(paged_tree_mma_kernel<D, FP8>, smem_set, smem_most);
  if (err != cudaSuccess) return err;
  const size_t smem = mma_smem<D, FP8>(a.B, a.T);
  if (smem > (size_t)smem_most.load(std::memory_order_relaxed)) return cudaErrorInvalidValue;
  paged_tree_mma_kernel<D, FP8><<<blocks, warps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// mma: 1 = the tensor-core kernel (bf16 q, D 64 or 128, every tensor on a
// 16-byte boundary), 0 = the CUDA-core kernel.  dtype: q's, 0 = float32, 1
// = bfloat16.  kfmt: the pools' storage format, 0 = float32, 1 = bfloat16,
// 2 = float8_e4m3fn, 3 = float8_e5m2 (q's own, bf16 under f32 q, or fp8;
// read widened to q's type); the tree's K/V are in q's type.  window <= 0
// means no window.  blocks (the persistent grid), warps (4 or 8) and
// min_items are the mma kernel's plan (kernels.paged_tree_plan); its scratch
// holds scratch_floats >= 2 * blocks * 16 * warps * (D + 2) floats and
// counters B * KH * ceil((H / KH) * T / (16 * warps)) ints, zero before the
// first call (each call leaves them zero).  Returns a cudaError_t (0 =
// success); shapes are validated by the caller.
extern "C" int dabt_paged_tree(const void* q, const void* k_pool, const void* v_pool,
                               const void* block_tables, const void* lengths,
                               const void* tree_k, const void* tree_v, const void* anc,
                               const void* depths, void* out, void* scratch,
                               long long scratch_floats, void* counters, int mma, int dtype,
                               int kfmt, int B, int H, int KH, int T_, int P, int page, int NB,
                               int D, int window, int blocks, int warps, int min_items,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* len = static_cast<const int*>(lengths);
  const uint8_t* an = static_cast<const uint8_t*>(anc);
  const int* dep = static_cast<const int*>(depths);
  if (B < 1 || KH <= 0 || H % KH != 0 || T_ < 1 || P < 1 || page < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  if (kfmt < KV_F32 || kfmt > KV_E5M2 || (dtype == 1 && kfmt == KV_F32))
    return (int)cudaErrorInvalidValue;
  if (mma) {
    const auto misaligned = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 != 0; };
    if (dtype != 1 || blocks < 1 || warps < 4 || warps > MAX_WARPS || warps % 4 != 0 ||
        min_items < 1 ||
        scratch == nullptr || counters == nullptr || misaligned(q) || misaligned(k_pool) ||
        misaligned(v_pool) || misaligned(tree_k) || misaligned(tree_v) || misaligned(out))
      return (int)cudaErrorInvalidValue;
    TreeArgs a;
    a.q = static_cast<const __nv_bfloat16*>(q);
    a.block_tables = bt;
    a.lengths = len;
    a.anc = an;
    a.depths = dep;
    a.out = static_cast<__nv_bfloat16*>(out);
    a.counters = static_cast<int*>(counters);
    a.B = B;
    a.H = H;
    a.KH = KH;
    a.T = T_;
    a.P = P;
    a.page = page;
    a.NB = NB;
    a.window = window;
    a.kfmt = kfmt;
    a.min_items = min_items;
    float* sc = static_cast<float*>(scratch);
    const bool f8 = kfmt == KV_E4M3 || kfmt == KV_E5M2;
#define DABT_M(DIM, F8)                                                                   \
  if (D == DIM && f8 == F8)                                                               \
    return (int)launch_mma<DIM, F8>(a, k_pool, v_pool, tree_k, tree_v, sc, scratch_floats, \
                                    blocks, warps, s);
    DABT_M(64, false)
    DABT_M(64, true)
    DABT_M(128, false)
    DABT_M(128, true)
#undef DABT_M
    return (int)cudaErrorInvalidValue;
  }
#define DABT_CC(TYPE, DIM)                                                                  \
  if (D == DIM)                                                                             \
    return (int)launch_cc<TYPE, DIM>(q, k_pool, v_pool, bt, len, tree_k, tree_v, an, dep, out, \
                                     B, H, KH, T_, P, page, NB, window, kfmt, s);
  if (dtype == 0) {
    DABT_CC(float, 16) DABT_CC(float, 32) DABT_CC(float, 64) DABT_CC(float, 128)
    DABT_CC(float, 256)
  } else if (dtype == 1) {
    DABT_CC(__nv_bfloat16, 16) DABT_CC(__nv_bfloat16, 32) DABT_CC(__nv_bfloat16, 64)
    DABT_CC(__nv_bfloat16, 128) DABT_CC(__nv_bfloat16, 256)
  }
#undef DABT_CC
  return (int)cudaErrorInvalidValue;
}
