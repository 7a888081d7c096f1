// Paged tree attention for Hopper (sm_90a): the speculative verify forward's
// read.  Every node of a speculation tree attends to its slot's verified
// prefix in the page pool, read in place through the block table, plus its
// own root-path ancestors among the tree's freshly projected keys.
//
// Replaces: django_assistant_bot_tpu/ops/attention.py `paged_tree_attention`
// (:328-424), an XLA fori_loop over logical blocks (:401) followed by one
// ancestor-masked tree chunk in the JAX package.  Computes what
// `ops/attention.py` `paged_tree_attention_plain` (the port's twin of that
// function) computes.
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
//   the serving path): `paged_tree_mma_kernel`, flash prefill's structure
//   (`flash_prefill.cu`) on the rows of a (slot, KV head): up to 8 warps of
//   16 query rows each (5 warps, 80 rows, for 68 live rows), more rows in
//   a further block along grid.z.  Each key tile of 64 keys is gathered
//   through the block table by `cp.async` (16 bytes a thread, the key's page
//   looked up per row, rows swizzled by XOR of the 16-byte chunk index with
//   row % 8 so `ldmatrix` reads them without bank conflicts) into a double
//   buffer: the next tile is in flight while this one computes.  Keys past
//   the row's length are zero-filled, never read.  S = Q.K^T and O += P.V
//   run as `mma.sync.m16n8k16` bf16 products with f32 accumulators; the
//   online softmax runs on the accumulator fragments in log2 units, and P is
//   packed to bf16 straight into the A fragments of P.V (that packing is the
//   JAX function's rounding).  The tree is the last tile, under the
//   ancestor mask.
//   Work split: B * KH (slot, KV head) rows (64 at Llama-3-8B, 8 slots) do
//   not fill 132 SMs, so each row's prefix tiles are cut between `nsplit`
//   blocks (grid.y; chosen on the host from shapes alone, so a CUDA graph
//   can capture the launch).  Every block derives its tiles on the device
//   from lengths; the last split also takes the tree.  With nsplit > 1 each
//   block writes one (acc, m, l) partial per query row to f32 scratch and
//   adds one to the row group's counter (after `__threadfence()`); the block
//   that completes the count merges the partials in split order, writes the
//   normalised output and resets the counter, so no memset is needed.  The
//   split and the merge order depend on the inputs alone: equal inputs give
//   bitwise-equal outputs.
//
// * f32 (tight checks), other head dims, or inputs off 16-byte boundaries:
//   `paged_tree_cc_kernel`, CUDA cores, one warp per query row: 32 keys at a
//   time, a lane a key for the scores and the online softmax, each lane
//   holding D / 32 output columns for P.V.  Prefix keys in order, then the
//   tree.  No split, no scratch.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int BK = 64;          // keys per tile (prefix tiles and the tree tile)
constexpr int MAX_T = 64;       // tree nodes (one tile)
constexpr int MAX_SPLIT = 16;   // blocks one row group's prefix is cut between
constexpr int MAX_WARPS = 8;    // mma kernel: warps of 16 query rows per block
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
  // the tree: one more step under the ancestor mask (T <= 32 here, or two)
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

// c += a . b for one 16x8x16 tile (bf16 in, f32 accumulate)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
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

// element offset of (row, 16-byte chunk) in a [rows][D] bf16 tile whose
// chunks are swizzled by XOR with row % 8
template <int D>
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * D + ((chunk ^ (row & 7)) << 3);
}

// the row groups' f32 partials: per (slot, KV head, split, query row), acc
// [D], then m (log2 units) and l
template <int D>
__device__ __forceinline__ size_t part_off(int bk, int nsplit, int s, int R, int r) {
  return (((size_t)bk * nsplit + s) * R + r) * (D + 2);
}

// One 64-key tile into the swizzled K and V stages: prefix keys [kbase,
// kbase + 64) through the block table (tree == false), or the tree's keys
// [0, T) (tree == true); rows past the live range are zero-filled.
template <int D>
__device__ __forceinline__ void load_kv_tile(__nv_bfloat16* Kd, __nv_bfloat16* Vd,
                                             const __nv_bfloat16* k_pool,
                                             const __nv_bfloat16* v_pool, const int* bt_row,
                                             const __nv_bfloat16* tk, const __nv_bfloat16* tv,
                                             bool tree, int kbase, int kend, int kh, int KH,
                                             int P, int page, int tid, int nthreads) {
  constexpr int CPR = D / 8;
  for (int idx = tid; idx < BK * CPR; idx += nthreads) {
    const int row = idx / CPR;
    const int ch = idx - row * CPR;
    const int key = kbase + row;
    const int o = swz<D>(row, ch);
    if (key < kend) {
      size_t src;
      const __nv_bfloat16* kp;
      const __nv_bfloat16* vp;
      if (tree) {
        src = (size_t)key * D;
        kp = tk;
        vp = tv;
      } else {
        src = pool_row(bt_row, key, kh, KH, P, page, D);
        kp = k_pool;
        vp = v_pool;
      }
      cp_async16(smem_u32(Kd + o), kp + src + ch * 8);
      cp_async16(smem_u32(Vd + o), vp + src + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(Kd + o) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vd + o) = make_uint4(0, 0, 0, 0);
    }
  }
}

// fp8 pools: one prefix tile's K and V rows [kbase, kbase + 64) as they lie
// in the pool (D bytes a key, 16 a thread), unswizzled, through the block
// table; rows past the live range are zero-filled
template <int D>
__device__ __forceinline__ void load_kv_tile_fp8(uint8_t* Kd, uint8_t* Vd, const uint8_t* k_pool,
                                                 const uint8_t* v_pool, const int* bt_row,
                                                 int kbase, int kend, int kh, int KH, int P,
                                                 int page, int tid, int nthreads) {
  constexpr int CPR = D / 16;
  for (int idx = tid; idx < BK * CPR; idx += nthreads) {
    const int row = idx / CPR;
    const int ch = idx - row * CPR;
    const int key = kbase + row;
    const int o = row * D + ch * 16;
    if (key < kend) {
      const size_t src = pool_row(bt_row, key, kh, KH, P, page, D) + ch * 16;
      cp_async16(smem_u32(Kd + o), k_pool + src);
      cp_async16(smem_u32(Vd + o), v_pool + src);
    } else {
      *reinterpret_cast<uint4*>(Kd + o) = make_uint4(0, 0, 0, 0);
      *reinterpret_cast<uint4*>(Vd + o) = make_uint4(0, 0, 0, 0);
    }
  }
}

// fp8 pools: a landed tile widened exactly to bf16 into the swizzled stage
// the products read (16 values a thread per 16 bytes)
template <int D>
__device__ __forceinline__ void widen_tile(const uint8_t* raw, __nv_bfloat16* dst, bool kind,
                                           int tid, int nthreads) {
  constexpr int CPR = D / 16;
  for (int idx = tid; idx < BK * CPR; idx += nthreads) {
    const int row = idx / CPR;
    const int ch = idx - row * CPR;
    const uint4 r = *reinterpret_cast<const uint4*>(raw + row * D + ch * 16);
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch)) =
        make_uint4(widen_fp8x2(r.x, kind), widen_fp8x2(r.x >> 16, kind),
                   widen_fp8x2(r.y, kind), widen_fp8x2(r.y >> 16, kind));
    *reinterpret_cast<uint4*>(dst + swz<D>(row, 2 * ch + 1)) =
        make_uint4(widen_fp8x2(r.z, kind), widen_fp8x2(r.z >> 16, kind),
                   widen_fp8x2(r.w, kind), widen_fp8x2(r.w >> 16, kind));
  }
}

// FP8: the pools hold e4m3 or e5m2 (kfmt).  Prefix tiles then land as they
// lie in the pool (half the bytes of bf16) in a second double buffer, and
// once landed the block widens them exactly to bf16 into the stage the
// unchanged products read (`cp.async` does not convert, `ldmatrix.trans`
// takes 16-bit elements only); the tree tile, in q's type, lands in the
// stage directly.  This is the JAX function's dequant read (:377-393): the
// tree read has no in-dot scheme there.
template <int D, bool FP8>
__global__ void __launch_bounds__(MAX_WARPS * 32)
paged_tree_mma_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ k_pool,
                      const void* __restrict__ v_pool,
                      const int* __restrict__ block_tables, const int* __restrict__ lengths,
                      const __nv_bfloat16* __restrict__ tree_k,
                      const __nv_bfloat16* __restrict__ tree_v, const uint8_t* __restrict__ anc,
                      const int* __restrict__ depths, __nv_bfloat16* __restrict__ out,
                      float* __restrict__ scratch, int* __restrict__ counters, int H, int KH,
                      int T_, int P, int page, int NB, int window, float scale_log2, int kfmt) {
  constexpr int KSTEPS = D / 16;  // k-steps of S = Q.K^T
  constexpr int NT = BK / 8;      // 8-key n-tiles of S
  constexpr int DT = D / 8;       // 8-column n-tiles of O
  constexpr int CPR = D / 8;      // 16-byte chunks per row
  const int nthreads = blockDim.x;
  const int W = nthreads >> 5;
  const int RB = 16 * W;  // query rows of this block
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_bytes);  // [2][BK][D]
  __nv_bfloat16* Vs = Ks + 2 * BK * D;                                // [2][BK][D]
  __nv_bfloat16* Qs = Vs + 2 * BK * D;                                // [RB][D]
  uint8_t* s_anc = reinterpret_cast<uint8_t*>(Qs + RB * D);           // [T][T]
  int* s_dep = reinterpret_cast<int*>(s_anc + MAX_T * MAX_T);         // [T]
  uint8_t* Kr = reinterpret_cast<uint8_t*>(s_dep + MAX_T);            // FP8: [2][BK][D]
  uint8_t* Vr = Kr + 2 * BK * D;                                      // FP8: [2][BK][D]
  __shared__ int s_last;
  const bool kind = kfmt == KV_E4M3;  // else e5m2 (FP8)

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;  // accumulator rows g, g + 8 of the warp's 16
  const int t = lane & 3;   // accumulator columns 2t, 2t + 1 of each 8
  const int bk = blockIdx.x;
  const int b = bk / KH;
  const int kh = bk - b * KH;
  const int split = blockIdx.y;
  const int nsplit = gridDim.y;
  const int R = (H / KH) * T_;
  const int r0 = blockIdx.z * RB;
  const int rows = min(R - r0, RB);

  const int len = lengths[b];
  int klo, klen;
  key_range(len, NB, page, window, klo, klen);
  const int ntiles = (klen - klo + BK - 1) / BK;
  const int t_lo = (int)((long long)split * ntiles / nsplit);
  const int t_hi = (int)((long long)(split + 1) * ntiles / nsplit);
  const bool with_tree = split == nsplit - 1;
  const int n_work = t_hi - t_lo + (with_tree ? 1 : 0);
  const int* bt_row = block_tables + (size_t)b * NB;
  const __nv_bfloat16* tk = tree_k + (size_t)bk * T_ * D;
  const __nv_bfloat16* tv = tree_v + (size_t)bk * T_ * D;

  // tiles in order: prefix tiles t_lo..t_hi-1, then the tree
  auto load_work = [&](int i, int stage) {
    const bool tree = i >= t_hi - t_lo;
    const int kbase = tree ? 0 : klo + (t_lo + i) * BK;
    const int kend = tree ? T_ : klen;
    if (FP8 && !tree) {
      load_kv_tile_fp8<D>(Kr + stage * BK * D, Vr + stage * BK * D,
                          static_cast<const uint8_t*>(k_pool), static_cast<const uint8_t*>(v_pool),
                          bt_row, kbase, kend, kh, KH, P, page, tid, nthreads);
    } else {
      load_kv_tile<D>(Ks + stage * BK * D, Vs + stage * BK * D,
                      FP8 ? nullptr : static_cast<const __nv_bfloat16*>(k_pool),
                      FP8 ? nullptr : static_cast<const __nv_bfloat16*>(v_pool), bt_row, tk, tv,
                      tree, kbase, kend, kh, KH, P, page, tid, nthreads);
    }
  };

  // the block's query rows (zero past R), the tree's mask and depths
  const __nv_bfloat16* qb = q + ((size_t)bk * R + r0) * D;
  for (int idx = tid; idx < RB * CPR; idx += nthreads) {
    const int row = idx / CPR;
    const int ch = idx - row * CPR;
    if (row < rows) {
      cp_async16(smem_u32(Qs + swz<D>(row, ch)), qb + (size_t)row * D + ch * 8);
    } else {
      *reinterpret_cast<uint4*>(Qs + swz<D>(row, ch)) = make_uint4(0, 0, 0, 0);
    }
  }
  for (int i = tid; i < T_ * T_; i += nthreads) s_anc[i] = anc[i];
  for (int i = tid; i < T_; i += nthreads) s_dep[i] = depths[i];
  if (n_work > 0) load_work(0, 0);
  cp_async_commit();

  const int a_row = lane & 15;
  const int a_ch = lane >> 4;
  const int kb_row = (lane & 7) + ((lane >> 4) << 3);
  const int kb_ch = (lane >> 3) & 1;
  const int qrow = warp * 16 + a_row;

  // this lane's two query rows: validity, tree node, position
  const int ra = r0 + warp * 16 + g;
  const int rb_ = ra + 8;
  const bool va = ra < R, vb = rb_ < R;
  int ta = 0, tb = 0, qpa = 0, qpb = 0;

  uint32_t qf[KSTEPS][4];
  float oacc[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) oacc[d][0] = oacc[d][1] = oacc[d][2] = oacc[d][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max (log2 units) of rows g, g + 8
  float l0 = 0.f, l1 = 0.f;              // this lane's part of the running sums

  for (int i = 0; i < n_work; ++i) {
    const int st = i & 1;
    if (i + 1 < n_work) {
      load_work(i + 1, st ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bool tree = i >= t_hi - t_lo;
    if constexpr (FP8) {
      if (!tree) {  // block-uniform
        widen_tile<D>(Kr + st * BK * D, Ks + st * BK * D, kind, tid, nthreads);
        widen_tile<D>(Vr + st * BK * D, Vs + st * BK * D, kind, tid, nthreads);
        __syncthreads();
      }
    }
    if (i == 0) {
#pragma unroll
      for (int ks = 0; ks < KSTEPS; ++ks)
        ldsm_x4(smem_u32(Qs + swz<D>(qrow, ks * 2 + a_ch)), qf[ks]);
      ta = ra % T_;
      tb = rb_ % T_;
      qpa = len + s_dep[ta];
      qpb = len + s_dep[tb];
    }
    const int kbase = tree ? 0 : klo + (t_lo + i) * BK;
    const __nv_bfloat16* Kt = Ks + st * BK * D;
    const __nv_bfloat16* Vt = Vs + st * BK * D;

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

    // scale into log2 units and mask: prefix keys below the length and in
    // the window; tree keys under the ancestor mask and the window
#pragma unroll
    for (int j = 0; j < NT; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool hi_row = e >> 1;
        const int key = kbase + j * 8 + 2 * t + (e & 1);
        const int qp = hi_row ? qpb : qpa;
        bool keep = hi_row ? vb : va;
        if (tree) {
          const int tr = hi_row ? tb : ta;
          keep = keep && key < T_ && s_anc[tr * T_ + key] != 0;
          if (keep && window > 0) keep = len + s_dep[key] > qp - window;
        } else {
          keep = keep && key < klen;
          if (window > 0) keep = keep && key > qp - window;
        }
        s[j][e] = keep ? s[j][e] * scale_log2 : -INFINITY;
      }
    }

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
    // a row that has seen no live key keeps m = -inf: reference 0, p = 0
    const float ref0 = mx0 == -INFINITY ? 0.f : mx0;
    const float ref1 = mx1 == -INFINITY ? 0.f : mx1;
    const float alpha0 = ex2(m0 - ref0);
    const float alpha1 = ex2(m1 - ref1);
    m0 = mx0;
    m1 = mx1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      s[j][0] = ex2(s[j][0] - ref0);
      s[j][1] = ex2(s[j][1] - ref0);
      s[j][2] = ex2(s[j][2] - ref1);
      s[j][3] = ex2(s[j][3] - ref1);
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
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }

  __nv_bfloat16* ob = out + (size_t)bk * R * D;
  if (nsplit == 1) {
    const float inv0 = 1.f / fmaxf(l0, 1e-30f);
    const float inv1 = 1.f / fmaxf(l1, 1e-30f);
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int col = d * 8 + 2 * t;
      if (va)
        *reinterpret_cast<uint32_t*>(ob + (size_t)ra * D + col) =
            pack_bf16(oacc[d][0] * inv0, oacc[d][1] * inv0);
      if (vb)
        *reinterpret_cast<uint32_t*>(ob + (size_t)rb_ * D + col) =
            pack_bf16(oacc[d][2] * inv1, oacc[d][3] * inv1);
    }
    return;
  }

  // split: this block's partial per row, then the last block of the row
  // group merges every split's partial in split order
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int col = d * 8 + 2 * t;
    if (va)
      *reinterpret_cast<float2*>(scratch + part_off<D>(bk, nsplit, split, R, ra) + col) =
          make_float2(oacc[d][0], oacc[d][1]);
    if (vb)
      *reinterpret_cast<float2*>(scratch + part_off<D>(bk, nsplit, split, R, rb_) + col) =
          make_float2(oacc[d][2], oacc[d][3]);
  }
  if (t == 0) {
    if (va) {
      scratch[part_off<D>(bk, nsplit, split, R, ra) + D] = m0;
      scratch[part_off<D>(bk, nsplit, split, R, ra) + D + 1] = l0;
    }
    if (vb) {
      scratch[part_off<D>(bk, nsplit, split, R, rb_) + D] = m1;
      scratch[part_off<D>(bk, nsplit, split, R, rb_) + D + 1] = l1;
    }
  }
  __threadfence();
  __syncthreads();
  int* counter = counters + (size_t)bk * gridDim.z + blockIdx.z;
  if (tid == 0) s_last = atomicAdd(counter, 1) == nsplit - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  // merge weights of each row (reusing the K stages): w[row][split], 1 / L
  float* s_w = reinterpret_cast<float*>(Ks);  // [RB][MAX_SPLIT]
  float* s_inv = s_w + RB * MAX_SPLIT;         // [RB]
  for (int i = tid; i < rows; i += nthreads) {
    float M = -INFINITY;
    for (int sp = 0; sp < nsplit; ++sp)
      M = fmaxf(M, __ldcg(scratch + part_off<D>(bk, nsplit, sp, R, r0 + i) + D));
    float L = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const size_t o = part_off<D>(bk, nsplit, sp, R, r0 + i);
      const float ms = __ldcg(scratch + o + D);
      const float w = ms == -INFINITY ? 0.f : ex2(ms - M);
      s_w[i * MAX_SPLIT + sp] = w;
      L += w * __ldcg(scratch + o + D + 1);
    }
    s_inv[i] = 1.f / fmaxf(L, 1e-30f);
  }
  __syncthreads();
  for (int idx = tid; idx < rows * (D / 2); idx += nthreads) {
    const int i = idx / (D / 2);
    const int col = 2 * (idx - i * (D / 2));
    float a0 = 0.f, a1 = 0.f;
    for (int sp = 0; sp < nsplit; ++sp) {
      const float2 v = __ldcg(reinterpret_cast<const float2*>(
          scratch + part_off<D>(bk, nsplit, sp, R, r0 + i) + col));
      const float w = s_w[i * MAX_SPLIT + sp];
      a0 = fmaf(w, v.x, a0);
      a1 = fmaf(w, v.y, a1);
    }
    const float inv = s_inv[i];
    *reinterpret_cast<uint32_t*>(ob + (size_t)(r0 + i) * D + col) = pack_bf16(a0 * inv, a1 * inv);
  }
  if (tid == 0) *counter = 0;
}

// Opts `kernel` into `smem` bytes of dynamic shared memory once per device
// (bit per device in `done`), off the per-launch path.
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

// the K/V stages, the block's query rows, the tree's mask and depths, and
// (FP8) the double buffer of raw prefix tiles
template <int D, bool FP8>
size_t mma_smem(int warps) {
  return sizeof(__nv_bfloat16) * (4 * BK * D + 16 * warps * D) + MAX_T * MAX_T +
         sizeof(int) * MAX_T + (FP8 ? 4 * BK * D : 0);
}

template <int D, bool FP8>
cudaError_t launch_mma(const void* q, const void* k_pool, const void* v_pool, const int* bt,
                       const int* lengths, const void* tree_k, const void* tree_v,
                       const uint8_t* anc, const int* depths, void* out, float* scratch,
                       int* counters, int B, int H, int KH, int T_, int P, int page, int NB,
                       int window, int nsplit, int warps, int kfmt, cudaStream_t stream) {
  const int R = (H / KH) * T_;
  const int rc = (R + 16 * warps - 1) / (16 * warps);
  static std::atomic<uint32_t> smem_set{0};
  cudaError_t err =
      allow_smem(paged_tree_mma_kernel<D, FP8>, mma_smem<D, FP8>(MAX_WARPS), smem_set);
  if (err != cudaSuccess) return err;
  dim3 grid(B * KH, nsplit, rc);
  paged_tree_mma_kernel<D, FP8><<<grid, warps * 32, mma_smem<D, FP8>(warps), stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, bt, lengths,
      static_cast<const __nv_bfloat16*>(tree_k), static_cast<const __nv_bfloat16*>(tree_v), anc,
      depths, static_cast<__nv_bfloat16*>(out), scratch, counters, H, KH, T_, P, page, NB,
      window, LOG2E / sqrtf((float)D), kfmt);
  return cudaGetLastError();
}

}  // namespace

// mma: 1 = the tensor-core kernel (bf16 q, D 64 or 128, 16-byte aligned), 0
// = the CUDA-core kernel.  dtype: q's, 0 = float32, 1 = bfloat16.  kfmt: the
// pools' storage format, 0 = float32, 1 = bfloat16, 2 = float8_e4m3fn, 3 =
// float8_e5m2 (q's own, bf16 under f32 q, or fp8; read widened to q's
// type); the tree's K/V are in q's type.  window <= 0 means no window.
// nsplit (1..16) and warps (1..8) are the mma kernel's work split
// (kernels.paged_tree_plan); with nsplit > 1, scratch holds B * KH * nsplit
// * (H / KH) * T * (D + 2) floats and counters B * KH * ceil((H / KH) * T /
// (16 * warps)) zeroed ints, left at zero.  Returns a cudaError_t (0 =
// success); shapes are validated by the caller.
extern "C" int dabt_paged_tree(const void* q, const void* k_pool, const void* v_pool,
                               const void* block_tables, const void* lengths,
                               const void* tree_k, const void* tree_v, const void* anc,
                               const void* depths, void* out, void* scratch, void* counters,
                               int mma, int dtype, int kfmt, int B, int H, int KH, int T_, int P,
                               int page, int NB, int D, int window, int nsplit, int warps,
                               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* bt = static_cast<const int*>(block_tables);
  const int* len = static_cast<const int*>(lengths);
  const uint8_t* an = static_cast<const uint8_t*>(anc);
  const int* dep = static_cast<const int*>(depths);
  if (KH <= 0 || H % KH != 0 || T_ < 1 || T_ > MAX_T || P < 1 || page < 1 || NB < 1)
    return (int)cudaErrorInvalidValue;
  if (kfmt < KV_F32 || kfmt > KV_E5M2 || (dtype == 1 && kfmt == KV_F32))
    return (int)cudaErrorInvalidValue;
  if (mma) {
    if (dtype != 1 || nsplit < 1 || nsplit > MAX_SPLIT || warps < 1 || warps > MAX_WARPS)
      return (int)cudaErrorInvalidValue;
    if (nsplit > 1 && (scratch == nullptr || counters == nullptr))
      return (int)cudaErrorInvalidValue;
    float* sc = static_cast<float*>(scratch);
    int* ct = static_cast<int*>(counters);
    const bool f8 = kfmt == KV_E4M3 || kfmt == KV_E5M2;
#define DABT_M(DIM, F8)                                                                      \
  if (D == DIM && f8 == F8)                                                                  \
    return (int)launch_mma<DIM, F8>(q, k_pool, v_pool, bt, len, tree_k, tree_v, an, dep, out, \
                                    sc, ct, B, H, KH, T_, P, page, NB, window, nsplit, warps, \
                                    kfmt, s);
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
