// Fused masked cosine score + exact top-k for Hopper (sm_90a).
//
// Replaces: django_assistant_bot_tpu/storage/knn.py `_topk_scores_impl`
// (:71-81) with the exact top-k it calls, `ops/sampling.py` `top_k_auto` /
// `top_k_hierarchical` (:22-68).  Computes, for index [N, D] bf16 (rows
// normalised), queries [Q, D] bf16 and valid [N] (bool bytes):
//
//   score[q, n] = sum_d queries[q, d] * index[n, d]   bf16 products, f32 sums
//   score[q, n] = -inf where !valid[n]
//   out_scores[q, :k], out_ids[q, :k] = the exact top-k of score[q, :],
//   descending, equal scores lower row first (lax.top_k's order)
//
// Slots past the query's valid-row count hold -inf and id 0.  D is any
// multiple of 8 (16-byte rows), N and Q any count, k any value up to N.
//
// What bounds it on the H100: at the serving corpus (N = 1,048,576 rows of
// D = 768, 1.61 GB of bf16) one read of the index takes 0.48 ms at
// 3.35 TB/s, while the product is 2 Q N D operations: 0.013 ms at Q = 8 and
// 0.21 ms at Q = 128 at 989 TFLOP/s.  So it is bound by bytes at every query
// bucket, and the least it can take is one read of the index.  The library
// route (matmul, then topk) also writes the [Q, N] f32 score matrix (537 MB
// at Q = 128) and reads it back.  This design reads the index once, and the
// rows of the groups that can hold a result once more, for all Q queries at
// once, and never writes [Q, N]:
//
//   1. `score_kernel<MT, false>`: one block per (128-row group, 128-query
//      tile).  Index rows and query rows stream through shared memory in
//      64-wide slices of D by `cp.async` (three stages, 16-byte chunks
//      swizzled by XOR with row % 8 so `ldmatrix` reads them without bank
//      conflicts); the scores come from `mma.sync.m16n8k16` bf16 products
//      with f32 accumulators (queries are the A operand, index rows the B
//      operand), and each block writes only its group's maximum per query,
//      as an order key (below): gkey [Q, G], G = ceil(N / 128).
//   2. `threshold_kernel`: one block per query selects, among the G groups
//      keyed by (maximum descending, group ascending), the kg-th largest,
//      kg = min(k, G), by a radix select over 64-bit keys.  Its score part is
//      the threshold tau, its group part the last selected group of those
//      whose maximum equals tau.  Every element of the top k lies in a
//      selected group and scores >= tau (each selected group ahead of an
//      element's own group holds an element that outranks it: the argument
//      of `ops/sampling.py:27-33`), and the selected groups hold at most
//      kg * 128 rows.  With k >= G every valid row is a candidate.
//   3. `score_kernel<MT, true>`: a block whose group no query of its tile
//      selected returns at once; the others recompute the same scores (the
//      same instructions in the same order, so bit-identical) and append
//      each valid element of a selected group scoring >= tau to the query's
//      candidate buffer (kg * 128 or N slots, whichever is fewer; an atomic
//      counter per query).  So the second pass reads only the selected
//      groups' rows: at most Q kg of the G groups, about 1.6% of the index
//      at Q = 8, k = 16 and 1,048,576 rows, the whole of it only when
//      Q kg approaches G.
//   4. `select_kernel`: one block per query takes the k largest candidates
//      (a radix select when there are more than k) and sorts them in shared
//      memory (bitonic).  A k past the shared buffer (k > SORT_CAP, far past
//      the k buckets) is sorted in global memory instead: the select block
//      compacts the winners into a buffer of kpad = SORT_CAP 2^m keys (zero
//      keys after them), `run_sort_kernel` sorts each SORT_CAP run in
//      shared memory, `merge_kernel` merges pairs of runs, log2(kpad /
//      SORT_CAP) times (each key finds its place in the other run by a
//      binary search), and `emit_kernel` writes the first k.  So every
//      query costs O(kpad log kpad), spread over kpad / 256 blocks.
//
// Order keys: a score s maps to ord(s), an unsigned 32-bit key whose order
// is the float order (sign-flipped bits); a candidate is the 64-bit key
// ord(s) << 32 | (0xffffffff - row), so the larger key is the larger score
// and, among equal scores, the lower row.  A group with no valid row has
// key 0, below every finite score.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 128;      // index rows per block = one group
constexpr int QTILE = 128;     // query rows per block, at most
constexpr int DC = 64;         // D slice per pipeline stage
constexpr int STAGES = 3;
constexpr int THREADS = 128;   // 4 warps of 32 rows each
constexpr int SEL_THREADS = 512;
constexpr int SORT_CAP = 16384;  // candidates a select block sorts in shared memory

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes));
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

// c += a . b for one 16x8x16 tile (bf16 in, f32 accumulators)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// element offset of (row, 16-byte chunk) in a [rows][DC] bf16 slice whose
// chunks are swizzled by XOR with row % 8
__device__ __forceinline__ int swz(int row, int chunk) {
  return row * DC + ((chunk ^ (row & 7)) << 3);
}

__device__ __forceinline__ uint32_t ord_key(float s) {
  const uint32_t b = __float_as_uint(s);
  return b ^ ((b & 0x80000000u) ? 0xffffffffu : 0x80000000u);
}

__device__ __forceinline__ float key_score(uint32_t o) {
  return __uint_as_float(o ^ ((o & 0x80000000u) ? 0x80000000u : 0xffffffffu));
}

__device__ __forceinline__ uint64_t cand_key(uint32_t o, int row) {
  return (static_cast<uint64_t>(o) << 32) | (0xffffffffu - static_cast<uint32_t>(row));
}

// one D slice of the block's 128 index rows and QT query rows into shared
// memory; rows past N or Q and columns past D are zero-filled
template <int QT>
__device__ __forceinline__ void load_slice(__nv_bfloat16* xs, __nv_bfloat16* qs,
                                           const __nv_bfloat16* __restrict__ index,
                                           const __nv_bfloat16* __restrict__ queries,
                                           int row0, int q0, int N, int Q, int D, int d0,
                                           int tid) {
  constexpr int CPR = DC / 8;  // 16-byte chunks per slice row
#pragma unroll
  for (int i = 0; i < ROWS * CPR / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    const int r = idx / CPR;
    const int ch = idx % CPR;
    const int d = d0 + ch * 8;
    const bool in = row0 + r < N && d < D;
    const __nv_bfloat16* src = in ? index + (size_t)(row0 + r) * D + d : index;
    cp_async16(smem_u32(xs + swz(r, ch)), src, in ? 16 : 0);
  }
#pragma unroll
  for (int i = 0; i < (QT * CPR + THREADS - 1) / THREADS; ++i) {
    const int idx = tid + i * THREADS;
    if (QT * CPR % THREADS == 0 || idx < QT * CPR) {
      const int r = idx / CPR;
      const int ch = idx % CPR;
      const int d = d0 + ch * 8;
      const bool in = q0 + r < Q && d < D;
      const __nv_bfloat16* src = in ? queries + (size_t)(q0 + r) * D + d : queries;
      cp_async16(smem_u32(qs + swz(r, ch)), src, in ? 16 : 0);
    }
  }
}

// Passes 1 and 3.  MT 16-query m-tiles per block (QT = 16 MT queries); the
// grid is linear, the query tile fastest, so the tiles of one row group run
// side by side and share its read through L2.
template <int MT, bool FILTER>
__global__ void __launch_bounds__(THREADS)
score_kernel(const __nv_bfloat16* __restrict__ index, const __nv_bfloat16* __restrict__ queries,
             const uint8_t* __restrict__ valid, uint32_t* __restrict__ gkey,
             const uint32_t* __restrict__ tau, const int* __restrict__ gcut,
             int* __restrict__ cnt, uint64_t* __restrict__ cand, int N, int D, int Q, int G,
             int n_qt, long long cap) {
  constexpr int QT = MT * 16;
  extern __shared__ __align__(128) unsigned char smem_bytes[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem_bytes);  // [STAGES][ROWS][DC]
  __nv_bfloat16* qs = xs + STAGES * ROWS * DC;                        // [STAGES][QT][DC]
  __shared__ uint32_t red[4][QT];

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int qt = blockIdx.x % n_qt;
  const int g = blockIdx.x / n_qt;
  const int row0 = g * ROWS;
  const int q0 = qt * QTILE;

  if (FILTER) {
    // a group that no query of the tile selected holds no candidate: its
    // rows are not read a second time
    bool sel = false;
    if (tid < QT && q0 + tid < Q) {
      const int q = q0 + tid;
      const uint32_t gk = gkey[(size_t)q * G + g];
      sel = gk > tau[q] || (gk == tau[q] && g <= gcut[q]);
    }
    if (!__syncthreads_or(sel)) return;
  }

  const int nsl = (D + DC - 1) / DC;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nsl)
      load_slice<QT>(xs + s * ROWS * DC, qs + s * QT * DC, index, queries, row0, q0, N, Q, D,
                     s * DC, tid);
    cp_async_commit();
  }

  // ldmatrix row addresses: for the A tile (queries), lane l names row l % 16
  // and chunk l / 16; for the B tiles (index rows), row (l % 8) + 8 (l / 16)
  // of a 16-row pair of n-tiles, chunk (l / 8) % 2
  const int a_row = lane & 15;
  const int a_ch = lane >> 4;
  const int b_row = (lane & 7) + ((lane >> 4) << 3);
  const int b_ch = (lane >> 3) & 1;

  float acc[MT][4][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < 4; ++n) acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  for (int sl = 0; sl < nsl; ++sl) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // slice sl is in; every warp is done with slice sl - 1
    const int nx = sl + STAGES - 1;
    if (nx < nsl)
      load_slice<QT>(xs + (nx % STAGES) * ROWS * DC, qs + (nx % STAGES) * QT * DC, index,
                     queries, row0, q0, N, Q, D, nx * DC, tid);
    cp_async_commit();
    const __nv_bfloat16* xt = xs + (sl % STAGES) * ROWS * DC;
    const __nv_bfloat16* qtl = qs + (sl % STAGES) * QT * DC;
#pragma unroll
    for (int ks = 0; ks < DC / 16; ++ks) {
      uint32_t bf[2][4];
#pragma unroll
      for (int np = 0; np < 2; ++np)
        ldsm_x4(smem_u32(xt + swz(warp * 32 + np * 16 + b_row, ks * 2 + b_ch)), bf[np]);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        uint32_t af[4];
        ldsm_x4(smem_u32(qtl + swz(m * 16 + a_row, ks * 2 + a_ch)), af);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          mma_bf16(acc[m][2 * np], af, bf[np][0], bf[np][1]);
          mma_bf16(acc[m][2 * np + 1], af, bf[np][2], bf[np][3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // accumulator element (m, n, e): query m * 16 + lane / 4 + 8 (e / 2), row
  // warp * 32 + n * 8 + 2 (lane % 4) + e % 2 of the block's tile
  bool ok[4][2];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      const int row = row0 + warp * 32 + n * 8 + 2 * (lane & 3) + c;
      ok[n][c] = row < N && valid[row];
    }

  if (!FILTER) {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        uint32_t best = 0;
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c)
            if (ok[n][c]) best = max(best, ord_key(acc[m][n][2 * h + c]));
        best = max(best, __shfl_xor_sync(0xffffffffu, best, 1));
        best = max(best, __shfl_xor_sync(0xffffffffu, best, 2));
        if ((lane & 3) == 0) red[warp][m * 16 + (lane >> 2) + 8 * h] = best;
      }
    __syncthreads();
    for (int i = tid; i < QT; i += THREADS) {
      if (q0 + i < Q) {
        const uint32_t b = max(max(red[0][i], red[1][i]), max(red[2][i], red[3][i]));
        gkey[(size_t)(q0 + i) * G + g] = b;
      }
    }
  } else {
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int q = q0 + m * 16 + (lane >> 2) + 8 * h;
        if (q >= Q) continue;
        const uint32_t t = tau[q];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int c = 0; c < 2; ++c) {
            if (!ok[n][c]) continue;
            const uint32_t o = ord_key(acc[m][n][2 * h + c]);
            // a score equal to tau counts only in a selected group: one whose
            // maximum passes tau, or one at tau no later than the last taken
            if (o > t || (o == t && (g <= gcut[q] || gkey[(size_t)q * G + g] > t))) {
              const int pos = atomicAdd(cnt + q, 1);
              if (pos < cap) {
                const int row = row0 + warp * 32 + n * 8 + 2 * (lane & 3) + c;
                cand[(size_t)q * cap + pos] = cand_key(o, row);
              }
            }
          }
      }
  }
}

// The rank-th largest (1-based) of n distinct 64-bit keys key_at(i), by an
// MSB-first radix select over 8-bit digits.  Every thread of the block calls
// it and gets the answer; hist holds 256 counters, sh 2 words of scratch.
template <class KeyAt>
__device__ uint64_t radix_select(KeyAt key_at, int n, int rank, unsigned* hist,
                                 unsigned* sh) {
  uint64_t prefix = 0, mask = 0;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += blockDim.x) hist[i] = 0;
    __syncthreads();
    for (int i = tid; i < n; i += blockDim.x) {
      const uint64_t key = key_at(i);
      if ((key & mask) == prefix) atomicAdd(hist + ((key >> shift) & 255), 1u);
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns digits 255 - 8 l down to 248 - 8 l; a scan over the lanes
      // finds the digit where the count from the top reaches rank
      unsigned own = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) own += hist[255 - 8 * lane - j];
      unsigned incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned v = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += v;
      }
      const unsigned hit = __ballot_sync(0xffffffffu, incl >= (unsigned)rank);
      if (lane == __ffs(hit) - 1) {
        unsigned before = incl - own;
        int digit = 255 - 8 * lane - 7;
        for (int j = 0; j < 8; ++j) {
          const int d = 255 - 8 * lane - j;
          if (before + hist[d] >= (unsigned)rank) {
            digit = d;
            break;
          }
          before += hist[d];
        }
        sh[0] = digit;
        sh[1] = rank - before;
      }
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(sh[0]) << shift;
    mask |= static_cast<uint64_t>(255) << shift;
    rank = sh[1];
    __syncthreads();
  }
  return prefix;
}

// Pass 2: per query, the threshold key tau and the last selected group at
// tau; zeroes the query's candidate counter
__global__ void __launch_bounds__(256)
threshold_kernel(const uint32_t* __restrict__ gkey, uint32_t* __restrict__ tau,
                 int* __restrict__ gcut, int* __restrict__ cnt, int G, int k) {
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[2];
  const int q = blockIdx.x;
  if (k >= G) {  // every group is selected: every valid row is a candidate
    if (threadIdx.x == 0) {
      tau[q] = 0;
      gcut[q] = G;
      cnt[q] = 0;
    }
    return;
  }
  const uint32_t* row = gkey + (size_t)q * G;
  const uint64_t kth = radix_select(
      [row](int i) { return cand_key(row[i], i); }, G, k, hist, sh);
  if (threadIdx.x == 0) {
    tau[q] = static_cast<uint32_t>(kth >> 32);
    gcut[q] = static_cast<int>(0xffffffffu - static_cast<uint32_t>(kth));
    cnt[q] = 0;
  }
}

// bitonic sort of keys[0, P) in shared memory, descending; P a power of two
__device__ void bitonic_desc(uint64_t* keys, int P) {
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      __syncthreads();
      for (int i = threadIdx.x; i < P / 2; i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const bool desc = (lo & size) == 0;
        const uint64_t a = keys[lo], b = keys[hi];
        if ((a < b) == desc) {
          keys[lo] = b;
          keys[hi] = a;
        }
      }
    }
  }
  __syncthreads();
}

__device__ __forceinline__ void emit(float* os, int* oi, int j, uint64_t key) {
  // key 0 is no candidate: the slots past the valid rows
  os[j] = key ? key_score(static_cast<uint32_t>(key >> 32)) : -__int_as_float(0x7f800000);
  oi[j] = key ? static_cast<int>(0xffffffffu - static_cast<uint32_t>(key)) : 0;
}

// Pass 4: per query, the k largest candidates in descending key order; with
// a global buffer `win` (k > SORT_CAP), their compaction into it
__global__ void __launch_bounds__(SEL_THREADS)
select_kernel(const uint64_t* __restrict__ cand, const int* __restrict__ cnt,
              float* __restrict__ out_scores, int* __restrict__ out_ids, int k, long long cap,
              uint64_t* __restrict__ win, int kpad) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_bytes);  // [pow2 >= k]
  __shared__ unsigned hist[256];
  __shared__ unsigned sh[2];
  __shared__ int taken;
  const int q = blockIdx.x;
  const int tid = threadIdx.x;
  const uint64_t* c = cand + (size_t)q * cap;
  const int count = static_cast<int>(min((long long)cnt[q], cap));
  const int n_sel = min(count, k);
  uint64_t kth = 0;  // with count <= k every candidate is taken
  if (count > k) kth = radix_select([c](int i) { return c[i]; }, count, k, hist, sh);
  if (tid == 0) taken = 0;
  __syncthreads();

  if (win != nullptr) {
    // the winners in any order, then zero keys up to kpad: the runs that
    // run_sort_kernel and merge_kernel put in order
    uint64_t* w = win + (size_t)q * kpad;
    for (int i = tid; i < count; i += blockDim.x) {
      const uint64_t key = c[i];
      if (key >= kth) w[atomicAdd(&taken, 1)] = key;
    }
    for (int i = n_sel + tid; i < kpad; i += blockDim.x) w[i] = 0;
    return;
  }
  int P = 1;
  while (P < n_sel) P <<= 1;
  for (int i = tid; i < count; i += blockDim.x) {
    const uint64_t key = c[i];
    if (key >= kth) keys[atomicAdd(&taken, 1)] = key;
  }
  for (int i = n_sel + tid; i < P; i += blockDim.x) keys[i] = 0;
  bitonic_desc(keys, P);
  float* os = out_scores + (size_t)q * k;
  int* oi = out_ids + (size_t)q * k;
  for (int j = tid; j < k; j += blockDim.x) emit(os, oi, j, j < n_sel ? keys[j] : 0);
}

// k > SORT_CAP: each SORT_CAP run of a query's winners sorted in place,
// descending (grid: kpad / SORT_CAP runs x Q)
__global__ void __launch_bounds__(SEL_THREADS)
run_sort_kernel(uint64_t* __restrict__ win, int kpad) {
  extern __shared__ __align__(16) unsigned char smem_bytes[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem_bytes);  // [SORT_CAP]
  uint64_t* w = win + (size_t)blockIdx.y * kpad + (size_t)blockIdx.x * SORT_CAP;
  for (int i = threadIdx.x; i < SORT_CAP; i += blockDim.x) keys[i] = w[i];
  bitonic_desc(keys, SORT_CAP);
  for (int i = threadIdx.x; i < SORT_CAP; i += blockDim.x) w[i] = keys[i];
}

// one merge level: runs of `width` sorted keys, merged in pairs from src
// into dst (grid: kpad / 256 x Q).  A key of the left run goes after the
// right run's greater keys, one of the right run after the left run's keys
// greater or equal, so equal (zero) keys keep their places apart.
__global__ void __launch_bounds__(256)
merge_kernel(const uint64_t* __restrict__ src, uint64_t* __restrict__ dst, int kpad,
             int width) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kpad) return;
  const uint64_t* s = src + (size_t)blockIdx.y * kpad;
  const int r = i / width;
  const int off = i - r * width;
  const int left = (r & ~1) * width;
  const uint64_t key = s[i];
  const bool is_left = (r & 1) == 0;
  const uint64_t* other = s + (is_left ? left + width : left);
  int lo = 0, hi = width;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint64_t o = other[mid];
    if (o > key || (!is_left && o == key)) lo = mid + 1;
    else hi = mid;
  }
  dst[(size_t)blockIdx.y * kpad + left + off + lo] = key;
}

// the first k sorted keys as scores and ids (grid: ceil(k / 256) x Q)
__global__ void __launch_bounds__(256)
emit_kernel(const uint64_t* __restrict__ sorted, float* __restrict__ out_scores,
            int* __restrict__ out_ids, int k, int kpad) {
  const int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= k) return;
  const size_t q = blockIdx.y;
  emit(out_scores + q * k, out_ids + q * k, j, sorted[q * kpad + j]);
}

template <int MT, bool FILTER>
cudaError_t launch_score(const __nv_bfloat16* index, const __nv_bfloat16* queries,
                         const uint8_t* valid, uint32_t* gkey, const uint32_t* tau,
                         const int* gcut, int* cnt, uint64_t* cand, int N, int D, int Q, int G,
                         long long cap, cudaStream_t s) {
  constexpr int QT = MT * 16;
  const size_t smem = (size_t)STAGES * (ROWS + QT) * DC * sizeof(__nv_bfloat16);
  cudaError_t err = cudaFuncSetAttribute(score_kernel<MT, FILTER>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int n_qt = (Q + QTILE - 1) / QTILE;
  const long long blocks = (long long)n_qt * G;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  score_kernel<MT, FILTER><<<(unsigned)blocks, THREADS, smem, s>>>(
      index, queries, valid, gkey, tau, gcut, cnt, cand, N, D, Q, G, n_qt, cap);
  return cudaGetLastError();
}

template <bool FILTER>
cudaError_t score_pass(int q_tile, const __nv_bfloat16* index, const __nv_bfloat16* queries,
                       const uint8_t* valid, uint32_t* gkey, const uint32_t* tau,
                       const int* gcut, int* cnt, uint64_t* cand, int N, int D, int Q, int G,
                       long long cap, cudaStream_t s) {
  if (q_tile <= 16)
    return launch_score<1, FILTER>(index, queries, valid, gkey, tau, gcut, cnt, cand, N, D, Q,
                                   G, cap, s);
  if (q_tile <= 32)
    return launch_score<2, FILTER>(index, queries, valid, gkey, tau, gcut, cnt, cand, N, D, Q,
                                   G, cap, s);
  if (q_tile <= 64)
    return launch_score<4, FILTER>(index, queries, valid, gkey, tau, gcut, cnt, cand, N, D, Q,
                                   G, cap, s);
  return launch_score<8, FILTER>(index, queries, valid, gkey, tau, gcut, cnt, cand, N, D, Q, G,
                                 cap, s);
}

}  // namespace

// index [N, D] bf16, queries [Q, D] bf16, valid [N] bytes; out_scores [Q, k]
// f32, out_ids [Q, k] int32; scratch: Q G + 3 Q int32 words (group keys,
// tau, gcut, counters), cand: Q cap 64-bit keys, cap = min(N, min(k, G) 128)
// (the caller computes it the same way); win: for k > SORT_CAP, 2 Q kpad
// 64-bit keys, kpad the least SORT_CAP 2^m >= k, else null and kpad 0.
// Returns cudaGetLastError() of the last launch, or the first error.
extern "C" int dabt_knn_topk(const void* index, const void* queries, const void* valid,
                             void* out_scores, void* out_ids, void* scratch, void* cand,
                             int N, int D, int Q, int k, long long cap, void* win, int kpad,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || Q <= 0 || k <= 0 || k > N || D <= 0 || D % 8 != 0) return (int)cudaErrorInvalidValue;
  const int G = (N + ROWS - 1) / ROWS;
  const long long kg = k < G ? k : G;
  const long long want_cap = kg * ROWS < N ? kg * ROWS : N;
  if (cap != want_cap) return (int)cudaErrorInvalidValue;
  int want_kpad = k > SORT_CAP ? SORT_CAP : 0;
  while (want_kpad && want_kpad < k) want_kpad <<= 1;
  if (kpad != want_kpad || (k > SORT_CAP) != (win != nullptr)) return (int)cudaErrorInvalidValue;
  const auto* x = static_cast<const __nv_bfloat16*>(index);
  const auto* qv = static_cast<const __nv_bfloat16*>(queries);
  const auto* vd = static_cast<const uint8_t*>(valid);
  auto* gkey = static_cast<uint32_t*>(scratch);
  auto* tau = gkey + (size_t)Q * G;
  auto* gcut = reinterpret_cast<int*>(tau + Q);
  int* cnt = gcut + Q;
  auto* cd = static_cast<uint64_t*>(cand);
  auto* os = static_cast<float*>(out_scores);
  auto* oi = static_cast<int*>(out_ids);
  const int q_tile = Q < QTILE ? Q : QTILE;

  cudaError_t err = score_pass<false>(q_tile, x, qv, vd, gkey, tau, gcut, cnt, cd, N, D, Q, G,
                                      cap, s);
  if (err != cudaSuccess) return (int)err;
  threshold_kernel<<<Q, 256, 0, s>>>(gkey, tau, gcut, cnt, G, k);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = score_pass<true>(q_tile, x, qv, vd, gkey, tau, gcut, cnt, cd, N, D, Q, G, cap, s);
  if (err != cudaSuccess) return (int)err;
  int slots = 1;
  while (slots < k && slots < SORT_CAP) slots <<= 1;
  const size_t smem = (size_t)slots * sizeof(uint64_t);
  err = cudaFuncSetAttribute(select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  auto* w0 = static_cast<uint64_t*>(win);
  select_kernel<<<Q, SEL_THREADS, win ? 0 : smem, s>>>(cd, cnt, os, oi, k, cap, w0, kpad);
  err = cudaGetLastError();
  if (err != cudaSuccess || win == nullptr) return (int)err;

  const size_t run_smem = (size_t)SORT_CAP * sizeof(uint64_t);
  err = cudaFuncSetAttribute(run_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)run_smem);
  if (err != cudaSuccess) return (int)err;
  run_sort_kernel<<<dim3(kpad / SORT_CAP, Q), SEL_THREADS, run_smem, s>>>(w0, kpad);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  uint64_t* src = w0;
  uint64_t* dst = w0 + (size_t)Q * kpad;
  for (int width = SORT_CAP; width < kpad; width <<= 1) {
    merge_kernel<<<dim3(kpad / 256, Q), 256, 0, s>>>(src, dst, kpad, width);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    uint64_t* t = src;
    src = dst;
    dst = t;
  }
  emit_kernel<<<dim3((k + 255) / 256, Q), 256, 0, s>>>(src, os, oi, k, kpad);
  return (int)cudaGetLastError();
}
