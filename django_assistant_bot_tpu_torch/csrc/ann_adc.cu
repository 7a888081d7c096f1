// IVF-PQ asymmetric-distance (ADC) scan + shortlist for Hopper (sm_90a).
//
// Replaces: django_assistant_bot_tpu/storage/ann.py `_adc_body` (:208-222,
// a fori_loop over the m subspaces) inside `_adc_shortlist_impl` (:225-245),
// after its centroid scores and LUT.  For codes [nlist, L, m] uint8, lvalid
// [nlist, L] bool, rowpos [nlist, L] int32, the probed lists top_ci [Q, P]
// and their scores top_c [Q, P], and the LUT [Q, m, 256] f32 (the plain
// twin: storage/ann.py `adc_shortlist_plain`), per query q and flat item
// f = p * L + s (probe-major, slot-minor, as `jnp.repeat(top_c, L)` lays it
// out), with l = top_ci[q, p]:
//
//   acc   = 0; for j = 0 .. m - 1: acc += LUT[q, j, codes[l, s, j]]
//   score = lvalid[l, s] ? top_c[q, p] + acc : -inf
//   the top S scores, descending, equal scores the lower f first
//   (`lax.top_k`), and their row positions rowpos[l, s].
//
// The sum keeps the JAX loop's order (j ascending from 0.0, then top_c), so
// the scores equal the twin's bit for bit; only additions, so no FMA
// contraction can change a rounding.
//
// What bounds it on the H100: bytes.  A query reads its P probed lists'
// validity and, for their valid slots, the m code bytes and, for the
// shortlist, the row positions; the LUT (m 256 4 = 96 KB a query) beside
// them.  The operations (one table lookup and one addition per code byte)
// are far below the card's rate.  Every list is padded to the fullest
// one's capacity L, so where k-means leaves the lists unequal (on the
// 2,000,000 x 768 corpus of chip_smoke.py the fullest list holds 30,479
// rows against an average of 488) most probed slots are empty.
//
// Design: two kernels, one launch function.
//   1. adc_scan_kernel, grid (ceil(P L / span), Q), 512 threads: a block
//      stages its query's LUT in shared memory (96 KB at m = 96: dynamic
//      shared memory past 48 KB), then scores `span` flat items, a thread
//      an item at a time: an invalid slot is -inf with no code read; a
//      valid one reads its m code bytes as 16-byte words (4-byte or single
//      bytes when m or the base is not so aligned) and its m lookups from
//      shared memory.  The scores go to a global scratch [Q, P L], and
//      each warp's maximum over its 32 consecutive items (a group) to
//      gmax [Q, G].  Past LUT_CHUNK subspaces (a LUT over 192 KB, e.g. a
//      4,096-wide corpus at m = 512) the LUT is staged a chunk at a time
//      and each item's partial sum rides in the scratch between chunks,
//      read and written by the same thread, so the order stays j-ascending.
//   2. adc_select_kernel, grid Q, 1024 threads.  When the query has more
//      than S groups, a radix select over the group maxima finds T, the
//      S-th largest: at least S items are >= T, so the top S lie in the
//      groups whose maximum is >= T.  Those candidate groups are listed in
//      ascending order (a block-wide prefix count), and the same select
//      runs over their items: a radix select (four 8-bit passes over the
//      order keys, histograms in shared memory with warp-aggregated
//      atomics, the keys kept in a shared-memory cache when they fit)
//      finds the S-th largest key and how many of the keys equal to it are
//      in; one ordered pass takes every item above it and the first of
//      those equal to it in item order; a bitonic sort of the S 64-bit keys
//      (order key, then the inverted flat index, so keys are unique and the
//      result does not depend on the order the threads run in) orders
//      them; the block writes the scores and looks up the row positions.
// The select then reads the scratch only in the candidate groups (a few
// thousand items a query where the lists hold a few hundred rows each).
// One block a query runs the select, which is what its time is made of at
// small Q.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int SCAN_THREADS = 512;
constexpr int SEL_THREADS = 1024;
constexpr int SEL_WARPS = SEL_THREADS / 32;
constexpr int CODES = 256;
constexpr int LUT_CHUNK = 192;  // subspaces staged at once: 192 KB of LUT
constexpr int MAX_S = 2048;     // storage/ann.py MAX_SHORTLIST
constexpr int GROUP = 32;       // items a group maximum covers: one warp's
constexpr int CACHE = 32768;    // order keys the select keeps in shared memory
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const uint8_t* codes;   // [nlist, L, m]
  const uint8_t* lvalid;  // [nlist, L]
  const int* rowpos;      // [nlist, L]
  const int* top_ci;      // [Q, P]
  const float* top_c;     // [Q, P]
  const float* lut;       // [Q, m, 256]
  float* scores;          // [Q, P L] scratch
  float* gmax;            // [Q, G] scratch: each group's maximum score
  int* cgroups;           // [Q, G] scratch: a query's candidate groups
  float* out_scores;      // [Q, S]
  int* out_pos;           // [Q, S]
  int L, m, P, S, span, n_items, n_groups, word;  // word: bytes a code load (16, 4 or 1)
};

// the sum of one item's LUT terms for subspaces [0, mc) of the staged chunk,
// added to acc in j order; c points at the item's first code of the chunk
template <int W>
__device__ __forceinline__ float adc_sum(const uint8_t* c, const float* lut_s, int mc,
                                         float acc) {
  if constexpr (W == 16) {
    const uint4* w = reinterpret_cast<const uint4*>(c);
    for (int i = 0; i < mc / 16; ++i) {
      const uint4 v = __ldg(w + i);
      const uint32_t words[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int h = 0; h < 4; ++h) {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          acc += lut_s[(16 * i + 4 * h + b) * CODES + ((words[h] >> (8 * b)) & 255u)];
      }
    }
  } else if constexpr (W == 4) {
    const uint32_t* w = reinterpret_cast<const uint32_t*>(c);
    for (int i = 0; i < mc / 4; ++i) {
      const uint32_t v = __ldg(w + i);
#pragma unroll
      for (int b = 0; b < 4; ++b) acc += lut_s[(4 * i + b) * CODES + ((v >> (8 * b)) & 255u)];
    }
  } else {
    for (int j = 0; j < mc; ++j) acc += lut_s[j * CODES + __ldg(c + j)];
  }
  return acc;
}

// a float's order key: unsigned compare of keys = float compare, -0 as +0
__device__ __forceinline__ uint32_t ord(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

template <int W>
__global__ void __launch_bounds__(SCAN_THREADS) adc_scan_kernel(Args a) {
  extern __shared__ float lut_s[];
  const int q = blockIdx.y, lane = threadIdx.x & 31;
  const int f0 = blockIdx.x * a.span;
  const int f1 = min(f0 + a.span, a.n_items);
  const float* lut_q = a.lut + (size_t)q * a.m * CODES;
  const int* ci = a.top_ci + (size_t)q * a.P;
  float* out = a.scores + (size_t)q * a.n_items;
  for (int j0 = 0; j0 < a.m; j0 += LUT_CHUNK) {
    const int mc = min(LUT_CHUNK, a.m - j0);
    __syncthreads();  // the previous chunk's readers are done
    const float4* src = reinterpret_cast<const float4*>(lut_q + (size_t)j0 * CODES);
    float4* dst = reinterpret_cast<float4*>(lut_s);
    for (int i = threadIdx.x; i < mc * CODES / 4; i += SCAN_THREADS) dst[i] = __ldg(src + i);
    __syncthreads();
    const bool first = j0 == 0, last = j0 + mc >= a.m;
    // warp-uniform trips: a warp's 32 lanes hold 32 consecutive items
    for (int b = f0; b < f1; b += SCAN_THREADS) {
      const int f = b + threadIdx.x;
      float v = -INFINITY;
      if (f < f1) {
        const int p = f / a.L, s = f - p * a.L;
        const size_t slot = (size_t)__ldg(ci + p) * a.L + s;
        if (__ldg(a.lvalid + slot)) {
          float acc = first ? 0.0f : out[f];
          acc = adc_sum<W>(a.codes + slot * a.m + j0, lut_s, mc, acc);
          v = last ? __ldg(a.top_c + (size_t)q * a.P + p) + acc : acc;
          out[f] = v;
        } else if (last) {  // an empty or tombstoned slot: no code read
          out[f] = -INFINITY;
        }
      }
      if (last) {
        float g = v;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) g = fmaxf(g, __shfl_xor_sync(FULL, g, o));
        const int grp = (b + (threadIdx.x & ~31)) / GROUP;
        if (lane == 0 && grp < a.n_groups) a.gmax[(size_t)q * a.n_groups + grp] = g;
      }
    }
  }
}

__device__ __forceinline__ float unord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ unsigned long long make_key(uint32_t o, uint32_t i) {
  return ((unsigned long long)o << 32) | (unsigned long long)(0xFFFFFFFFu - i);
}

struct SelSmem {
  uint32_t hist[256];
  uint32_t warp_total[SEL_WARPS];
  uint32_t prefix, want;
  int n_gt;
  unsigned long long keys[MAX_S];
};

// Radix select of the n-th largest of n_items order keys (key(i) the
// i-th), 8 bits a pass, top bits first: returns it in sm.prefix, and in
// sm.want how many of the keys equal to it are among the n largest.  The
// keys are kept in `cache` when n_items <= CACHE (read once, in the first
// pass).  1 <= n <= n_items.  Every thread of the block calls it.
template <typename K>
__device__ void radix_kth(SelSmem& sm, uint32_t* cache, int n_items, int n, K key) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cached = n_items <= CACHE;
  uint32_t prefix = 0, mask = 0, want = (uint32_t)n;
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += SEL_THREADS) sm.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n_items; base += SEL_THREADS) {
      const int i = base + tid;
      bool in = false;
      uint32_t bin = 0;
      if (i < n_items) {
        uint32_t u;
        if (shift == 24) {
          u = key(i);
          if (cached) cache[i] = u;
        } else {
          u = cached ? cache[i] : key(i);
        }
        in = (u & mask) == prefix;
        bin = (u >> shift) & 255u;
      }
      const uint32_t active = __ballot_sync(FULL, in);
      if (in) {
        // one atomic per distinct bin of the warp
        const uint32_t peers = __match_any_sync(active, bin);
        if (lane == __ffs(peers) - 1) atomicAdd(&sm.hist[bin], (uint32_t)__popc(peers));
      }
    }
    __syncthreads();
    if (warp == 0) {
      // lane l holds bins 255 - 8 l down to 248 - 8 l: the top bins first
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c[j] = sm.hist[255 - 8 * lane - j];
        sum += c[j];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += t;
      }
      const uint32_t hit = __ballot_sync(FULL, inc >= want);
      if (lane == __ffs(hit) - 1) {
        uint32_t cum = inc - sum;
        for (int j = 0; j < 8; ++j) {
          if (cum + c[j] >= want) {
            sm.prefix = prefix | ((uint32_t)(255 - 8 * lane - j) << shift);
            sm.want = want - cum;
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    prefix = sm.prefix;
    want = sm.want;
    mask |= 255u << shift;
  }
}

// Block-wide ordered pass over n_items: calls take(i, rank) for every item
// with pick(i) true, rank its count among the picked items before it (in
// item order).  Returns the count.  Every thread of the block calls it.
template <typename Pick, typename Take>
__device__ int ordered_pass(SelSmem& sm, int n_items, Pick pick, Take take) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  uint32_t taken = 0;  // picked items before this chunk (the same in every thread)
  for (int base = 0; base < n_items; base += SEL_THREADS) {
    const int i = base + tid;
    const bool hit = i < n_items && pick(i);
    const uint32_t bal = __ballot_sync(FULL, hit);
    if (lane == 0) sm.warp_total[warp] = __popc(bal);
    __syncthreads();
    uint32_t before = taken + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < SEL_WARPS; ++w) {
      if (w < warp) before += sm.warp_total[w];
      total += sm.warp_total[w];
    }
    if (hit) take(i, before);
    taken += total;
    __syncthreads();
  }
  return (int)taken;
}

__global__ void __launch_bounds__(SEL_THREADS) adc_select_kernel(Args a) {
  extern __shared__ uint32_t cache[];  // [CACHE] order keys
  __shared__ SelSmem sm;
  const int q = blockIdx.x, tid = threadIdx.x;
  const float* sc = a.scores + (size_t)q * a.n_items;
  const float* gm = a.gmax + (size_t)q * a.n_groups;
  int* cg = a.cgroups + (size_t)q * a.n_groups;
  const int n = a.S, G = a.n_groups;
  // the candidate groups: those whose maximum is >= the n-th largest maximum
  uint32_t t_ord = 0;
  if (G > n) {
    radix_kth(sm, cache, G, n, [&](int g) { return ord(__ldcg(gm + g)); });
    t_ord = sm.prefix;
  }
  __syncthreads();
  const bool gcached = G <= CACHE && G > n;
  const int n_cg = ordered_pass(
      sm, G, [&](int g) { return (gcached ? cache[g] : ord(__ldcg(gm + g))) >= t_ord; },
      [&](int g, uint32_t rank) { cg[rank] = g; });
  __syncthreads();  // the candidate list (global) is complete for the block
  // the candidates' items, in ascending flat order; past n_items: key 0
  // (below every score's key: never taken, there being >= n real items)
  const int n_c = n_cg * GROUP;
  auto flat = [&](int i) { return cg[i / GROUP] * GROUP + i % GROUP; };
  auto key = [&](int i) {
    const int f = flat(i);
    return f < a.n_items ? ord(__ldcg(sc + f)) : 0u;
  };
  radix_kth(sm, cache, n_c, n, key);
  const uint32_t prefix = sm.prefix, want = sm.want;
  const bool cached = n_c <= CACHE;
  // every key above prefix, then the first `want` equal to it in item order
  const int n_gt = n - (int)want;
  if (tid == 0) sm.n_gt = 0;
  __syncthreads();
  for (int base = 0; base < n_c; base += SEL_THREADS) {
    const int i = base + tid;
    if (i < n_c) {
      const uint32_t u = cached ? cache[i] : key(i);
      if (u > prefix) sm.keys[atomicAdd(&sm.n_gt, 1)] = make_key(u, (uint32_t)flat(i));
    }
  }
  ordered_pass(
      sm, n_c, [&](int i) { return (cached ? cache[i] : key(i)) == prefix; },
      [&](int i, uint32_t rank) {
        if (rank < want) sm.keys[n_gt + rank] = make_key(prefix, (uint32_t)flat(i));
      });
  // bitonic sort of the n keys, descending, padded to a power of two with 0
  int np = 1;
  while (np < n) np <<= 1;
  for (int i = n + tid; i < np; i += SEL_THREADS) sm.keys[i] = 0;
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < np; i += SEL_THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = sm.keys[i], y = sm.keys[j];
          if (((i & size) == 0) ? (x < y) : (x > y)) {
            sm.keys[i] = y;
            sm.keys[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < n; r += SEL_THREADS) {
    const unsigned long long k = sm.keys[r];
    const int f = (int)(0xFFFFFFFFu - (uint32_t)k);
    const int p = f / a.L, s = f - p * a.L;
    const int l = a.top_ci[(size_t)q * a.P + p];
    a.out_scores[(size_t)q * n + r] = unord((uint32_t)(k >> 32));
    a.out_pos[(size_t)q * n + r] = a.rowpos[(size_t)l * a.L + s];
  }
}

template <int W>
cudaError_t launch_scan(const Args& a, int Q, cudaStream_t stream) {
  const int smem = min(a.m, LUT_CHUNK) * CODES * (int)sizeof(float);
  // past 48 KB only with the attribute raised (on the current device)
  const cudaError_t e = cudaFuncSetAttribute(
      adc_scan_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((a.n_items + a.span - 1) / a.span, Q);
  adc_scan_kernel<W><<<grid, SCAN_THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ADC shortlist: codes [nlist, L, m] uint8, lvalid [nlist, L] bool, rowpos
// [nlist, L] int32, top_ci [Q, P] int32 (lists in [0, nlist)), top_c [Q, P]
// f32, lut [Q, m, 256] f32 (16-byte aligned), all contiguous; scratch
// Q (P L + 2 G) floats, G = ceil(P L / 32); out_scores [Q, S] f32 and
// out_pos [Q, S] int32.  1 <= S <= min(P L, 2048), P L < 2^31, span a
// multiple of 512.  Returns cudaGetLastError(), or cudaErrorInvalidValue
// for arguments the kernels do not take.
extern "C" int dabt_ann_adc(const void* codes, const void* lvalid, const void* rowpos,
                            const void* top_ci, const void* top_c, const void* lut,
                            void* scratch, void* out_scores, void* out_pos, int nlist, int L,
                            int m, int Q, int P, int S, int span, void* stream) {
  const long long n_items = (long long)P * L;
  if (nlist < 1 || L < 1 || m < 1 || Q < 1 || P < 1 || P > nlist || S < 1 || S > MAX_S ||
      S > n_items || n_items >= (1LL << 31) - GROUP || span < SCAN_THREADS ||
      span % SCAN_THREADS != 0 || codes == nullptr || lvalid == nullptr ||
      rowpos == nullptr || top_ci == nullptr || top_c == nullptr || lut == nullptr ||
      scratch == nullptr || out_scores == nullptr || out_pos == nullptr ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const int G = (int)((n_items + GROUP - 1) / GROUP);
  Args a;
  a.codes = static_cast<const uint8_t*>(codes);
  a.lvalid = static_cast<const uint8_t*>(lvalid);
  a.rowpos = static_cast<const int*>(rowpos);
  a.top_ci = static_cast<const int*>(top_ci);
  a.top_c = static_cast<const float*>(top_c);
  a.lut = static_cast<const float*>(lut);
  a.scores = static_cast<float*>(scratch);
  a.gmax = a.scores + (size_t)Q * n_items;
  a.cgroups = reinterpret_cast<int*>(a.gmax + (size_t)Q * G);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_pos = static_cast<int*>(out_pos);
  a.L = L;
  a.m = m;
  a.P = P;
  a.S = S;
  a.span = span;
  a.n_items = (int)n_items;
  a.n_groups = G;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  a.word = (m % 16 == 0 && base % 16 == 0) ? 16 : (m % 4 == 0 && base % 4 == 0) ? 4 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e = a.word == 16 ? launch_scan<16>(a, Q, st)
                  : a.word == 4 ? launch_scan<4>(a, Q, st)
                                : launch_scan<1>(a, Q, st);
  if (e != cudaSuccess) return (int)e;
  const int cache_bytes = CACHE * (int)sizeof(uint32_t);
  e = cudaFuncSetAttribute(adc_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           cache_bytes);
  if (e != cudaSuccess) return (int)e;
  adc_select_kernel<<<Q, SEL_THREADS, cache_bytes, st>>>(a);
  return (int)cudaGetLastError();
}
