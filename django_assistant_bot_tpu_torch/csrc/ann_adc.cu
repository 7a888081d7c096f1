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
// The index also hands over fill [nlist] int32, each list's high-water mark
// (the slots ever handed out; tombstones do not lower it): every slot at or
// past it is invalid.  The kernel reads no slot past a fill.
//
// What bounds it on the H100: bytes.  A query reads its P probed lists'
// validity up to their fills and, for their valid slots, the m code bytes;
// the LUT (m 256 4 = 96 KB a query) beside them.  The operations (one table
// lookup and one addition per code byte) are far below the card's rate.
// Every list is padded to the fullest one's capacity L (on the 2,000,000 x
// 768 corpus of chip_smoke.py 30,592 slots against an average fill of 488),
// so a scan over the padding would read 60x the live slots' validity and
// write a score for each.
//
// Design: one kernel, grid (B, Q), 512 threads; B (blocks a query), the LUT
// chunk and the candidate buffer come from `kernels.ann_adc_plan`.
//   1. The live tiles.  A block walks its query's probes in chunks of
//      PCH: each probe's fill, clamped to [0, L], gives ceil(fill / 32)
//      tiles of 32 slots (a warp's); a block-wide prefix sum numbers them
//      across the probes.  Block b takes every B-th tile of the query
//      (tiles t with t mod B = b), so the blocks' shares differ by one tile
//      at most whatever the fills; a round gives each warp one tile, found
//      by a binary search of the prefix.  No slot past a fill is touched.
//   2. The scores.  The block stages its query's LUT in shared memory once
//      (or, past the chunk the plan allows, a chunk at a time each round,
//      the partial sums in registers so the order stays j-ascending); a
//      lane scores one slot below the fill (a tombstone too, so its code
//      loads need not wait for its validity byte; it is dropped after): its
//      m code bytes as 16-byte words (4-byte or single bytes when m or the
//      base is not so aligned) and its m lookups from shared memory.
//   3. The block's candidates, in shared memory: 64-bit keys (the score's
//      order key, then the inverted flat index, so keys are unique and the
//      result does not depend on the order the threads run in).  A key
//      above the block's threshold joins the buffer; when the buffer holds
//      more than 2 S after a round (but the block's last), a radix select
//      (8-bit digits, top first, stopping as soon as the digit's bin holds
//      exactly the keys still wanted) keeps the top S and the threshold
//      rises to the S-th key.  At the end the block selects its top S the
//      same way, sorts them (bitonic) and writes them, zeros past its
//      count, to its slot of the query's [B, S] candidate scratch.
//   4. The merge.  The last block of a query to take a ticket (the counter
//      resets, so a CUDA graph replays) loads the query's B lists into
//      shared memory.  Where fewer than S of their keys score above -inf
//      (the probes hold fewer than S valid slots), the -inf tail comes
//      next as one more list: the lowest invalid flat indices, in flat
//      order a probe at a time (tombstones inside the fill, read from
//      lvalid, then the slots past it, which need no read).  The lists are
//      merged in pairs, each merge keeping the top S (a thread a run of
//      outputs from a binary search of the merge path), until one is
//      left; the block writes its scores and looks up the row positions.
// Shared memory: the LUT chunk and the buffer (2 S + 512 keys), or the
// merge's lists (B + 1, then half as many for the first merge's outputs),
// whichever is larger, then S rounded up to a power of two keys (the
// select's output and the block's sort); at most 222 KB.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;      // kernels.ANN_ADC_THREADS
constexpr int WARPS = THREADS / 32;
constexpr int CODES = 256;
constexpr int TILE = 32;          // slots a tile: a warp's
constexpr int PCH = 256;          // probes a chunk of the tile walk
constexpr int RUN = 4;            // merge outputs a thread takes at once
constexpr int MAX_S = 2048;       // storage/ann.py MAX_SHORTLIST
constexpr int MAX_SMEM = 222 * 1024;  // dynamic shared memory a block, at most
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr uint32_t ORD_NEG_INF = 0x007FFFFFu;  // ord(-inf)

typedef unsigned long long u64;

struct Args {
  const uint8_t* codes;   // [nlist, L, m]
  const uint8_t* lvalid;  // [nlist, L]
  const int* rowpos;      // [nlist, L]
  const int* fill;        // [nlist]
  const int* top_ci;      // [Q, P], rows ldi apart
  const float* top_c;     // [Q, P], rows ldc apart
  const float* lut;       // [Q, m, 256]: q lq, j lj floats apart, codes contiguous
  u64* cand;              // [Q, B, S] scratch: the blocks' sorted candidates
  int* counters;          // [Q]: the tickets (left at 0)
  float* out_scores;      // [Q, S]
  int* out_pos;           // [Q, S]
  int L, m, P, S, B, Q, chunk, ldi, ldc, lq, lj;
  int region;  // bytes before the select's keys
};

struct Smem {
  uint32_t hist[256];
  int warp_total[WARPS];
  u64 prefix, thr;
  uint32_t want;
  int done, count, kept, last, n_hi;
  int lst[PCH], fil[PCH], pre[PCH + 1];
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

__device__ __forceinline__ float unord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// (order key, inverted flat index): above 0 for every flat index < 2^31
__device__ __forceinline__ u64 make_key(uint32_t o, uint32_t f) {
  return ((u64)o << 32) | (u64)(0xFFFFFFFFu - f);
}

// stage mc subspaces of a LUT (rows of 256 floats lj apart, 16-byte
// aligned) into shared memory
__device__ __forceinline__ void stage_lut(float* lut_s, const float* src, int mc, int lj) {
  float4* d4 = reinterpret_cast<float4*>(lut_s);
  for (int i = threadIdx.x; i < mc * CODES / 4; i += THREADS) {
    const int j = i / (CODES / 4), c4 = i - j * (CODES / 4);
    d4[i] = __ldg(reinterpret_cast<const float4*>(src + (size_t)j * lj) + c4);
  }
}

// the warp's lanes with `in` write `key` at dst[*count ...] (one shared
// atomic a warp); every lane of the warp calls it
__device__ __forceinline__ void push(int* count, u64* dst, bool in, u64 key) {
  const int lane = threadIdx.x & 31;
  const uint32_t bal = __ballot_sync(FULL, in);
  if (!bal) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(bal));
  base = __shfl_sync(FULL, base, 0);
  if (in) dst[base + __popc(bal & ((1u << lane) - 1u))] = key;
}

// Radix select over n_items unique 64-bit keys in shared memory: returns lo
// such that exactly n keys are >= lo.  Digits of 8 bits, top first; it
// stops where the chosen digit's bin holds exactly the keys still wanted (lo
// then has the lower digits 0).  1 <= n <= n_items.  Every thread calls it.
__device__ u64 radix_kth(Smem& sm, const u64* keys, int n_items, int n) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  u64 prefix = 0, mask = 0;
  uint32_t want = (uint32_t)n;
  for (int shift = 56; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) sm.hist[i] = 0;
    __syncthreads();
    for (int base = 0; base < n_items; base += THREADS) {
      const int i = base + tid;
      bool in = false;
      uint32_t bin = 0;
      if (i < n_items) {
        const u64 u = keys[i];
        in = (u & mask) == prefix;
        bin = (uint32_t)(u >> shift) & 255u;
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
            sm.prefix = prefix | ((u64)(255 - 8 * lane - j) << shift);
            sm.want = want - cum;
            sm.done = c[j] == want - cum;
            break;
          }
          cum += c[j];
        }
      }
    }
    __syncthreads();
    // sm.prefix, want and done are written again only after two more syncs
    prefix = sm.prefix;
    want = sm.want;
    mask |= (u64)255 << shift;
    if (sm.done) break;
  }
  return prefix;
}

// the top S of keys[0, n) (n > S) into sel[0, S), in no order.  Every
// thread calls it.  Returns the radix select's lo (all S keys are >= lo).
__device__ u64 select_top(Smem& sm, const u64* keys, int n, int S, u64* sel) {
  const u64 lo = radix_kth(sm, keys, n, S);
  if (threadIdx.x == 0) sm.kept = 0;
  __syncthreads();
  for (int base = 0; base < n; base += THREADS) {
    const int i = base + threadIdx.x;
    const u64 k = i < n ? keys[i] : 0;
    push(&sm.kept, sel, i < n && k >= lo, k);
  }
  __syncthreads();
  return lo;
}

// one compare-exchange of a bitonic sort in registers: element i (held by
// this lane) and i ^ st (lane ^ st of the same warp), in a block of `size`
// sorted descending where i & size is 0, else ascending
__device__ __forceinline__ u64 bitonic_step(u64 x, int i, int size, int st) {
  const u64 y = __shfl_xor_sync(FULL, x, st);
  const bool keep_max = ((i & st) == 0) == ((i & size) == 0);
  return keep_max ? (x > y ? x : y) : (x < y ? x : y);
}

// sort keys[0, n) descending, n a power of two.  Every thread calls it.
// From n = 64 the strides below 32 run in registers, an element a lane
// (the warps hold whole runs of 32): sizes up to 32 in one pass, then for
// each larger size its strides from 32 up in shared memory and the rest in
// one register pass.
__device__ void bitonic_desc(u64* keys, int n) {
  const int tid = threadIdx.x;
  int size = 2;
  if (n >= 64) {
    for (int i = tid; i < n; i += THREADS) {
      u64 x = keys[i];
      for (int sz = 2; sz <= 32; sz <<= 1)
        for (int st = sz >> 1; st > 0; st >>= 1) x = bitonic_step(x, i, sz, st);
      keys[i] = x;
    }
    __syncthreads();
    size = 64;
  }
  for (; size <= n; size <<= 1) {
    int stride = size >> 1;
    for (; stride > 0 && (stride >= 32 || n < 64); stride >>= 1) {
      for (int i = tid; i < n; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const u64 x = keys[i], y = keys[j];
          if (((i & size) == 0) ? (x < y) : (x > y)) {
            keys[i] = y;
            keys[j] = x;
          }
        }
      }
      __syncthreads();
    }
    if (stride > 0) {
      for (int i = tid; i < n; i += THREADS) {
        u64 x = keys[i];
        for (int st = stride; st > 0; st >>= 1) x = bitonic_step(x, i, size, st);
        keys[i] = x;
      }
      __syncthreads();
    }
  }
}

// Block-wide ordered pass over n_items: calls take(i, rank) for every item
// with pick(i) true, rank its count among the picked items before it (in
// item order).  Returns the count.  Every thread of the block calls it.
template <typename Pick, typename Take>
__device__ int ordered_pass(Smem& sm, int n_items, Pick pick, Take take) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int taken = 0;  // picked items before this chunk (the same in every thread)
  for (int base = 0; base < n_items; base += THREADS) {
    const int i = base + tid;
    const bool hit = i < n_items && pick(i);
    const uint32_t bal = __ballot_sync(FULL, hit);
    if (lane == 0) sm.warp_total[warp] = __popc(bal);
    __syncthreads();
    int before = taken + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += sm.warp_total[w];
      total += sm.warp_total[w];
    }
    if (hit) take(i, before);
    taken += total;
    __syncthreads();
  }
  return taken;
}

template <int W>
__global__ void __launch_bounds__(THREADS, 2) adc_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ Smem sm;
  float* lut_s = reinterpret_cast<float*>(smem);
  u64* buf = reinterpret_cast<u64*>(smem + (size_t)a.chunk * CODES * sizeof(float));
  u64* cache = reinterpret_cast<u64*>(smem);  // the merge's keys (the LUT is done)
  u64* sel = reinterpret_cast<u64*>(smem + a.region);
  const int q = blockIdx.y, b = blockIdx.x, tid = threadIdx.x, lane = tid & 31,
            warp = tid >> 5;
  const int S = a.S, L = a.L;
  int np2 = 1;  // S rounded up to a power of two: the block's sort
  while (np2 < S) np2 <<= 1;
  const float* lut_q = a.lut + (size_t)q * a.lq;
  const int* ci = a.top_ci + (size_t)q * a.ldi;
  const float* tc = a.top_c + (size_t)q * a.ldc;
  const bool one_chunk = a.chunk >= a.m;
  if (one_chunk) stage_lut(lut_s, lut_q, a.m, a.lj);  // the first walk's sync orders it
  if (tid == 0) {
    sm.count = 0;
    sm.thr = 0;
  }

  // ---- the scan: this block's live tiles, a probe chunk at a time
  int g0 = 0;  // tiles of the probes before the chunk
  for (int pc0 = 0; pc0 < a.P; pc0 += PCH) {
    const int np = min(PCH, a.P - pc0);
    __syncthreads();  // the previous chunk's readers are done
    int tiles = 0;
    if (tid < np) {
      const int l = __ldg(ci + pc0 + tid);
      const int f = min(max(__ldg(a.fill + l), 0), L);
      sm.lst[tid] = l;
      sm.fil[tid] = f;
      tiles = (f + TILE - 1) / TILE;
    }
    int inc = tiles;  // the warp's inclusive prefix
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(FULL, inc, o);
      if (lane >= o) inc += t;
    }
    if (lane == 31) sm.warp_total[warp] = inc;
    __syncthreads();
    if (tid < np) {
      for (int w = 0; w < warp; ++w) inc += sm.warp_total[w];
      sm.pre[tid + 1] = inc;
    }
    if (tid == 0) sm.pre[0] = 0;
    __syncthreads();
    const int n_tiles = sm.pre[np];
    // this block's tiles of the chunk: t0, t0 + B, ... (global tile g0 + t)
    const int t0 = ((b - g0) % a.B + a.B) % a.B;
    const int mine = t0 < n_tiles ? (n_tiles - t0 + a.B - 1) / a.B : 0;
    for (int r0 = 0; r0 < mine; r0 += WARPS) {  // a round: one tile a warp
      const int k = r0 + warp;
      bool in_fill = false, valid = false;
      int p = 0, s = 0;
      size_t slot = 0;
      if (k < mine) {
        const int t = t0 + k * a.B;
        int lo = 0, hi = np - 1;  // the last probe whose tiles start at or before t
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (sm.pre[mid] <= t) lo = mid;
          else hi = mid - 1;
        }
        p = lo;
        s = (t - sm.pre[p]) * TILE + lane;
        slot = (size_t)sm.lst[p] * L + s;
        in_fill = s < sm.fil[p];
        valid = in_fill && __ldg(a.lvalid + slot);
      }
      float acc = 0.0f;
      for (int j0 = 0; j0 < a.m; j0 += a.chunk) {
        const int mc = min(a.chunk, a.m - j0);
        if (!one_chunk) {
          __syncthreads();  // the previous chunk's readers are done
          stage_lut(lut_s, lut_q + (size_t)j0 * a.lj, mc, a.lj);
          __syncthreads();
        }
        // a tombstone inside the fill is scored too: its codes load beside
        // its validity instead of after it
        if (in_fill) acc = adc_sum<W>(a.codes + slot * a.m + j0, lut_s, mc, acc);
      }
      u64 key = 0;
      if (valid) key = make_key(ord(__ldg(tc + pc0 + p) + acc), (uint32_t)((pc0 + p) * L + s));
      push(&sm.count, buf, key > sm.thr, key);
      __syncthreads();
      const int n = sm.count;
      __syncthreads();  // every warp has read the count before the next push
      // keep the top S and raise the threshold to the S-th key, but after
      // the block's last round (the end takes its top S from the buffer)
      if (n > 2 * S && !(pc0 + PCH >= a.P && r0 + WARPS >= mine)) {
        const u64 lo = select_top(sm, buf, n, S, sel);
        for (int i = tid; i < S; i += THREADS) buf[i] = sel[i];
        if (tid == 0) {
          sm.count = S;
          sm.thr = lo ? lo - 1 : 0;  // keys >= lo join
        }
        __syncthreads();
      }
    }
    g0 += n_tiles;
  }

  // ---- the block's top S, sorted, into its query's candidate lists; the ticket
  __syncthreads();
  const int cnt = sm.count;
  if (cnt > S) {
    select_top(sm, buf, cnt, S, sel);
  } else {
    for (int i = tid; i < cnt; i += THREADS) sel[i] = buf[i];
  }
  for (int i = min(cnt, S) + tid; i < np2; i += THREADS) sel[i] = 0;  // 0: below every key
  __syncthreads();
  bitonic_desc(sel, np2);
  u64* cq = a.cand + (size_t)q * a.B * S;
  for (int i = tid; i < S; i += THREADS) cq[(size_t)b * S + i] = sel[i];
  __threadfence();
  __syncthreads();
  if (tid == 0) sm.last = atomicAdd(a.counters + q, 1) == a.B - 1;
  __syncthreads();
  if (!sm.last) return;
  __threadfence();
  if (tid == 0) {
    atomicExch(a.counters + q, 0);  // reset: a graph replays
    sm.n_hi = 0;
  }
  // the B lists into shared memory, counting the keys above -inf
  int hi = 0;
  for (int i = tid; i < a.B * S; i += THREADS) {
    const u64 k = __ldcg(cq + i);
    cache[i] = k;
    hi += (uint32_t)(k >> 32) > ORD_NEG_INF;
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) hi += __shfl_xor_sync(FULL, hi, o);
  __syncthreads();
  if (lane == 0 && hi) atomicAdd(&sm.n_hi, hi);
  __syncthreads();

  // ---- the -inf tail, one more list: the lowest invalid flat indices, a
  // probe at a time (descending keys)
  int lists = a.B;
  if (sm.n_hi < S) {
    u64* tl = cache + (size_t)a.B * S;
    for (int i = tid; i < S; i += THREADS) tl[i] = 0;
    __syncthreads();
    int need = S - sm.n_hi, t = 0;
    for (int p = 0; p < a.P && need > 0; ++p) {
      const int l = __ldg(ci + p);
      const int f = min(max(__ldg(a.fill + l), 0), L);
      const uint8_t* v = a.lvalid + (size_t)l * L;
      const int fp = p * L;
      const int got = ordered_pass(
          sm, f, [&](int s) { return !__ldg(v + s); },
          [&](int s, int rank) {
            if (rank < need) tl[t + rank] = make_key(ORD_NEG_INF, (uint32_t)(fp + s));
          });
      const int t_in = min(got, need);
      t += t_in;
      need -= t_in;
      const int t_past = min(L - f, need);
      for (int i = tid; i < t_past; i += THREADS)
        tl[t + i] = make_key(ORD_NEG_INF, (uint32_t)(fp + f + i));
      t += t_past;
      need -= t_past;
    }
    lists += 1;
    __syncthreads();
  }

  // ---- the lists merged in pairs, each merge keeping the top S, until one
  // is left: a thread a run of RUN outputs, its start found by a binary
  // search of the merge path (equal keys, only the zeros, the left first)
  u64* src = cache;
  u64* dst = cache + (size_t)(a.B + 1) * S;
  while (lists > 1) {
    const int outs = (lists + 1) / 2, runs = (S + RUN - 1) / RUN;
    for (int r = tid; r < outs * runs; r += THREADS) {
      const int o = r / runs, k0 = (r - o * runs) * RUN, k1 = min(k0 + RUN, S);
      const u64* x = src + (size_t)(2 * o) * S;
      u64* d = dst + (size_t)o * S;
      if (2 * o + 1 == lists) {  // the odd list out: copied
        for (int k = k0; k < k1; ++k) d[k] = x[k];
        continue;
      }
      const u64* y = x + S;
      int lo = max(0, k0 - S), hi2 = min(k0, S);
      while (lo < hi2) {  // lo: the outputs before k0 taken from x
        const int mid = (lo + hi2) >> 1;
        if (x[mid] >= y[k0 - 1 - mid]) lo = mid + 1;
        else hi2 = mid;
      }
      int i = lo, j = k0 - lo;
      for (int k = k0; k < k1; ++k) d[k] = (j >= S || (i < S && x[i] >= y[j])) ? x[i++] : y[j++];
    }
    __syncthreads();
    u64* t = src;
    src = dst;
    dst = t;
    lists = outs;
  }
  for (int r = tid; r < S; r += THREADS) {
    const u64 k = src[r];
    const int f = (int)(0xFFFFFFFFu - (uint32_t)k);
    const int p = f / L, s = f - p * L;
    const int l = __ldg(ci + p);
    a.out_scores[(size_t)q * S + r] = unord((uint32_t)(k >> 32));
    a.out_pos[(size_t)q * S + r] = __ldg(a.rowpos + (size_t)l * L + s);
  }
}

template <int W>
cudaError_t launch(const Args& a, int smem, cudaStream_t stream) {
  // past 48 KB only with the attribute raised (on the current device)
  const cudaError_t e =
      cudaFuncSetAttribute(adc_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return e;
  adc_kernel<W><<<dim3(a.B, a.Q), THREADS, smem, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// ADC shortlist: codes [nlist, L, m] uint8, lvalid [nlist, L] bool, rowpos
// [nlist, L] int32, fill [nlist] int32 (each list's high-water mark: lvalid
// false at and past it), top_ci [Q, P] int32 (lists in [0, nlist); rows ldi
// >= P apart), top_c [Q, P] f32 (rows ldc >= P apart: a top-k's slices are
// read in place), lut [Q, m, 256] f32 (16-byte aligned; queries lq, subspaces
// lj >= 256 floats apart, both multiples of 4: an einsum's [m, Q, 256]
// layout is read in place), the others contiguous; cand a
// Q blocks S u64 scratch (8-byte aligned) and counters Q int32 at zero
// (left at zero); out_scores [Q, S] f32 and out_pos [Q, S] int32.  The plan
// (`kernels.ann_adc_plan`): blocks a query, chunk (LUT subspaces staged at
// once: m, or a multiple of 16 below it) and cap (the block's candidate
// buffer, >= 2 S + 512 keys).  1 <= S <= min(P L, 2048), P L < 2^31 - 32.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take (shared memory past 222 KB among them).
extern "C" int dabt_ann_adc(const void* codes, const void* lvalid, const void* rowpos,
                            const void* fill, const void* top_ci, const void* top_c,
                            const void* lut, void* cand, void* counters, void* out_scores,
                            void* out_pos, int nlist, int L, int m, int Q, int P, int S,
                            int blocks, int chunk, int cap, int ldi, int ldc, int lq, int lj,
                            void* stream) {
  const long long n_items = (long long)P * L;
  if (nlist < 1 || L < 1 || m < 1 || Q < 1 || Q > 65535 || P < 1 || P > nlist || S < 1 ||
      S > MAX_S || S > n_items || n_items >= (1LL << 31) - 32 || blocks < 1 || chunk < 1 ||
      (chunk < m && chunk % 16 != 0) || cap < 2 * S + THREADS || ldi < P || ldc < P ||
      lq < 0 || lq % 4 != 0 || lj % 4 != 0 || (m > 1 && lj < CODES) || codes == nullptr ||
      lvalid == nullptr || rowpos == nullptr || fill == nullptr || top_ci == nullptr ||
      top_c == nullptr || lut == nullptr || cand == nullptr || counters == nullptr ||
      out_scores == nullptr || out_pos == nullptr ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0 || reinterpret_cast<uintptr_t>(cand) % 8 != 0)
    return (int)cudaErrorInvalidValue;
  const long long chunk_eff = chunk < m ? chunk : m;
  const long long scan = chunk_eff * CODES * 4 + (long long)cap * 8;
  // the merge: the B lists and the tail, then half as many for the pairs' outputs
  const long long merge = ((long long)blocks + 1 + (blocks + 2) / 2) * S * 8;
  const long long region = ((scan > merge ? scan : merge) + 15) / 16 * 16;
  int np2 = 1;
  while (np2 < S) np2 <<= 1;
  const long long smem = region + (long long)np2 * 8;
  if (smem > MAX_SMEM) return (int)cudaErrorInvalidValue;
  Args a;
  a.codes = static_cast<const uint8_t*>(codes);
  a.lvalid = static_cast<const uint8_t*>(lvalid);
  a.rowpos = static_cast<const int*>(rowpos);
  a.fill = static_cast<const int*>(fill);
  a.top_ci = static_cast<const int*>(top_ci);
  a.top_c = static_cast<const float*>(top_c);
  a.lut = static_cast<const float*>(lut);
  a.cand = static_cast<u64*>(cand);
  a.counters = static_cast<int*>(counters);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_pos = static_cast<int*>(out_pos);
  a.L = L;
  a.m = m;
  a.P = P;
  a.S = S;
  a.B = blocks;
  a.Q = Q;
  a.chunk = (int)chunk_eff;
  a.ldi = ldi;
  a.ldc = ldc;
  a.lq = lq;
  a.lj = lj;
  a.region = (int)region;
  const uintptr_t base = reinterpret_cast<uintptr_t>(codes);
  const int word = (m % 16 == 0 && base % 16 == 0) ? 16 : (m % 4 == 0 && base % 4 == 0) ? 4 : 1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t e = word == 16 ? launch<16>(a, (int)smem, st)
                        : word == 4 ? launch<4>(a, (int)smem, st)
                                    : launch<1>(a, (int)smem, st);
  return (int)e;
}
