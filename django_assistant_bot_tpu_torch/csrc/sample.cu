// Fused masked top-k / top-p / Gumbel draw / JSON FSM advance for Hopper
// (sm_90a): one sampling step of the decode loop, one launch.
//
// Replaces: django_assistant_bot_tpu/ops/sampling.py `sample_logits`
// (:73-140) with the exact top-k it calls, `top_k_auto` /
// `top_k_hierarchical` (:22-67), and the JSON grammar mask and FSM advance
// around it in serving/engine.py `_make_decode_tick` (:1070-1079) and
// `_make_activate` (:999-1013).  For logits [B, V] (f32 or bf16, read as
// f32), per row b (the plain twin, `ops/sampling.py` `sample_logits_plain`):
//
//   x[v]  = NEG_INF where json[b] and !allowed[state[b], v], else logits[b, v]
//   x[v] /= t'         t' = temperature[b] if > 0, else 1 (an IEEE division)
//   the top k of x, descending; V >= 16384: `top_k_hierarchical` (the top
//     k 128-lane groups by their maximum, pad lanes NEG_INF, then the top k
//     of those groups' lanes), else over all V; equal values in the
//     functions' order: groups by maximum, the lower group first, then the
//     candidates in that group order (rank * 128 + lane), or, flat, the
//     lower index first; out-of-vocab pad lanes clamp to V - 1
//   e_j = exp(v_j - v_0), s = e_0 + e_1 + ... (in that order), p_j = e_j / s,
//   c_j = p_0 + ... + p_j (in that order), keep_j = (c_j - p_j) < top_p[b]
//   choice = the first argmax of (keep_j ? v_j : NEG_INF) + gumbel[b, j]
//   id[b] = temperature[b] > 0 ? idx[choice] : idx[0]
//   state_out[b] = json[b] ? next_state[state[b], min(id, V - 1)] : state[b]
//
// What bounds it on the H100: bytes.  The logits are read once (B V 4 bytes
// in f32: 4.10 MB at B = 8, V = 128,256, 1.2 us at 3.35 TB/s), and a JSON
// step reads the B mask rows of V bytes too (1.5 us).  The operations (a
// compare per element, a division) are far below the card's rate.  The
// library route is about twenty launches (max per group, top-k of groups,
// gather, top-k, softmax, cumsum, the draw...), each a pass over small
// tensors with a launch's latency.
//
// Design: one launch, grid (splits, B), 256 threads a block.
//   1. (V >= 16384) the `splits` blocks of a row each take a range of the
//      row's G = ceil(V / 128) groups, a warp a group at a time (four
//      groups' loads in flight a warp), and write each group's masked,
//      scaled maximum to gmax [B, G].  The last block of the row to finish
//      (a per-row counter, as qgemm's split K: fence, atomic add, the last
//      resets it to 0) goes on alone.
//   2. That block selects the row's top kg = min(k, G) groups: a radix
//      select (four 8-bit passes over the order key of each value) finds
//      the kg-th largest maximum and how many of the maxima equal to it
//      are in; one ordered pass takes every group above it and the first
//      of those equal to it, in group order (a block-wide prefix count), and
//      a bitonic sort of the kg 64-bit keys (value, then the lower position)
//      orders them.  The same select over the kg * 128 candidate lanes
//      (recomputed from the logits, their order keys kept in shared memory)
//      gives the top k.  (V < 16384: the select runs over all V lanes
//      directly, grid (1, B).)  The keys are unique (a position is in each),
//      so the result does not depend on the order the threads run in.
//   3. The block computes the k values' e_j and loads their noise, a
//      thread an entry; one thread then does the sequential sums, top-p,
//      the draw and the FSM advance over the k sorted values, in the plain
//      twin's order, so `keep` rounds as it does there.
// The design reads each logit once in pass 1 and the candidates' again (L2
// hits); it uses B * splits blocks in pass 1 but only B in pass 2, whose
// serial parts (the selects' passes and syncs, the k-long sums) are what its
// time is made of at B = 8.  A faster form (the select spread over blocks,
// the sums by warp scans in a fixed order) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int GROUP = 128;          // lanes of a group (`_GROUP` of ops/sampling.py)
constexpr int HIER_MIN_VOCAB = 16384;  // `_HIER_TOPK_MIN_VOCAB`
constexpr int MAX_K = 256;
constexpr int CACHE = 8192;         // order keys of the candidates kept in shared memory
constexpr int GB = 4;               // groups a warp loads at once in pass 1
constexpr float NEG_INF = -1e30f;   // ops/attention.py NEG_INF
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const void* logits;      // [B, V] f32 or bf16
  const float* temperature;  // [B]
  const float* top_p;        // [B]
  const float* gumbel;       // [B, k]
  const uint8_t* allowed;    // [S, V] bool, or null (no JSON)
  const int* next_state;     // [S, V]
  const int* state;          // [B]
  const uint8_t* jmask;      // [B] bool
  int* ids;                  // [B]
  int* state_out;            // [B], or null (no JSON)
  float* gmax;               // [B, G] (V >= 16384)
  int* counters;             // [B], zero between calls
  int bf16, B, V, k, G, splits;
};

// a float's order key: unsigned compare of keys = float compare, -0 as +0
__device__ __forceinline__ uint32_t ord(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ uint64_t make_key(uint32_t o, uint32_t pos) {
  return ((uint64_t)o << 32) | (uint64_t)(0xFFFFFFFFu - pos);
}

struct Row {
  const float* f32;
  const __nv_bfloat16* bf;
  const uint8_t* mask;  // the row's allowed row, or null
  float t;              // the divisor t'
  int V;

  // the masked, scaled value of lane v; NEG_INF past the vocab (pad lanes)
  __device__ __forceinline__ float value(long v) const {
    if (v >= V) return NEG_INF;
    float x = f32 != nullptr ? __ldg(f32 + v) : __bfloat162float(bf[v]);
    if (mask != nullptr && !__ldg(mask + v)) x = NEG_INF;
    return x / t;
  }
};

__device__ Row row_of(const Args& a, int b) {
  Row r;
  const size_t off = (size_t)b * a.V;
  r.f32 = a.bf16 ? nullptr : static_cast<const float*>(a.logits) + off;
  r.bf = a.bf16 ? static_cast<const __nv_bfloat16*>(a.logits) + off : nullptr;
  const bool json = a.allowed != nullptr && a.jmask[b];
  r.mask = json ? a.allowed + (size_t)a.state[b] * a.V : nullptr;
  const float t = a.temperature[b];
  r.t = t > 0.0f ? t : 1.0f;
  r.V = a.V;
  return r;
}

struct Smem {
  uint32_t hist[256];
  uint32_t warp_total[WARPS];
  uint32_t prefix, want;
  int n_gt;
  int last;
  uint64_t keys[MAX_K];
  int groups[MAX_K];
  float vals[MAX_K], exps[MAX_K], noise[MAX_K];  // the k values, e_j, the draw's noise
  uint32_t cache[CACHE];
};

// The top n of n_items values (fetch(i) the i-th), as keys sorted
// descending in sm.keys[0, n): the value's order key, then the lower
// position first.  1 <= n <= min(n_items, MAX_K).
template <typename F>
__device__ void select_top(Smem& sm, int n_items, int n, F fetch) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const bool cached = n_items <= CACHE;
  uint32_t prefix = 0, mask = 0, want = (uint32_t)n;
  // radix select of the n-th largest order key, 8 bits a pass, top bits first
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int i = tid; i < 256; i += THREADS) sm.hist[i] = 0;
    __syncthreads();
#pragma unroll 4
    for (int i = tid; i < n_items; i += THREADS) {
      uint32_t u;
      if (shift == 24) {
        u = ord(fetch(i));
        if (cached) sm.cache[i] = u;
      } else {
        u = cached ? sm.cache[i] : ord(fetch(i));
      }
      if ((u & mask) == prefix) atomicAdd(&sm.hist[(u >> shift) & 255u], 1u);
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
  // prefix: the n-th largest key; want of those equal to it are in, and the
  // n - want above it.  One ordered pass takes them.
  const int n_gt = n - (int)want;
  if (tid == 0) sm.n_gt = 0;
  __syncthreads();
  uint32_t taken = 0;  // equal keys taken before this chunk (the same in every thread)
  for (int base = 0; base < n_items; base += THREADS) {
    const int i = base + tid;
    uint32_t u = 0;
    bool eq = false;
    if (i < n_items) {
      u = cached ? sm.cache[i] : ord(fetch(i));
      if (u > prefix) sm.keys[atomicAdd(&sm.n_gt, 1)] = make_key(u, (uint32_t)i);
      eq = u == prefix;
    }
    const uint32_t bal = __ballot_sync(FULL, eq);
    if (lane == 0) sm.warp_total[warp] = __popc(bal);
    __syncthreads();
    uint32_t before = taken + __popc(bal & ((1u << lane) - 1u)), total = 0;
    for (int w = 0; w < WARPS; ++w) {
      if (w < warp) before += sm.warp_total[w];
      total += sm.warp_total[w];
    }
    if (eq && before < want) sm.keys[n_gt + before] = make_key(u, (uint32_t)i);
    taken += total;
    __syncthreads();
  }
  // bitonic sort of the n keys, descending, padded to a power of two with 0
  int np = 1;
  while (np < n) np <<= 1;
  for (int i = n + tid; i < np; i += THREADS) sm.keys[i] = 0;
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < np; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const uint64_t a = sm.keys[i], b = sm.keys[j];
          if (((i & size) == 0) ? (a < b) : (a > b)) {
            sm.keys[i] = b;
            sm.keys[j] = a;
          }
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(THREADS) sample_kernel(Args a) {
  __shared__ Smem sm;
  const int b = blockIdx.y, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const Row row = row_of(a, b);
  const bool hier = a.V >= HIER_MIN_VOCAB;
  if (hier) {
    // pass 1: this block's groups' maxima
    const int g0 = (int)((long)blockIdx.x * a.G / a.splits);
    const int g1 = (int)((long)(blockIdx.x + 1) * a.G / a.splits);
    for (int g = g0 + warp * GB; g < g1; g += WARPS * GB) {
      float v[GB][GROUP / 32];
#pragma unroll
      for (int i = 0; i < GB; ++i)
#pragma unroll
        for (int j = 0; j < GROUP / 32; ++j)
          v[i][j] = g + i < g1 ? row.value((long)(g + i) * GROUP + lane + 32 * j) : NEG_INF;
#pragma unroll
      for (int i = 0; i < GB; ++i) {
        float m = v[i][0];
#pragma unroll
        for (int j = 1; j < GROUP / 32; ++j) m = fmaxf(m, v[i][j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(FULL, m, o));
        if (lane == 0 && g + i < g1) a.gmax[(size_t)b * a.G + g + i] = m;
      }
    }
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      const int done = atomicAdd(a.counters + b, 1);
      sm.last = done == a.splits - 1;
      if (sm.last) a.counters[b] = 0;  // every block of the row has arrived
    }
    __syncthreads();
    if (!sm.last) return;
    __threadfence();
    // pass 2: the top kg groups, then the top k of their lanes
    const float* gm = a.gmax + (size_t)b * a.G;
    const int kg = min(a.k, a.G);
    select_top(sm, a.G, kg, [&](int i) { return __ldcg(gm + i); });
    for (int r = tid; r < kg; r += THREADS) sm.groups[r] = (int)(0xFFFFFFFFu - (uint32_t)sm.keys[r]);
    __syncthreads();
    select_top(sm, kg * GROUP, a.k, [&](int i) {
      return row.value((long)sm.groups[i / GROUP] * GROUP + i % GROUP);
    });
  } else {
    select_top(sm, a.V, a.k, [&](int i) { return row.value(i); });
  }
  // 3. the values, e_j = exp(v_j - v_0) and the noise, a thread an entry;
  // then one thread sums in order: softmax, top-p, the draw, the advance
  const float v0 = unord((uint32_t)(sm.keys[0] >> 32));
  const float* noise = a.gumbel + (size_t)b * a.k;
  for (int j = tid; j < a.k; j += THREADS) {
    const float v = unord((uint32_t)(sm.keys[j] >> 32));
    sm.vals[j] = v;
    sm.exps[j] = expf(v - v0);
    sm.noise[j] = noise[j];
  }
  __syncthreads();
  if (tid != 0) return;
  float s = 0.0f;
  for (int j = 0; j < a.k; ++j) s += sm.exps[j];
  const float top_p = a.top_p[b];
  float cum = 0.0f, best = 0.0f;
  int choice = 0;
  for (int j = 0; j < a.k; ++j) {
    const float v = sm.vals[j];
    const float p = sm.exps[j] / s;
    cum += p;
    const float z = ((cum - p) < top_p ? v : NEG_INF) + sm.noise[j];
    if (j == 0 || z > best) {
      best = z;
      choice = j;
    }
  }
  const int pick = a.temperature[b] > 0.0f ? choice : 0;
  const uint32_t item = 0xFFFFFFFFu - (uint32_t)sm.keys[pick];
  int id = hier ? sm.groups[item / GROUP] * GROUP + (int)(item % GROUP) : (int)item;
  id = min(id, a.V - 1);
  a.ids[b] = id;
  if (a.state_out != nullptr) {
    const int st = a.state[b];
    a.state_out[b] = a.jmask[b] ? a.next_state[(size_t)st * a.V + id] : st;
  }
}

}  // namespace

// One sampling step: logits [B, V] (dtype 0 = f32, 1 = bf16, contiguous),
// temperature, top_p [B] f32, gumbel [B, k] f32, ids [B] int32 out; with a
// JSON FSM, allowed [S, V] bool, next_state [S, V] int32, state and
// state_out [B] int32 and jmask [B] bool (all null without one).  For V >=
// 16384, gmax holds B * ceil(V / 128) floats and counters B zeroed ints,
// which every call leaves at zero, and splits (>= 1) blocks share each
// row's first pass; below it splits must be 1.  1 <= k <= 256, k < V.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int dabt_sample(const void* logits, const void* temperature, const void* top_p,
                           const void* gumbel, const void* allowed, const void* next_state,
                           const void* state, const void* jmask, void* ids, void* state_out,
                           void* gmax, void* counters, int dtype, int B, int V, int k, int splits,
                           void* stream) {
  const int G = (V + GROUP - 1) / GROUP;
  const bool hier = V >= HIER_MIN_VOCAB;
  const bool json = allowed != nullptr;
  if (B < 1 || k < 1 || k > MAX_K || k >= V || (dtype != 0 && dtype != 1) || logits == nullptr ||
      temperature == nullptr || top_p == nullptr || gumbel == nullptr || ids == nullptr ||
      splits < 1 || (!hier && splits != 1) || (hier && (gmax == nullptr || counters == nullptr)) ||
      (json && (next_state == nullptr || state == nullptr || jmask == nullptr ||
                state_out == nullptr)) ||
      (!hier && V > (1 << 24)))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.logits = logits;
  a.temperature = static_cast<const float*>(temperature);
  a.top_p = static_cast<const float*>(top_p);
  a.gumbel = static_cast<const float*>(gumbel);
  a.allowed = static_cast<const uint8_t*>(allowed);
  a.next_state = static_cast<const int*>(next_state);
  a.state = static_cast<const int*>(state);
  a.jmask = static_cast<const uint8_t*>(jmask);
  a.ids = static_cast<int*>(ids);
  a.state_out = json ? static_cast<int*>(state_out) : nullptr;
  a.gmax = static_cast<float*>(gmax);
  a.counters = static_cast<int*>(counters);
  a.bf16 = dtype;
  a.B = B;
  a.V = V;
  a.k = k;
  a.G = G;
  a.splits = splits;
  sample_kernel<<<dim3(splits, B), THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}
