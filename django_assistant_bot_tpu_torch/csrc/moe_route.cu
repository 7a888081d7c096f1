// Mixtral MoE routing and combine for Hopper (sm_90a): the router, its top-k,
// the capacity slots, and the gated sum of the experts' outputs.
//
// Replaces: django_assistant_bot_tpu/models/mixtral.py `moe_mlp` (:38-73),
// its routing (:46-63) and its combine (:72).  The JAX function builds a
// dense one-hot dispatch [T, X, C] and a combine of the same shape; here the
// routing is kept as indices (the plain twins: ops/moe.py `moe_route_plain`
// and `moe_combine_plain`):
//
//   logits[t, x] = sum_e f32(x[t, e]) * f32(router[e, x])
//   probs        = softmax(logits)                  (f32, exp(l - max) / sum)
//   ids, vals    = the top K of probs, equal values the lower expert first
//                  (`lax.top_k`'s order)
//   gates        = vals / max(vals_0 + ... + vals_{K-1}, 1e-9)
//   positions    = choice 0 of every token in token order, then choice 1, ...:
//                  pos = the tokens before it (in that order) routed to the
//                  same expert; kept iff pos < C (the JAX code's cumsum and
//                  `counts` carry)
//   tok_slot[t, k] = expert * C + pos, or -1 where dropped; tok_gate[t, k]
//   slot_tok[x, c] = the token in that slot, or -1; fill[x] = min(count, C)
//
//   out[t, :] = round( sum_k round(gate[t, k]) * ye[tok_slot[t, k], :] )
//               the products and their sum in f32 (a dropped choice adds
//               nothing), `round` the model dtype's (the JAX combine's
//               `astype(cfg.dtype)`); rounded once at the end.
//
// What bounds it on the H100: bytes at prefill, latency at the decode tick.
// The router reads x once (T E elements) and the small router table (E X);
// the combine reads K rows of ye and writes one row per token.  The logits'
// 2 T E X operations take under half of x's read time on the CUDA cores at
// X = 8 (2 us against 5 us at T = 2,048).  The decode tick's 8 tokens are a
// chain of dependent steps (read, logits, top-k, slots): one launch, the
// logits spread over four blocks.
//
// Design, `moe_route_kernel` (one launch; `kernels.moe_route_plan` sizes it):
// a block takes a tile of TT = 64 / XMAX tokens (8 at X <= 8) and a range of
// E, which it walks in passes of up to 256 16-byte chunks of x, a chunk a
// thread.  A pass's router rows are contiguous: they are copied into shared
// memory with 16-byte `cp.async` copies (swizzled, so that a thread's rows
// fall in distinct banks across neighbouring lanes), while each thread reads
// its chunk of the tile's tokens with one 16-byte load a token; the thread
// keeps the TT x XMAX partial logits in registers.  A reduce-scatter
// butterfly sums them over the warp (62 shuffles for the 64 values), the
// eight warps' sums add in warp order; every expert column gets the same
// operations in the same order, so two equal router columns give bit-equal
// logits and an exact tie stays a tie.  A warp a token then takes the
// softmax and the K arg-max rounds across its lanes (`__reduce_max_sync` on
// the probabilities' bits, ties to the lower lane), and warp 0 ranks each
// choice among the tile's choices of its expert (`__match_any_sync`).
// Three forms:
//   - one tile over `splits` blocks, each a range of E (the decode tick):
//     each writes its f32 partial logits, and the last block to take a
//     ticket sums them in block order and writes the slots (the experts'
//     counts over the earlier choices + the rank);
//   - one tile, one block: the same with no scratch and no ticket;
//   - token tiles (prefill): each block writes its choices' experts and
//     ranks (packed into tok_slot) and its counts per (choice, expert); the
//     last block scans the counts over the tiles (integers: exact in any
//     order) in chunks that fit shared memory and writes the slots, sixteen
//     loads in flight a thread.
// The last block resets the ticket counter to zero, so a CUDA graph replays.
//
// `moe_combine_kernel`: a block takes 128 16-byte vectors of one token's
// row; each thread reads the token's K slots and gates once, the K ye vectors
// with 16-byte loads, and writes out with one 16-byte store; the products and
// the sum are `__fmul_rn` / `__fadd_rn` (no fused multiply-add), so the
// result equals the twin's bit for bit.  Where E is not a multiple of the
// vector or ye / out is off 16 bytes, the same threads take the elements one
// at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_X = 32;  // experts: one lane each in the top-k
constexpr int MAX_K = 8;
constexpr int ROUTE_THREADS = 256;
constexpr int ROUTE_WARPS = ROUTE_THREADS / 32;
constexpr int ROUTE_VALUES = 64;  // partial logits a thread keeps: tile tokens x XMAX
constexpr int STAGE_BYTES = 64 * 1024;  // a pass's router rows in shared memory, at most
constexpr int SCAN_INTS = 8192;   // the last block's per-tile counts in shared memory
constexpr int SCAN_ITEMS = 16;    // choices a thread loads before it writes their slots
constexpr int COMBINE_THREADS = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// 16 bytes as raw words: 8 bf16 or 4 f32 elements
struct Raw {
  unsigned w[4];
};

template <typename T> struct Elems { static constexpr int n = 16 / sizeof(T); };

// element i of a raw chunk, widened to f32 (exactly as __bfloat162float)
template <typename T> __device__ __forceinline__ float elem(const Raw& r, int i);
template <> __device__ __forceinline__ float elem<float>(const Raw& r, int i) {
  return __uint_as_float(r.w[i]);
}
template <> __device__ __forceinline__ float elem<__nv_bfloat16>(const Raw& r, int i) {
  const unsigned w = r.w[i >> 1];
  return __uint_as_float((i & 1) ? (w & 0xFFFF0000u) : (w << 16));
}

__device__ __forceinline__ Raw load16(const void* p) {
  const uint4 v = __ldg(static_cast<const uint4*>(p));
  return Raw{{v.x, v.y, v.z, v.w}};
}

// n (<= the chunk's elements) elements from p one at a time, the rest zero
template <typename T> __device__ __forceinline__ Raw load_elems(const T* p, int n) {
  Raw r{{0u, 0u, 0u, 0u}};
  constexpr int V = Elems<T>::n;
#pragma unroll
  for (int i = 0; i < V; ++i) {
    if (i < n) {
      if constexpr (sizeof(T) == 4) {
        r.w[i] = __ldg(reinterpret_cast<const unsigned*>(p) + i);
      } else {
        const unsigned h = __ldg(reinterpret_cast<const unsigned short*>(p) + i);
        r.w[i >> 1] |= (i & 1) ? (h << 16) : h;
      }
    }
  }
  return r;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// the router stage's 16-byte unit g lies at unit swz(g): a thread's rows
// (8 or 4 units a chunk) fall in distinct banks across 8 neighbouring lanes
__device__ __forceinline__ int swz(int g) { return g ^ ((g >> 3) & 7); }

// elements [0, n) of src into the stage: 16-byte copies (cp.async) where
// src lies on 16 bytes, the rest one element at a time
template <typename T>
__device__ __forceinline__ void stage_rows(unsigned char* st, const T* src, int n, bool vec) {
  const int units = vec ? n * (int)sizeof(T) / 16 : 0;
  for (int g = threadIdx.x; g < units; g += ROUTE_THREADS)
    cp_async16(st + swz(g) * 16, reinterpret_cast<const unsigned char*>(src) + g * 16);
  for (int i = units * 16 / (int)sizeof(T) + threadIdx.x; i < n; i += ROUTE_THREADS) {
    const int b = i * (int)sizeof(T);
    *reinterpret_cast<T*>(st + swz(b >> 4) * 16 + (b & 15)) = src[i];
  }
}

// the ticket of a block that finished its part: true for the last block,
// which leaves the counter at zero.  The block's global writes are ordered
// before the ticket by the barrier and thread 0's fence (fences are
// cumulative), and the other blocks' before the last block's reads by its
// fence after the ticket.
__device__ __forceinline__ bool last_block(int* counter, int* flag) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    const bool last = atomicAdd(counter, 1) == (int)gridDim.x - 1;
    if (last) {
      *counter = 0;
      __threadfence();
    }
    *flag = last;
  }
  __syncthreads();
  return *flag != 0;
}

// the warp's sum of each of a lane's ROUTE_VALUES partials, scattered: at
// the level that keeps HALF values a lane keeps the upper half where its
// bit HALF / 2 is set and adds its partner's copy of the same values, so
// lane l ends with the sums of values 2 l and 2 l + 1 in acc[0], acc[1]; every
// value takes the same tree of additions
template <int HALF>
__device__ __forceinline__ void reduce_scatter(float (&acc)[ROUTE_VALUES], int lane) {
  const bool up = lane & (HALF / 2);
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = up ? acc[i] : acc[i + HALF];
    const float keep = up ? acc[i + HALF] : acc[i];
    acc[i] = keep + __shfl_xor_sync(FULL, send, HALF / 2);
  }
  if constexpr (HALF > 2) reduce_scatter<HALF / 2>(acc, lane);
}

// float -> int with the same order (for __reduce_max_sync), and back
__device__ __forceinline__ int order_key(float f) {
  const int i = __float_as_int(f);
  return i ^ ((i >> 31) & 0x7FFFFFFF);
}
__device__ __forceinline__ float from_order_key(int k) {
  return __int_as_float(k ^ ((k >> 31) & 0x7FFFFFFF));
}

template <typename T, int XMAX>
__global__ void __launch_bounds__(ROUTE_THREADS)
moe_route_kernel(const T* __restrict__ x, const T* __restrict__ router, int* __restrict__ tok_slot,
                 float* __restrict__ tok_gate, int* __restrict__ slot_tok, int* __restrict__ fill,
                 float* __restrict__ scratch, int* __restrict__ counter, int Tn, int E, int X,
                 int K, int C, int splits, int vec_x, int vec_r) {
  constexpr int TT = ROUTE_VALUES / XMAX;  // tokens a tile
  constexpr int V = Elems<T>::n;           // elements a 16-byte chunk
  __shared__ float red[ROUTE_WARPS][ROUTE_VALUES];
  __shared__ float logit[ROUTE_VALUES];
  __shared__ int sid[TT][MAX_K];
  __shared__ int cnt[MAX_K * MAX_X];   // counts, then (the scan) carries, per choice and expert
  __shared__ int base[MAX_K * MAX_X];  // the slots earlier choices took, per choice and expert
  __shared__ int flag;
  extern __shared__ __align__(16) unsigned char stage[];  // the router rows of a pass
  int* sc = reinterpret_cast<int*>(stage);  // then the last block's per-tile counts
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tiles = (Tn + TT - 1) / TT;
  const int tile = blockIdx.x / splits, split = blockIdx.x - tile * splits;
  const int t0 = tile * TT, nt = min(TT, Tn - t0);

  // ---- partial logits over this block's range of E, in passes of PC
  // 16-byte chunks of x (a chunk a thread); a pass's router rows are
  // contiguous and staged whole, x read into registers
  float acc[ROUTE_VALUES];
#pragma unroll
  for (int i = 0; i < ROUTE_VALUES; ++i) acc[i] = 0.0f;
  const int nchunk = (E + V - 1) / V, per = (nchunk + splits - 1) / splits;
  const int PC = min(ROUTE_THREADS, STAGE_BYTES / (16 * X));
  const bool row_vec = X % V == 0;  // a row is whole 16-byte units
  const int c_begin = split * per, c_end = min(nchunk, c_begin + per);
  for (int cb = c_begin; cb < c_end; cb += PC) {
    const int e_lo = cb * V, e_hi = min(E, min(c_end, cb + PC) * V);
    stage_rows(stage, router + (size_t)e_lo * X, (e_hi - e_lo) * X, vec_r);
    const int e0 = (cb + tid) * V, n = tid < PC ? max(0, min(V, e_hi - e0)) : 0;
    Raw xr[TT];
#pragma unroll
    for (int t = 0; t < TT; ++t) {
      const T* p = x + (size_t)(t0 + t) * E + e0;
      xr[t] = t >= nt || n == 0 ? Raw{{0u, 0u, 0u, 0u}} : vec_x ? load16(p) : load_elems(p, n);
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int i = 0; i < V; ++i) {
      if (i < n) {
        const int r0 = (e0 + i - e_lo) * X;  // the row's first element in the stage
        float r[XMAX];
        if (row_vec) {
#pragma unroll
          for (int q = 0; q < XMAX / V; ++q) {
            Raw piece{{0u, 0u, 0u, 0u}};
            if (q * V < X) {
              const uint4 u = *reinterpret_cast<const uint4*>(stage + swz(r0 / V + q) * 16);
              piece = Raw{{u.x, u.y, u.z, u.w}};
            }
#pragma unroll
            for (int j = 0; j < V; ++j) r[q * V + j] = elem<T>(piece, j);
          }
        } else {
#pragma unroll
          for (int j = 0; j < XMAX; ++j) {
            const int b = (r0 + j) * (int)sizeof(T);
            r[j] = j < X ? to_f32(*reinterpret_cast<const T*>(stage + swz(b >> 4) * 16 +
                                                                (b & 15)))
                         : 0.0f;
          }
        }
#pragma unroll
        for (int t = 0; t < TT; ++t) {
          const float xv = elem<T>(xr[t], i);
#pragma unroll
          for (int j = 0; j < XMAX; ++j) acc[t * XMAX + j] = fmaf(xv, r[j], acc[t * XMAX + j]);
        }
      }
    }
    __syncthreads();  // the next pass overwrites the stage
  }
  reduce_scatter<ROUTE_VALUES / 2>(acc, lane);  // lane l: values 2 l and 2 l + 1
  red[warp][2 * lane] = acc[0];
  red[warp][2 * lane + 1] = acc[1];
  __syncthreads();
  if (tid < ROUTE_VALUES) {
    float s = red[0][tid];
#pragma unroll
    for (int w = 1; w < ROUTE_WARPS; ++w) s += red[w][tid];
    logit[tid] = s;
  }
  if (splits > 1) {  // one tile over `splits` blocks: the last sums the partials in block order
    if (tid < ROUTE_VALUES) scratch[split * ROUTE_VALUES + tid] = logit[tid];
    if (!last_block(counter, &flag)) return;
    if (tid < ROUTE_VALUES) {
      float s = __ldcg(scratch + tid);
      for (int b = 1; b < splits; ++b) s += __ldcg(scratch + b * ROUTE_VALUES + tid);
      logit[tid] = s;
    }
  }
  __syncthreads();

  // ---- top-k: a warp a token, a lane an expert
  if (warp < nt) {
    const float l = lane < X ? logit[warp * XMAX + lane] : -INFINITY;
    const float mx = from_order_key(__reduce_max_sync(FULL, order_key(l)));
    const float ex = lane < X ? expf(l - mx) : 0.0f;
    float sum = ex;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
    // K rounds of arg-max, equal values the lower lane: a probability's bits
    // (+ 1, so 0 stays below it) order as the values do; taken lanes and
    // lanes past X hold 0
    const float p = ex / sum;
    unsigned key = lane < X ? __float_as_uint(p) + 1u : 0u;
    float val[MAX_K];
    float vsum = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < K) {
        const unsigned best = __reduce_max_sync(FULL, key);
        const int bl = __ffs(__ballot_sync(FULL, key == best)) - 1;
        if (lane == 0) sid[warp][k] = bl;
        val[k] = __uint_as_float(best - 1u);
        vsum = k == 0 ? val[k] : vsum + val[k];
        if (lane == bl) key = 0u;
      }
    }
    if (lane == 0) {
      const float denom = fmaxf(vsum, 1e-9f);
#pragma unroll
      for (int k = 0; k < MAX_K; ++k)
        if (k < K) tok_gate[(size_t)(t0 + warp) * K + k] = val[k] / denom;
    }
  }
  __syncthreads();

  // ---- warp 0: each choice's rank among the tile's choices of its expert
  // (lane t: token t), and the tile's counts per (choice, expert)
  const int S = K * X;
  int* counts = reinterpret_cast<int*>(scratch);  // token tiles: [K X][tiles]
  if (warp == 0) {
    const unsigned lower = (1u << lane) - 1u;
    int total = 0;  // lane x < X: expert x's choices so far (one tile)
    for (int k = 0; k < K; ++k) {
      const int e = lane < nt ? sid[lane][k] : -1 - lane;
      const unsigned peers = __match_any_sync(FULL, e);
      const int rank = __popc(peers & lower);
      if (lane < X) cnt[lane] = 0;
      __syncwarp();
      if (lane < nt && rank == 0) cnt[e] = __popc(peers);
      __syncwarp();
      const int n = lane < X ? cnt[lane] : 0;
      if (tiles == 1) {  // the whole call: the slot is the earlier choices' count + rank
        const int pos = __shfl_sync(FULL, total, e & 31) + rank;
        if (lane < nt) {
          const bool keep = pos < C;
          tok_slot[lane * K + k] = keep ? e * C + pos : -1;
          if (keep) slot_tok[e * C + pos] = lane;
        }
      } else {  // expert and rank packed for the last block; the tile's counts
        if (lane < nt) tok_slot[(size_t)(t0 + lane) * K + k] = e | (rank << 8);
        if (lane < X) counts[(size_t)(k * X + lane) * tiles + tile] = n;
      }
      total += n;
      __syncwarp();
    }
    if (tiles == 1 && lane < X) {
      fill[lane] = min(total, C);
      for (int c = min(total, C); c < C; ++c) slot_tok[lane * C + c] = -1;
    }
  }
  if (tiles == 1) return;
  if (!last_block(counter, &flag)) return;

  // ---- the last block: per (choice, expert) an exclusive scan of the counts
  // over the tiles, in chunks of CT tiles, carried across the chunks
  const int CT = min(tiles, SCAN_INTS / S);
  const bool one = CT == tiles;
  if (!one) {  // the totals first: the slots of earlier choices come before a chunk's
    for (int s = warp; s < S; s += ROUTE_WARPS) {
      int n = 0;
      for (int i = lane; i < tiles; i += 32) n += __ldcg(counts + (size_t)s * tiles + i);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) n += __shfl_xor_sync(FULL, n, o);
      if (lane == 0) base[s] = n;
    }
  }
  if (tid < S) cnt[tid] = 0;  // carries
  __syncthreads();
  if (!one && tid < X) {  // totals -> the slots the earlier choices took
    int run = 0;
    for (int k = 0; k < K; ++k) {
      const int n = base[k * X + tid];
      base[k * X + tid] = run;
      run += n;
    }
  }
  for (int c0 = 0; c0 < tiles; c0 += CT) {
    const int nct = min(CT, tiles - c0);
#pragma unroll 8
    for (int i = tid; i < S * nct; i += ROUTE_THREADS) {
      const int s = i / nct, j = i - s * nct;
      sc[s * CT + j] = __ldcg(counts + (size_t)s * tiles + c0 + j);
    }
    __syncthreads();
    for (int s = warp; s < S; s += ROUTE_WARPS) {  // lane-chunked scan of one sequence
      int* seq = sc + s * CT;
      const int m = (nct + 31) / 32, lo = min(lane * m, nct), hi = min(lo + m, nct);
      int own = 0;
      for (int i = lo; i < hi; ++i) own += seq[i];
      int incl = own;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int v = __shfl_up_sync(FULL, incl, o);
        if (lane >= o) incl += v;
      }
      const int carry = cnt[s];
      __syncwarp();
      int run = carry + incl - own;
      for (int i = lo; i < hi; ++i) {
        const int v = seq[i];
        seq[i] = run;
        run += v;
      }
      if (lane == 31) cnt[s] = carry + incl;
    }
    __syncthreads();
    if (one && tid < X) {  // one chunk: its carries are the totals
      int run = 0;
      for (int k = 0; k < K; ++k) {
        base[k * X + tid] = run;
        run += cnt[k * X + tid];
      }
    }
    __syncthreads();
    // the chunk's choices: expert and rank in, slot out
    const int lo = c0 * TT * K, hi = min((c0 + nct) * TT, Tn) * K;
    for (int i0 = lo; i0 < hi; i0 += ROUTE_THREADS * SCAN_ITEMS) {
      int pk[SCAN_ITEMS];
#pragma unroll
      for (int u = 0; u < SCAN_ITEMS; ++u) {
        const int i = i0 + u * ROUTE_THREADS + tid;
        pk[u] = i < hi ? __ldcg(tok_slot + i) : 0;
      }
#pragma unroll
      for (int u = 0; u < SCAN_ITEMS; ++u) {
        const int i = i0 + u * ROUTE_THREADS + tid;
        if (i < hi) {
          const int t = i / K, k = i - t * K, e = pk[u] & 255;
          const int pos = base[k * X + e] + sc[(k * X + e) * CT + t / TT - c0] + (pk[u] >> 8);
          const bool keep = pos < C;
          tok_slot[i] = keep ? e * C + pos : -1;
          if (keep) slot_tok[e * C + pos] = t;
        }
      }
    }
    __syncthreads();
  }
  // fills, and the empty slots past them: an expert a warp
  for (int e = warp; e < X; e += ROUTE_WARPS) {
    int run = 0;
    for (int k = 0; k < K; ++k) run += cnt[k * X + e];
    const int f = min(run, C);
    if (lane == 0) fill[e] = f;
    for (int c = f + lane; c < C; c += 32) slot_tok[e * C + c] = -1;
  }
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
moe_combine_kernel(const int* __restrict__ tok_slot, const float* __restrict__ tok_gate,
                   const T* __restrict__ ye, T* __restrict__ out, int E, int K, int parts,
                   int vec) {
  constexpr int V = Elems<T>::n;
  const int t = blockIdx.x / parts;
  const int e0 = ((blockIdx.x - t * parts) * COMBINE_THREADS + threadIdx.x) * V;
  int slot[MAX_K];
  float g[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    slot[k] = k < K ? __ldg(tok_slot + (size_t)t * K + k) : -1;
    g[k] = k < K ? to_f32(from_f32<T>(__ldg(tok_gate + (size_t)t * K + k))) : 0.0f;
  }
  if (e0 >= E) return;
  const int n = min(V, E - e0);
  Raw y[MAX_K];
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    y[k] = Raw{{0u, 0u, 0u, 0u}};
    if (slot[k] >= 0) {
      const T* p = ye + (size_t)slot[k] * E + e0;
      y[k] = vec ? load16(p) : load_elems(p, n);
    }
  }
  float acc[V];
#pragma unroll
  for (int i = 0; i < V; ++i) {
    acc[i] = 0.0f;
#pragma unroll
    for (int k = 0; k < MAX_K; ++k)
      if (slot[k] >= 0) acc[i] = __fadd_rn(acc[i], __fmul_rn(g[k], elem<T>(y[k], i)));
  }
  T* o = out + (size_t)t * E + e0;
  if (vec) {
    Raw r;
    if constexpr (sizeof(T) == 4) {
#pragma unroll
      for (int i = 0; i < V; ++i) r.w[i] = __float_as_uint(acc[i]);
    } else {
#pragma unroll
      for (int i = 0; i < V; i += 2) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(acc[i], acc[i + 1]);
        r.w[i >> 1] = *reinterpret_cast<const unsigned*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(r.w[0], r.w[1], r.w[2], r.w[3]);
  } else {
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (i < n) o[i] = from_f32<T>(acc[i]);
  }
}

template <typename T>
int combine_for(const void* tok_slot, const void* tok_gate, const void* ye, void* out, int Tn,
                int E, int K, int parts, int vec, cudaStream_t st) {
  moe_combine_kernel<T><<<Tn * parts, COMBINE_THREADS, 0, st>>>(
      static_cast<const int*>(tok_slot), static_cast<const float*>(tok_gate),
      static_cast<const T*>(ye), static_cast<T*>(out), E, K, parts, vec);
  return (int)cudaGetLastError();
}

template <typename T, int XMAX>
int launch_route(const void* x, const void* router, void* tok_slot, void* tok_gate,
                 void* slot_tok, void* fill, void* scratch, void* counter, int Tn, int E, int X,
                 int K, int C, int splits, int vec_x, int vec_r, cudaStream_t st) {
  constexpr int TT = ROUTE_VALUES / XMAX;
  const int tiles = (Tn + TT - 1) / TT;
  if ((splits > 1 && tiles > 1) || ((splits > 1 || tiles > 1) && (scratch == nullptr ||
                                                                   counter == nullptr)))
    return (int)cudaErrorInvalidValue;
  // a pass's router rows (PC 16-byte chunks of x, X columns; whole groups
  // of 8 units, which the swizzle permutes), or the last block's counts
  const int pc = min(ROUTE_THREADS, STAGE_BYTES / (16 * X));
  const int smem = max((pc * X + 7) / 8 * 128, SCAN_INTS * (int)sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        moe_route_kernel<T, XMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  moe_route_kernel<T, XMAX><<<tiles * splits, ROUTE_THREADS, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(router), static_cast<int*>(tok_slot),
      static_cast<float*>(tok_gate), static_cast<int*>(slot_tok), static_cast<int*>(fill),
      static_cast<float*>(scratch), static_cast<int*>(counter), Tn, E, X, K, C, splits, vec_x,
      vec_r);
  return (int)cudaGetLastError();
}

template <typename T>
int route_for(int xmax, const void* x, const void* router, void* tok_slot, void* tok_gate,
              void* slot_tok, void* fill, void* scratch, void* counter, int Tn, int E, int X,
              int K, int C, int splits, int vec_x, int vec_r, cudaStream_t st) {
  if (xmax == 8)
    return launch_route<T, 8>(x, router, tok_slot, tok_gate, slot_tok, fill, scratch, counter, Tn,
                              E, X, K, C, splits, vec_x, vec_r, st);
  if (xmax == 16)
    return launch_route<T, 16>(x, router, tok_slot, tok_gate, slot_tok, fill, scratch, counter,
                               Tn, E, X, K, C, splits, vec_x, vec_r, st);
  if (xmax == 32)
    return launch_route<T, 32>(x, router, tok_slot, tok_gate, slot_tok, fill, scratch, counter,
                               Tn, E, X, K, C, splits, vec_x, vec_r, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// Routing: x [T, E] and router [E, X], both f32 (dtype 0) or bf16 (1),
// contiguous; writes tok_slot [T, K] int32, tok_gate [T, K] f32, slot_tok
// [X, C] int32, fill [X] int32.  1 <= K <= min(X, 8), X <= xmax (8, 16 or
// 32: tiles of 64 / xmax tokens), C >= 1.  One launch of (T / tiles) x
// splits blocks; splits > 1 only with one tile.  With more than one block,
// scratch holds max(splits 64 floats, K X tiles ints) and counter one int
// that is zero on entry (and on exit).  vec_x: x is on 16 bytes and E a
// multiple of 16 bytes' elements; vec_r: router is on 16 bytes.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int dabt_moe_route(const void* x, const void* router, void* tok_slot, void* tok_gate,
                              void* slot_tok, void* fill, void* scratch, void* counter, int dtype,
                              int Tn, int E, int X, int K, int C, int xmax, int splits, int vec_x,
                              int vec_r, void* stream) {
  if (Tn < 1 || E < 1 || X < 1 || X > xmax || K < 1 || K > MAX_K || K > X || C < 1 ||
      splits < 1 || (long long)X * C > (1LL << 30) || x == nullptr || router == nullptr ||
      tok_slot == nullptr || tok_gate == nullptr || slot_tok == nullptr || fill == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return route_for<float>(xmax, x, router, tok_slot, tok_gate, slot_tok, fill, scratch, counter,
                            Tn, E, X, K, C, splits, vec_x, vec_r, st);
  if (dtype == 1)
    return route_for<__nv_bfloat16>(xmax, x, router, tok_slot, tok_gate, slot_tok, fill, scratch,
                                    counter, Tn, E, X, K, C, splits, vec_x, vec_r, st);
  return (int)cudaErrorInvalidValue;
}

// Combine: tok_slot [T, K] int32 and tok_gate [T, K] f32 (moe_route's),
// ye [X * C, E] and out [T, E] in f32 (dtype 0) or bf16 (1), contiguous;
// every slot of tok_slot is -1 or below X * C.  vec: ye and out on 16 bytes
// and E a multiple of 16 bytes' elements (else one element at a time).
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernel does not take.
extern "C" int dabt_moe_combine(const void* tok_slot, const void* tok_gate, const void* ye,
                                void* out, int dtype, int Tn, int E, int K, int vec,
                                void* stream) {
  if (Tn < 1 || E < 1 || K < 1 || K > MAX_K || tok_slot == nullptr || tok_gate == nullptr ||
      ye == nullptr || out == nullptr || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const int V = dtype == 0 ? 4 : 8;
  const int parts = ((E + V - 1) / V + COMBINE_THREADS - 1) / COMBINE_THREADS;
  if ((long long)Tn * parts > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return combine_for<float>(tok_slot, tok_gate, ye, out, Tn, E, K, parts, vec, st);
  return combine_for<__nv_bfloat16>(tok_slot, tok_gate, ye, out, Tn, E, K, parts, vec, st);
}
