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
// What bounds it on the H100: bytes.  The router reads x once (T E
// elements) and the tiny router table (E X, held in L1/L2); the combine reads
// K rows of ye and writes one row per token.  The operations (2 T E X for
// the logits) are far below even the CUDA cores' rate at X = 8.
//
// Design: `moe_route_topk_kernel` gives each token a block of 256 threads:
// the threads stride over E (each thread's X partial sums in registers, the
// same operations for every expert, so two equal router columns give
// bit-equal logits and an exact tie stays a tie), a butterfly reduction in
// each warp, then lane j of the first warp sums expert j's eight warp
// partials; the softmax and the K arg-max rounds (ties to the lower lane)
// run across that warp's lanes.  It writes each token's expert ids into tok_slot.
// `moe_route_scan_kernel` is one block of 1,024 threads that walks the tokens
// choice by choice in tiles of 1,024: `__match_any_sync` groups a warp's
// lanes by expert (the rank within the group is the position inside the
// warp), the group leaders write per-warp counts to shared memory, warp x
// scans expert x's counts over the warps and adds the running count carried
// from earlier tiles and choices.  The scan is the only serial part: 2 T / 1,024
// tiles, a few microseconds at T = 4,096.  `moe_combine_kernel` is one thread an
// output element, reading the K rows coalesced; the products and the sum are
// `__fmul_rn` / `__fadd_rn` (no fused multiply-add), so the result equals
// the twin's bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int MAX_X = 32;  // experts: one lane each in the top-k, one warp each in the scan
constexpr int MAX_K = 8;
constexpr int TOPK_THREADS = 256;  // a block a token
constexpr int SCAN_THREADS = 1024;
constexpr int COMBINE_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(TOPK_THREADS)
moe_route_topk_kernel(const T* __restrict__ x, const T* __restrict__ router,
                      int* __restrict__ ids, float* __restrict__ gates, int Tn, int E, int X,
                      int K) {
  __shared__ float part[TOPK_THREADS / 32][MAX_X];  // per warp, per expert
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x;
  float acc[MAX_X];
#pragma unroll
  for (int j = 0; j < MAX_X; ++j) acc[j] = 0.0f;
  const T* xr = x + (size_t)t * E;
  for (int e = threadIdx.x; e < E; e += TOPK_THREADS) {
    const float xv = to_f32(xr[e]);
    const T* r = router + (size_t)e * X;
#pragma unroll
    for (int j = 0; j < MAX_X; ++j)
      if (j < X) acc[j] += xv * to_f32(r[j]);
  }
#pragma unroll
  for (int j = 0; j < MAX_X; ++j) {
    if (j < X) {
      float v = acc[j];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
      if (lane == 0) part[warp][j] = v;
    }
  }
  __syncthreads();
  if (warp != 0) return;
  float logit = -INFINITY;
  if (lane < X) {
    logit = part[0][lane];
#pragma unroll
    for (int w = 1; w < TOPK_THREADS / 32; ++w) logit += part[w][lane];
  }
  // softmax across the lanes (lanes >= X hold -inf and weigh 0)
  float mx = logit;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, o));
  const float ex = lane < X ? expf(logit - mx) : 0.0f;
  float sum = ex;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(FULL, sum, o);
  float p = lane < X ? ex / sum : -INFINITY;
  // K rounds of arg-max, equal values the lower lane; a taken lane drops to
  // -1 (below every probability, above the lanes past X)
  int id[MAX_K];
  float val[MAX_K];
  float vsum = 0.0f;
#pragma unroll
  for (int k = 0; k < MAX_K; ++k) {
    if (k < K) {
      float bv = p;
      int bl = lane;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, o);
        const int ol = __shfl_xor_sync(FULL, bl, o);
        if (ov > bv || (ov == bv && ol < bl)) {
          bv = ov;
          bl = ol;
        }
      }
      id[k] = bl;
      val[k] = bv;
      vsum = k == 0 ? bv : vsum + bv;
      if (lane == bl) p = -1.0f;
    }
  }
  if (lane == 0) {
    const float denom = fmaxf(vsum, 1e-9f);
#pragma unroll
    for (int k = 0; k < MAX_K; ++k) {
      if (k < K) {
        ids[(size_t)t * K + k] = id[k];
        gates[(size_t)t * K + k] = val[k] / denom;
      }
    }
  }
}

// tok_slot holds the expert ids on entry (moe_route_topk_kernel's) and the slots
// on exit; one block
__global__ void __launch_bounds__(SCAN_THREADS)
moe_route_scan_kernel(int* __restrict__ tok_slot, int* __restrict__ slot_tok, int* __restrict__ fill,
                  int Tn, int X, int K, int C) {
  __shared__ int warp_off[SCAN_THREADS / 32][MAX_X];  // per warp and expert: counts, then offsets
  __shared__ int carry[MAX_X];                        // slots taken so far per expert
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < X * C; i += SCAN_THREADS) slot_tok[i] = -1;
  if (tid < X) carry[tid] = 0;
  const unsigned lower = (1u << lane) - 1u;
  for (int k = 0; k < K; ++k) {
    for (int base = 0; base < Tn; base += SCAN_THREADS) {
      for (int i = tid; i < (SCAN_THREADS / 32) * MAX_X; i += SCAN_THREADS)
        warp_off[i / MAX_X][i % MAX_X] = 0;
      __syncthreads();
      const int t = base + tid;
      const bool valid = t < Tn;
      const int e = valid ? tok_slot[(size_t)t * K + k] : -1;
      const unsigned peers = __match_any_sync(FULL, e);
      const int rank = __popc(peers & lower);
      if (valid && rank == 0) warp_off[warp][e] = __popc(peers);
      __syncthreads();
      if (warp < X) {  // warp x: exclusive scan of expert x's counts over the warps
        const int v = warp_off[lane][warp];
        int incl = v;
#pragma unroll
        for (int o = 1; o < 32; o <<= 1) {
          const int n = __shfl_up_sync(FULL, incl, o);
          if (lane >= o) incl += n;
        }
        const int c0 = carry[warp];
        __syncwarp();
        warp_off[lane][warp] = c0 + incl - v;
        if (lane == 31) carry[warp] = c0 + incl;
      }
      __syncthreads();
      if (valid) {
        const int pos = warp_off[warp][e] + rank;
        const bool keep = pos < C;
        tok_slot[(size_t)t * K + k] = keep ? e * C + pos : -1;
        if (keep) slot_tok[e * C + pos] = t;
      }
      __syncthreads();
    }
  }
  if (tid < X) fill[tid] = min(carry[tid], C);
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_THREADS)
moe_combine_kernel(const int* __restrict__ tok_slot, const float* __restrict__ tok_gate,
               const T* __restrict__ ye, T* __restrict__ out, int Tn, int E, int K) {
  const size_t n = (size_t)Tn * E;
  for (size_t i = (size_t)blockIdx.x * COMBINE_THREADS + threadIdx.x; i < n;
       i += (size_t)gridDim.x * COMBINE_THREADS) {
    const size_t t = i / E, e = i % E;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) {
      const int s = tok_slot[t * K + k];
      if (s >= 0) {
        const float g = to_f32(from_f32<T>(tok_gate[t * K + k]));
        acc = __fadd_rn(acc, __fmul_rn(g, to_f32(ye[(size_t)s * E + e])));
      }
    }
    out[i] = from_f32<T>(acc);
  }
}

template <typename T>
int launch_route(const void* x, const void* router, void* tok_slot, void* tok_gate,
                 void* slot_tok, void* fill, int Tn, int E, int X, int K, int C,
                 cudaStream_t st) {
  moe_route_topk_kernel<T><<<Tn, TOPK_THREADS, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(router), static_cast<int*>(tok_slot),
      static_cast<float*>(tok_gate), Tn, E, X, K);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  moe_route_scan_kernel<<<1, SCAN_THREADS, 0, st>>>(static_cast<int*>(tok_slot),
                                                 static_cast<int*>(slot_tok),
                                                 static_cast<int*>(fill), Tn, X, K, C);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_combine(const void* tok_slot, const void* tok_gate, const void* ye, void* out, int Tn,
                   int E, int K, cudaStream_t st) {
  const size_t n = (size_t)Tn * E, want = (n + COMBINE_THREADS - 1) / COMBINE_THREADS;
  const int blocks = want < (size_t)(1 << 20) ? (int)want : (1 << 20);
  moe_combine_kernel<T><<<blocks, COMBINE_THREADS, 0, st>>>(
      static_cast<const int*>(tok_slot), static_cast<const float*>(tok_gate),
      static_cast<const T*>(ye), static_cast<T*>(out), Tn, E, K);
  return (int)cudaGetLastError();
}

}  // namespace

// Routing: x [T, E] and router [E, X], both f32 (dtype 0) or bf16 (1),
// contiguous; writes tok_slot [T, K] int32, tok_gate [T, K] f32, slot_tok
// [X, C] int32, fill [X] int32.  1 <= K <= min(X, 8), X <= 32, C >= 1.
// Two launches (the top-k, then the one-block scan).  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels do
// not take.
extern "C" int dabt_moe_route(const void* x, const void* router, void* tok_slot, void* tok_gate,
                              void* slot_tok, void* fill, int dtype, int Tn, int E, int X, int K,
                              int C, void* stream) {
  if (Tn < 1 || E < 1 || X < 1 || X > MAX_X || K < 1 || K > MAX_K || K > X || C < 1 ||
      (long long)X * C > (1LL << 30) || x == nullptr || router == nullptr ||
      tok_slot == nullptr || tok_gate == nullptr || slot_tok == nullptr || fill == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_route<float>(x, router, tok_slot, tok_gate, slot_tok, fill, Tn, E, X, K, C, st);
  if (dtype == 1)
    return launch_route<__nv_bfloat16>(x, router, tok_slot, tok_gate, slot_tok, fill, Tn, E, X, K,
                                       C, st);
  return (int)cudaErrorInvalidValue;
}

// Combine: tok_slot [T, K] int32 and tok_gate [T, K] f32 (moe_route's),
// ye [X * C, E] and out [T, E] in f32 (dtype 0) or bf16 (1), contiguous;
// every slot of tok_slot is -1 or below X * C.  Returns cudaGetLastError(),
// or cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int dabt_moe_combine(const void* tok_slot, const void* tok_gate, const void* ye,
                                void* out, int dtype, int Tn, int E, int K, void* stream) {
  if (Tn < 1 || E < 1 || K < 1 || K > MAX_K || tok_slot == nullptr || tok_gate == nullptr ||
      ye == nullptr || out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_combine<float>(tok_slot, tok_gate, ye, out, Tn, E, K, st);
  if (dtype == 1) return launch_combine<__nv_bfloat16>(tok_slot, tok_gate, ye, out, Tn, E, K, st);
  return (int)cudaErrorInvalidValue;
}
