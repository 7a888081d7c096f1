// Exact rerank of an IVF-PQ shortlist for Hopper (sm_90a): gather, bf16 dot,
// mask, top-k, one launch.
//
// Replaces: django_assistant_bot_tpu/storage/ann.py `_rerank_impl`
// (:251-264).  For the bf16 row tier [N, D], its validity rvalid [N], the
// queries q [Q, D] f32, and an ADC shortlist (sl_scores [Q, S] f32, sl_pos
// [Q, S] int32), per query (the plain twin: storage/ann.py `rerank_plain`):
//
//   pos_s   = clip(sl_pos[s], 0, N - 1)
//   exact_s = sum_d bf16(q[d]) * tier[pos_s, d]   (bf16 products, f32 sums)
//   exact_s = -inf unless isfinite(sl_scores[s]) and rvalid[pos_s]
//   the top k of exact, descending, equal scores the lower s first
//   (`lax.top_k`); out_pos = sl_pos at those s (unclipped).
//
// The products of two bf16 values are exact in f32; the sums run in another
// order than the twin's einsum, so scores agree within
// `knn_check.topk_score_bound` (D 2^-22 |q| max|x|), not bit for bit.
//
// What bounds it on the H100: bytes, the S gathered rows (S D 2 bytes a
// query: 393,216 B at S = 256, D = 768).  The operations (2 S D a query)
// are far below the tensor cores' rate, and a row is only ever read by one
// query, so the products stay on the CUDA cores.
//
// Design: grid Q, 1024 threads.  The block rounds its query to bf16 into
// shared memory; each warp takes shortlist entries in turn and, for a
// valid one, reads the row in 16-byte loads (8 bf16 a lane, the warp's
// loads one contiguous stretch; scalar loads when D or the tier's base is
// off 16 bytes), sums its lane's products in f32 and reduces over the warp
// by shuffles.  Each entry's 64-bit key (the score's order key, then the
// inverted shortlist index: unique, so the result does not depend on the
// order the warps run in) goes to shared memory; a bitonic sort of the S
// keys orders them and the block writes the first k.  One block a query
// leaves most SMs idle at Q = 8; splitting a query's rows over blocks (and
// merging their keys) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_S = 2048;  // storage/ann.py MAX_SHORTLIST
constexpr unsigned FULL = 0xFFFFFFFFu;

struct Args {
  const __nv_bfloat16* tier;  // [N, D]
  const uint8_t* rvalid;      // [N]
  const float* q;             // [Q, D]
  const float* sl_scores;     // [Q, S]
  const int* sl_pos;          // [Q, S]
  float* out_scores;          // [Q, k]
  int* out_pos;               // [Q, k]
  int N, D, S, k, vec;        // vec: rows read in 16-byte loads
};

__device__ __forceinline__ uint32_t ord(float v) {
  if (v == 0.0f) v = 0.0f;
  const uint32_t u = __float_as_uint(v);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unord(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__global__ void __launch_bounds__(THREADS) rerank_kernel(Args a) {
  extern __shared__ float qs[];  // [D], the query rounded to bf16
  __shared__ unsigned long long keys[MAX_S];
  const int qi = blockIdx.x, tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int D = a.D, S = a.S;
  for (int d = tid; d < D; d += THREADS)
    qs[d] = __bfloat162float(__float2bfloat16(a.q[(size_t)qi * D + d]));
  __syncthreads();
  for (int s = warp; s < S; s += WARPS) {
    const float sl = a.sl_scores[(size_t)qi * S + s];
    const int pos = min(max(a.sl_pos[(size_t)qi * S + s], 0), a.N - 1);
    const bool ok = isfinite(sl) && a.rvalid[pos] != 0;
    float acc = 0.0f;
    if (ok) {
      const __nv_bfloat16* row = a.tier + (size_t)pos * D;
      if (a.vec) {
        for (int d = 8 * lane; d < D; d += 256) {
          const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + d));
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int h = 0; h < 4; ++h) {
            const __nv_bfloat162 pair = *reinterpret_cast<const __nv_bfloat162*>(&w[h]);
            const float2 f = __bfloat1622float2(pair);
            acc += qs[d + 2 * h] * f.x;
            acc += qs[d + 2 * h + 1] * f.y;
          }
        }
      } else {
        for (int d = lane; d < D; d += 32) acc += qs[d] * __bfloat162float(row[d]);
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(FULL, acc, o);
    }
    if (lane == 0)
      keys[s] = ((unsigned long long)ord(ok ? acc : -INFINITY) << 32) |
                (unsigned long long)(0xFFFFFFFFu - (uint32_t)s);
  }
  // bitonic sort of the S keys, descending, padded to a power of two with 0
  int np = 1;
  while (np < S) np <<= 1;
  for (int i = S + tid; i < np; i += THREADS) keys[i] = 0;
  __syncthreads();
  for (int size = 2; size <= np; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < np; i += THREADS) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = keys[i], y = keys[j];
          if (((i & size) == 0) ? (x < y) : (x > y)) {
            keys[i] = y;
            keys[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int r = tid; r < a.k; r += THREADS) {
    const unsigned long long key = keys[r];
    const int s = (int)(0xFFFFFFFFu - (uint32_t)key);
    a.out_scores[(size_t)qi * a.k + r] = unord((uint32_t)(key >> 32));
    a.out_pos[(size_t)qi * a.k + r] = a.sl_pos[(size_t)qi * S + s];
  }
}

}  // namespace

// Rerank: tier [N, D] bf16, rvalid [N] bool, q [Q, D] f32, sl_scores [Q, S]
// f32, sl_pos [Q, S] int32, all contiguous; out_scores [Q, k] f32 and
// out_pos [Q, k] int32.  1 <= k <= S <= 2048, D <= 16384.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernel does
// not take.
extern "C" int dabt_ann_rerank(const void* tier, const void* rvalid, const void* q,
                               const void* sl_scores, const void* sl_pos, void* out_scores,
                               void* out_pos, int N, int D, int Q, int S, int k, void* stream) {
  if (N < 1 || D < 1 || D > 16384 || Q < 1 || S < 1 || S > MAX_S || k < 1 || k > S ||
      tier == nullptr || rvalid == nullptr || q == nullptr || sl_scores == nullptr ||
      sl_pos == nullptr || out_scores == nullptr || out_pos == nullptr)
    return (int)cudaErrorInvalidValue;
  Args a;
  a.tier = static_cast<const __nv_bfloat16*>(tier);
  a.rvalid = static_cast<const uint8_t*>(rvalid);
  a.q = static_cast<const float*>(q);
  a.sl_scores = static_cast<const float*>(sl_scores);
  a.sl_pos = static_cast<const int*>(sl_pos);
  a.out_scores = static_cast<float*>(out_scores);
  a.out_pos = static_cast<int*>(out_pos);
  a.N = N;
  a.D = D;
  a.S = S;
  a.k = k;
  a.vec = D % 8 == 0 && reinterpret_cast<uintptr_t>(tier) % 16 == 0;
  const int smem = D * (int)sizeof(float);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smem > 48 * 1024) {
    const cudaError_t e =
        cudaFuncSetAttribute(rerank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  rerank_kernel<<<Q, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}
