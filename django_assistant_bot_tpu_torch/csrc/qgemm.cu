// Weight-only int8 / grouped int4 matrix product for Hopper (sm_90a):
// y[M, N] = x[M, K] . W[K, N], W stored as integers with f32 scales.
//
// Replaces: django_assistant_bot_tpu/ops/quant.py `qeinsum` (:160-208), which
// XLA lowers to a dot whose weight operand is a pure int -> bf16 convert, so
// only the integers are read.  A PyTorch composition (`q.to(bf16)` then
// `torch.matmul`) would read 1 byte per weight, write 2 and read 2 again;
// this kernel reads each integer once and dequantizes it in registers.
// Also the tied int8 head of `models/llama.py` `_head_logits` (:452-466):
// x scaled per E in the model dtype, then x . q^T over the [V, E] table.
//
// Layouts (the JAX package's): x and y row-major [M, K] and [M, N], bf16 or
// f32 (the same type).  int8: w int8 [K, N], scale f32 [N] (per output
// channel).  int4: w uint8 [K/2, N], byte (p, n) holding k = 2p in its low
// nibble and k = 2p + 1 in its high one, two's complement; scale f32
// [K/g, N] (per group of g rows and output channel).
//
// Numerics (the JAX function's roundings in the output type):
//   int8: y = round(round(sum_k x q) * round(scale)), the sum in f32;
//   int4: y = round(sum_G round(sum_{k in G} x q) * round(scale_G)), each
//   group's partial rounded, times the rounded scale (an exact f32
//   product), summed over groups in f32, rounded once.  A split of K
//   therefore falls on group boundaries.  The activations are never
//   quantized.  For f32, round() is the identity.
//
// What bounds it on the H100: at decode (M = 1-8) the weight read, 1 byte
// (int8) or 0.5 byte plus 4/g bytes of scale (int4) per weight, over the
// 3.35 TB/s of HBM: 17.5 us for 4096 x 14336 int8 at M = 8.  At M = 512 the
// 2 M K N operations at 989 TFLOP/s (60.8 us for 4096 x 14336).
//
// Design, decode (bf16, M <= 64, `qgemm_stream_kernel`): a persistent grid
// of about one block per SM streams the weights through a ring of TMA boxes
// in shared memory (a stage: 64 rows of K x 256 columns as two 128-column
// boxes side by side, so each row of W is read as 256 contiguous bytes;
// int4's scale rows and x's 64-row slice of K with them; a producer warp
// keeps 64 KB of weights in flight per SM whatever the shape).  The work is
// one sequence of granules (member, column tile, 64 rows of K; int4: whole
// groups) cut into equal ranges, one a block, so each block reads the same
// bytes to within one granule and short shapes fill the card too.  Eight
// consumer warps take 16 columns of each box and compute y^T = W^T x^T
// with `mma.sync.m16n8k16`: the integers are dequantized from shared memory
// into the A fragments exactly as the prefill kernel does (`load_a`), x's
// rows are the B operand (8 a tile, so M = 1-8 wastes no A rows).  int4's
// group flush needs the group's products done: with groups of whole stages
// each 16-row step's products go to their own accumulator, so the flush
// waits for one product, not a chain of four.  A tile whose K range is cut
// between blocks sums the blocks' f32 partials in block order behind a
// per-tile counter (the last block to arrive), so a call gives the same
// bits every time.  One launch takes up to three members that share x
// (QKV; gate and up), each with its own map, scale, y and N.  A
// K-contiguous form (int8 [N, K], no scale) serves a tied embedding table
// as the head.
//   `qgemm_mma_kernel`, the first decode kernel, stays for bf16 calls at
// M <= 64 that TMA cannot take (N not a multiple of 16, or an operand off
// 16 bytes): each thread owns 8 consecutive output columns and, per 16-row
// step of K, four consecutive rows of them, loaded straight from global
// memory into registers (int8: four 8-byte loads; int4: two), several
// steps at a time; the same `mma.sync` product with the mma's k index
// permuted so that a thread's A pairs come from its own loads.
// Dequantization in registers: int8 by the 2^23 magic-number trick (byte
// permute into an f32 mantissa, one subtract, exact), int4 by the bf16
// trick (nibble into a bf16 mantissa at 128, one bf16x2 subtract, exact);
// int8 and int4 values are exact in bf16.  A block is four warps on 64
// output columns; K is split across blocks until the grid fills the card;
// each block sums its warps in shared memory in a fixed order, writes one
// f32 partial, and the block that completes a tile's counter sums the
// partials in split order, applies the epilogue and resets the counter.
//   Past 64 rows (prefill) the products are bound by operations, and only
// `wgmma` reaches the tensor cores' rate: with N a multiple of 16 (a TMA
// row stride is a multiple of 16 bytes; N = 1032 keeps the direct-load
// kernel) `qgemm_wgmma_kernel` takes the call.  It computes y^T = W^T x^T:
// the integers become wgmma's A operand straight from registers (each warp
// loads its 16 columns of W with `ldmatrix.trans`, the columns permuted so
// that a thread's two A rows are one byte pair, and dequantizes them as
// above), and x's tile is the B operand in shared memory, 128-byte
// swizzled by TMA, so no bf16 copy of W is written; two consumer
// warpgroups take 64 columns of W each.  A producer warp keeps a 4-stage
// ring of TMA loads in flight (x's tile, the integer tile, int4's scale
// rows with it, so no global load is left in the inner loop).  K splits
// on group boundaries and the partials go through the same kind of counter
// as the direct-load kernel's, so small N fills the card with one launch
// and replays equal eager calls bit for bit.
// Every other call takes `qgemm_generic_kernel` (below): the f32 route (the
// small f32 parity models, the tied head too) and the generic route, every
// bf16 shape the kernels above do not take (int4 groups that are not a
// multiple of 16, in not a multiple of 16, out not a multiple of 8, q or
// scale off 16 bytes, a tied head whose E or V is off those multiples).
// It keeps the stream kernel's grid (equal ranges of granules, one block an
// SM, split tiles summed in block order) with a `cp.async` ring that takes
// any alignment, and `mma.sync.m16n8k8` for bf16, so a group of 8 is one
// product per group and a group boundary inside a step costs one masked
// product per group it touches.
//
// Not done here (later work): a persistent prefill grid, TMA multicast of x
// across a cluster, and `wgmma` at decode past 32 rows of x.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper_tma.cuh"  // mbarriers, TMA, wgmma descriptors, the tensor-map encoder

namespace {

constexpr int TILE_N = 64;    // output columns of a block (8 per thread of a warp)
constexpr int THREADS = 128;  // four warps

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// acc0 += round(p0) * s0 and acc1 += round(p1) * s1, the pair rounded to
// bf16 by one conversion (a bf16 product is exact in f32, so the fma rounds
// only the sum)
__device__ __forceinline__ void add_rounded_pair(float& acc0, float& acc1, float p0, float p1,
                                                 float s0, float s1) {
  __nv_bfloat162 b = __floats2bfloat162_rn(p0, p1);
  const uint32_t u = *reinterpret_cast<uint32_t*>(&b);
  acc0 = fmaf(__uint_as_float(u << 16), s0, acc0);
  acc1 = fmaf(__uint_as_float(u & 0xFFFF0000u), s1, acc1);
}

// two integer-valued floats of at most 8 significant bits as a bf16x2: their
// upper halves, exactly (a byte permute, cheaper than a conversion)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  return __byte_perm(__float_as_uint(lo), __float_as_uint(hi), 0x7632u);
}

// byte j of u (u = int8 bytes ^ 0x80) as the exact f32 integer: the byte
// becomes the low mantissa byte of 2^23, and 2^23 + 128 comes off.
__device__ __forceinline__ float i8_value(uint32_t u, int j) {
  return __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | j)) - 8388736.0f;
}

// byte j of w (two int4 nibbles) as a bf16x2 {low nibble, high nibble}: each
// nibble ^ 8 lands in the mantissa of 128.0 (0x4300), and 136 comes off.
__device__ __forceinline__ uint32_t i4_pair(uint32_t w, int j) {
  uint32_t t = __byte_perm(w, w >> 4, j | ((4 + j) << 8));
  uint32_t v = (t & 0x000F000Fu) ^ 0x43084308u;
  __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&v);
  b = __hsub2(b, __floats2bfloat162_rn(136.0f, 136.0f));
  return *reinterpret_cast<uint32_t*>(&b);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c = a . b (bf16 in, f32 out), the accumulator input zero
__device__ __forceinline__ void mma_bf16_zero(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                              uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1), "f"(0.0f));
}

__device__ __forceinline__ uint32_t word_of(const uint2& r, int j) { return j < 4 ? r.x : r.y; }

// One 16-row step of K for a warp: the thread's weight rows (int8: four rows
// of its 8 columns; int4: two packed rows) dequantized into the A fragments
// of the warp's four 16-column tiles, times the B fragments of its MT 8-row
// tiles of x, accumulated into c.
template <int BITS, int MT>
__device__ __forceinline__ void warp_step(const uint2 (&wa)[BITS == 8 ? 4 : 2],
                                          const uint2 (&xb)[MT], float (&c)[MT][4][4]) {
  uint32_t a[4][4];
  if constexpr (BITS == 8) {
    const uint32_t r0[2] = {wa[0].x ^ 0x80808080u, wa[0].y ^ 0x80808080u};
    const uint32_t r1[2] = {wa[1].x ^ 0x80808080u, wa[1].y ^ 0x80808080u};
    const uint32_t r2[2] = {wa[2].x ^ 0x80808080u, wa[2].y ^ 0x80808080u};
    const uint32_t r3[2] = {wa[3].x ^ 0x80808080u, wa[3].y ^ 0x80808080u};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j0 = 2 * t, j1 = 2 * t + 1;  // this thread's columns of tile t
      a[t][0] = pack_bf16(i8_value(r0[j0 >> 2], j0 & 3), i8_value(r1[j0 >> 2], j0 & 3));
      a[t][1] = pack_bf16(i8_value(r0[j1 >> 2], j1 & 3), i8_value(r1[j1 >> 2], j1 & 3));
      a[t][2] = pack_bf16(i8_value(r2[j0 >> 2], j0 & 3), i8_value(r3[j0 >> 2], j0 & 3));
      a[t][3] = pack_bf16(i8_value(r2[j1 >> 2], j1 & 3), i8_value(r3[j1 >> 2], j1 & 3));
    }
  } else {
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int j0 = 2 * t, j1 = 2 * t + 1;
      a[t][0] = i4_pair(word_of(wa[0], j0), j0 & 3);
      a[t][1] = i4_pair(word_of(wa[0], j1), j1 & 3);
      a[t][2] = i4_pair(word_of(wa[1], j0), j0 & 3);
      a[t][3] = i4_pair(word_of(wa[1], j1), j1 & 3);
    }
  }
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t) mma_bf16(c[i][t], a[t], xb[i].x, xb[i].y);
}

// int4: group G ends.  Round the group's partial, times the rounded scale of
// the thread's 8 columns (from ncol), into acc; the partial restarts at 0.
template <int MT>
__device__ __forceinline__ void group_flush(const float* __restrict__ scale, int G, int N,
                                            int ncol, bool ncol_ok, float (&part)[MT][4][4],
                                            float (&acc)[MT][4][4]) {
  float sc[8];
  if (ncol_ok) {
    const float4* sp = reinterpret_cast<const float4*>(scale + (size_t)G * N + ncol);
    const float4 s_lo = __ldg(sp), s_hi = __ldg(sp + 1);
    sc[0] = s_lo.x; sc[1] = s_lo.y; sc[2] = s_lo.z; sc[3] = s_lo.w;
    sc[4] = s_hi.x; sc[5] = s_hi.y; sc[6] = s_hi.z; sc[7] = s_hi.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) sc[j] = 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) sc[j] = bf16_round(sc[j]);
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t) {
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const float s_e = sc[2 * t + (e >> 1)];
        add_rounded_pair(acc[i][t][e], acc[i][t][e + 1], part[i][t][e], part[i][t][e + 1], s_e, s_e);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) part[i][t][e] = 0.0f;
    }
}

// The tensor-core route's tail: block partials through the split-K counter.
// `vals(idx)` is the block's sum for element idx of its TN x BM tile (n
// fastest); `epi(v, n)` the output value.  With ksplit == 1 the block
// writes y directly.
template <int TN, typename T, typename Vals, typename Epi>
__device__ __forceinline__ void finish_tile(Vals vals, Epi epi, T* __restrict__ y,
                                            float* __restrict__ scratch, int* __restrict__ counters,
                                            int M, int N, int BM, int ksplit) {
  const int n0 = blockIdx.x * TN, mb = blockIdx.y * BM;
  const int count = TN * BM;
  if (ksplit == 1) {
    for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
      int n = n0 + idx % TN, m = mb + idx / TN;
      if (n < N && m < M) y[(size_t)m * N + n] = epi(vals(idx), n);
    }
    return;
  }
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int n = n0 + idx % TN, m = mb + idx / TN;
    if (n < N && m < M) scratch[((size_t)blockIdx.z * M + m) * N + n] = vals(idx);
  }
  __shared__ int s_last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int tile = blockIdx.y * gridDim.x + blockIdx.x;
    s_last = atomicAdd(counters + tile, 1) == ksplit - 1;
    if (s_last) counters[tile] = 0;  // every split has arrived: ready for the next call
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  for (int idx = threadIdx.x; idx < count; idx += blockDim.x) {
    int n = n0 + idx % TN, m = mb + idx / TN;
    if (n < N && m < M) {
      float v = 0.0f;
      for (int s = 0; s < ksplit; ++s) v += __ldcg(scratch + ((size_t)s * M + m) * N + n);
      y[(size_t)m * N + n] = epi(v, n);
    }
  }
}

// BITS 8 or 4; MT m-tiles of 8 rows a warp; WARPS_M warps along M (the
// other 4 / WARPS_M split the block's K range); U steps of 16 rows loaded
// before any is used.
template <int BITS, int MT, int WARPS_M>
__global__ void __launch_bounds__(THREADS)
qgemm_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, __nv_bfloat16* __restrict__ y,
                 float* __restrict__ scratch, int* __restrict__ counters, int M, int N, int K,
                 int group, int kchunk, int ksplit) {
  constexpr int KW = THREADS / 32 / WARPS_M;
  constexpr int BM = WARPS_M * MT * 8;
  constexpr int U = MT >= 4 ? 2 : (MT == 2 ? 4 : 8);
  constexpr int ROWS = BITS == 8 ? 4 : 2;  // 8-byte weight loads a step
  __shared__ float red[KW * TILE_N * BM];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp % WARPS_M, wk = warp / WARPS_M;
  const int ncol = blockIdx.x * TILE_N + 8 * gid;  // this thread's 8 columns
  const bool ncol_ok = ncol < N;
  const int m_base = blockIdx.y * BM + wm * MT * 8;
  const int kbeg = min(K, (blockIdx.z * KW + wk) * kchunk);
  const int kend = min(K, kbeg + kchunk);
  const int steps = (kend - kbeg) / 16;
  const int gsteps = BITS == 4 ? group / 16 : 1;

  float acc[MT][4][4];
  float part[MT][4][4];  // int4: the current group's partial
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = part[i][t][e] = 0.0f;

  // a batch of U steps: loads (zeros past the warp's range), then the steps
  auto load = [&](uint2 (&wa)[U][ROWS], uint2 (&xb)[U][MT], int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int k0 = kbeg + 16 * (s0 + u);
      const bool live = s0 + u < steps;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const size_t row = BITS == 8 ? (size_t)(k0 + 4 * tig + r) : (size_t)(k0 / 2 + 2 * tig + r);
        wa[u][r] = live && ncol_ok ? __ldg(reinterpret_cast<const uint2*>(w + row * N + ncol))
                                   : make_uint2(0u, 0u);
      }
#pragma unroll
      for (int i = 0; i < MT; ++i) {
        const int m = m_base + i * 8 + gid;
        xb[u][i] = live && m < M
                       ? __ldg(reinterpret_cast<const uint2*>(x + (size_t)m * K + k0 + 4 * tig))
                       : make_uint2(0u, 0u);
      }
    }
  };
  auto compute = [&](const uint2 (&wa)[U][ROWS], const uint2 (&xb)[U][MT], int s0) {
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (s0 + u >= steps) break;
      if constexpr (BITS == 8) {
        warp_step<BITS, MT>(wa[u], xb[u], acc);
      } else {
        warp_step<BITS, MT>(wa[u], xb[u], part);
        if ((s0 + u + 1) % gsteps == 0)
          group_flush<MT>(scale, (kbeg + 16 * (s0 + u + 1)) / group - 1, N, ncol, ncol_ok, part,
                          acc);
      }
    }
  };

  if (m_base < M) {
    for (int s0 = 0; s0 < steps; s0 += U) {
      uint2 wa[U][ROWS], xb[U][MT];
      load(wa, xb, s0);
      compute(wa, xb, s0);
    }
  }

  // C fragment element (i, t, e): column 8 gid + 2t + (e >> 1), row
  // i * 8 + 2 tig + (e & 1) of the warp's slab
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int nl = 8 * gid + 2 * t + (e >> 1);
        const int ml = wm * MT * 8 + i * 8 + 2 * tig + (e & 1);
        red[(wk * TILE_N + nl) * BM + ml] = acc[i][t][e];
      }
  __syncthreads();
  auto vals = [&](int idx) {
    const int nl = idx % TILE_N, ml = idx / TILE_N;
    float v = 0.0f;
#pragma unroll
    for (int k = 0; k < KW; ++k) v += red[(k * TILE_N + nl) * BM + ml];
    return v;
  };
  auto epi = [&](float v, int n) {
    if (BITS == 8) return __float2bfloat16_rn(bf16_round(v) * bf16_round(__ldg(scale + n)));
    return __float2bfloat16_rn(v);
  };
  finish_tile<TILE_N>(vals, epi, y, scratch, counters, M, N, BM, ksplit);
}

// the consumers' named barrier (id 1; 0 is __syncthreads)
__device__ __forceinline__ void consumers_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 accumulate: A
// from registers (a[0..3], the m16n8k16 A fragment of each warp's 16
// rows), B K-major from shared memory.  scale_d 0 overwrites d.  Fragment:
// d[4 j + r] is row 16 warp + lane / 4 + 8 (r >> 1), column 8 j +
// 2 (lane % 4) + (r & 1).  A's registers are read asynchronously: they stay
// unchanged until the product is waited for.
__device__ __forceinline__ void wgmma_128_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

constexpr int WG_BM = 128, WG_BN = 128, WG_KT = 64;  // output tile, rows of K a stage
constexpr int WG_STAGES = 4;                         // TMA ring
constexpr int WG_THREADS = 288;  // two consumer warpgroups + a producer warp
constexpr int WG_RED_STRIDE = WG_BM + 4;  // floats a row of the epilogue's f32 tile

// Shared memory of the wgmma kernel, in bytes from a 1024-byte aligned base
// (the 128-byte swizzle repeats every 1024 bytes): the ring's x tiles
// [128 x 64] bf16, integer tiles [64 x 128] int8 or [32 x 128] packed int4
// and (int4) up to four scale rows [128] f32, then the ring's full and
// empty barriers.  The epilogue's f32 tile [128 x RED_STRIDE] reuses the
// ring.
template <int BITS>
struct WgSmem {
  static constexpr int X = WG_BM * WG_KT * 2;
  static constexpr int W = (BITS == 8 ? WG_KT : WG_KT / 2) * WG_BN;
  static constexpr int S = BITS == 4 ? 4 * WG_BN * 4 : 0;
  static constexpr int X_OFF = 0;
  static constexpr int W_OFF = X_OFF + WG_STAGES * X;
  static constexpr int S_OFF = W_OFF + WG_STAGES * W;
  static constexpr int BAR_OFF = S_OFF + WG_STAGES * S;
  static constexpr int BYTES = BAR_OFF + 2 * WG_STAGES * 8 + 1024;  // + the alignment slack
  static_assert(WG_BM * WG_RED_STRIDE * 4 <= BAR_OFF, "the epilogue tile must fit in the ring");
};

// This warp's A fragments for the four 16-row steps of a stage, from the
// integer tile `wt` (128-byte rows, 16-byte chunk c of row k at chunk
// c ^ (k & 7), as TMA wrote it).  The warp's 16 A rows are 16 columns of
// W, chunk `c` of each row, permuted so that A row g (lane / 4) is column
// 2g and row g + 8 column 2g + 1: a thread's two rows are then one byte
// pair.  int8: `ldmatrix.trans` of 8 x 8 b16 matrices (rows of K, byte
// pairs) hands thread (g, t = lane % 4) the pairs of rows 2t and 2t + 1 of
// columns 2g, 2g + 1; int4: a packed row holds both rows of a thread's K
// pair, one 16-bit load per row pair.  Values are exact in bf16.
template <int BITS>
__device__ __forceinline__ void load_a(const uint8_t* wt, int c, int lane, uint32_t (&a)[4][4]) {
  if constexpr (BITS == 8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows 32 h .. 32 h + 31: four matrices of 8 rows
      const int k = 32 * h + lane;  // this lane's row address: matrix lane / 8, row lane % 8
      uint32_t r[4];
      const uint32_t addr = smem_u32(wt + k * 128 + ((c ^ (k & 7)) << 4));
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                   : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                   : "r"(addr));
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // step 2h + q: rows +0..7 in r[2q], +8..15 in r[2q+1]
        const uint32_t lo = r[2 * q] ^ 0x80808080u, hi = r[2 * q + 1] ^ 0x80808080u;
        uint32_t* f = a[2 * h + q];
        f[0] = pack_bf16(i8_value(lo, 0), i8_value(lo, 2));  // column 2g, rows 2t, 2t + 1
        f[1] = pack_bf16(i8_value(lo, 1), i8_value(lo, 3));  // column 2g + 1
        f[2] = pack_bf16(i8_value(hi, 0), i8_value(hi, 2));  // rows 2t + 8, 2t + 9
        f[3] = pack_bf16(i8_value(hi, 1), i8_value(hi, 3));
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const __nv_bfloat162 off = __floats2bfloat162_rn(136.0f, 136.0f);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int p0 = 8 * j + t, p1 = p0 + 4;  // packed rows: K rows 2p, 2p + 1
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int p = h ? p1 : p0;
        // bytes b0 (column 2g), b1 (2g + 1) of the row; x = v | v << 12
        // holds b0's nibbles at bits 0 and 16 and b1's at 8 and 24, so each
        // byte's {low, high} nibbles land in a bf16x2's mantissas at 128
        // (xor 8 and 136 off make them signed) with one mask
        const uint32_t v = *reinterpret_cast<const uint16_t*>(wt + p * 128 + ((c ^ (p & 7)) << 4) + 2 * g);
        const uint32_t x = v | (v << 12);
        uint32_t u[2] = {(x & 0x000F000Fu) ^ 0x43084308u, ((x >> 8) & 0x000F000Fu) ^ 0x43084308u};
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          __nv_bfloat162 r = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&u[e]), off);
          a[j][2 * h + e] = *reinterpret_cast<uint32_t*>(&r);
        }
      }
    }
  }
}

// M > 64 (prefill), N a multiple of 16, x, w, scale and y on 16-byte
// boundaries: a block takes 128 rows of x x 128 output columns over rows
// [z kchunk, (z + 1) kchunk) of K, as y^T = W^T x^T.  Warp 8 is the
// producer: one thread keeps a ring of TMA loads in flight (x's tile
// 128-byte swizzled, the integer tile, and for int4 the tile's scale
// rows), each stage tracked by a full and an empty mbarrier.  Warpgroups 0
// and 1 are the consumers, 64 columns of W each: per stage a warpgroup
// dequantizes its columns straight into the A fragments of four wgmma
// m64n128k16 (A from registers, x's tile the B operand from shared memory),
// so no bf16 copy of W is written.  int8 keeps two sets of fragments and
// dequantizes stage t + 1 while stage t's products run.  int4 accumulates
// each group in a partial (its first wgmma overwrites it) and at the
// group's end rounds it and adds it times the rounded scale to the
// accumulator; the warpgroups take turns at the tensor cores, so one's
// flush and dequantization run while the other's products do.  The
// epilogue goes through shared memory: 16-byte stores, and with K split
// the partials and the last block's sum in split order.
template <int BITS, bool WHOLE>
__global__ void __launch_bounds__(WG_THREADS, 1)
qgemm_wgmma_kernel(const __grid_constant__ CUtensorMap tx, const __grid_constant__ CUtensorMap tw,
                   const __grid_constant__ CUtensorMap ts, const float* __restrict__ scale,
                   __nv_bfloat16* __restrict__ y, float* __restrict__ scratch,
                   int* __restrict__ counters, int M, int N, int K, int group, int kchunk,
                   int ksplit, int srows) {
  using L = WgSmem<BITS>;
  extern __shared__ uint8_t smem_raw[];
  // offset from the array itself (not a cast integer), so the compiler
  // keeps the accesses shared-memory loads and stores
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + WG_STAGES;
  const int kbeg = blockIdx.z * kchunk;
  const int kend = min(K, kbeg + kchunk);
  const int ntiles = (kend - kbeg + WG_KT - 1) / WG_KT;  // >= 1: no split is empty

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < WG_STAGES; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival (plus the TMA bytes)
      mbar_init(empty + s, 2);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      // TMA counts every byte of a box, the zero-filled ones past an edge too
      const uint32_t bytes = L::X + L::W + (BITS == 4 ? srows * WG_BN * 4 : 0);
      const int n0 = blockIdx.x * WG_BN, m0 = blockIdx.y * WG_BM;
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % WG_STAGES;
        mbar_wait(empty + s, ((t / WG_STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, bytes);
        const int k0 = kbeg + t * WG_KT;
        tma_load_2d(smem + L::X_OFF + s * L::X, &tx, full + s, k0, m0);
        tma_load_2d(smem + L::W_OFF + s * L::W, &tw, full + s, n0, BITS == 8 ? k0 : k0 / 2);
        if constexpr (BITS == 4)
          tma_load_2d(smem + L::S_OFF + s * L::S, &ts, full + s, n0, k0 / group);
      }
    }
    return;
  }

  const int cw = threadIdx.x >> 7;  // columns 64 cw .. 64 cw + 63 of the tile
  const int ltid = threadIdx.x & 127, lane = ltid & 31, warp = ltid >> 5;
  const int chunk = 4 * cw + warp;  // this warp's 16 columns: chunk of a 128-byte row
  uint32_t afrag[4][4], bfrag[4][4];  // A fragments of a stage (int8: two, alternating)

  // stage t: wait for its loads, dequantize this warp's A fragments into
  // `a`; returns the shared address of x's tile
  auto stage_in = [&](int t, uint32_t (&a)[4][4]) {
    const int s = t % WG_STAGES;
    mbar_wait(full + s, (t / WG_STAGES) & 1);
    load_a<BITS>(smem + L::W_OFF + s * L::W, chunk, lane, a);
    return smem_u32(smem + L::X_OFF + s * L::X);
  };
  // the four wgmma of a stage (16 rows of K each) into d; scale_d 0 on the
  // first overwrites d.  A tile past K holds zeros (TMA's fill), so all
  // four run.
  auto issue4 = [&](float (&d)[64], uint32_t xa, const uint32_t (&a)[4][4], int first_scale_d) {
    fence_operands(d);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < WG_KT / 16; ++j) {
      wgmma_128_rs(d, a[j], gmma_desc(xa + 32 * j, 16, 1024), j == 0 ? first_scale_d : 1);
    }
    wgmma_commit();
  };
  auto release = [&](int t) {
    if (ltid == 0) mbar_arrive(empty + t % WG_STAGES);
  };
  // warpgroup w's turn at the tensor cores: named barrier 2 + w, passed by
  // the other warpgroup (bar.arrive) and taken by w (bar.sync)
  auto turn_wait = [&](int w) { asm volatile("bar.sync %0, 256;\n" ::"r"(2 + w) : "memory"); };
  auto turn_pass = [&](int w) { asm volatile("bar.arrive %0, 256;\n" ::"r"(2 + w) : "memory"); };
  // this thread's two scales (columns 2g and 2g + 1 of its warp's 16; a
  // thread's A rows) in scale row r of stage t, rounded to bf16
  auto scales = [&](int t, int r) {
    const float2 s2 = *reinterpret_cast<const float2*>(
        smem + L::S_OFF + (t % WG_STAGES) * L::S + 4 * (r * WG_BN + 64 * cw + 16 * warp + 2 * (lane >> 2)));
    return make_float2(bf16_round(s2.x), bf16_round(s2.y));
  };
  // acc += round(p) * s, s this thread's rounded scales
  auto flush = [&](float (&p)[64], float (&acc)[64], float2 s) {
#pragma unroll
    for (int jm = 0; jm < 16; ++jm) {
      add_rounded_pair(acc[4 * jm], acc[4 * jm + 1], p[4 * jm], p[4 * jm + 1], s.x, s.x);
      add_rounded_pair(acc[4 * jm + 2], acc[4 * jm + 3], p[4 * jm + 2], p[4 * jm + 3], s.y, s.y);
    }
  };

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  if constexpr (BITS == 8) {
    // two sets of A fragments: stage t + 1 is dequantized while the
    // products of stage t are in flight
    uint32_t xa = stage_in(0, afrag);
    issue4(acc, xa, afrag, 1);
    int t = 1;
    for (; t + 1 < ntiles; t += 2) {
      xa = stage_in(t, bfrag);
      issue4(acc, xa, bfrag, 1);
      wgmma_wait<1>();  // stage t - 1's products are done: its fragments and stage are free
      release(t - 1);
      xa = stage_in(t + 1, afrag);
      issue4(acc, xa, afrag, 1);
      wgmma_wait<1>();
      release(t);
    }
    for (; t < ntiles; ++t) {
      xa = stage_in(t, bfrag);
      issue4(acc, xa, bfrag, 1);
      wgmma_wait<1>();
      release(t - 1);
    }
    wgmma_wait<0>();
    fence_operands(acc);
  } else if constexpr (WHOLE) {
    // int4, groups of gt whole tiles: one partial, overwritten by its
    // group's first products and flushed after its last, with the scales
    // read before those products start.  A stage's products run alone
    // (issued, then waited for), and the two warpgroups take turns at them:
    // while one's products run, the other flushes and dequantizes the next
    // stage.  No branch holds a wgmma operand (ptxas serializes a wgmma
    // whose registers a branch it cannot prove uniform touches).
    float p0[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) p0[i] = 0.0f;
    const int gt = group / WG_KT, ngroups = ntiles / gt;
    auto mma = [&](uint32_t xa, int first_scale_d) {
      turn_wait(cw);
      issue4(p0, xa, afrag, first_scale_d);
      wgmma_wait<0>();
      turn_pass(cw ^ 1);
    };
    int t = 0;
    uint32_t xa;
    auto run_group = [&]() {  // the group's first tile is staged in xa, afrag
      int scale_d = 0;
      for (int i = 1; i < gt; ++i) {  // the group's tiles but its last
        mma(xa, scale_d);
        scale_d = 1;
        release(t);
        xa = stage_in(++t, afrag);
      }
      const float2 s = scales(t, 0);  // the stage's scale box starts at the group's row
      mma(xa, scale_d);
      fence_operands(p0);
      flush(p0, acc, s);
      release(t);
    };
    if (cw == 1) turn_pass(0);  // warpgroup 0 starts
    xa = stage_in(0, afrag);
    for (int G = 0; G < ngroups - 1; ++G) {
      run_group();
      xa = stage_in(++t, afrag);
    }
    run_group();
    if (cw == 0) turn_wait(0);  // warpgroup 1's last pass: every turn is taken
  } else {
    // int4, groups of 16-48 rows or not a multiple of 64: a group may end
    // inside a tile, and is flushed there.
    float p0[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) p0[i] = 0.0f;
    for (int t = 0; t < ntiles; ++t) {
      const uint32_t xa = stage_in(t, afrag);
      const int kl = t * WG_KT;  // from kbeg, a group boundary
      fence_operands(p0);
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < WG_KT / 16; ++j) {
        const int k = kl + 16 * j;
        if (kbeg + k >= kend) break;
        wgmma_128_rs(p0, afrag[j], gmma_desc(xa + 32 * j, 16, 1024), k % group != 0);
        if ((k + 16) % group == 0) {  // the group ends: round, scale, add
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(p0);
          flush(p0, acc, scales(t, k / group - t * WG_KT / group));
          fence_operands(p0);
          wgmma_fence();
        }
      }
      wgmma_commit();
      wgmma_wait<0>();
      release(t);
    }
  }

  // Epilogue: the two warpgroups' fragments (rows: columns of W, columns:
  // rows of x) into an f32 tile [m][n] in the ring (free now), then each
  // thread takes 8 consecutive columns of 8 rows: the int8 scales loaded
  // once, 16-byte stores.  With K split, the block writes its partial, and
  // the last of the tile's blocks to arrive sums the partials in split
  // order (the same sums on every call).
  consumers_sync();
  float* red = reinterpret_cast<float*>(smem);
  {
    const int nc = 64 * cw + 16 * warp + 2 * (lane >> 2);  // columns nc (A row g), nc + 1 (g + 8)
#pragma unroll
    for (int jm = 0; jm < 16; ++jm) {
      const int m = 8 * jm + 2 * (lane & 3);
      *reinterpret_cast<float2*>(red + m * WG_RED_STRIDE + nc) = make_float2(acc[4 * jm], acc[4 * jm + 2]);
      *reinterpret_cast<float2*>(red + (m + 1) * WG_RED_STRIDE + nc) =
          make_float2(acc[4 * jm + 1], acc[4 * jm + 3]);
    }
  }
  consumers_sync();
  const int tid = threadIdx.x;
  const int cg = tid & 15, r0 = tid >> 4;  // columns 8 cg .. 8 cg + 7, rows r0 + 16 p
  const int n = blockIdx.x * WG_BN + 8 * cg, m0 = blockIdx.y * WG_BM;
  const bool n_ok = n < N;  // N is a multiple of 16: a group of 8 is all in or all out
  float sc[8];
#pragma unroll
  for (int e = 0; e < 8; ++e) sc[e] = 1.0f;
  if (BITS == 8 && n_ok) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(scale + n));
    const float4 b = __ldg(reinterpret_cast<const float4*>(scale + n) + 1);
    sc[0] = a.x; sc[1] = a.y; sc[2] = a.z; sc[3] = a.w;
    sc[4] = b.x; sc[5] = b.y; sc[6] = b.z; sc[7] = b.w;
  }
  auto store = [&](const float (&v)[8], int m) {
    uint32_t o[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      __nv_bfloat162 h = BITS == 8 ? __floats2bfloat162_rn(bf16_round(v[2 * e]) * bf16_round(sc[2 * e]),
                                                            bf16_round(v[2 * e + 1]) * bf16_round(sc[2 * e + 1]))
                                   : __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
      o[e] = *reinterpret_cast<uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(y + (size_t)m * N + n) = make_uint4(o[0], o[1], o[2], o[3]);
  };
  constexpr int PASSES = WG_BM / 16;
  if (ksplit == 1) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int r = r0 + 16 * p;
      const float4 a = *reinterpret_cast<const float4*>(red + r * WG_RED_STRIDE + 8 * cg);
      const float4 b = *reinterpret_cast<const float4*>(red + r * WG_RED_STRIDE + 8 * cg + 4);
      const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
      if (n_ok && m0 + r < M) store(v, m0 + r);
    }
    return;
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p) {
    const int r = r0 + 16 * p;
    if (n_ok && m0 + r < M) {
      float4* dst = reinterpret_cast<float4*>(scratch + ((size_t)blockIdx.z * M + m0 + r) * N + n);
      dst[0] = *reinterpret_cast<const float4*>(red + r * WG_RED_STRIDE + 8 * cg);
      dst[1] = *reinterpret_cast<const float4*>(red + r * WG_RED_STRIDE + 8 * cg + 4);
    }
  }
  __shared__ int s_last;
  __threadfence();
  consumers_sync();
  if (tid == 0) {
    const int tile = blockIdx.y * gridDim.x + blockIdx.x;
    s_last = atomicAdd(counters + tile, 1) == ksplit - 1;
    if (s_last) counters[tile] = 0;  // every split has arrived: ready for the next call
  }
  consumers_sync();
  if (!s_last) return;
  __threadfence();
  float v[PASSES][8];
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
#pragma unroll
    for (int e = 0; e < 8; ++e) v[p][e] = 0.0f;
  for (int s = 0; s < ksplit; ++s) {
#pragma unroll
    for (int p = 0; p < PASSES; ++p) {
      const int m = m0 + r0 + 16 * p;
      if (n_ok && m < M) {
        const float4* src = reinterpret_cast<const float4*>(scratch + ((size_t)s * M + m) * N + n);
        const float4 a = __ldcg(src), b = __ldcg(src + 1);
        v[p][0] += a.x; v[p][1] += a.y; v[p][2] += a.z; v[p][3] += a.w;
        v[p][4] += b.x; v[p][5] += b.y; v[p][6] += b.z; v[p][7] += b.w;
      }
    }
  }
#pragma unroll
  for (int p = 0; p < PASSES; ++p)
    if (n_ok && m0 + r0 + 16 * p < M) store(v[p], m0 + r0 + 16 * p);
}

// ---------------------------------------------------------------- stream route
// Decode (bf16, M <= 64): a streaming weight-only GEMV.  A persistent grid
// (about one block per SM) walks a list of work units, each (member, column
// tile of 256, range of K); the units of a launch are cut from one sequence,
// the members' tiles in order and each tile's K in granules of 64 rows (int4:
// lcm(64, group), so ranges start on group boundaries), and block c takes
// granules [c T / C, (c + 1) T / C), so every block streams the same bytes
// to within one granule.  A producer warp keeps a ring of TMA loads in
// flight: per stage x's 64-row slice of K (zero-filled past M), the tile's
// two 128-column integer boxes side by side (so each row of W is read as
// 256 contiguous bytes) and int4's scale rows.  Eight consumer warps take
// 16 columns of each box: per stage they dequantize their A fragments
// (`load_a`, as the prefill kernel does) and run `mma.sync.m16n8k16`, y^T =
// W^T x^T, x's B fragments from the swizzled slice, read once for both
// boxes.  A tile whose K is cut between blocks sums its f32 partials behind
// the per-tile counter in split order, like `finish_tile`, so every call
// gives the same bits.  One launch takes 1-3 members that share x (QKV,
// gate/up).  KMAJ: the tied int8 head, W [N, K] with K contiguous (the
// embedding table), no scale epilogue (x is scaled per K by the caller).

constexpr int ST_KT = 64;           // rows of K a stage
constexpr int ST_BOX = 128;         // columns of an integer box: 8 consumer warps x 16
constexpr int ST_CH = 2;            // boxes side by side in a tile
constexpr int ST_BN = ST_BOX * ST_CH;  // output columns of a tile
constexpr int ST_THREADS = 288;     // eight consumer warps + a producer warp
// the ring holds this many bytes of weights (and scales) in flight: int8 4
// stages, int4 8; more in flight measured slower at int8 (PERF.md section 6)
constexpr int ST_RING_BYTES = 64 << 10;
constexpr int ST_SMEM = 232448;     // the most shared memory a block can use
// the weights' L2 promotion: none (a weight is read once; a stage's rows
// are whole 256-byte spans)
constexpr CUtensorMapL2promotion ST_L2 = CU_TENSOR_MAP_L2_PROMOTION_NONE;

struct StreamArgs {
  CUtensorMap tx;     // x [M, K] bf16: box [64, 8 MT], 128-byte swizzle
  CUtensorMap tw[3];  // each member's integers, box [128, 64] (KMAJ: [64, 128], 64-byte swizzle)
  CUtensorMap ts[3];  // int4: each member's scale rows, box [128, srows]
  const float* scale[3];
  __nv_bfloat16* y[3];
  float* scratch;     // two slots of 8 MT x 256 f32 a block
  int* counters;      // one a tile, zero between calls
  int n[3];
  int tiles[3];       // column tiles a member (0 past the members)
  int M, K, group;
  int granule;        // rows of K a granule
  int gcount;         // granules of a tile
  int total;          // granules of the launch
  int stages;         // ring stages
  int srows;          // int4: scale rows a stage
};

// bytes of a stage's x slice, integer boxes and scale boxes
__host__ __device__ inline void st_sizes(int bits, int mt, int srows, int& xb, int& wb, int& sb) {
  xb = 1024 * mt;
  wb = ST_CH * (bits == 8 ? ST_KT * ST_BOX : ST_KT / 2 * ST_BOX);
  sb = bits == 4 ? ST_CH * srows * ST_BOX * 4 : 0;
}

// the first granule of block c, and the block that owns granule s
// (kernels.qgemm_stream_plan computes the same)
__device__ __forceinline__ int st_first(int total, int ctas, int c) {
  return (int)((long long)c * total / ctas);
}
__device__ __forceinline__ int st_owner(int total, int ctas, int s) {
  return (int)(((long long)(s + 1) * ctas - 1) / total);
}

struct StUnit {
  int member, n0, k0, k1, gtile, next;
};

// the unit that starts at granule s of a block whose range ends at s_end
__device__ __forceinline__ StUnit st_unit(const StreamArgs& a, int s, int s_end) {
  StUnit u;
  const int gt = s / a.gcount, g0 = s - gt * a.gcount;
  const int g1 = min(a.gcount, g0 + (s_end - s));
  int t = gt, m = 0;
  if (t >= a.tiles[0]) {
    t -= a.tiles[0];
    m = 1;
    if (t >= a.tiles[1]) {
      t -= a.tiles[1];
      m = 2;
    }
  }
  u.member = m;
  u.n0 = t * ST_BN;
  u.k0 = g0 * a.granule;
  u.k1 = min(a.K, g1 * a.granule);
  u.gtile = gt;
  u.next = s + (g1 - g0);
  return u;
}

template <typename T>
__device__ __forceinline__ T st_pick(int m, T v0, T v1, T v2) {
  return m == 0 ? v0 : (m == 1 ? v1 : v2);
}

// KMAJ: this warp's A fragments for the four 16-column steps of a stage from
// a [128 rows of W, 64 bytes of K] box (64-byte swizzle: 16-byte chunk c
// of row r at chunk c ^ ((r >> 1) & 3)).  A row g is W row 2g of the warp's
// 16 and row g + 8 is 2g + 1, as `load_a` permutes columns, so the epilogue
// is shared.  The mma's k index is permuted: slots 2t, 2t + 1 take K 4t,
// 4t + 1 of the step and slots 2t + 8, 2t + 9 take 4t + 2, 4t + 3, so a
// thread's four bytes of a row are one load (`x_frag` permutes x alike).
// Lanes 0-15 load the even row first and lanes 16-31 the odd one, so the
// eight rows of each load fall in eight distinct bank groups.
__device__ __forceinline__ void load_a_kmajor(const uint8_t* wt, int warp, int lane,
                                              uint32_t (&a)[4][4]) {
  const int g = lane >> 2, t = lane & 3, sel = g >> 2;
  const int ra = 16 * warp + 2 * g + sel, rb = ra ^ 1;
  const int sw = (ra >> 1) & 3;  // the same for rb
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint32_t la = *reinterpret_cast<const uint32_t*>(wt + ra * 64 + ((j ^ sw) << 4) + 4 * t);
    const uint32_t lb = *reinterpret_cast<const uint32_t*>(wt + rb * 64 + ((j ^ sw) << 4) + 4 * t);
    const uint32_t w0 = (sel ? lb : la) ^ 0x80808080u, w1 = (sel ? la : lb) ^ 0x80808080u;
    a[j][0] = pack_bf16(i8_value(w0, 0), i8_value(w0, 1));
    a[j][1] = pack_bf16(i8_value(w1, 0), i8_value(w1, 1));
    a[j][2] = pack_bf16(i8_value(w0, 2), i8_value(w0, 3));
    a[j][3] = pack_bf16(i8_value(w1, 2), i8_value(w1, 3));
  }
}

// the B fragment (x^T) of rows 8i .. 8i + 7 of x for 16-row step j of the
// stage's x slice (128-byte rows, 128-byte swizzle; row & 7 is g)
template <bool KMAJ>
__device__ __forceinline__ void x_frag(const uint8_t* xt, int i, int j, int g, int t, uint32_t& b0,
                                       uint32_t& b1) {
  const uint8_t* row = xt + (8 * i + g) * 128;
  if constexpr (KMAJ) {  // K 4t .. 4t + 3 of the step: one 8-byte load
    const uint2 v = *reinterpret_cast<const uint2*>(row + (((2 * j + (t >> 1)) ^ g) << 4) + 8 * (t & 1));
    b0 = v.x;
    b1 = v.y;
  } else {  // K 2t, 2t + 1 and 2t + 8, 2t + 9 of the step
    b0 = *reinterpret_cast<const uint32_t*>(row + (((2 * j) ^ g) << 4) + 4 * t);
    b1 = *reinterpret_cast<const uint32_t*>(row + (((2 * j + 1) ^ g) << 4) + 4 * t);
  }
}

template <int BITS, int MT, bool KMAJ>
__global__ void __launch_bounds__(ST_THREADS, 1)
qgemm_stream_kernel(const __grid_constant__ StreamArgs a) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int xb, wb, sb;
  st_sizes(BITS, MT, a.srows, xb, wb, sb);
  const int wbox = wb / ST_CH, sbox = sb / ST_CH;
  const int nst = a.stages;
  const int w_off = nst * xb, s_off = w_off + nst * wb, bar_off = s_off + nst * sb;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + bar_off);
  uint64_t* empty = full + nst;
  const int ctas = gridDim.x, total = a.total;
  const int s_begin = st_first(total, ctas, blockIdx.x);
  const int s_end = st_first(total, ctas, blockIdx.x + 1);

  if (threadIdx.x == 0) {
    for (int s = 0; s < nst; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival (plus the TMA bytes)
      mbar_init(empty + s, 8);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {  // the producer warp
    if (threadIdx.x == 256) {
      // TMA counts every byte of a box, the zero-filled ones past an edge too
      const uint32_t bytes = xb + wb + sb;
      int st = 0, phase = 0;  // the ring slot and its pass parity
      for (int s = s_begin; s < s_end;) {
        const StUnit u = st_unit(a, s, s_end);
        const CUtensorMap* tw = st_pick(u.member, &a.tw[0], &a.tw[1], &a.tw[2]);
        const CUtensorMap* ts = st_pick(u.member, &a.ts[0], &a.ts[1], &a.ts[2]);
        for (int k0 = u.k0; k0 < u.k1; k0 += ST_KT, st = st + 1 == nst ? 0 : st + 1,
                 phase ^= st == 0) {
          mbar_wait(empty + st, phase ^ 1);
          mbar_expect_tx(full + st, bytes);
          tma_load_2d(smem + st * xb, &a.tx, full + st, k0, 0);
#pragma unroll
          for (int ch = 0; ch < ST_CH; ++ch) {
            uint8_t* wdst = smem + w_off + st * wb + ch * wbox;
            const int n = u.n0 + ch * ST_BOX;
            if constexpr (KMAJ)
              tma_load_2d(wdst, tw, full + st, k0, n);
            else
              tma_load_2d(wdst, tw, full + st, n, BITS == 8 ? k0 : k0 / 2);
            if constexpr (BITS == 4)
              tma_load_2d(smem + s_off + st * sb + ch * sbox, ts, full + st, n, k0 / a.group);
          }
        }
        s = u.next;
      }
    }
    return;
  }

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  // this thread's columns of box ch: nl, nl + 1 (A rows g, g + 8); of the tile, ch 128 + nl
  const int nl = 16 * warp + 2 * g;
  constexpr int SLOT = 8 * MT * ST_BN;
  // int4 groups of whole stages (the group a multiple of 64): each 16-row
  // step's products go to one of NQ independent accumulators (fresh at the
  // stage's first steps), summed in f32 at the stage's end, so the group's
  // flush waits for one product's latency, not a chain of four; registers
  // allow 4 of them to M = 16 and 2 to 32; past 32 rows the products chain
  // into the group's partial as for other groups
  constexpr int NQ = MT <= 2 ? 4 : (MT == 4 ? 2 : 1);
  const bool whole = BITS == 4 && NQ > 1 && a.group % ST_KT == 0;
  __shared__ int s_last;
  int st = 0, phase = 0;  // the ring slot and its pass parity
  for (int s = s_begin; s < s_end;) {
    const StUnit u = st_unit(a, s, s_end);
    float acc[ST_CH][MT][4], part[ST_CH][MT][4];  // part: int4's open group
#pragma unroll
    for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ch][i][e] = part[ch][i][e] = 0.0f;
    // acc += round(p) * s for this thread's two columns of each box, the
    // scales (row r of the stage's scale boxes) rounded
    auto flush = [&](float (&p)[ST_CH][MT][4], int r) {
#pragma unroll
      for (int ch = 0; ch < ST_CH; ++ch) {
        const float2 s2 = *reinterpret_cast<const float2*>(
            smem + s_off + st * sb + ch * sbox + 4 * (r * ST_BOX + nl));
        const float sx = bf16_round(s2.x), sy = bf16_round(s2.y);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          add_rounded_pair(acc[ch][i][0], acc[ch][i][1], p[ch][i][0], p[ch][i][1], sx, sx);
          add_rounded_pair(acc[ch][i][2], acc[ch][i][3], p[ch][i][2], p[ch][i][3], sy, sy);
        }
      }
    };
    int gleft = a.group;  // int4: rows of the open group still to come (ranges start on groups)

    for (int k0 = u.k0; k0 < u.k1;
         k0 += ST_KT, st = st + 1 == nst ? 0 : st + 1, phase ^= st == 0) {
      mbar_wait(full + st, phase);
      const uint8_t* xt = smem + st * xb;
      uint32_t af[ST_CH][4][4];
#pragma unroll
      for (int ch = 0; ch < ST_CH; ++ch) {
        if constexpr (KMAJ)
          load_a_kmajor(smem + w_off + st * wb + ch * wbox, warp, lane, af[ch]);
        else
          load_a<BITS>(smem + w_off + st * wb + ch * wbox, warp, lane, af[ch]);
      }
      if (BITS == 8 || !whole) {
        // int8 (and KMAJ): one accumulator, read only at the unit's end.
        // int4 groups of 16-48 rows (or not a multiple of 64), and M > 32:
        // the open group's partial, flushed at the step that ends it.
        const int srow0 = BITS == 4 ? k0 / a.group : 0;  // the stage's first scale row
#pragma unroll
        for (int j = 0; j < ST_KT / 16; ++j) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t b0, b1;
            x_frag<KMAJ>(xt, i, j, g, t, b0, b1);
#pragma unroll
            for (int ch = 0; ch < ST_CH; ++ch) {
              if constexpr (BITS == 8)
                mma_bf16(acc[ch][i], af[ch][j], b0, b1);
              else
                mma_bf16(part[ch][i], af[ch][j], b0, b1);
            }
          }
          if constexpr (BITS == 4) {
            gleft -= 16;
            if (gleft == 0) {
              flush(part, (k0 + 16 * j) / a.group - srow0);
#pragma unroll
              for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
                for (int i = 0; i < MT; ++i)
#pragma unroll
                  for (int e = 0; e < 4; ++e) part[ch][i][e] = 0.0f;
              gleft = a.group;
            }
          }
        }
      } else if constexpr (BITS == 4) {
        float q[NQ][ST_CH][MT][4];
#pragma unroll
        for (int j = 0; j < ST_KT / 16; ++j) {
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            uint32_t b0, b1;
            x_frag<KMAJ>(xt, i, j, g, t, b0, b1);
#pragma unroll
            for (int ch = 0; ch < ST_CH; ++ch) {
              if (j < NQ)
                mma_bf16_zero(q[j % NQ][ch][i], af[ch][j], b0, b1);
              else
                mma_bf16(q[j % NQ][ch][i], af[ch][j], b0, b1);
            }
          }
        }
        // the stage's products into the open group, in a fixed order
#pragma unroll
        for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              float v = part[ch][i][e];
#pragma unroll
              for (int jq = 0; jq < NQ; ++jq) v += q[jq][ch][i][e];
              part[ch][i][e] = v;
            }
        gleft -= ST_KT;
        if (gleft == 0) {  // the group ends with the stage: its scale row is the stage's first
          flush(part, 0);
#pragma unroll
          for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 4; ++e) part[ch][i][e] = 0.0f;
          gleft = a.group;
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty + st);
    }

    // Epilogue.  C fragment (ch, i, e): column ch 128 + nl + (e >> 1) of the
    // tile, row 8i + 2t + (e & 1) of x.
    const int N = st_pick(u.member, a.n[0], a.n[1], a.n[2]);
    __nv_bfloat16* y = st_pick(u.member, a.y[0], a.y[1], a.y[2]);
    float2 sc[ST_CH];
#pragma unroll
    for (int ch = 0; ch < ST_CH; ++ch) {
      const int n = u.n0 + ch * ST_BOX + nl;
      sc[ch] = make_float2(1.0f, 1.0f);
      if (BITS == 8 && !KMAJ && n < N) {
        const float* scale = st_pick(u.member, a.scale[0], a.scale[1], a.scale[2]);
        const float2 s2 = __ldg(reinterpret_cast<const float2*>(scale + n));
        sc[ch] = make_float2(bf16_round(s2.x), bf16_round(s2.y));
      }
    }
    auto store = [&](int ch, int m, float v0, float v1) {
      const int n = u.n0 + ch * ST_BOX + nl;
      if (m < a.M && n < N) {
        if (BITS == 8 && !KMAJ) {
          v0 = bf16_round(v0) * sc[ch].x;
          v1 = bf16_round(v1) * sc[ch].y;
        }
        *reinterpret_cast<__nv_bfloat162*>(y + (size_t)m * N + n) = __floats2bfloat162_rn(v0, v1);
      }
    };
    const int tile_s = u.gtile * a.gcount;
    const int cf = st_owner(total, ctas, tile_s), cl = st_owner(total, ctas, tile_s + a.gcount - 1);
    if (cf == cl) {  // the whole tile is this block's
#pragma unroll
      for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          store(ch, 8 * i + 2 * t, acc[ch][i][0], acc[ch][i][2]);
          store(ch, 8 * i + 2 * t + 1, acc[ch][i][1], acc[ch][i][3]);
        }
    } else {  // K cut between blocks cf..cl: partials, summed in block order by the last
      float* p = a.scratch + (size_t)(2 * blockIdx.x + (s == s_begin ? 0 : 1)) * SLOT;
#pragma unroll
      for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          const int m = 8 * i + 2 * t, c0 = ch * ST_BOX + nl;
          *reinterpret_cast<float2*>(p + m * ST_BN + c0) = make_float2(acc[ch][i][0], acc[ch][i][2]);
          *reinterpret_cast<float2*>(p + (m + 1) * ST_BN + c0) =
              make_float2(acc[ch][i][1], acc[ch][i][3]);
        }
      __threadfence();
      consumers_sync();
      if (threadIdx.x == 0) {
        s_last = atomicAdd(a.counters + u.gtile, 1) == cl - cf;
        if (s_last) a.counters[u.gtile] = 0;  // every split has arrived: ready for the next call
      }
      consumers_sync();
      if (s_last) {
        __threadfence();
        // the blocks' partials in block order, RB blocks' loaded at a time
        // (32 loads in flight a thread), then added
        constexpr int RB = 8 / MT;
        float v[ST_CH][MT][4];
#pragma unroll
        for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) v[ch][i][e] = 0.0f;
        for (int c0 = cf; c0 <= cl; c0 += RB) {
          float2 lo[RB][ST_CH][MT], hi[RB][ST_CH][MT];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int c = min(c0 + r, cl);
            // block c's unit of this tile is its first unless its range starts before the tile
            const float* q = a.scratch +
                             (size_t)(2 * c + (st_first(total, ctas, c) < tile_s ? 1 : 0)) * SLOT;
#pragma unroll
            for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                const int m = 8 * i + 2 * t, col = ch * ST_BOX + nl;
                lo[r][ch][i] = __ldcg(reinterpret_cast<const float2*>(q + m * ST_BN + col));
                hi[r][ch][i] = __ldcg(reinterpret_cast<const float2*>(q + (m + 1) * ST_BN + col));
              }
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (c0 + r > cl) break;
#pragma unroll
            for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
              for (int i = 0; i < MT; ++i) {
                v[ch][i][0] += lo[r][ch][i].x;
                v[ch][i][2] += lo[r][ch][i].y;
                v[ch][i][1] += hi[r][ch][i].x;
                v[ch][i][3] += hi[r][ch][i].y;
              }
          }
        }
#pragma unroll
        for (int ch = 0; ch < ST_CH; ++ch)
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            store(ch, 8 * i + 2 * t, v[ch][i][0], v[ch][i][2]);
            store(ch, 8 * i + 2 * t + 1, v[ch][i][1], v[ch][i][3]);
          }
      }
    }
    s = u.next;
  }
}

// the scale rows a 64-row tile of K touches at most; a block's K range
// starts on a group boundary, so a tile starts 64 t rows past one
int wg_scale_rows(int group) {
  int most = 1;
  for (int t = 0; t < group; ++t) most = max(most, ((WG_KT * t) % group + WG_KT - 1) / group + 1);
  return most;
}

template <int BITS>
int launch_wgmma(const void* x, const void* w, const void* scale, void* y, void* scratch,
                 void* counters, int M, int N, int K, int group, int kchunk, int ksplit,
                 cudaStream_t stream) {
  using L = WgSmem<BITS>;
  CUtensorMap tx, tw, ts;
  const int srows = BITS == 4 ? wg_scale_rows(group) : 0;
  bool ok = tensor_map(&tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, WG_KT,
                       WG_BM, CU_TENSOR_MAP_SWIZZLE_128B) &&
            tensor_map(&tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, BITS == 8 ? K : K / 2, N, WG_BN,
                       BITS == 8 ? WG_KT : WG_KT / 2, CU_TENSOR_MAP_SWIZZLE_128B);
  if (BITS == 4)
    ok = ok && tensor_map(&ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group,
                          (uint64_t)N * 4, WG_BN, srows, CU_TENSOR_MAP_SWIZZLE_NONE);
  else
    ts = tw;
  if (!ok) return (int)cudaErrorInvalidValue;
  // int4 groups of whole 64-row tiles take the peeled loop (WHOLE)
  auto kernel = qgemm_wgmma_kernel<BITS, true>;
  if constexpr (BITS == 4)
    if (group % WG_KT) kernel = qgemm_wgmma_kernel<BITS, false>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + WG_BN - 1) / WG_BN, (M + WG_BM - 1) / WG_BM, ksplit);
  kernel<<<grid, WG_THREADS, L::BYTES, stream>>>(
      tx, tw, ts, static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(scratch), static_cast<int*>(counters), M, N, K, group, kchunk, ksplit,
      srows);
  return (int)cudaGetLastError();
}

template <int BITS, int MT, bool KMAJ>
int launch_stream_t(StreamArgs& a, int ctas, cudaStream_t stream) {
  int xb, wb, sb;
  st_sizes(BITS, MT, a.srows, xb, wb, sb);
  // ST_RING_BYTES of weights in flight, within what shared memory holds
  // beside the barriers, the alignment slack and the kernel's static word
  a.stages = min((ST_RING_BYTES + wb + sb - 1) / (wb + sb), (ST_SMEM - 1024 - 256) / (xb + wb + sb + 16));
  const int bytes = a.stages * (xb + wb + sb + 16) + 1024;
  auto kernel = qgemm_stream_kernel<BITS, MT, KMAJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, ST_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int BITS, bool KMAJ>
int launch_stream(StreamArgs& a, int mt, int ctas, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch_stream_t<BITS, 1, KMAJ>(a, ctas, stream);
    case 2: return launch_stream_t<BITS, 2, KMAJ>(a, ctas, stream);
    case 4: return launch_stream_t<BITS, 4, KMAJ>(a, ctas, stream);
    case 8: return launch_stream_t<BITS, 8, KMAJ>(a, ctas, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// The generic kernel (`qgemm_generic_kernel`): every call the tensor-core
// routes above do not take (int4 groups that are not a multiple of 16, K
// not a multiple of 16, N not one of 8, x, q or scale off 16 bytes), the f32
// route (T = float), and the tied head's K-contiguous form (KMAJ) of both.
// Any M, N, K, any even group dividing K and any element-aligned pointer.
//
// The grid is the stream kernel's: the work is one sequence of granules
// (m tile of 8 MT rows, column tile of 256, 64 rows of K; int4: lcm(64,
// g) rows, so every range starts on a group boundary), cut into equal
// ranges, one a block, two blocks an SM up to 16 rows of x where each
// still takes eight granules (one with the whole ring otherwise), at least
// two granules a block (``kernels.qgemm_generic_plan`` computes the same).  A tile whose K is cut between blocks sums their f32
// partials in block order behind a per-tile counter: the same bits every
// call.
//
// Loads: a ring of stages (x's 8 MT rows of 64 columns, the integer rows,
// int4's scale rows with them), about 64 KB of weights and scales in
// flight a block.  All eight warps fill a stage by `cp.async`, 16 bytes a
// copy where the pointer and the row pitch allow it (8 or 4 otherwise,
// zeros past the edge; a 1- or 2-byte aligned tensor by plain loads).
// bf16 int4 at groups 2, 4 and 8 with every tensor on 16-byte boundaries
// (the served shapes) takes TMA instead: one thread, five boxes a stage,
// edges zero-filled by the copy engine; `cp.async` of the same stages
// measured ~1.9 TB/s alone at most on an H100 (PERF.md section 6).  Each
// integer byte and each scale is read from memory once; the scales are
// rounded to bf16 once a stage, in shared memory.
//
// Products (bf16): `mma.sync.m16n8k8`, y^T = W^T x^T as the stream kernel
// computes it: the dequantized weights are A (16 columns of W a fragment,
// permuted so that a thread's two A rows are adjacent columns: each warp
// takes 32 columns, a thread 4 consecutive ones, read as one 32-bit word
// of a row), x's rows are B (8 a tile, so M = 1-8 wastes no A rows).  An
// 8-row step that a group boundary cuts (g = 2, 4, 6, the tails of 24 and
// 40) is issued once per group it touches, with the B rows of the other
// groups zeroed (the TMA-fed groups 2, 4 and 8 as straight-line code over
// the stage, template GS); each group's products go to its partial, which is
// rounded to bf16, times the rounded scale (exact in f32) and added in f32
// when the group ends: the JAX function's numerics, no rounding skipped.
// f32 (T = float): the same tiles and fragments, the products as f32 FMAs
// on the CUDA cores (TF32 would miss the f32 tolerance).
//
// What bounds it on the H100: at decode the weight read, 0.5 byte a weight
// plus 4/g bytes of scale (16.8 MB at 4096 x 4096, g = 8: 5.0 us at 3.35
// TB/s); at M = 512 the group flush, one round, multiply and add on the
// CUDA cores per output and group (1.07 G at 4096 x 4096, g = 8, M = 512).
constexpr int GN_KT = 64;                  // rows of K a stage
constexpr int GN_BN = 256;                 // output columns of a tile: 8 warps x 32
constexpr int GN_THREADS = 256;
constexpr int GN_MAX_STAGES = 8;
constexpr int GN_RING_BYTES = 64 << 10;    // weights and scales in flight a block slot
constexpr int GN_MIN_GRANULES = 2;         // granules a block takes at least
constexpr int GN_DEEP = 8;                 // granules a block at two an SM, at least
constexpr int GN_SMEM = 232448;            // the most shared memory a block can use
// shared-memory row pitches (bytes, multiples of 16), padded so that a
// warp's fragment loads fall in distinct banks: integer rows of int8 [K, N]
// and packed int4, the K-contiguous table's rows, a scale row
constexpr int GN_WS8 = GN_BN + 16, GN_WS4 = GN_BN + 32, GN_WSK = GN_KT + 16;
constexpr int GN_SROW = GN_BN * 4;

template <typename T> struct GnF32 { static constexpr bool value = false; };
template <> struct GnF32<float> { static constexpr bool value = true; };

template <typename T> __device__ __forceinline__ float round_to(float v) { return v; }
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) { return bf16_round(v); }
__device__ __forceinline__ void store_t(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_t(__nv_bfloat16* p, float v) { *p = __float2bfloat16_rn(v); }

struct GnArgs {
  CUtensorMap tx, tw, ts;  // TMA forms: x [64 x 8 MT], w [128 x 32] (two a stage), scales [128 x srows]
  const void* x;          // [M, K], T
  const uint8_t* w;       // int8 [K, N], packed int4 [K/2, N] or (KMAJ) int8 [N, K]
  const float* scale;     // [1, N] (int8), [K/g, N] (int4), none (KMAJ)
  void* y;                // [M, N], T
  float* scratch;         // two slots of 8 MT x 256 f32 a block
  int* counters;          // one a tile, zero between calls
  int M, N, K, group;
  int ntiles;             // column tiles
  int granule, gcount;    // rows of K a granule, granules a tile
  int total;              // granules of the launch
  int stages, srows;      // ring stages; int4: scale rows a stage
  int lvx, lvw, lvs;      // log2 of the copy width (bytes) of x, w and the scales
};

// bytes of a stage's x rows, integer rows and scale rows; TMA: x's 128-byte
// swizzled rows, two swizzled [32 x 128] integer boxes, two scale boxes
template <typename T, int BITS, bool KMAJ, bool TMA>
__host__ __device__ inline void gn_sizes(int mt, int srows, int& xb, int& wb, int& sb) {
  xb = 8 * mt * (GN_KT * (int)sizeof(T) + (TMA ? 0 : 16));
  wb = TMA ? GN_KT / 2 * GN_BN : KMAJ ? GN_BN * GN_WSK : (BITS == 8 ? GN_KT * GN_WS8 : GN_KT / 2 * GN_WS4);
  sb = BITS == 4 ? srows * GN_SROW : 0;
}

struct GnUnit {
  int m0, n0, k0, k1, gtile, next;
};

// the unit that starts at granule s of a block whose range ends at s_end
__device__ __forceinline__ GnUnit gn_unit(const GnArgs& a, int s, int s_end, int bm) {
  GnUnit u;
  const int gt = s / a.gcount, g0 = s - gt * a.gcount;
  const int g1 = min(a.gcount, g0 + (s_end - s));
  u.m0 = gt / a.ntiles * bm;
  u.n0 = gt % a.ntiles * GN_BN;
  u.k0 = g0 * a.granule;
  u.k1 = min(a.K, g1 * a.granule);
  u.gtile = gt;
  u.next = s + (g1 - g0);
  return u;
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// wait until at most n of this thread's copy groups are in flight
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// Rows [r0, r0 + R) x bytes [c0, c0 + 2^lcb) of a row-major array (`pitch`
// bytes a row, nr rows of nc bytes) to shared memory at dst (`ds` bytes a
// row), in chunks of 2^lv bytes: `cp.async` for 4-16 (zeros past the
// array's edge), plain byte loads and stores for 1 and 2.
__device__ __forceinline__ void gn_copy(uint8_t* dst, int ds, const uint8_t* base, long long pitch,
                                        long long nr, long long nc, long long r0, long long c0,
                                        int R, int lcb, int lv) {
  const int v = 1 << lv, lper = lcb - lv;
  const int n = R << lper;
  for (int idx = threadIdx.x; idx < n; idx += GN_THREADS) {
    const int r = idx >> lper, cb = (idx - (r << lper)) << lv;
    const long long gr = r0 + r, gc = c0 + cb;
    const int valid = gr < nr && gc < nc ? (int)min((long long)v, nc - gc) : 0;
    const uint8_t* src = valid ? base + gr * pitch + gc : base;
    uint8_t* d = dst + r * ds + cb;
    if (lv >= 2) {
      const uint32_t sd = smem_u32(d);
      if (v == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(sd), "l"(src), "r"(valid) : "memory");
      else if (v == 8)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(sd), "l"(src), "r"(valid) : "memory");
      else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(sd), "l"(src), "r"(valid) : "memory");
    } else {
      for (int b = 0; b < v; ++b) d[b] = b < valid ? src[b] : 0;
    }
  }
}

// gn_copy of R rows of 2^lcb bytes that lie inside the array, 16 bytes a
// copy on 16-byte boundaries: no bounds to check
__device__ __forceinline__ void gn_copy16(uint8_t* dst, int ds, const uint8_t* src, long long pitch,
                                          int R, int lcb) {
  const int lper = lcb - 4, n = R << lper;
  for (int idx = threadIdx.x; idx < n; idx += GN_THREADS) {
    const int r = idx >> lper, cb = (idx & ((1 << lper) - 1)) << 4;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst + r * ds + cb)),
                 "l"(src + r * pitch + cb)
                 : "memory");
  }
}

// one stage: x's rows of the unit's m tile, K [k0, k0 + 64); the integer
// rows (or, KMAJ, the tile's table rows) of the same K; int4's scale rows.
// A box inside its array, every row on a 16-byte boundary, takes gn_copy16.
template <typename T, int BITS, bool KMAJ, int MT>
__device__ __forceinline__ void gn_load(const GnArgs& a, uint8_t* stage, int xb, int wb,
                                        const GnUnit& u, int k0) {
  constexpr int TS = sizeof(T), XS = GN_KT * TS + 16;
  const bool inside = u.n0 + GN_BN <= a.N && k0 + GN_KT <= a.K;
  const uint8_t* x = static_cast<const uint8_t*>(a.x);
  if (a.lvx == 4 && inside && u.m0 + 8 * MT <= a.M)
    gn_copy16(stage, XS, x + ((long long)u.m0 * a.K + k0) * TS, (long long)a.K * TS, 8 * MT,
              TS == 4 ? 8 : 7);
  else
    gn_copy(stage, XS, x, (long long)a.K * TS, a.M, (long long)a.K * TS, u.m0, (long long)k0 * TS,
            8 * MT, TS == 4 ? 8 : 7, a.lvx);
  uint8_t* ws = stage + xb;
  const bool wfast = a.lvw == 4 && inside;
  if constexpr (KMAJ) {
    if (wfast)
      gn_copy16(ws, GN_WSK, a.w + (long long)u.n0 * a.K + k0, a.K, GN_BN, 6);
    else
      gn_copy(ws, GN_WSK, a.w, a.K, a.N, a.K, u.n0, k0, GN_BN, 6, a.lvw);
  } else if constexpr (BITS == 8) {
    if (wfast)
      gn_copy16(ws, GN_WS8, a.w + (long long)k0 * a.N + u.n0, a.N, GN_KT, 8);
    else
      gn_copy(ws, GN_WS8, a.w, a.N, a.K, a.N, k0, u.n0, GN_KT, 8, a.lvw);
  } else {
    if (wfast)
      gn_copy16(ws, GN_WS4, a.w + (long long)(k0 / 2) * a.N + u.n0, a.N, GN_KT / 2, 8);
    else
      gn_copy(ws, GN_WS4, a.w, a.N, a.K / 2, a.N, k0 / 2, u.n0, GN_KT / 2, 8, a.lvw);
  }
  if constexpr (BITS == 4) {
    const uint8_t* sc = reinterpret_cast<const uint8_t*>(a.scale);
    const int g0 = k0 / a.group;
    if (a.lvs == 4 && inside)  // the rows the stage's groups take (fewer at K's end)
      gn_copy16(ws + wb, GN_SROW, sc + ((long long)g0 * a.N + u.n0) * 4, (long long)a.N * 4,
                min(a.srows, a.K / a.group - g0), 10);
    else
      gn_copy(ws + wb, GN_SROW, sc, (long long)a.N * 4, a.K / a.group, (long long)a.N * 4, g0,
              (long long)u.n0 * 4, a.srows, 10, a.lvs);
  }
}

// c += a . b, m16n8k8, bf16 in, f32 accumulate
__device__ __forceinline__ void mma_k8(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b));
}

// c = a . b, m16n8k8, the accumulator input zero
__device__ __forceinline__ void mma_k8_zero(float (&c)[4], const uint32_t (&a)[2], uint32_t b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5}, {%6}, {%7, %7, %7, %7};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(b), "f"(0.0f));
}

// int4's group flush for a thread's columns nb .. nb + 3: acc += round(part)
// * scale, the four scales (already rounded to T) at `sp` in the stage
template <typename T, int MT>
__device__ __forceinline__ void gn_flush(float (&acc)[2][MT][4], const float (&part)[2][MT][4],
                                         const uint8_t* sp) {
  const float4 s4 = *reinterpret_cast<const float4*>(sp);
  const float sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      if constexpr (GnF32<T>::value) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][i][e] = fmaf(part[h][i][e], sc[2 * h + (e >> 1)], acc[h][i][e]);
      } else {
        add_rounded_pair(acc[h][i][0], acc[h][i][1], part[h][i][0], part[h][i][1], sc[2 * h], sc[2 * h]);
        add_rounded_pair(acc[h][i][2], acc[h][i][3], part[h][i][2], part[h][i][3], sc[2 * h + 1],
                         sc[2 * h + 1]);
      }
    }
}

// The A fragments of 8-row step j for a thread's columns nb .. nb + 3: tile
// a's row g is column nb + 2a, row g + 8 column nb + 2a + 1; the thread's K
// pair is rows 8j + 2t, 8j + 2t + 1 (low, high half).  Values are exact in bf16.
template <int BITS, bool KMAJ, bool TMA = false>
__device__ __forceinline__ void gn_a_frags(const uint8_t* ws, int j, int nb, int t,
                                           uint32_t (&af)[2][2]) {
  if constexpr (TMA) {  // int4 in two [32 x 128] boxes, 16-byte chunk c of row p at c ^ (p & 7)
    const int p = 4 * j + t, c = nb & 127;
    const uint32_t v = *reinterpret_cast<const uint32_t*>(
        ws + (nb >> 7) * (GN_KT / 2 * 128) + p * 128 + (((c >> 4) ^ (p & 7)) << 4) + (c & 15));
#pragma unroll
    for (int q = 0; q < 4; ++q) af[q >> 1][q & 1] = i4_pair(v, q);
  } else if constexpr (KMAJ) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint32_t v =
          *reinterpret_cast<const uint16_t*>(ws + (nb + q) * GN_WSK + 8 * j + 2 * t) ^ 0x8080u;
      af[q >> 1][q & 1] = pack_bf16(i8_value(v, 0), i8_value(v, 1));
    }
  } else if constexpr (BITS == 8) {
    const uint32_t r0 = *reinterpret_cast<const uint32_t*>(ws + (8 * j + 2 * t) * GN_WS8 + nb) ^ 0x80808080u;
    const uint32_t r1 = *reinterpret_cast<const uint32_t*>(ws + (8 * j + 2 * t + 1) * GN_WS8 + nb) ^ 0x80808080u;
#pragma unroll
    for (int q = 0; q < 4; ++q) af[q >> 1][q & 1] = pack_bf16(i8_value(r0, q), i8_value(r1, q));
  } else {
    const uint32_t v = *reinterpret_cast<const uint32_t*>(ws + (4 * j + t) * GN_WS4 + nb);
#pragma unroll
    for (int q = 0; q < 4; ++q) af[q >> 1][q & 1] = i4_pair(v, q);
  }
}

// f32: the integer values of step j for a thread's columns nb + q, rows 8j + r
template <int BITS, bool KMAJ>
__device__ __forceinline__ void gn_w_values(const uint8_t* ws, int j, int nb, float (&wv)[4][8]) {
  if constexpr (KMAJ) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const uint2 v = *reinterpret_cast<const uint2*>(ws + (nb + q) * GN_WSK + 8 * j);
#pragma unroll
      for (int r = 0; r < 8; ++r) wv[q][r] = (float)(int8_t)((r < 4 ? v.x : v.y) >> (8 * (r & 3)));
    }
  } else if constexpr (BITS == 8) {
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(ws + (8 * j + r) * GN_WS8 + nb);
#pragma unroll
      for (int q = 0; q < 4; ++q) wv[q][r] = (float)(int8_t)(v >> (8 * q));
    }
  } else {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const uint32_t v = *reinterpret_cast<const uint32_t*>(ws + (4 * j + p) * GN_WS4 + nb);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int b = (v >> (8 * q)) & 0xFF;
        wv[q][2 * p] = (float)(((b & 15) ^ 8) - 8);
        wv[q][2 * p + 1] = (float)(((b >> 4) ^ 8) - 8);
      }
    }
  }
}

// Block slots an SM: two at M <= 16 (the decode shapes; <= 128 registers a
// thread), so one block's copies and flushes overlap the other's products.
__host__ __device__ constexpr int gn_blocks_per_sm(int mt) { return mt <= 2 ? 2 : 1; }

// The blocks an SM runs for a launch of `total` granules: both slots where
// each block still takes GN_DEEP granules, else one block with the whole
// ring (a short call's ramp and split tiles cost more than the overlap)
__host__ inline int gn_blocks_for(int mt, int total, int sms) {
  return gn_blocks_per_sm(mt) == 2 && total >= 2 * GN_DEEP * sms ? 2 : 1;
}

// Eight warps, a tile of 8 MT rows x 256 columns, warp w on columns 32 w ..
// 32 w + 31, thread (g, t) on nb = 32 w + 4 g .. nb + 3.  Fragment element
// (a, i, e) of acc / part: column nb + 2a + (e >> 1), row 8i + 2t + (e & 1).
// GS: a bf16 int4 group of 2, 4 or 8 (with TMA), whose stages run as
// straight-line code (a stage starts on a group boundary; each group's
// products go to a fresh partial, flushed at once); 0: any other group or
// alignment, int8, f32.
template <typename T, int BITS, bool KMAJ, int MT, int GS, bool TMA>
__global__ void __launch_bounds__(GN_THREADS, gn_blocks_per_sm(MT))
qgemm_generic_kernel(const __grid_constant__ GnArgs a) {
  static_assert(GS == 0 || (TMA && BITS == 4 && !GnF32<T>::value), "GS: the TMA-fed bf16 int4 form");
  constexpr int BM = 8 * MT;
  constexpr bool F32 = GnF32<T>::value;
  constexpr int XS = GN_KT * (int)sizeof(T) + 16;
  extern __shared__ __align__(16) uint8_t gn_raw[];
  // 1024-byte aligned (the 128-byte swizzle repeats every 1024 bytes)
  uint8_t* gn_smem = gn_raw + ((1024 - (smem_u32(gn_raw) & 1023)) & 1023);
  int xb, wb, sb;
  gn_sizes<T, BITS, KMAJ, TMA>(MT, a.srows, xb, wb, sb);
  const int stage_bytes = xb + wb + sb, nst = a.stages;
  // TMA: a full barrier a stage, completed by the copies' bytes
  uint64_t* full = reinterpret_cast<uint64_t*>(gn_smem + nst * stage_bytes);
  if (TMA && threadIdx.x == 0) {
    for (int st = 0; st < nst; ++st) mbar_init(full + st, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int ctas = gridDim.x, total = a.total;
  const int s_begin = st_first(total, ctas, blockIdx.x);
  const int s_end = st_first(total, ctas, blockIdx.x + 1);

  // the copy cursor runs ahead of the products by nst - 1 stages, across units
  int is = s_begin;
  GnUnit iu = gn_unit(a, is, s_end, BM);
  int ik = iu.k0;
  auto issue = [&](int slot) {
    if (is < s_end) {
      uint8_t* stage = gn_smem + slot * stage_bytes;
      if constexpr (TMA) {
        // every box counts whole, the zeros past an edge too
        if (threadIdx.x == 0) {
          mbar_expect_tx(full + slot, xb + wb + sb);
          tma_load_2d(stage, &a.tx, full + slot, ik, iu.m0);
#pragma unroll
          for (int ch = 0; ch < 2; ++ch) {
            tma_load_2d(stage + xb + ch * (wb / 2), &a.tw, full + slot, iu.n0 + 128 * ch, ik / 2);
            tma_load_2d(stage + xb + wb + ch * (sb / 2), &a.ts, full + slot, iu.n0 + 128 * ch,
                        ik / a.group);
          }
        }
      } else {
        gn_load<T, BITS, KMAJ, MT>(a, stage, xb, wb, iu, ik);
      }
      ik += GN_KT;
      if (ik >= iu.k1) {
        is = iu.next;
        if (is < s_end) {
          iu = gn_unit(a, is, s_end, BM);
          ik = iu.k0;
        }
      }
    }
    if constexpr (!TMA) cp_async_commit();  // an empty group past the range keeps the count
  };
  for (int st = 0; st + 1 < nst; ++st) issue(st);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int nb = 32 * warp + 4 * g;
  constexpr int SLOT = BM * GN_BN;
  __shared__ int s_last;
  int cs = 0, phase = 0;  // the ring slot of the next stage and its pass parity
  for (int s = s_begin; s < s_end;) {
    const GnUnit u = gn_unit(a, s, s_end, BM);
    float acc[2][MT][4], part[2][MT][4];  // part: int4's open group
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[h][i][e] = part[h][i][e] = 0.0f;
    int gleft = a.group;                              // int4: rows of the open group to come
    int grp = BITS == 4 ? u.k0 / a.group : 0;         // and its index
    for (int k0 = u.k0; k0 < u.k1; k0 += GN_KT) {
      if constexpr (TMA)
        mbar_wait(full + cs, phase);
      else
        cp_async_wait(nst - 2);
      __syncthreads();  // and every thread is done with the slot the issue below refills
      const uint8_t* xs = gn_smem + cs * stage_bytes;
      const uint8_t* ws = xs + xb;
      const uint8_t* ss = ws + wb;
      const int rows = min(GN_KT, u.k1 - k0);
      const int srow0 = BITS == 4 ? k0 / a.group : 0;  // the stage's first scale row
      if constexpr (BITS == 4 && !F32) {
        // the stage's scales rounded to bf16 once, in place, for every flush.
        // TMA refills the slot through the async proxy, so each writer fences
        // its writes before the barrier; thread 0, which issues the copies,
        // writes none (as in csrc/paged_tree.cu).
        float* sf = reinterpret_cast<float*>(const_cast<uint8_t*>(ss));
        const int wid = TMA ? (int)threadIdx.x - 1 : (int)threadIdx.x;
        const int writers = TMA ? GN_THREADS - 1 : GN_THREADS;
        if (wid >= 0) {
          for (int i = 4 * wid; i < a.srows * GN_BN; i += 4 * writers) {
            float4 v = *reinterpret_cast<float4*>(sf + i);
            v = make_float4(bf16_round(v.x), bf16_round(v.y), bf16_round(v.z), bf16_round(v.w));
            *reinterpret_cast<float4*>(sf + i) = v;
          }
          if constexpr (TMA) asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        }
        __syncthreads();
      }
      // the open group ends: acc += round(part) * scale, part = 0
      auto flush = [&]() {
        gn_flush<T, MT>(acc, part, ss + (grp - srow0) * GN_SROW + 4 * nb);
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) part[h][i][e] = 0.0f;
        ++grp;
        gleft = a.group;
      };
      if constexpr (!F32 && (BITS == 8 || GS != 0)) {
        // every step of the stage, rows past K included (their x, weights
        // and scales are zeros): no branch between the steps
#pragma unroll
        for (int j = 0; j < GN_KT / 8; ++j) {
          uint32_t af[2][2];
          gn_a_frags<BITS, KMAJ, TMA>(ws, j, nb, t, af);
          uint32_t bx[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i)  // TMA: 16-byte chunk j of row 8i + g at j ^ g
            bx[i] = TMA ? *reinterpret_cast<const uint32_t*>(xs + (8 * i + g) * 128 + ((j ^ g) << 4) + 4 * t)
                        : *reinterpret_cast<const uint32_t*>(xs + (8 * i + g) * XS + 2 * (8 * j + 2 * t));
          if constexpr (BITS == 8) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < MT; ++i) mma_k8(acc[h][i], af[h], bx[i]);
          } else {
#pragma unroll
            for (int q = 0; q < 8 / GS; ++q) {  // the step's groups: q's rows 8j + q GS ..
              const bool keep = 2 * t / GS == q;
              float p[2][MT][4];
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int i = 0; i < MT; ++i) mma_k8_zero(p[h][i], af[h], keep ? bx[i] : 0u);
              // the scales in two TMA boxes of [srows x 128]
              const int row = (8 * j) / GS + q;
              gn_flush<T, MT>(acc, p, ss + (nb >> 7) * (sb / 2) + row * 512 + 4 * (nb & 127));
            }
          }
        }
      } else if constexpr (!F32) {
        // any other group: a step in pieces that end where a group ends;
        // the thread's K pair (rows kk + 2t, + 1) is in one group (g is even)
#pragma unroll
        for (int j = 0; j < GN_KT / 8; ++j) {
          const int kk = 8 * j;
          if (kk >= rows) break;
          uint32_t af[2][2];
          gn_a_frags<BITS, KMAJ>(ws, j, nb, t, af);
          uint32_t bx[MT];
#pragma unroll
          for (int i = 0; i < MT; ++i)
            bx[i] = *reinterpret_cast<const uint32_t*>(xs + (8 * i + g) * XS + 2 * (kk + 2 * t));
          const int end = min(kk + 8, rows), mine = kk + 2 * t;
          for (int r = kk; r < end;) {
            const int take = min(gleft, end - r);
            const bool keep = mine >= r && mine < r + take;
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int i = 0; i < MT; ++i) mma_k8(part[h][i], af[h], keep ? bx[i] : 0u);
            gleft -= take;
            r += take;
            if (gleft == 0) flush();
          }
        }
      } else {
        // f32: the same fragments' outputs as FMAs, a K pair at a time
#pragma unroll
        for (int j = 0; j < GN_KT / 8; ++j) {
          const int kk = 8 * j;
          if (kk >= rows) break;
          float wv[4][8];
          gn_w_values<BITS, KMAJ>(ws, j, nb, wv);
#pragma unroll
          for (int p = 0; p < 4; ++p) {
            const int k = kk + 2 * p;
            if (k >= rows) break;
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              const float2 x0 = *reinterpret_cast<const float2*>(xs + (8 * i + 2 * t) * XS + 4 * k);
              const float2 x1 = *reinterpret_cast<const float2*>(xs + (8 * i + 2 * t + 1) * XS + 4 * k);
#pragma unroll
              for (int h = 0; h < 2; ++h)
#pragma unroll
                for (int e = 0; e < 4; ++e) {
                  const float* w2 = wv[2 * h + (e >> 1)] + 2 * p;
                  const float2 xr = (e & 1) ? x1 : x0;
                  float& c = BITS == 8 ? acc[h][i][e] : part[h][i][e];
                  c = fmaf(w2[1], xr.y, fmaf(w2[0], xr.x, c));
                }
            }
            if constexpr (BITS == 4) {
              gleft -= 2;
              if (gleft == 0) flush();
            }
          }
        }
      }
      issue(cs == 0 ? nst - 1 : cs - 1);  // the slot every thread finished with above
      cs = cs + 1 == nst ? 0 : cs + 1;
      phase ^= cs == 0;
    }

    // Epilogue: the whole tile's sums go to y; a tile cut between blocks
    // cf..cl goes through the partials, summed in block order by the last.
    T* y = static_cast<T*>(a.y);
    auto store = [&](float (&v)[2][MT][4]) {
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = u.m0 + 8 * i + 2 * t + (e & 1), n = u.n0 + nb + 2 * h + (e >> 1);
            if (m < a.M && n < a.N) {
              float o = v[h][i][e];
              if (BITS == 8 && !KMAJ) o = round_to<T>(o) * round_to<T>(__ldg(a.scale + n));
              store_t(y + (size_t)m * a.N + n, o);
            }
          }
    };
    const int tile_s = u.gtile * a.gcount;
    const int cf = st_owner(total, ctas, tile_s), cl = st_owner(total, ctas, tile_s + a.gcount - 1);
    if (cf == cl) {
      store(acc);
    } else {
      float* p = a.scratch + (size_t)(2 * blockIdx.x + (s == s_begin ? 0 : 1)) * SLOT;
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float4*>(p + (8 * i + 2 * t + e) * GN_BN + nb) =
              make_float4(acc[0][i][e], acc[0][i][2 + e], acc[1][i][e], acc[1][i][2 + e]);
      __threadfence();
      __syncthreads();
      if (threadIdx.x == 0) {
        s_last = atomicAdd(a.counters + u.gtile, 1) == cl - cf;
        if (s_last) a.counters[u.gtile] = 0;  // every split has arrived: ready for the next call
      }
      __syncthreads();
      if (s_last) {
        __threadfence();
        float v[2][MT][4];
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int i = 0; i < MT; ++i)
#pragma unroll
            for (int e = 0; e < 4; ++e) v[h][i][e] = 0.0f;
        // the blocks' partials in block order, RB blocks' loaded at a time
        constexpr int RB = 8 / MT;
        for (int c0 = cf; c0 <= cl; c0 += RB) {
          float4 f[RB][MT][2];
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            const int c = min(c0 + r, cl);
            // block c's unit of this tile is its first unless its range starts before the tile
            const float* q = a.scratch + (size_t)(2 * c + (st_first(total, ctas, c) < tile_s ? 1 : 0)) * SLOT;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e)
                f[r][i][e] = __ldcg(reinterpret_cast<const float4*>(q + (8 * i + 2 * t + e) * GN_BN + nb));
          }
#pragma unroll
          for (int r = 0; r < RB; ++r) {
            if (c0 + r > cl) break;
#pragma unroll
            for (int i = 0; i < MT; ++i)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                v[0][i][e] += f[r][i][e].x;
                v[0][i][2 + e] += f[r][i][e].y;
                v[1][i][e] += f[r][i][e].z;
                v[1][i][2 + e] += f[r][i][e].w;
              }
          }
        }
        store(v);
      }
    }
    s = u.next;
  }
  if constexpr (!TMA) cp_async_wait(0);
}

// log2 of the widest copy (16, 8, 4, 2 or 1 bytes) that a base pointer and
// a row pitch both allow
int gn_lv(const void* p, long long pitch) {
  for (int lv = 4; lv > 0; --lv)
    if ((uintptr_t)p % (1u << lv) == 0 && pitch % (1ll << lv) == 0) return lv;
  return 0;
}

template <typename T, int BITS, bool KMAJ, int MT, int GS, bool TMA>
int launch_generic_t(GnArgs& a, int ctas, int bps, cudaStream_t stream) {
  int xb, wb, sb;
  gn_sizes<T, BITS, KMAJ, TMA>(MT, a.srows, xb, wb, sb);
  const int stage = xb + wb + sb;
  // GN_RING_BYTES a slot of weights and scales in flight (a block alone on
  // its SM takes both slots' share), within its share of shared memory
  const int ring = GN_RING_BYTES * gn_blocks_per_sm(MT) / bps;
  a.stages = max(2, min(GN_MAX_STAGES, (ring + wb + sb - 1) / (wb + sb)));
  a.stages = min(a.stages, (GN_SMEM / bps - 2048) / (stage + 8));
  if (a.stages < 2) return (int)cudaErrorInvalidValue;
  const int bytes = a.stages * (stage + 8) + 1024;  // the ring, its barriers, the alignment slack
  auto kernel = qgemm_generic_kernel<T, BITS, KMAJ, MT, GS, TMA>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<ctas, GN_THREADS, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, int BITS, bool KMAJ, int GS, bool TMA = false>
int launch_generic(GnArgs& a, int mt, int ctas, int bps, cudaStream_t stream) {
  switch (mt) {
    case 1: return launch_generic_t<T, BITS, KMAJ, 1, GS, TMA>(a, ctas, bps, stream);
    case 2: return launch_generic_t<T, BITS, KMAJ, 2, GS, TMA>(a, ctas, bps, stream);
    case 4: return launch_generic_t<T, BITS, KMAJ, 4, GS, TMA>(a, ctas, bps, stream);
    case 8: return launch_generic_t<T, BITS, KMAJ, 8, GS, TMA>(a, ctas, bps, stream);
  }
  return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_generic(GnArgs& a, int bits, int kmajor, int mt, int ctas, int bps, bool tma,
                     cudaStream_t stream) {
  if (kmajor) return launch_generic<T, 8, true, 0>(a, mt, ctas, bps, stream);
  if (bits == 8) return launch_generic<T, 8, false, 0>(a, mt, ctas, bps, stream);
  if constexpr (!GnF32<T>::value) {  // aligned bf16 groups of 2, 4 and 8: straight-line, TMA-fed
    if (tma) {
      if (a.group == 8) return launch_generic<T, 4, false, 8, true>(a, mt, ctas, bps, stream);
      if (a.group == 4) return launch_generic<T, 4, false, 4, true>(a, mt, ctas, bps, stream);
      return launch_generic<T, 4, false, 2, true>(a, mt, ctas, bps, stream);
    }
  }
  return launch_generic<T, 4, false, 0>(a, mt, ctas, bps, stream);
}

template <int BITS, int MT, int WARPS_M>
void launch_mma(const void* x, const void* w, const void* scale, void* y, void* scratch,
                void* counters, int M, int N, int K, int group, int kchunk, int ksplit,
                cudaStream_t stream) {
  constexpr int BM = WARPS_M * MT * 8;
  dim3 grid((N + TILE_N - 1) / TILE_N, (M + BM - 1) / BM, ksplit);
  qgemm_mma_kernel<BITS, MT, WARPS_M><<<grid, THREADS, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y),
      static_cast<float*>(scratch), static_cast<int*>(counters), M, N, K, group, kchunk, ksplit);
}

template <int BITS>
int dispatch_mma(int mt, int warps_m, const void* x, const void* w, const void* scale, void* y,
                 void* scratch, void* counters, int M, int N, int K, int group, int kchunk,
                 int ksplit, cudaStream_t stream) {
  if (warps_m == 8)
    return launch_wgmma<BITS>(x, w, scale, y, scratch, counters, M, N, K, group, kchunk, ksplit,
                              stream);
  if (mt == 1 && warps_m == 1)
    launch_mma<BITS, 1, 1>(x, w, scale, y, scratch, counters, M, N, K, group, kchunk, ksplit, stream);
  else if (mt == 2 && warps_m == 1)
    launch_mma<BITS, 2, 1>(x, w, scale, y, scratch, counters, M, N, K, group, kchunk, ksplit, stream);
  else if (mt == 2 && warps_m == 4)
    launch_mma<BITS, 2, 4>(x, w, scale, y, scratch, counters, M, N, K, group, kchunk, ksplit, stream);
  else if (mt == 4 && warps_m == 4)
    launch_mma<BITS, 4, 4>(x, w, scale, y, scratch, counters, M, N, K, group, kchunk, ksplit, stream);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

}  // namespace

// x [M, K], w (int8 [K, N] or packed int4 [K/2, N]), scale (f32 [N] or
// [K/group, N]), y [M, N]; dtype 1 = bf16 (tensor cores; f32 takes
// `dabt_qgemm_generic`); bits 8 or 4; (mt, warps_m, ksplit, kchunk) the host's plan (bf16
// only): warps_m 8 takes the wgmma kernel (mt 2: two warpgroups of 64 rows,
// eight warps of 16; N a multiple of 16 and x, w and scale on 16-byte
// boundaries, which TMA needs; kchunk a multiple of 64), 1 or 4 the
// direct-load kernel with that many warps along M; mt m-tiles of 8 rows a
// warp; K split into ksplit ranges of kchunk rows (a block's for warps_m 4
// and 8, a warp's for 1).  With ksplit > 1,
// scratch holds ksplit * M * N floats and counters one zeroed int per
// output tile (``kernels.qgemm_tiles``), which every call leaves at zero.
// Returns cudaGetLastError(), or cudaErrorInvalidValue for arguments the
// kernels do not take.
extern "C" int dabt_qgemm(const void* x, const void* w, const void* scale, void* y, void* scratch,
                          void* counters, int dtype, int bits, int M, int N, int K, int group,
                          int mt, int warps_m, int ksplit, int kchunk, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N < 8 || K < 16 || N % 8 || K % 16 || (bits != 8 && bits != 4))
    return (int)cudaErrorInvalidValue;
  if (bits == 4 && (group < 16 || group % 16 || K % group)) return (int)cudaErrorInvalidValue;
  if (dtype != 1 || (warps_m != 1 && warps_m != 4 && warps_m != 8) || ksplit < 1 ||
      kchunk < 16 || kchunk % 16 || (bits == 4 && kchunk % group) ||
      (long long)ksplit * (warps_m == 8 ? 1 : THREADS / 32 / warps_m) * kchunk < K ||
      (ksplit > 1 && (scratch == nullptr || counters == nullptr)) ||
      (warps_m == 8 && (mt != 2 || N % 16 || kchunk % 64 || (long long)(ksplit - 1) * kchunk >= K ||
                        ((uintptr_t)x | (uintptr_t)w | (uintptr_t)scale | (uintptr_t)y) % 16)))
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return dispatch_mma<8>(mt, warps_m, x, w, scale, y, scratch, counters, M, N, K, group, kchunk,
                           ksplit, st);
  return dispatch_mma<4>(mt, warps_m, x, w, scale, y, scratch, counters, M, N, K, group, kchunk,
                         ksplit, st);
}

// The stream route (bf16 x [M, K], M <= 64): `members` (1-3) products that
// share x, member i with w_i (int8 [K, N_i] or packed int4 [K/2, N_i]),
// scale_i and y_i [M, N_i]; N_i a multiple of 16 and every pointer on a
// 16-byte boundary (TMA's terms).  kmajor: the tied head, one int8 member
// w [N, K] (N a multiple of 8), no scale.  The grid is ceil(granules /
// ceil(granules / sms)) blocks (``kernels.qgemm_stream_plan``); scratch
// holds 2 x blocks x 8 MT x 256 floats (MT = M rounded up to 8, 16, 32 or
// 64, over 8) and counters one zeroed int per column tile of all members,
// which every call leaves at zero.  Returns cudaGetLastError(), or cudaErrorInvalidValue for what the
// kernel does not take.
extern "C" int dabt_qgemm_stream(const void* x, const void* w0, const void* w1, const void* w2,
                                 const void* s0, const void* s1, const void* s2, void* y0,
                                 void* y1, void* y2, int n0, int n1, int n2, int members,
                                 int bits, int M, int K, int group, int kmajor, int sms,
                                 void* scratch, void* counters, void* stream) {
  const void* ws[3] = {w0, w1, w2};
  const void* ss[3] = {s0, s1, s2};
  void* ys[3] = {y0, y1, y2};
  const int ns[3] = {n0, n1, n2};
  if (members < 1 || members > 3 || M < 1 || M > 64 || K < 16 || K % 16 || sms < 1 ||
      (bits != 8 && bits != 4) || (kmajor && (bits != 8 || members != 1)) ||
      (bits == 4 && (group < 16 || group % 16 || K % group)) || scratch == nullptr ||
      counters == nullptr || x == nullptr || (uintptr_t)x % 16)
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < members; ++i)
    if (ns[i] < 8 || ns[i] % (kmajor ? 8 : 16) || ws[i] == nullptr || ys[i] == nullptr ||
        ((uintptr_t)ws[i] | (uintptr_t)ys[i]) % 16 ||
        (!kmajor && (ss[i] == nullptr || (uintptr_t)ss[i] % 16)))
      return (int)cudaErrorInvalidValue;
  const int mt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
  StreamArgs a;
  memset(&a, 0, sizeof(a));
  a.M = M;
  a.K = K;
  a.group = bits == 4 ? group : 0;
  a.srows = bits == 4 ? wg_scale_rows(group) : 0;
  int granule = ST_KT;
  if (bits == 4)
    while (granule % group) granule += ST_KT;  // lcm(64, group)
  a.granule = granule;
  a.gcount = (K + granule - 1) / granule;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  bool ok = tensor_map(&a.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, ST_KT,
                       8 * mt, CU_TENSOR_MAP_SWIZZLE_128B);
  int tiles = 0;
  for (int i = 0; i < 3; ++i) {
    const int j = i < members ? i : 0;  // members past `members` repeat member 0, unused
    const int N = ns[j];
    if (kmajor)
      ok = ok && tensor_map(&a.tw[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, ws[j], K, N, K, ST_KT, ST_BOX,
                            CU_TENSOR_MAP_SWIZZLE_64B, ST_L2);
    else
      ok = ok && tensor_map(&a.tw[i], CU_TENSOR_MAP_DATA_TYPE_UINT8, ws[j], N, bits == 8 ? K : K / 2,
                            N, ST_BOX, bits == 8 ? ST_KT : ST_KT / 2, CU_TENSOR_MAP_SWIZZLE_128B, ST_L2);
    if (bits == 4)
      ok = ok && tensor_map(&a.ts[i], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, ss[j], N, K / group,
                            (uint64_t)N * 4, ST_BOX, a.srows, CU_TENSOR_MAP_SWIZZLE_NONE, ST_L2);
    else
      a.ts[i] = a.tw[i];
    a.scale[i] = static_cast<const float*>(ss[j]);
    a.y[i] = static_cast<__nv_bfloat16*>(ys[j]);
    a.n[i] = N;
    a.tiles[i] = i < members ? (N + ST_BN - 1) / ST_BN : 0;
    tiles += a.tiles[i];
  }
  if (!ok) return (int)cudaErrorInvalidValue;
  a.total = tiles * a.gcount;
  // as few blocks as keep the most granules a block at ceil(total / sms):
  // equal ranges then often end on tile boundaries, fewer partials
  const int ctas = (a.total + (a.total + sms - 1) / sms - 1) / ((a.total + sms - 1) / sms);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kmajor) return launch_stream<8, true>(a, mt, ctas, st);
  if (bits == 8) return launch_stream<8, false>(a, mt, ctas, st);
  return launch_stream<4, false>(a, mt, ctas, st);
}

// The generic route (`qgemm_generic_kernel`): the f32 route, and every bf16
// call the tensor-core kernels do not take.  x [M, K] f32 (dtype 0) or bf16
// (1), y [M, N] of the same type; w int8 [K, N] with scale [1, N], or
// packed int4 [K/2, N] with scale [K/group, N] (any even group dividing
// K), or, kmajor, the tied head's int8 [N, K] with no scale (x already
// scaled).  Any M, N, K and element-aligned pointers.  The grid is
// ceil(granules / ceil(granules / slots)) blocks, slots = sms x the blocks
// an SM runs (``gn_blocks_for``; ``kernels.qgemm_generic_plan``);
// scratch holds 2 x blocks x 8 MT x 256 floats (MT = M rounded up to 8,
// 16, 32 or 64, over 8) and counters one zeroed int per tile (m tiles x
// column tiles), which every call leaves at zero.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments it does not
// take.
extern "C" int dabt_qgemm_generic(const void* x, const void* w, const void* scale, void* y,
                                  void* scratch, void* counters, int dtype, int bits, int M,
                                  int N, int K, int group, int kmajor, int sms, void* stream) {
  const int ts = dtype == 0 ? 4 : 2;
  if (M < 1 || N < 1 || K < 1 || sms < 1 || (dtype != 0 && dtype != 1) || (bits != 8 && bits != 4) ||
      x == nullptr || w == nullptr || y == nullptr || scratch == nullptr || counters == nullptr ||
      (!kmajor && scale == nullptr) || (kmajor && bits != 8) ||
      (bits == 4 && (K % 2 || group < 2 || group % 2 || K % group)) ||
      ((uintptr_t)x | (uintptr_t)y) % ts || (scale != nullptr && (uintptr_t)scale % 4))
    return (int)cudaErrorInvalidValue;
  const int mt = M <= 8 ? 1 : M <= 16 ? 2 : M <= 32 ? 4 : 8;
  GnArgs a;
  memset(&a, 0, sizeof(a));
  a.x = x;
  a.w = static_cast<const uint8_t*>(w);
  a.scale = static_cast<const float*>(scale);
  a.y = y;
  a.scratch = static_cast<float*>(scratch);
  a.counters = static_cast<int*>(counters);
  a.M = M;
  a.N = N;
  a.K = K;
  a.group = bits == 4 ? group : 0;
  int granule = GN_KT;
  if (bits == 4)
    while (granule % group) granule += GN_KT;  // lcm(64, group)
  a.granule = granule;
  a.gcount = (K + granule - 1) / granule;
  a.ntiles = (N + GN_BN - 1) / GN_BN;
  const long long total = (long long)((M + 8 * mt - 1) / (8 * mt)) * a.ntiles * a.gcount;
  if (total > (1ll << 30)) return (int)cudaErrorInvalidValue;
  a.total = (int)total;
  a.srows = bits == 4 ? wg_scale_rows(group) : 0;
  a.lvx = gn_lv(x, (long long)K * ts);
  a.lvw = gn_lv(w, kmajor ? K : N);
  a.lvs = scale != nullptr ? gn_lv(scale, (long long)N * 4) : 2;
  // as few blocks as keep the most granules a block at ceil(total / slots),
  // slots the blocks the SMs run at once, and at least GN_MIN_GRANULES
  // (fewer partials to sum where the call is small)
  const int bps = gn_blocks_for(mt, a.total, sms);
  const int slots = sms * bps;
  const int per = max(GN_MIN_GRANULES, (a.total + slots - 1) / slots);
  const int ctas = (a.total + per - 1) / per;
  // bf16 int4 at groups of 2, 4 and 8 with every tensor on 16-byte
  // boundaries (TMA's terms): the ring fed by TMA
  bool tma = dtype == 1 && bits == 4 && !kmajor && (group == 2 || group == 4 || group == 8) &&
             a.lvx == 4 && a.lvw == 4 && a.lvs == 4;
  if (tma)
    tma = tensor_map(&a.tx, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M, (uint64_t)K * 2, GN_KT,
                     8 * mt, CU_TENSOR_MAP_SWIZZLE_128B) &&
          tensor_map(&a.tw, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, N, K / 2, N, 128, GN_KT / 2,
                     CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_NONE) &&
          tensor_map(&a.ts, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scale, N, K / group, (uint64_t)N * 4,
                     128, a.srows, CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dispatch_generic<float>(a, bits, kmajor, mt, ctas, bps, false, st);
  return dispatch_generic<__nv_bfloat16>(a, bits, kmajor, mt, ctas, bps, tma, st);
}
