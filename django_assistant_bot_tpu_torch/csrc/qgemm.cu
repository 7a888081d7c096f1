// Weight-only int8 / grouped int4 matrix product for Hopper (sm_90a):
// y[M, N] = x[M, K] . W[K, N], W stored as integers with f32 scales.
//
// Replaces: django_assistant_bot_tpu/ops/quant.py `qeinsum` (:160-208), which
// XLA lowers to a dot whose weight operand is a pure int -> bf16 convert, so
// only the integers are read.  A PyTorch composition (`q.to(bf16)` then
// `torch.matmul`) would read 1 byte per weight, write 2 and read 2 again;
// this kernel reads each integer once and dequantizes it in registers.
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
// Design (bf16, `qgemm_mma_kernel`): the product runs on the tensor cores as
// y^T = W^T x^T with `mma.sync.m16n8k16` (bf16 in, f32 accumulate): the
// weights are the A operand (16 output columns a tile), the activations
// the B operand (8 rows of x a tile), so M = 1-8 wastes no A rows.  Each
// thread owns 8 consecutive output columns and, per 16-row step of K, four
// consecutive rows of them (int8: four 8-byte loads; int4: two, one per
// packed row pair).  The mapping of the mma's k index to rows of K is
// permuted so that a thread's A pairs (two consecutive k of one column) come
// from its own loads and its B pairs are one 8-byte load of x; the same
// permutation on both operands leaves the sum unchanged.  Loads go straight
// from global memory to registers: per row a warp reads 64 contiguous
// bytes, every byte of each 32-byte sector used.  Several steps' loads are
// issued before any is used (U below), so each warp keeps 2-8 KB in flight.
// Dequantization in registers: int8 by the 2^23 magic-number trick (byte
// permute into an f32 mantissa, one subtract, exact), int4 by the bf16
// trick (nibble into a bf16 mantissa at 128, one bf16x2 subtract, exact);
// int8 and int4 values are exact in bf16.
//   A block is four warps on 64 output columns.  For M <= 16 the warps split
// the block's K range four ways; for larger M they take four slabs of rows
// of x (the same weights, read from L1).  Past 64 rows (prefill) with N a
// multiple of 16, `qgemm_tile_kernel` takes the call instead: eight warps on
// 128 x 128 outputs, the integer and x tiles brought through a 3-stage
// `cp.async` ring in shared memory, each integer tile dequantized once by
// the whole block into a bf16 tile that the warps read with `ldmatrix`
// (direct loads, and a dequantization repeated by every warp along M, left
// the tensor cores waiting there).  K is further split across blocks
// (grid z) until the grid fills the card; each block sums its warps in
// shared memory in a fixed order, writes one f32 partial, and the block
// that completes a tile's counter sums the partials in split order, applies
// the epilogue and resets the counter (one launch, no memset, and the same
// sums in the same order on every call).
// The f32 route (`qgemm_f32_kernel`, the small f32 parity models) runs on
// the CUDA cores, one output column a thread, 8 rows of x a block.
//
// Not done here (later work): wgmma and TMA, a repacked weight layout (one
// wide load per fragment at decode), and QKV or gate/up in one launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING));
}

constexpr int TILE_THREADS = 256;  // eight warps
constexpr int TILE_BN = 128, TILE_BM = 128, TILE_KT = 32, TILE_STAGES = 3;
constexpr int TILE_WSTRIDE = TILE_BN + 16;  // bytes a row of the integer tile
constexpr int TILE_XSTRIDE = TILE_KT + 8;   // bf16 a row of x's tile
constexpr int TILE_BSTRIDE = TILE_BN + 8;   // bf16 a row of the dequantized tile

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// int4 bytes 0 and 1 of w (sel 0x4140) or 2 and 3 (0x4342) as two bf16x2:
// {low nibbles} and {high nibbles}, each a signed value
__device__ __forceinline__ void i4_columns(uint32_t w, uint32_t sel, uint32_t& lo, uint32_t& hi) {
  const uint32_t t = __byte_perm(w, 0u, sel);
  uint32_t l = (t & 0x000F000Fu) ^ 0x43084308u, h = ((t >> 4) & 0x000F000Fu) ^ 0x43084308u;
  const __nv_bfloat162 off = __floats2bfloat162_rn(136.0f, 136.0f);
  __nv_bfloat162 lb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&l), off);
  __nv_bfloat162 hb = __hsub2(*reinterpret_cast<__nv_bfloat162*>(&h), off);
  lo = *reinterpret_cast<uint32_t*>(&lb);
  hi = *reinterpret_cast<uint32_t*>(&hb);
}

// M > 64 (prefill), N a multiple of 16: a block takes 128 output columns x
// 128 rows of x with eight warps (2 along N, 4 along M), each warp 64
// columns x 32 rows.  K runs in tiles of 32 rows through a 3-stage
// `cp.async` ring in (dynamic) shared memory holding the integer tile and
// x's tile, so the next tiles' loads are in flight while this one is
// worked.  The block dequantizes each integer tile once, all 256 threads
// together, into a bf16 tile [32 x 128]; every warp then takes its A
// fragments from it with `ldmatrix.trans` and its B fragments from x's tile
// with `ldmatrix`, and runs `mma.sync` (16 products a warp a 16-row step).
// One warp owns the whole K of its outputs: no split, no partials.
template <int BITS>
__global__ void __launch_bounds__(TILE_THREADS)
qgemm_tile_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ w,
                  const float* __restrict__ scale, __nv_bfloat16* __restrict__ y, int M, int N,
                  int K, int group) {
  constexpr int BN = TILE_BN, BM = TILE_BM, KT = TILE_KT, STAGES = TILE_STAGES;
  constexpr int WROWS = BITS == 8 ? KT : KT / 2;  // integer rows of a stage
  extern __shared__ __align__(16) uint8_t smem[];
  uint8_t* ws = smem;                                                         // [STAGES][WROWS][WSTRIDE]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(ws + STAGES * WROWS * TILE_WSTRIDE);  // [STAGES][BM][XSTRIDE]
  __nv_bfloat16* wb = xs + STAGES * BM * TILE_XSTRIDE;                         // [KT][BSTRIDE]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int nw = (warp & 1) * 64, mw = (warp >> 1) * 32;
  const int ktiles = (K + KT - 1) / KT;
  const int wrows_total = BITS == 8 ? K : K / 2;

  auto load = [&](int slot, int kt) {
    const int k0 = kt * KT;
    uint8_t* wd = ws + slot * WROWS * TILE_WSTRIDE;
    for (int c = tid; c < WROWS * (BN / 16); c += TILE_THREADS) {
      const int r = c / (BN / 16), col = (c % (BN / 16)) * 16;
      const int grow = (BITS == 8 ? k0 : k0 / 2) + r;
      const bool ok = grow < wrows_total && n0 + col < N;
      cp_async16(wd + r * TILE_WSTRIDE + col, ok ? w + (size_t)grow * N + n0 + col : w,
                 ok ? 16 : 0);
    }
    __nv_bfloat16* xd = xs + slot * BM * TILE_XSTRIDE;
    for (int c = tid; c < BM * (KT / 8); c += TILE_THREADS) {
      const int r = c / (KT / 8), col = (c % (KT / 8)) * 8;
      const bool ok = m0 + r < M && k0 + col < K;
      cp_async16(xd + r * TILE_XSTRIDE + col, ok ? x + (size_t)(m0 + r) * K + k0 + col : x,
                 ok ? 16 : 0);
    }
  };

  // the integer tile of `slot` -> the bf16 tile wb [k][n] (zero-filled
  // integers give zeros)
  auto dequant = [&](int slot) {
    const uint8_t* wt = ws + slot * WROWS * TILE_WSTRIDE;
    if constexpr (BITS == 8) {  // 32 rows x 128 columns: 16 columns a thread
      const int r = tid >> 3, c0 = (tid & 7) * 16;
      const uint4 q = *reinterpret_cast<const uint4*>(wt + r * TILE_WSTRIDE + c0);
      const uint32_t words[4] = {q.x ^ 0x80808080u, q.y ^ 0x80808080u, q.z ^ 0x80808080u,
                                 q.w ^ 0x80808080u};
      uint32_t o[8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o[2 * k] = pack_bf16(i8_value(words[k], 0), i8_value(words[k], 1));
        o[2 * k + 1] = pack_bf16(i8_value(words[k], 2), i8_value(words[k], 3));
      }
      uint4* dst = reinterpret_cast<uint4*>(wb + r * TILE_BSTRIDE + c0);
      dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
      dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
    } else {  // 16 packed rows (32 rows of K) x 128 columns: 8 columns of a row pair a thread
      const int p = tid >> 4, c0 = (tid & 15) * 8;
      const uint2 q = *reinterpret_cast<const uint2*>(wt + p * TILE_WSTRIDE + c0);
      uint32_t lo[4], hi[4];
      i4_columns(q.x, 0x4140u, lo[0], hi[0]);
      i4_columns(q.x, 0x4342u, lo[1], hi[1]);
      i4_columns(q.y, 0x4140u, lo[2], hi[2]);
      i4_columns(q.y, 0x4342u, lo[3], hi[3]);
      *reinterpret_cast<uint4*>(wb + (2 * p) * TILE_BSTRIDE + c0) = make_uint4(lo[0], lo[1], lo[2], lo[3]);
      *reinterpret_cast<uint4*>(wb + (2 * p + 1) * TILE_BSTRIDE + c0) = make_uint4(hi[0], hi[1], hi[2], hi[3]);
    }
  };

  // C fragment element (i, t, e): column nw + 16t + gid + 8 (e >> 1), row
  // mw + 8i + 2 tig + (e & 1)
  float acc[4][4][4];
  float part[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][t][e] = part[i][t][e] = 0.0f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < ktiles) load(st, st);
    cp_async_commit();
  }
  const int mi = lane >> 3, ri = lane & 7;  // ldmatrix: this lane's matrix and row
  for (int kt = 0; kt < ktiles; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt landed for all; every warp is done with wb and tile kt - 1
    if (kt + STAGES - 1 < ktiles) load((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_async_commit();
    dequant(kt % STAGES);
    __syncthreads();  // wb holds tile kt
    const __nv_bfloat16* xt = xs + (kt % STAGES) * BM * TILE_XSTRIDE;
#pragma unroll
    for (int h = 0; h < KT / 16; ++h) {
      const int k = kt * KT + 16 * h;
      if (k >= K) break;
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int t = 0; t < 4; ++t)  // rows of K, 8 columns each: matrices (n, k) 00, 10, 01, 11
        ldsm_x4_t(a[t], wb + (16 * h + (mi >> 1) * 8 + ri) * TILE_BSTRIDE + nw + 16 * t +
                            (mi & 1) * 8);
#pragma unroll
      for (int i = 0; i < 4; i += 2) {  // rows of x: matrices (m, k) 00, 01, 10, 11
        uint32_t r[4];
        ldsm_x4(r, xt + (mw + 8 * (i + (mi >> 1)) + ri) * TILE_XSTRIDE + 16 * h + (mi & 1) * 8);
        b[i][0] = r[0]; b[i][1] = r[1]; b[i + 1][0] = r[2]; b[i + 1][1] = r[3];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int t = 0; t < 4; ++t) {
          if constexpr (BITS == 8)
            mma_bf16(acc[i][t], a[t], b[i][0], b[i][1]);
          else
            mma_bf16(part[i][t], a[t], b[i][0], b[i][1]);
        }
      if constexpr (BITS == 4) {
        if ((k + 16) % group == 0) {  // the group ends: round, scale, add
          const int G = (k + 16) / group - 1;
          float sc[4][2];
#pragma unroll
          for (int t = 0; t < 4; ++t)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int n = n0 + nw + 16 * t + gid + 8 * hf;
              sc[t][hf] = n < N ? bf16_round(__ldg(scale + (size_t)G * N + n)) : 0.0f;
            }
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int t = 0; t < 4; ++t) {
#pragma unroll
              for (int e = 0; e < 4; e += 2)
                add_rounded_pair(acc[i][t][e], acc[i][t][e + 1], part[i][t][e], part[i][t][e + 1],
                                 sc[t][e >> 1], sc[t][e >> 1]);
#pragma unroll
              for (int e = 0; e < 4; ++e) part[i][t][e] = 0.0f;
            }
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int t = 0; t < 4; ++t)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int n = n0 + nw + 16 * t + gid + 8 * (e >> 1);
        const int m = m0 + mw + 8 * i + 2 * tig + (e & 1);
        if (n < N && m < M) {
          const float v = acc[i][t][e];
          y[(size_t)m * N + n] =
              BITS == 8 ? __float2bfloat16_rn(bf16_round(v) * bf16_round(__ldg(scale + n)))
                        : __float2bfloat16_rn(v);
        }
      }
}

template <int BITS>
int launch_tile(const void* x, const void* w, const void* scale, void* y, int M, int N, int K,
                int group, cudaStream_t stream) {
  constexpr int WROWS = BITS == 8 ? TILE_KT : TILE_KT / 2;
  constexpr int smem = TILE_STAGES * WROWS * TILE_WSTRIDE + 2 * TILE_STAGES * TILE_BM * TILE_XSTRIDE +
                       2 * TILE_KT * TILE_BSTRIDE;
  cudaError_t err = cudaFuncSetAttribute(qgemm_tile_kernel<BITS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + TILE_BN - 1) / TILE_BN, (M + TILE_BM - 1) / TILE_BM);
  qgemm_tile_kernel<BITS><<<grid, TILE_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<__nv_bfloat16*>(y), M, N, K, group);
  return (int)cudaGetLastError();
}

// f32 on the CUDA cores: one output column a thread, 8 rows of x a block,
// the rows' K values staged in shared memory 64 at a time.
template <int BITS>
__global__ void __launch_bounds__(THREADS)
qgemm_f32_kernel(const float* __restrict__ x, const uint8_t* __restrict__ w,
                 const float* __restrict__ scale, float* __restrict__ y, int M, int N, int K,
                 int group) {
  constexpr int KC = 64;
  __shared__ float xs[8][KC];
  const int n = blockIdx.x * THREADS + threadIdx.x;
  const int m0 = blockIdx.y * 8;
  float acc[8], part[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) acc[r] = part[r] = 0.0f;
  for (int kc = 0; kc < K; kc += KC) {
    for (int i = threadIdx.x; i < 8 * KC; i += THREADS) {
      const int r = i / KC, c = i % KC;
      xs[r][c] = m0 + r < M && kc + c < K ? x[(size_t)(m0 + r) * K + kc + c] : 0.0f;
    }
    __syncthreads();
    if (n < N) {
      const int kn = min(KC, K - kc);
      for (int c = 0; c < kn; ++c) {
        const int k = kc + c;
        float wv;
        if (BITS == 8) {
          wv = (float)(int8_t)w[(size_t)k * N + n];
        } else {
          const uint32_t b = w[(size_t)(k >> 1) * N + n];
          const int nib = (k & 1) ? (b >> 4) : (b & 15);
          wv = (float)((nib ^ 8) - 8);
        }
#pragma unroll
        for (int r = 0; r < 8; ++r) part[r] = fmaf(xs[r][c], wv, part[r]);
        if (BITS == 4 && (k + 1) % group == 0) {
          const float s = scale[(size_t)(k / group) * N + n];
#pragma unroll
          for (int r = 0; r < 8; ++r) {
            acc[r] += part[r] * s;
            part[r] = 0.0f;
          }
        }
      }
    }
    __syncthreads();
  }
  if (n >= N) return;
  const float s8 = BITS == 8 ? scale[n] : 1.0f;
#pragma unroll
  for (int r = 0; r < 8; ++r)
    if (m0 + r < M) y[(size_t)(m0 + r) * N + n] = BITS == 8 ? part[r] * s8 : acc[r];
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
  if (mt == 4 && warps_m == 8)
    return launch_tile<BITS>(x, w, scale, y, M, N, K, group, stream);
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
// [K/group, N]), y [M, N]; dtype 0 = f32 (CUDA cores), 1 = bf16 (tensor
// cores); bits 8 or 4; (mt, warps_m, ksplit, kchunk) the host's plan (bf16
// only): warps_m 8 takes the tile kernel (no split), 1 or 4 the direct-load
// kernel with that many warps along M; mt m-tiles of 8 rows a warp; K split
// into ksplit ranges of kchunk rows (a block's for warps_m 4 and 8, a
// warp's for 1).  With ksplit > 1,
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
  if (dtype == 0) {
    dim3 grid((N + THREADS - 1) / THREADS, (M + 7) / 8);
    if (bits == 8)
      qgemm_f32_kernel<8><<<grid, THREADS, 0, st>>>(static_cast<const float*>(x),
          static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
          static_cast<float*>(y), M, N, K, group);
    else
      qgemm_f32_kernel<4><<<grid, THREADS, 0, st>>>(static_cast<const float*>(x),
          static_cast<const uint8_t*>(w), static_cast<const float*>(scale),
          static_cast<float*>(y), M, N, K, group);
    return (int)cudaGetLastError();
  }
  if (dtype != 1 || (warps_m != 1 && warps_m != 4 && warps_m != 8) || ksplit < 1 ||
      kchunk < 16 || kchunk % 16 || (bits == 4 && kchunk % group) ||
      (long long)ksplit * (warps_m == 8 ? 1 : THREADS / 32 / warps_m) * kchunk < K ||
      (ksplit > 1 && (scratch == nullptr || counters == nullptr)) ||
      (warps_m == 8 && (mt != 4 || ksplit != 1 || N % 16)))
    return (int)cudaErrorInvalidValue;
  if (bits == 8)
    return dispatch_mma<8>(mt, warps_m, x, w, scale, y, scratch, counters, M, N, K, group, kchunk,
                           ksplit, st);
  return dispatch_mma<4>(mt, warps_m, x, w, scale, y, scratch, counters, M, N, K, group, kchunk,
                         ksplit, st);
}
