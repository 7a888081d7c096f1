// Grouped expert GEMM of a Mixtral MoE layer for Hopper (sm_90a): each
// expert's SwiGLU gate/up product and its down product over the slots the
// router filled, reading only the experts that have tokens.
//
// Replaces: django_assistant_bot_tpu/models/mixtral.py `moe_mlp`'s expert
// einsums (:65-71): xe = dispatch . x, h = silu(xe . Wg) * (xe . Wu), ye = h
// . Wd, over all X experts and all C slots of each.  Here (the plain twin:
// ops/moe.py `moe_expert_gemm_plain`), for expert x and slot c < fill[x]:
//
//   gate/up: A = x[slot_tok[x, c], :] (gathered in the kernel, no [X, C, E]
//            copy), h[x, c, f] = r(r(silu(r(A . Wg[x][:, f]))) *
//            r(A . Wu[x][:, f]))
//   down:    A = h[x, c, :], ye[x, c, e] = r(A . Wd[x][:, e])
//
// r() rounds to the model dtype (bf16, or nothing in f32) at the JAX
// function's points: each product, the activation, their product.  The
// sums are f32.  Rows c >= fill[x] of the output are not written (nothing
// reads them: the combine reads only the slots tok_slot names).
//
// What bounds it on the H100: bytes.  A decode step's 8 tokens route to
// about 7 of Mixtral's 8 experts, each 352 MB of bf16 weights (Wg, Wu, Wd:
// 4,096 x 14,336 each), against 2 C E F operations a product: about 2
// operations a weight byte, far below the ~295 at which the tensor cores
// would be the limit.  A 512-token chunk (C = 160) does ~160 a byte, still
// under it.  So the kernel's job is to stream each live expert's weights
// once at the memory's rate, and to read nothing of an expert without tokens.
//
// Design (route "mma", bf16 with K and N multiples of 64 and 16-byte aligned
// operands): grid (slot tiles of 64, feature tiles of 64, experts); a block
// whose slot tile starts at or past fill[x] (read on the device) returns
// before it loads a byte, so an empty expert costs one tiny block a tile.
// The slot tiles of one feature tile run next to each other, so a prefill's
// tiles of one expert share its weight tiles in L2.  Four warps; a 4-stage
// cp.async ring of 64-deep K tiles: the weight tiles [64 x 64] of Wg and Wu
// (or Wd) and the A tile [64 slots x 64], its rows gathered through
// slot_tok, rows past the tile's live slots not loaded.  The product runs
// on the tensor cores as y^T = W^T . A^T with `mma.sync.m16n8k16` (f32
// accumulation): each warp owns 16 output features (the mma's M, from the
// weight tile by `ldmatrix.trans`) and the live slots in groups of 8 (the
// mma's N, by `ldmatrix`), so a decode step's 8 slots are one group and its
// work is the weight stream; shared-memory rows are XOR-swizzled in 16-byte
// chunks so ldmatrix reads no bank twice.  The epilogue rounds at the
// points above and stores the live slots.  Other shapes and f32 take route
// "cuda_core": 16 slots x 64 features a block of 256 threads, shared-memory
// tiles, f32 FMA, the same epilogue.  wgmma and TMA are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;  // slots a block (mma route)
constexpr int BN = 64;  // output features a block
constexpr int BK = 64;  // K a stage
constexpr int STAGES = 4;
constexpr int THREADS = 128;
constexpr int TILE_ELEMS = BK * BN;  // one weight tile (= one A tile, BM x BK)

constexpr int CC_BM = 16, CC_BN = 64, CC_BK = 32, CC_THREADS = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
template <typename T> __device__ __forceinline__ float rnd(float v) { return to_f32(from_f32<T>(v)); }

__device__ __forceinline__ float silu(float g) { return g / (1.0f + expf(-g)); }

// the epilogue of one output element: gate/up from the two f32 sums, down
// from one
template <typename T, bool GATE_UP>
__device__ __forceinline__ T epilogue(float acc_g, float acc_u) {
  if (GATE_UP) {
    const float s = rnd<T>(silu(rnd<T>(acc_g)));
    return from_f32<T>(s * rnd<T>(acc_u));
  }
  return from_f32<T>(acc_g);
}

// ---------------------------------------------------------------- route mma
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// element offset of 16-byte chunk `ch` (0-7) of row `row` in a 64-wide tile
__device__ __forceinline__ int swz(int row, int ch) { return (row * 8 + (ch ^ (row & 7))) * 8; }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

struct Args {
  const void* a;        // gate/up: x [T, K]; down: h [X, C, K]
  const int* slot_tok;  // [X, C]
  const int* fill;      // [X]
  const void* w0;       // [X, K, N]: Wg or Wd
  const void* w1;       // [X, K, N]: Wu (gate/up) or null
  void* out;            // [X, C, N]
  int C, K, N;
};

template <bool GATE_UP>
__global__ void __launch_bounds__(THREADS) moe_gemm_mma_kernel(Args p) {
  constexpr int NW = GATE_UP ? 2 : 1;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];  // STAGES x (NW weight tiles, A tile)
  const int x = blockIdx.z, m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int live = min(p.fill[x], p.C) - m0;
  if (live <= 0) return;  // an empty tile: no weight byte read
  const int rows = min(live, BM);
  const int groups = (rows + 7) >> 3;  // live slots in groups of 8 (the mma's N)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C, K = p.K, N = p.N;
  const __nv_bfloat16* w0 = static_cast<const __nv_bfloat16*>(p.w0) + (size_t)x * K * N;
  const __nv_bfloat16* w1 =
      GATE_UP ? static_cast<const __nv_bfloat16*>(p.w1) + (size_t)x * K * N : nullptr;
  const __nv_bfloat16* abase = static_cast<const __nv_bfloat16*>(p.a);

  // this thread's four A rows (tid / 8 + 16 i) and its chunk (tid % 8)
  const int a_ch = tid & 7;
  const __nv_bfloat16* a_row[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = (tid >> 3) + 16 * i;
    a_row[i] = nullptr;
    if (r < rows) {
      if (GATE_UP) {
        const int tok = p.slot_tok[x * C + m0 + r];
        if (tok >= 0) a_row[i] = abase + (size_t)tok * K;
      } else {
        a_row[i] = abase + ((size_t)x * C + m0 + r) * K;
      }
    }
  }

  auto stage_ptr = [&](int s) { return smem + s * (NW + 1) * TILE_ELEMS; };
  auto load_stage = [&](int s, int kt) {
    __nv_bfloat16* st = stage_ptr(s);
    const int k0 = kt * BK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int id = tid + THREADS * i, row = id >> 3, ch = id & 7;
      const size_t off = (size_t)(k0 + row) * N + n0 + ch * 8;
      cp_async16(st + swz(row, ch), w0 + off);
      if (GATE_UP) cp_async16(st + TILE_ELEMS + swz(row, ch), w1 + off);
    }
    __nv_bfloat16* at = st + NW * TILE_ELEMS;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (a_row[i] != nullptr) {
        const int r = (tid >> 3) + 16 * i;
        cp_async16(at + swz(r, a_ch), a_row[i] + k0 + a_ch * 8);
      }
    }
  };

  float acc0[8][4], acc1[8][4];
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc0[j][q] = acc1[j][q] = 0.0f;

  const int nk = K / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) load_stage(s, s);
    cp_commit();
  }
  // ldmatrix lane roles: matrix mat = lane / 8, its row r = lane % 8
  const int mat = lane >> 3, r8 = lane & 7;
  for (int kt = 0; kt < nk; ++kt) {
    cp_wait<STAGES - 2>();
    __syncthreads();
    if (kt + STAGES - 1 < nk) load_stage((kt + STAGES - 1) % STAGES, kt + STAGES - 1);
    cp_commit();
    const __nv_bfloat16* st = stage_ptr(kt % STAGES);
    const __nv_bfloat16* at = st + NW * TILE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      // weight fragments (the mma's A: 16 features x 16 k) for k steps kk, kk + 16
      uint32_t wa0[2][4], wa1[2][4];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int krow = kk + 16 * h + r8 + ((mat >> 1) << 3);
        const int ch = warp * 2 + (mat & 1);
        ldsm_x4_t(wa0[h], st + swz(krow, ch));
        if (GATE_UP) ldsm_x4_t(wa1[h], st + TILE_ELEMS + swz(krow, ch));
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (j < groups) {
          // activation fragments (the mma's B: 16 k x 8 slots), both k steps
          uint32_t b[4];
          ldsm_x4(b, at + swz(j * 8 + r8, (kk >> 3) + mat));
          mma(acc0[j], wa0[0], b[0], b[1]);
          mma(acc0[j], wa0[1], b[2], b[3]);
          if (GATE_UP) {
            mma(acc1[j], wa1[0], b[0], b[1]);
            mma(acc1[j], wa1[1], b[2], b[3]);
          }
        }
      }
    }
  }
  cp_wait<0>();

  // c0, c1: feature g, slots 2t, 2t + 1; c2, c3: feature g + 8
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out) + ((size_t)x * C + m0) * N;
  const int g = lane >> 2, t2 = (lane & 3) * 2;
  const int f = n0 + warp * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < groups) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int slot = j * 8 + t2 + (q & 1);
        if (slot < rows)
          out[(size_t)slot * N + f + (q >> 1) * 8] =
              epilogue<__nv_bfloat16, GATE_UP>(acc0[j][q], acc1[j][q]);
      }
    }
  }
}

// ---------------------------------------------------------- route cuda_core
template <typename T, bool GATE_UP>
__global__ void __launch_bounds__(CC_THREADS) moe_gemm_cc_kernel(Args p) {
  __shared__ float As[CC_BM][CC_BK + 1];
  __shared__ float Ws[GATE_UP ? 2 : 1][CC_BK][CC_BN];
  const int x = blockIdx.z, m0 = blockIdx.x * CC_BM, n0 = blockIdx.y * CC_BN;
  const int live = min(p.fill[x], p.C) - m0;
  if (live <= 0) return;
  const int rows = min(live, CC_BM);
  const int C = p.C, K = p.K, N = p.N;
  const int tid = threadIdx.x, tx = tid % CC_BN, ty = tid / CC_BN;  // ty: slots 4 ty .. 4 ty + 3
  const T* w0 = static_cast<const T*>(p.w0) + (size_t)x * K * N;
  const T* w1 = GATE_UP ? static_cast<const T*>(p.w1) + (size_t)x * K * N : nullptr;
  const T* abase = static_cast<const T*>(p.a);
  float acc0[4] = {0.f, 0.f, 0.f, 0.f}, acc1[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k0 = 0; k0 < K; k0 += CC_BK) {
    for (int i = tid; i < CC_BM * CC_BK; i += CC_THREADS) {
      const int r = i / CC_BK, kc = i % CC_BK, k = k0 + kc;
      float v = 0.0f;
      if (r < rows && k < K) {
        if (GATE_UP) {
          const int tok = p.slot_tok[x * C + m0 + r];
          if (tok >= 0) v = to_f32(abase[(size_t)tok * K + k]);
        } else {
          v = to_f32(abase[((size_t)x * C + m0 + r) * K + k]);
        }
      }
      As[r][kc] = v;
    }
    for (int i = tid; i < CC_BK * CC_BN; i += CC_THREADS) {
      const int kr = i / CC_BN, nc = i % CC_BN, k = k0 + kr, n = n0 + nc;
      const bool in = k < K && n < N;
      Ws[0][kr][nc] = in ? to_f32(w0[(size_t)k * N + n]) : 0.0f;
      if (GATE_UP) Ws[GATE_UP ? 1 : 0][kr][nc] = in ? to_f32(w1[(size_t)k * N + n]) : 0.0f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kc = 0; kc < CC_BK; ++kc) {
      const float wg = Ws[0][kc][tx];
      const float wu = GATE_UP ? Ws[GATE_UP ? 1 : 0][kc][tx] : 0.0f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float av = As[ty * 4 + q][kc];
        acc0[q] = fmaf(av, wg, acc0[q]);
        if (GATE_UP) acc1[q] = fmaf(av, wu, acc1[q]);
      }
    }
    __syncthreads();
  }
  T* out = static_cast<T*>(p.out);
  const int n = n0 + tx;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int r = ty * 4 + q;
    if (r < rows && n < N)
      out[((size_t)x * C + m0 + r) * N + n] = epilogue<T, GATE_UP>(acc0[q], acc1[q]);
  }
}

template <bool GATE_UP>
int launch_mma(const Args& a, int X, cudaStream_t st) {
  constexpr int NW = GATE_UP ? 2 : 1;
  const int smem = STAGES * (NW + 1) * TILE_ELEMS * (int)sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(moe_gemm_mma_kernel<GATE_UP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.C + BM - 1) / BM, a.N / BN, X);
  moe_gemm_mma_kernel<GATE_UP><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool GATE_UP>
int launch_cc(const Args& a, int X, cudaStream_t st) {
  const dim3 grid((a.C + CC_BM - 1) / CC_BM, (a.N + CC_BN - 1) / CC_BN, X);
  moe_gemm_cc_kernel<T, GATE_UP><<<grid, CC_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One grouped expert GEMM.  epilogue 0 (gate/up): a = x [T, K], w0 = Wg and
// w1 = Wu, each [X, K, N]; epilogue 1 (down): a = h [X, C, K], w0 = Wd [X,
// K, N], w1 null.  slot_tok [X, C] and fill [X] int32 (the router's); out
// [X, C, N]; every float operand f32 (dtype 0) or bf16 (1), contiguous.
// route 0 ("mma"): bf16, K and N multiples of 64, a / w0 / w1 on 16-byte
// boundaries; route 1 ("cuda_core"): any shape, either dtype.  Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels do
// not take.
extern "C" int dabt_moe_gemm(const void* a, const void* slot_tok, const void* fill, const void* w0,
                             const void* w1, void* out, int dtype, int epilogue_kind, int route,
                             int X, int C, int K, int N, void* stream) {
  const bool gate_up = epilogue_kind == 0;
  if (X < 1 || C < 1 || K < 1 || N < 1 || (epilogue_kind != 0 && epilogue_kind != 1) ||
      a == nullptr || slot_tok == nullptr || fill == nullptr || w0 == nullptr || out == nullptr ||
      (gate_up && w1 == nullptr) || C > 65535 * BM)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = a;
  p.slot_tok = static_cast<const int*>(slot_tok);
  p.fill = static_cast<const int*>(fill);
  p.w0 = w0;
  p.w1 = w1;
  p.out = out;
  p.C = C;
  p.K = K;
  p.N = N;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    const auto misaligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; };
    if (dtype != 1 || K % BK != 0 || N % BN != 0 || misaligned(a) || misaligned(w0) ||
        (gate_up && misaligned(w1)) || N / BN > 65535)
      return (int)cudaErrorInvalidValue;
    return gate_up ? launch_mma<true>(p, X, st) : launch_mma<false>(p, X, st);
  }
  if (route != 1 || (N + CC_BN - 1) / CC_BN > 65535) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return gate_up ? launch_cc<float, true>(p, X, st) : launch_cc<float, false>(p, X, st);
  if (dtype == 1)
    return gate_up ? launch_cc<__nv_bfloat16, true>(p, X, st)
                   : launch_cc<__nv_bfloat16, false>(p, X, st);
  return (int)cudaErrorInvalidValue;
}
