// Grouped expert GEMM of a Mixtral MoE layer for Hopper (sm_90a): each
// expert's SwiGLU gate/up product and its down product over the slots the
// router filled, reading only the experts that have tokens.
//
// Replaces: django_assistant_bot_tpu/models/mixtral.py `moe_mlp`'s expert
// einsums (:65-71): xe = dispatch . x, h = silu(xe . Wg) * (xe . Wu), ye = h
// . Wd, over all X experts and all C slots of each.  Here (the plain twin:
// ops/moe.py `moe_expert_gemm_plain`), for expert x and slot c < fill[x]:
//
//   gate/up: A = x[slot_tok[x, c], :] (no dense [T, X, C] dispatch),
//            h[x, c, f] = r(r(silu(r(A . Wg[x][:, f]))) * r(A . Wu[x][:, f]))
//   down:    A = h[x, c, :], ye[x, c, e] = r(A . Wd[x][:, e])
//
// r() rounds to the model dtype (bf16, or nothing in f32) at the JAX
// function's points: each product, the activation, their product.  The
// sums are f32; a product whose K is split between blocks adds the blocks'
// f32 partials in split order and rounds once.  Rows c >= fill[x] of the
// output are not written (nothing reads them: the combine reads only the
// slots tok_slot names).
//
// What bounds it on the H100: a decode step's 8 tokens route to about 7 of
// Mixtral's 8 experts, each 352 MB of bf16 weights (Wg, Wu, Wd: 4,096 x
// 14,336 each), against 2 C E F operations a product: about 2 operations a
// weight byte, far below the ~295 at which the tensor cores would be the
// limit, so bytes.  A 512-token chunk (C = 160) does ~128 a byte: bytes at
// wgmma's rate, operations at mma.sync's.  A [4, 512] prefill (C = 640) is
// past the ridge: operations.  So the kernels stream each live expert's
// weights once at the memory's rate, read nothing of an expert without
// tokens, and past a few dozen slots an expert reach the tensor cores'
// full rate through wgmma.
//
// Route "wgmma" (kernels.moe_gemm_plan: bf16, K a multiple of 64, N of
// 128, 16-byte aligned operands and at least MOE_WGMMA_MIN_C slots an
// expert): `moe_gemm_wgmma_kernel`, grid (slot
// tiles of 128 or 192, feature tiles of 128 or, for down when the grid
// stays several waves deep, 256, experts).  The output tile is slots x
// features: two or three consumer warpgroups take 64 slots each (the
// wgmma's M), and one producer thread keeps a ring of stages in flight
// by TMA, each stage 64 deep in K:
// the A box [128 or 192 slots x 64 k] and the weights as [64 k x 64 n]
// boxes of the [X K, N] view, all 128-byte swizzled.  A block streams its
// weight tile through shared memory whatever its live slots, so for down's
// 128-feature blocks the plan takes the slot tile that covers C with the
// fewest rows: a 512-token chunk's C 160 in one 192-slot pass, where 128
// would take a second, mostly empty, tile.  (Three consumer warpgroups
// leave 128 registers a thread, too few for gate/up's 128 accumulators.)  The weights feed the wgmma as B in
// its transposed (MN-major) form, so no transposed copy exists; gate/up lays
// Wg's two boxes and Wu's two side by side, so one m64n256k16 a 16-deep
// step gives both sums of a slot in one thread's registers and the
// epilogue applies the rounding above; down's 256-feature tiles take an
// m64n256k16 the same way, its 128-feature ones an m64n128k16 (at a chunk
// the wider tiles leave too few blocks).  down's A is h [X C, K] itself.
// gate/up's rows are x's rows named by slot_tok, and TMA on sm_90 has no
// row gather: `moe_gather_kernel` first copies the live slots' rows into a
// [X, C, K] buffer the wrapper gives (a few MB: 10 at a 512-token chunk,
// against the 1.9 GB of weights read), which the A boxes then read.  The
// gather in the kernel instead (cp.async by the producer warp into the
// swizzled layout, signalling the stage's mbarrier) was slower at every T
// measured, the producer warp's gather the limit (PERF.md section 6).  A
// block whose slot tile starts at or past fill[x] returns before it loads a
// byte; a warpgroup whose 64 slots are all past it waits and releases the
// stages but issues no product.  The slot tiles of one feature tile run
// next to each other, so a prefill's tiles of one expert share its weight
// tiles in L2 and each live expert's weights come from HBM about once.  K
// is not split on this route: down's 32 feature tiles (E 4,096) leave the
// last of a chunk's ~2.5 waves part empty, but a K split's partials cost
// more than that tail at every T measured.
//
// Route "mma" (bf16, K and N multiples of 64, 16-byte aligned operands:
// decode and short prefills): `moe_gemm_mma_kernel`, grid (slot tiles of 64,
// feature tiles of 64, experts x K splits).  Four warps; a 4-stage cp.async
// ring of 64-deep K tiles: the weight tiles [64 x 64] of Wg and Wu (or Wd)
// and the A tile [64 slots x 64], its rows gathered through slot_tok, rows
// past the tile's live slots not loaded.  The product runs on the tensor
// cores as y^T = W^T . A^T with `mma.sync.m16n8k16` (f32 accumulation): each
// warp owns 16 output features (the mma's M, from the weight tile by
// `ldmatrix.trans`) and the live slots in groups of 8 (the mma's N, by
// `ldmatrix`), so a decode step's 8 slots are one group and its work is the
// weight stream; shared-memory rows are XOR-swizzled in 16-byte chunks so
// ldmatrix reads no bank twice.  At decode, down (64 feature tiles x 7 live
// experts of a 224-step K loop, three blocks an SM) leaves a second wave of
// 52 blocks after 396: the plan splits its K ("mma_split") into several
// shorter waves; the split blocks write f32 partials and the last block of
// a tile to arrive (a counter a tile, reset by it) sums them in split
// order, so every call gives the same bits.
//
// Other shapes and f32 take route "cuda_core": 16 slots x 64 features a
// block of 256 threads, shared-memory tiles, f32 FMA, the same epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"  // mbarriers, TMA, wgmma descriptors, the tensor-map encoder

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

struct Args {
  const void* a;        // gate/up: x [T, K]; down: h [X, C, K]
  const int* slot_tok;  // [X, C]
  const int* fill;      // [X]
  const void* w0;       // [X, K, N]: Wg or Wd
  const void* w1;       // [X, K, N]: Wu (gate/up) or null
  void* out;            // [X, C, N]
  float* scratch;       // K split: f32 partials [ksplit, X, C, N]
  int* counters;        // K split: one a tile, zero between calls
  int X, C, K, N;
  int ksplit, kchunk;   // K in ksplit ranges of kchunk rows (a multiple of 64)
};

// ---------------------------------------------------------------- route mma
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

// The K-split hand-off of one output tile, after every thread of the block
// wrote its f32 partial: true, in every thread, for the last of the tile's
// ksplit blocks to arrive, which resets the tile's counter for the next call.
__device__ __forceinline__ bool last_split(int* counter, int ksplit, int* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int last = atomicAdd(counter, 1) == ksplit - 1;
    if (last) *counter = 0;  // every split has arrived: ready for the next call
    *flag = last;
  }
  __syncthreads();
  const bool last = *flag != 0;
  if (last) __threadfence();
  return last;
}

template <bool GATE_UP>
__global__ void __launch_bounds__(THREADS) moe_gemm_mma_kernel(Args p) {
  constexpr int NW = GATE_UP ? 2 : 1;
  extern __shared__ __align__(128) __nv_bfloat16 smem[];  // STAGES x (NW weight tiles, A tile)
  __shared__ int s_last;
  const int ks = GATE_UP ? 1 : p.ksplit;
  const int x = blockIdx.z / ks, z = blockIdx.z - x * ks;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int live = min(p.fill[x], p.C) - m0;
  if (live <= 0) return;  // an empty tile: no weight byte read
  const int rows = min(live, BM);
  const int groups = (rows + 7) >> 3;  // live slots in groups of 8 (the mma's N)
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int C = p.C, K = p.K, N = p.N;
  const int kbeg = GATE_UP ? 0 : z * p.kchunk;
  const int kend = GATE_UP ? K : min(K, kbeg + p.kchunk);
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
    const int k0 = kbeg + kt * BK;
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

  const int nk = (kend - kbeg) / BK;
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
  if (!GATE_UP && ks > 1) {
    // K split: this block's f32 partial, then the tile's last block sums
    // the partials in split order and rounds once
    auto part = [&](int s) { return p.scratch + (((size_t)s * p.X + x) * C + m0) * N; };
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < groups)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int slot = j * 8 + t2 + (q & 1);
          if (slot < rows) part(z)[(size_t)slot * N + f + (q >> 1) * 8] = acc0[j][q];
        }
    const int tile = (x * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    if (!last_split(p.counters + tile, ks, &s_last)) return;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      if (j < groups)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int slot = j * 8 + t2 + (q & 1);
          if (slot < rows) {
            const size_t o = (size_t)slot * N + f + (q >> 1) * 8;
            float v = 0.0f;
            for (int s = 0; s < ks; ++s) v += __ldcg(part(s) + o);
            out[o] = __float2bfloat16_rn(v);
          }
        }
    return;
  }
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

// -------------------------------------------------------------- route wgmma
// d[64 x N] += A[64 x 16] . B[16 x N], bf16 in, f32 accumulate, both from
// shared memory: A K-major, B MN-major (imm-trans-b 1).  Fragment: d[4 j +
// r] is row 16 warp + lane / 4 + 8 (r >> 1), column 8 j + 2 (lane % 4) +
// (r & 1).
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

constexpr int WG_KT = 64;              // K a stage: one 128-byte swizzled row of A
constexpr int WG_SMEM = 227 * 1024;    // shared memory a block may take
constexpr int wg_threads(int nwg) { return 128 * nwg + 32; }  // + a producer warp

// Shared memory of the wgmma kernel with NB weight boxes a stage and NWG
// consumer warpgroups, in bytes from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 1024 bytes): the ring's stages, each the A tile
// [64 NWG slots x 64 k] and the weight boxes [64 k x 64 n] (gate/up: Wg's
// two halves of the block's 128 features, then Wu's; down: Wd's 128 or 256
// features), then the ring's full and empty barriers.  Four stages of
// four boxes, six of two, fewer where the block's shared memory ends.
template <int NB, int NWG>
struct WgSmem {
  static constexpr int A = 64 * NWG * WG_KT * 2;
  static constexpr int BOX = WG_KT * 64 * 2;
  static constexpr int W = NB * BOX;
  static constexpr int STAGE = A + W;
  static constexpr int FIT = (WG_SMEM - 2048) / STAGE;
  static constexpr int STAGES = (NB == 4 ? 4 : 6) < FIT ? (NB == 4 ? 4 : 6) : FIT;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 2 * STAGES * 8 + 1024;  // + the alignment slack
  static_assert(STAGES >= 3 && BYTES <= WG_SMEM, "the ring must hold three stages");
};

// gate/up's A for the wgmma route: rows[x, c, :] = x[slot_tok[x, c], :] for
// c < fill[x] (an empty slot's row zero; rows past fill are not written, and
// the outputs they feed are not either).  A block a slot, 16 bytes a thread.
__global__ void __launch_bounds__(128) moe_gather_kernel(const __nv_bfloat16* __restrict__ x,
                                                        const int* __restrict__ slot_tok,
                                                        const int* __restrict__ fill,
                                                        __nv_bfloat16* __restrict__ rows, int C,
                                                        int K) {
  const int e = blockIdx.y, c = blockIdx.x;
  if (c >= min(fill[e], C)) return;
  const int tok = slot_tok[e * C + c];
  const uint4* src = reinterpret_cast<const uint4*>(x + (size_t)max(tok, 0) * K);
  uint4* dst = reinterpret_cast<uint4*>(rows + ((size_t)e * C + c) * K);
  for (int i = threadIdx.x; i < K / 8; i += blockDim.x)
    dst[i] = tok >= 0 ? __ldg(src + i) : make_uint4(0u, 0u, 0u, 0u);
}

// bf16, K a multiple of 64, N of the block's features (BN: 128 for gate/up,
// 64 NB for down), operands on 16-byte boundaries; a block takes BM = 64 NWG
// slots.  Maps: ta the A rows as [X C, K] (down: h; gate/up: the gathered
// rows; box [BM rows x 64 k]), tw0 / tw1 the weights as [X K, N] (box [64 k
// x 64 n]).  The product is an m64n(64 NB)k16 a 16-deep step.
template <bool GATE_UP, int NB, int NWG>
__global__ void __launch_bounds__(wg_threads(NWG), 1)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tw0,
                      const __grid_constant__ CUtensorMap tw1, Args p) {
  static_assert(NB == 4 || (NB == 2 && !GATE_UP), "gate/up takes two boxes of Wg and two of Wu");
  using L = WgSmem<NB, NWG>;
  constexpr int NACC = 32 * NB;
  constexpr int BN = GATE_UP ? 128 : 64 * NB;
  constexpr int BM = 64 * NWG;
  extern __shared__ uint8_t smem_raw[];
  // offset from the array itself (not a cast integer), so the compiler
  // keeps the accesses shared-memory loads and stores
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  const int x = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int C = p.C, K = p.K, N = p.N;
  const int live = min(p.fill[x], C) - m0;
  if (live <= 0) return;  // an empty tile: no weight byte read
  const int rows = min(live, BM);
  const int nk = K / WG_KT;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < L::STAGES; ++s) {
      mbar_init(full + s, 1);   // the producer's arrival (plus the TMA bytes)
      mbar_init(empty + s, NWG);  // one arrival per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NWG) {  // the producer warp: one thread keeps the ring full
    if (threadIdx.x == 128 * NWG) {
      for (int t = 0; t < nk; ++t) {
        const int s = t % L::STAGES;
        const int k0 = t * WG_KT, wrow = x * K + k0;
        uint8_t* st = smem + s * L::STAGE;
        mbar_wait(empty + s, ((t / L::STAGES) & 1) ^ 1);
        // TMA counts every byte of a box, the zero-filled ones past an edge too
        mbar_expect_tx(full + s, L::A + L::W);
        tma_load_2d(st, &ta, full + s, k0, x * C + m0);
        if constexpr (GATE_UP) {  // Wg's two boxes, then Wu's
          tma_load_2d(st + L::A, &tw0, full + s, n0, wrow);
          tma_load_2d(st + L::A + L::BOX, &tw0, full + s, n0 + 64, wrow);
          tma_load_2d(st + L::A + 2 * L::BOX, &tw1, full + s, n0, wrow);
          tma_load_2d(st + L::A + 3 * L::BOX, &tw1, full + s, n0 + 64, wrow);
        } else {
#pragma unroll
          for (int b = 0; b < NB; ++b) tma_load_2d(st + L::A + b * L::BOX, &tw0, full + s, n0 + 64 * b, wrow);
        }
      }
    }
    return;
  }

  const int wg = threadIdx.x >> 7;  // slots 64 wg .. 64 wg + 63 of the tile
  const int ltid = threadIdx.x & 127, lane = ltid & 31, warp = ltid >> 5;
  if (rows <= 64 * wg) {
    // no live slot: keep the ring's count, issue nothing, store nothing
    for (int t = 0; t < nk; ++t) {
      const int s = t % L::STAGES;
      mbar_wait(full + s, (t / L::STAGES) & 1);
      if (ltid == 0) mbar_arrive(empty + s);
    }
    return;
  }
  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.0f;
  for (int t = 0; t < nk; ++t) {
    const int s = t % L::STAGES;
    mbar_wait(full + s, (t / L::STAGES) & 1);
    const uint32_t sa = smem_u32(smem + s * L::STAGE) + wg * 64 * 128;
    const uint32_t sb = smem_u32(smem + s * L::STAGE + L::A);
    fence_operands(acc);
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < WG_KT / 16; ++j)
      wgmma_ss(acc, gmma_desc(sa + 32 * j, 16, 1024), gmma_desc(sb + 16 * 128 * j, L::BOX, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // stage t - 1's products are done: its stage is free
    if (t > 0 && ltid == 0) mbar_arrive(empty + (t - 1) % L::STAGES);
  }
  wgmma_wait<0>();
  fence_operands(acc);

  // Epilogue: thread (warp, lane) holds rows 16 warp + lane / 4 (+ 8) of
  // its warpgroup's 64 and columns 8 j + 2 (lane % 4) (+ 1): gate/up's Wg
  // sums in j < 16 and the same features' Wu sums in j + 16.
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
  const int rbase = 64 * wg + 16 * warp + (lane >> 2);
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < (GATE_UP ? 16 : BN / 8); ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = rbase + 8 * h;
      if (r < rows) {
        __nv_bfloat162 v;
        if constexpr (GATE_UP) {
          v.x = epilogue<__nv_bfloat16, true>(acc[4 * j + 2 * h], acc[4 * (j + 16) + 2 * h]);
          v.y = epilogue<__nv_bfloat16, true>(acc[4 * j + 2 * h + 1], acc[4 * (j + 16) + 2 * h + 1]);
        } else {
          v = __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
        *reinterpret_cast<__nv_bfloat162*>(out + ((size_t)x * C + m0 + r) * N + n0 + 8 * j + c2) = v;
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
int launch_mma(const Args& a, cudaStream_t st) {
  constexpr int NW = GATE_UP ? 2 : 1;
  const int smem = STAGES * (NW + 1) * TILE_ELEMS * (int)sizeof(__nv_bfloat16);
  const cudaError_t e = cudaFuncSetAttribute(moe_gemm_mma_kernel<GATE_UP>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.C + BM - 1) / BM, a.N / BN, a.X * a.ksplit);
  moe_gemm_mma_kernel<GATE_UP><<<grid, THREADS, smem, st>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, bool GATE_UP>
int launch_cc(const Args& a, cudaStream_t st) {
  const dim3 grid((a.C + CC_BM - 1) / CC_BM, (a.N + CC_BN - 1) / CC_BN, a.X);
  moe_gemm_cc_kernel<T, GATE_UP><<<grid, CC_THREADS, 0, st>>>(a);
  return (int)cudaGetLastError();
}

// a row-major bf16 [rows, cols] tensor as a 2-D TMA map with box [box_rows,
// box_cols], 128-byte swizzled; out-of-range elements of a box read as zeros
bool bf16_map(CUtensorMap* map, const void* ptr, uint64_t cols, uint64_t rows, uint32_t box_cols,
              uint32_t box_rows) {
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, cols, rows, cols * 2, box_cols,
                    box_rows, CU_TENSOR_MAP_SWIZZLE_128B);
}

template <bool GATE_UP, int NB, int NWG>
int launch_wgmma(const Args& a, void* rows, cudaStream_t st) {
  using L = WgSmem<NB, NWG>;
  constexpr int BN = GATE_UP ? 128 : 64 * NB;
  constexpr int BM = 64 * NWG;
  if (GATE_UP) {  // the slots' rows, gathered for TMA (it has no row gather)
    moe_gather_kernel<<<dim3(a.C, a.X), 128, 0, st>>>(static_cast<const __nv_bfloat16*>(a.a),
                                                      a.slot_tok, a.fill,
                                                      static_cast<__nv_bfloat16*>(rows), a.C, a.K);
  }
  CUtensorMap ta, tw0, tw1;
  const uint64_t wrows = (uint64_t)a.X * a.K;
  const bool ok = bf16_map(&ta, GATE_UP ? rows : a.a, a.K, (uint64_t)a.X * a.C, WG_KT, BM) &&
                  bf16_map(&tw0, a.w0, a.N, wrows, 64, WG_KT) &&
                  bf16_map(&tw1, GATE_UP ? a.w1 : a.w0, a.N, wrows, 64, WG_KT);
  if (!ok) return (int)cudaErrorInvalidValue;
  auto kernel = moe_gemm_wgmma_kernel<GATE_UP, NB, NWG>;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.C + BM - 1) / BM, a.N / BN, a.X);
  kernel<<<grid, wg_threads(NWG), L::BYTES, st>>>(ta, tw0, tw1, a);
  return (int)cudaGetLastError();
}

}  // namespace

// One grouped expert GEMM.  epilogue 0 (gate/up): a = x [T, K], w0 = Wg and
// w1 = Wu, each [X, K, N]; epilogue 1 (down): a = h [X, C, K], w0 = Wd [X,
// K, N], w1 null.  slot_tok [X, C] and fill [X] int32 (the router's); out
// [X, C, N]; every float operand f32 (dtype 0) or bf16 (1), contiguous.
// route 0 ("mma"): bf16, K and N multiples of 64, a / w0 / w1 on 16-byte
// boundaries; down may split K: ksplit ranges of kchunk rows (a multiple of
// 64, ksplit = ceil(K / kchunk)), f32 partials in scratch ([ksplit, X, C,
// N] floats) and one int32 counter a tile in counters (X ceil(C / 64) N /
// 64), zero before the call and after it.  route 1 ("cuda_core"): any
// shape, either dtype.  route 2 ("wgmma"): route 0's terms with N a
// multiple of the block's features tile_n (gate/up: 128; down: 128 or
// 256), tile_m slots a block (128 or 192), no split, and for gate/up rows, a
// bf16 [X, C, K] buffer on a 16-byte boundary for the gathered slots.
// Returns
// cudaGetLastError(), or cudaErrorInvalidValue for arguments the kernels do
// not take.
extern "C" int dabt_moe_gemm(const void* a, const void* slot_tok, const void* fill, const void* w0,
                             const void* w1, void* out, void* scratch, void* counters, void* rows,
                             int dtype, int epilogue_kind, int route, int X, int C, int K, int N,
                             int ksplit, int kchunk, int tile_n, int tile_m, void* stream) {
  const bool gate_up = epilogue_kind == 0;
  if (X < 1 || C < 1 || K < 1 || N < 1 || (epilogue_kind != 0 && epilogue_kind != 1) ||
      a == nullptr || slot_tok == nullptr || fill == nullptr || w0 == nullptr || out == nullptr ||
      (gate_up && w1 == nullptr) || C > 65535 * BM || ksplit < 1)
    return (int)cudaErrorInvalidValue;
  Args p;
  p.a = a;
  p.slot_tok = static_cast<const int*>(slot_tok);
  p.fill = static_cast<const int*>(fill);
  p.w0 = w0;
  p.w1 = w1;
  p.out = out;
  p.scratch = static_cast<float*>(scratch);
  p.counters = static_cast<int*>(counters);
  p.X = X;
  p.C = C;
  p.K = K;
  p.N = N;
  p.ksplit = ksplit;
  p.kchunk = kchunk;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (route == 0 || route == 2) {
    const auto misaligned = [](const void* q) { return reinterpret_cast<uintptr_t>(q) % 16 != 0; };
    const bool split_ok =
        ksplit == 1 ? kchunk == K
                    : !gate_up && kchunk % BK == 0 && kchunk > 0 && (K + kchunk - 1) / kchunk == ksplit &&
                          scratch != nullptr && counters != nullptr;
    if (dtype != 1 || K % BK != 0 || N % BN != 0 || misaligned(a) || misaligned(w0) ||
        (gate_up && misaligned(w1)) || N / BN > 65535 || !split_ok || X * ksplit > 65535)
      return (int)cudaErrorInvalidValue;
    if (route == 0) return gate_up ? launch_mma<true>(p, st) : launch_mma<false>(p, st);
    if (ksplit != 1 || (gate_up && (tile_n != 128 || rows == nullptr || misaligned(rows))) ||
        (tile_n != 128 && tile_n != 256) || N % tile_n != 0 || (tile_m != 128 && tile_m != 192))
      return (int)cudaErrorInvalidValue;
    // three consumer warpgroups (416 threads) leave 128 registers a thread:
    // room for down's 64 accumulators of a 128-feature block only
    const bool three = tile_m == 192;
    if (three && (gate_up || tile_n != 128)) return (int)cudaErrorInvalidValue;
    if (gate_up) return launch_wgmma<true, 4, 2>(p, rows, st);
    if (tile_n == 256) return launch_wgmma<false, 4, 2>(p, rows, st);
    return three ? launch_wgmma<false, 2, 3>(p, rows, st) : launch_wgmma<false, 2, 2>(p, rows, st);
  }
  if (route != 1 || ksplit != 1 || (N + CC_BN - 1) / CC_BN > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return gate_up ? launch_cc<float, true>(p, st) : launch_cc<float, false>(p, st);
  if (dtype == 1)
    return gate_up ? launch_cc<__nv_bfloat16, true>(p, st) : launch_cc<__nv_bfloat16, false>(p, st);
  return (int)cudaErrorInvalidValue;
}
