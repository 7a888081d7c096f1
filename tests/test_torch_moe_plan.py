"""The grouped expert GEMM's route plan (``kernels.moe_gemm_plan``) on the
CPU, at Mixtral 8x7B's shapes and at its edges:

- every prefill bucket's capacity at Mixtral's widths takes ``"wgmma"``
  (K whole) from ``MOE_WGMMA_MIN_C`` slots an expert and the ``mma.sync``
  kernel below it; a decode tick's down splits its K (``"mma_split"``)
  into several waves of blocks, gate/up never splits;
- f32, an operand off 16 bytes, K or N not a multiple of 64 take
  ``"cuda_core"``; N a multiple of 64 but not of 128 stays on ``mma``;
- at a shape for each of the plan's forms the K ranges cover K once on
  64-row boundaries, within the split limits, and depend on shapes alone.
"""

import pytest
import torch

from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity

BF16 = torch.bfloat16
E, F, X = 4096, 14336, 8  # Mixtral 8x7B's expert layer
MIXTRAL = DecoderConfig.mixtral_8x7b()
# the engine's prefill buckets (B 1) and [4, 512], and the 8-slot decode tick
TOKENS = [8, 32, 64, 128, 256, 512, 1024, 2048, 4096]


def _plans(T):
    C = expert_capacity(MIXTRAL, T)
    return C, kernels.moe_gemm_plan(BF16, "gate_up", X, C, E, F), \
        kernels.moe_gemm_plan(BF16, "down", X, C, F, E)


def _covers_k(plan, K):
    assert plan.ksplit >= 1 and plan.kchunk >= 1
    assert -(-K // plan.kchunk) == plan.ksplit  # no empty range
    if plan.ksplit > 1:
        assert plan.kchunk % kernels.MOE_GEMM_TILE == 0
        assert plan.kchunk >= kernels.MOE_SPLIT_MIN_K
        assert plan.ksplit <= kernels.MOE_MAX_SPLIT
    else:
        assert plan.kchunk == K


@pytest.mark.parametrize("T", TOKENS)
def test_mixtral_shapes_take_wgmma_from_the_threshold(T):
    C, gu, dn = _plans(T)
    if C >= kernels.MOE_WGMMA_MIN_C:
        assert gu.route == dn.route == "wgmma"
    else:
        assert gu.route == "mma" and dn.route in ("mma", "mma_split")
    assert gu.ksplit == 1 and gu.kchunk == E
    _covers_k(dn, F)
    assert {gu.route, dn.route} <= set(kernels.MOE_GEMM_ROUTES)


def test_decode_tick_down_splits_into_waves():
    C, gu, dn = _plans(8)
    assert C == 8 and gu == kernels.MoePlan("mma", 1, E, 64, 64)
    assert dn.route == "mma_split" and dn.ksplit > 1
    tiles = kernels.moe_gemm_tiles(X, C, E)
    assert tiles == X * E // 64
    # the split blocks fill about MOE_MMA_WAVES waves of three blocks an SM
    assert tiles * dn.ksplit >= (kernels.MOE_MMA_WAVES - 1) * 3 * 132
    assert dn.ksplit * X * C * E <= kernels.MOE_PARTIAL_FLOATS


@pytest.mark.parametrize("T,down_tile,tile_m", [(128, 128, 128), (512, 128, 192),
                                                (1024, 256, 128), (2048, 256, 128),
                                                (4096, 256, 128)])
def test_prefill_keeps_k_whole_on_wgmma(T, down_tile, tile_m):
    """K whole on wgmma; down at a 512-token chunk (C 160) in one 192-slot
    tile; down's blocks widen to 256 features once that still leaves
    ``MOE_WIDE_WAVES`` waves (C 320: 8 x 3 x 16 = 384 blocks over 132 SMs;
    C 160: 8 x 1 x 16 = 128 do not)."""
    C, gu, dn = _plans(T)
    assert gu == kernels.MoePlan("wgmma", 1, E, 128, 128)
    assert dn == kernels.MoePlan("wgmma", 1, F, down_tile, tile_m)


@pytest.mark.parametrize("C", [32, 40, 64, 120, 128, 136, 160, 192, 200, 256, 320, 384, 544, 640])
def test_wgmma_slot_tile_computes_fewest_rows(C):
    """down's 128-feature blocks take the slot tile of
    ``MOE_WGMMA_TILES_M`` whose tiles cover C with the fewest rows, the
    smaller on a tie; gate/up (and down's 256-feature blocks) the first."""
    plan = kernels.moe_gemm_plan(BF16, "down", X, C, F, E, sms=10_000)  # never wide
    assert plan.tile_n == 128
    rows = {m: -(-C // m) * m for m in kernels.MOE_WGMMA_TILES_M}
    assert rows[plan.tile_m] == min(rows.values())
    assert plan.tile_m == min(m for m in rows if rows[m] == min(rows.values()))
    assert kernels.moe_gemm_plan(BF16, "gate_up", X, C, E, F).tile_m == 128


@pytest.mark.parametrize("delta", [-8, -1, 0, 1, 8])
@pytest.mark.parametrize("epilogue,K,N", [("gate_up", E, F), ("down", F, E)])
def test_threshold_edge(delta, epilogue, K, N):
    C = kernels.MOE_WGMMA_MIN_C + delta
    plan = kernels.moe_gemm_plan(BF16, epilogue, X, C, K, N)
    if delta >= 0:
        assert plan.route == "wgmma"
    else:
        assert plan.route in (("mma",) if epilogue == "gate_up" else ("mma", "mma_split"))


@pytest.mark.parametrize("epilogue,K,N", [("gate_up", E, F), ("down", F, E)])
@pytest.mark.parametrize("C", [8, 160, 640])
def test_f32_and_misaligned_take_cuda_core(epilogue, K, N, C):
    assert kernels.moe_gemm_plan(torch.float32, epilogue, X, C, K, N) == \
        kernels.MoePlan("cuda_core", 1, K, 64, 64)
    assert kernels.moe_gemm_plan(BF16, epilogue, X, C, K, N, aligned=False) == \
        kernels.MoePlan("cuda_core", 1, K, 64, 64)


@pytest.mark.parametrize("K,N", [(4096 + 32, 14336), (4096, 14336 + 32), (96, 80), (37, 64)])
@pytest.mark.parametrize("C", [8, 640])
def test_k_or_n_off_the_tile_take_cuda_core(K, N, C):
    for epilogue in ("gate_up", "down"):
        assert kernels.moe_gemm_plan(BF16, epilogue, X, C, K, N).route == "cuda_core"


@pytest.mark.parametrize("N", [64, 192, 4096 + 64])
def test_n_off_the_wgmma_tile_stays_on_mma(N):
    for epilogue in ("gate_up", "down"):
        plan = kernels.moe_gemm_plan(BF16, epilogue, X, 640, 4096, N)
        assert plan.route in ("mma", "mma_split")
        assert epilogue == "down" or plan.route == "mma"


# a shape for each form of the plan: gate/up and down on mma, down split,
# wgmma's 128-slot x 128-feature blocks, down's 192-slot and 256-feature
# ones, and the wide blocks on a card of few SMs
GRID = [("gate_up", 8, 8, E, F, 132), ("down", 1, 8, 512, 256, 132), ("down", 8, 8, F, E, 132),
        ("down", 2, 8, 4096, 1024, 7), ("gate_up", 8, 160, E, F, 132),
        ("down", 8, 160, F, E, 132), ("down", 8, 640, F, E, 132), ("down", 4, 40, F, E, 7)]


@pytest.mark.parametrize("epilogue,Xn,C,K,N,sms", GRID)
def test_plan_ranges_cover_k_within_the_limits(epilogue, Xn, C, K, N, sms):
    plan = kernels.moe_gemm_plan(BF16, epilogue, Xn, C, K, N, sms=sms)
    assert plan.route in kernels.MOE_GEMM_ROUTES and plan.route != "cuda_core"
    _covers_k(plan, K)
    if epilogue == "gate_up":
        assert plan.ksplit == 1
    if plan.ksplit > 1:
        assert plan.ksplit * Xn * C * N <= kernels.MOE_PARTIAL_FLOATS
        assert plan.route == "mma_split" and epilogue == "down"
    else:
        assert plan.route in ("wgmma", "mma")
    assert N % plan.tile_n == 0
    if plan.route == "wgmma":
        assert plan.tile_n == 128 or (plan.tile_n == 256 and epilogue == "down")
        assert plan.tile_m in kernels.MOE_WGMMA_TILES_M
        assert plan.tile_m == 128 or (epilogue == "down" and plan.tile_n == 128)
    else:
        assert plan.tile_n == plan.tile_m == 64
    # shapes alone decide: the same call gives the same plan
    assert kernels.moe_gemm_plan(BF16, epilogue, Xn, C, K, N, sms=sms) == plan


def test_grid_reaches_every_form():
    plans = [(kernels.moe_gemm_plan(BF16, ep, Xn, C, K, N, sms=sms), ep)
             for ep, Xn, C, K, N, sms in GRID]
    forms = {(p.route, p.tile_n, p.tile_m, ep) for p, ep in plans}
    assert {(r, 64, 64) for r in ("mma", "mma_split")} | {
        ("wgmma", 128, 128), ("wgmma", 128, 192), ("wgmma", 256, 128)} == {f[:3] for f in forms}
    assert ("mma", 64, 64, "gate_up") in forms and ("mma", 64, 64, "down") in forms
