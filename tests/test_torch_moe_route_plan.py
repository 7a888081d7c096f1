"""The MoE routing kernel's launch plan (``kernels.moe_route_plan``) on the
CPU: the decode tick's routing is one block with no scratch; every expert
count X <= 32, top K <= min(X, 8) and dtype the wrapper takes gets a tile
that holds X (64 partial logits a thread), a grid that covers T, and the
scratch and ticket counter its form needs; the one-tile split
(``MOE_ROUTE_SPLITS``) is capped at a warp's worth of 16-byte chunks a
block; the plan's constants are the kernel source's.
"""

import re

import pytest
import torch

from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.ops.moe import MAX_EXPERTS, MAX_TOP_K

TOKENS = [1, 2, 7, 8, 9, 33, 512, 2048, 4100]
MIXTRAL = DecoderConfig.mixtral_8x7b()


@pytest.fixture
def route_splits(monkeypatch):
    """Set ``kernels.MOE_ROUTE_SPLITS`` for one test; the cached plans are
    dropped before and after."""
    kernels.moe_route_plan.cache_clear()
    yield lambda s: monkeypatch.setattr(kernels, "MOE_ROUTE_SPLITS", s)
    kernels.moe_route_plan.cache_clear()


def test_decode_tick_is_one_launch_of_one_tile():
    """The decode tick (8 slots) is one tile: E over MOE_ROUTE_SPLITS blocks,
    their f32 partial logits and one ticket counter; at a short E (256, a
    warp's worth of 16-byte chunks) one block and no scratch."""
    plan = kernels.moe_route_plan(torch.bfloat16, 8, MIXTRAL.hidden_size, MIXTRAL.num_experts,
                                  MIXTRAL.experts_per_token)
    splits = kernels.MOE_ROUTE_SPLITS
    assert plan == kernels.RoutePlan("split", 8, 8, 1, splits, splits * 64, 1)
    assert kernels.moe_route_plan(torch.bfloat16, 8, 256, MIXTRAL.num_experts,
                                  MIXTRAL.experts_per_token) == \
        kernels.RoutePlan("block", 8, 8, 1, 1, 0, 0)


@pytest.mark.parametrize("T", [512, 2048, 4096])
def test_mixtral_prefill_takes_token_tiles(T):
    X, K = MIXTRAL.num_experts, MIXTRAL.experts_per_token
    plan = kernels.moe_route_plan(torch.bfloat16, T, MIXTRAL.hidden_size, X, K)
    assert plan == kernels.RoutePlan("tiles", 8, 8, T // 8, 1, K * X * T // 8, 1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("X", range(1, MAX_EXPERTS + 1))
def test_every_width_the_wrapper_takes_is_planned(X, dtype):
    for K in range(1, min(X, MAX_TOP_K) + 1):
        for T in TOKENS:
            plan = kernels.moe_route_plan(dtype, T, 4096, X, K)
            xmax = min(m for m in kernels.MOE_ROUTE_XMAX if m >= X)
            assert plan.xmax == xmax and plan.tile_tokens * xmax == kernels.MOE_ROUTE_VALUES
            assert plan.tiles == -(-T // plan.tile_tokens)
            if plan.tiles == 1:  # E 4,096 is 512 (bf16) or 1,024 (f32) 16-byte chunks
                assert plan.form == "split" and plan.splits == kernels.MOE_ROUTE_SPLITS
                assert (plan.scratch, plan.counters) == (plan.splits * 64, 1)
            else:
                assert plan.splits == 1
                assert plan.form == "tiles" and plan.counters == 1
                assert plan.scratch == K * X * plan.tiles  # one count a (choice, expert, tile)
            assert plan.form in kernels.MOE_ROUTE_FORMS


@pytest.mark.parametrize("dtype,E,splits,want", [
    (torch.bfloat16, 4096, 4, 4), (torch.bfloat16, 4096, 64, 16), (torch.float32, 4096, 64, 32),
    (torch.bfloat16, 4096, 1, 1), (torch.bfloat16, 64, 8, 1), (torch.float32, 260, 8, 2)])
def test_one_tile_split_is_capped_at_a_warp_of_chunks(dtype, E, splits, want, route_splits):
    route_splits(splits)
    plan = kernels.moe_route_plan(dtype, 8, E, 8, 2)
    assert plan.splits == want and plan.tiles == 1
    if want == 1:
        assert plan.form == "block" and plan.counters == 0
    else:  # f32 partial logits a block, one ticket counter
        assert plan.form == "split" and plan.scratch == want * kernels.MOE_ROUTE_VALUES
        assert plan.counters == 1


def test_split_applies_to_one_tile_only(route_splits):
    route_splits(8)
    plan = kernels.moe_route_plan(torch.bfloat16, 512, 4096, 8, 2)
    assert plan.form == "tiles" and plan.splits == 1


@pytest.mark.parametrize("dtype,X,K", [(torch.float16, 8, 2), (torch.bfloat16, 33, 2),
                                       (torch.bfloat16, 8, 9), (torch.bfloat16, 4, 5),
                                       (torch.float32, 8, 0)])
def test_plan_refuses_what_the_kernel_does_not_take(dtype, X, K):
    with pytest.raises((TypeError, ValueError)):
        kernels.moe_route_plan(dtype, 8, 4096, X, K)


def test_plan_constants_are_the_kernel_sources():
    src = (kernels.CSRC / "moe_route.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const("ROUTE_VALUES") == kernels.MOE_ROUTE_VALUES
    assert const("MAX_X") == MAX_EXPERTS == kernels.MOE_ROUTE_XMAX[-1]
    assert const("MAX_K") == MAX_TOP_K
    assert "kernels.moe_route_plan" in src
