"""The port's Hopper kernels against their plain PyTorch twins, on the card.

Every test here carries the ``cuda`` marker and skips without a card (the
skip condition is a string, so pytest evaluates it at setup, not while the
module is imported).  This file imports neither JAX nor the JAX package, so
it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.ops.attention import (
    FLASH_MMA_HEAD_DIMS,
    attention,
    flash_attention,
    flash_attention_plain,
    flash_bf16_bound,
    paged_gqa_decode_attention,
    paged_gqa_decode_attention_plain,
)

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

F32_TOL = 1e-4  # summation order only
# bf16 with P.V in f32 (paged decode, flash at head_dim 256): rounding an f32
# result moves it by at most 2^-8 of its magnitude; the absolute term covers
# the f32 summation order.  The tensor-core flash kernel (bf16 at
# FLASH_MMA_HEAD_DIMS) rounds P to bf16 before P.V, as the JAX kernel does,
# and is held to ``flash_bf16_bound`` instead.
BF16_REL, BF16_ABS = 2.0 ** -8, 1e-4


def _assert_close(out, ref, bound=None):
    diff = (out.float() - ref).abs()
    if out.dtype == torch.bfloat16:
        if bound is None:
            bound = BF16_REL * ref.abs() + BF16_ABS
        assert bool((diff <= bound).all()), (diff / bound).max().item()
    else:
        assert diff.max().item() <= F32_TOL


def _assert_flash_close(out, q, k, v, *, causal, window=None):
    args = (q.float(), k.float(), v.float())
    ref = flash_attention_plain(*args, causal=causal, window=window)
    bound = None
    if out.dtype == torch.bfloat16 and q.shape[-1] in FLASH_MMA_HEAD_DIMS:
        bound = flash_bf16_bound(*args, ref, causal=causal, window=window)
    _assert_close(out, ref, bound)


@pytest.mark.parametrize(
    "dtype,causal,window,D,shape",
    [  # shape: B, H, KH, Sq (= Sk)
        (torch.float32, True, None, 64, (2, 8, 2, 256)),
        (torch.float32, False, None, 128, (2, 8, 2, 256)),
        (torch.float32, True, 100, 128, (2, 8, 2, 256)),
        (torch.bfloat16, True, None, 128, (2, 8, 2, 256)),
        (torch.bfloat16, True, None, 256, (2, 8, 2, 256)),
        (torch.float32, True, 64, 256, (2, 8, 2, 256)),
        # the tensor-core kernel at Llama's head dims
        (torch.bfloat16, True, None, 64, (2, 32, 8, 512)),
        (torch.bfloat16, True, None, 128, (2, 32, 8, 512)),
        (torch.bfloat16, False, None, 64, (2, 8, 2, 256)),
        (torch.bfloat16, False, None, 128, (2, 8, 2, 256)),
        # key tiles wholly masked for some rows of a q tile
        (torch.bfloat16, True, 100, 64, (2, 8, 2, 512)),
        (torch.bfloat16, True, 100, 128, (2, 8, 2, 512)),
        # a single tile
        (torch.bfloat16, True, None, 64, (3, 4, 2, 64)),
        (torch.bfloat16, False, None, 128, (3, 4, 2, 64)),
    ],
)
def test_flash_kernel_matches_plain(dtype, causal, window, D, shape):
    gen = torch.Generator(device="cuda").manual_seed(0)
    B, H, KH, S = shape
    q = torch.randn((B, H, S, D), generator=gen, device="cuda", dtype=dtype)
    k = torch.randn((B, KH, S, D), generator=gen, device="cuda", dtype=dtype)
    v = torch.randn((B, KH, S, D), generator=gen, device="cuda", dtype=dtype)
    before = kernels.launch_counts()["flash_prefill"]
    out = flash_attention(q, k, v, causal=causal, window=window)
    assert kernels.launch_counts()["flash_prefill"] == before + 1
    _assert_flash_close(out, q, k, v, causal=causal, window=window)


def test_flash_kernel_refuses_misaligned_views():
    """A contiguous view whose data does not start on a 16-byte boundary
    (the kernel's copy width) is refused, not copied, and launches nothing."""
    shape = (1, 4, 128, 64)
    n = int(np.prod(shape))
    base = torch.zeros((3 * n + 1,), device="cuda", dtype=torch.bfloat16)
    q, k, v = (base[1 + i * n: 1 + (i + 1) * n].view(shape) for i in range(3))
    assert q.data_ptr() % 16 != 0
    before = kernels.launch_counts()["flash_prefill"]
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_prefill"] == before


@pytest.mark.parametrize("D", [64, 128, 256])
def test_attention_dispatch_launches_flash_kernel(D):
    """Every head_dim the JAX dispatch sends to flash launches the kernel on
    the card; none runs the plain path there."""
    gen = torch.Generator(device="cuda").manual_seed(1)
    q, k, v = (
        torch.randn((1, 4, 256, D), generator=gen, device="cuda", dtype=torch.bfloat16)
        for _ in range(3)
    )
    before = kernels.launch_counts()["flash_prefill"]
    out = attention(q, k, v, causal=True)
    assert kernels.launch_counts()["flash_prefill"] == before + 1
    _assert_flash_close(out, q, k, v, causal=True)


def test_attention_dispatch_raises_past_kernel_head_dims():
    q = torch.zeros((1, 4, 256, 384), device="cuda", dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim"):
        attention(q, q, q, causal=True)


@pytest.mark.parametrize(
    "dtype,window,D,G",
    [
        (torch.float32, None, 16, 2),
        (torch.float32, 40, 128, 4),
        (torch.float32, None, 64, 8),
        (torch.bfloat16, None, 128, 4),
        (torch.bfloat16, None, 256, 2),
        (torch.float32, 40, 256, 4),
    ],
)
def test_paged_kernel_matches_plain(dtype, window, D, G):
    rng = np.random.default_rng(2)
    B, KH, page, NB = 5, 2, 32, 6
    H = KH * G
    P = B * NB + 3
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    positions = np.asarray([0, 31, 32, 100, 191], np.int32)
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1 :] = P + b  # sentinels past each allocation
    gen = torch.Generator(device="cuda").manual_seed(0)
    q = torch.randn((B, H, 1, D), generator=gen, device="cuda", dtype=dtype)
    k_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=dtype)
    v_pool = torch.randn((P, KH, page, D), generator=gen, device="cuda", dtype=dtype)
    bt_t = torch.from_numpy(bt).cuda()
    pos_t = torch.from_numpy(positions).cuda()
    active = torch.tensor([True, True, False, True, True], device="cuda")
    out = paged_gqa_decode_attention(q, k_pool, v_pool, bt_t, pos_t, active=active, window=window)
    ref = paged_gqa_decode_attention_plain(
        q.float(), k_pool.float(), v_pool.float(), bt_t, pos_t, active=active, window=window
    )
    _assert_close(out, ref)


def test_kernel_wrappers_refuse_what_they_do_not_take():
    q = torch.zeros((1, 4, 256, 96), device="cuda")
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention(q, q, q, causal=True)
    q = torch.zeros((1, 16, 1, 256), device="cuda")
    pool = torch.zeros((2, 2, 8, 256), device="cuda")
    with pytest.raises(ValueError, match="H/KH"):
        paged_gqa_decode_attention(
            q, pool, pool, torch.zeros((1, 2), dtype=torch.int32, device="cuda"),
            torch.zeros((1,), dtype=torch.int32, device="cuda"),
        )
    q = torch.zeros((1, 4, 1, 64), device="cuda", dtype=torch.float16)
    pool = torch.zeros((2, 2, 8, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        paged_gqa_decode_attention(
            q, pool, pool, torch.zeros((1, 2), dtype=torch.int32, device="cuda"),
            torch.zeros((1,), dtype=torch.int32, device="cuda"),
        )
