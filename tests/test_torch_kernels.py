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
    chunked_bf16_bound,
    chunked_fp8_dot_bound,
    chunked_gqa_decode_attention,
    chunked_gqa_decode_attention_plain,
    flash_attention,
    flash_attention_plain,
    flash_bf16_bound,
    paged_bf16_bound,
    paged_fp8_dot_bound,
    paged_fp8_dot_probe,
    paged_gqa_decode_attention,
    paged_gqa_decode_attention_plain,
    paged_tree_attention,
    paged_tree_attention_plain,
    paged_tree_bf16_bound,
)
from django_assistant_bot_tpu_torch.ops.speculative import make_tree_spec
from django_assistant_bot_tpu_torch.ops.quant import (
    QTensor,
    QTensor4,
    deq,
    qeinsum,
    qeinsum_group,
    qeinsum_plain,
    qgemm_bf16_bound,
    quantize_tensor_int4,
    tied_head,
    tied_head_bf16_bound,
    to_kv_dtype,
)
from django_assistant_bot_tpu_torch.ops.sampling import (
    gumbel_noise,
    sample_logits,
    sample_logits_plain,
    top_p_margin,
)
from django_assistant_bot_tpu_torch.storage import VectorIndex, topk_scores
from django_assistant_bot_tpu_torch.storage.ann import (
    ANNIndex,
    adc_shortlist,
    adc_shortlist_plain,
    make_clustered,
    rerank,
)
from django_assistant_bot_tpu_torch.storage.knn_check import rerank_agreement, topk_agreement

pytestmark = [
    pytest.mark.cuda,
    pytest.mark.skipif("not torch.cuda.is_available()", reason="needs a CUDA card"),
]

F32_TOL = 1e-4  # summation order only
# bf16 with P.V in f32 (flash at head_dim 256): rounding an f32 result moves
# it by at most 2^-8 of its magnitude; the absolute term covers the f32
# summation order.  The tensor-core flash kernel (bf16 at
# FLASH_MMA_HEAD_DIMS) rounds P to bf16 before P.V, as the JAX kernel does,
# and is held to ``flash_bf16_bound`` instead; every bf16 paged decode
# output (P rounded before P.V, as the JAX loop does) to ``paged_bf16_bound``.
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


# rows of the default paged geometry: B=5, KH=2, page 32, NB 6; row 2 inactive
_PAGED_DEFAULT = dict(page=32, NB=6, positions=[0, 31, 32, 100, 191], inactive=[2])


def _paged_inputs(dtype, D, G, *, page, NB, positions, inactive, KH=2, offset=0):
    """Pools and queries for ``positions``; ``offset`` elements of a larger
    buffer precede each of q and the pools (to put them off 16 bytes)."""
    rng = np.random.default_rng(2)
    B = len(positions)
    H = KH * G
    P = B * NB + 3
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1 :] = P + b  # sentinels past each allocation
    gen = torch.Generator(device="cuda").manual_seed(0)

    def mk(*shape):
        n = int(np.prod(shape))
        flat = torch.randn((n + offset,), generator=gen, device="cuda", dtype=dtype)
        return flat[offset:].view(shape)

    q = mk(B, H, 1, D)
    k_pool = mk(P, KH, page, D)
    v_pool = mk(P, KH, page, D)
    active = torch.ones(B, dtype=torch.bool)
    active[inactive] = False
    return (q, k_pool, v_pool, torch.from_numpy(bt).cuda(),
            torch.tensor(positions, dtype=torch.int32, device="cuda")), active.cuda()


@pytest.mark.parametrize(
    "dtype,window,D,G,layout",
    [
        (torch.float32, None, 16, 2, _PAGED_DEFAULT),
        (torch.float32, 40, 128, 4, _PAGED_DEFAULT),
        (torch.float32, None, 64, 8, _PAGED_DEFAULT),
        (torch.bfloat16, None, 128, 4, _PAGED_DEFAULT),
        (torch.bfloat16, None, 256, 2, _PAGED_DEFAULT),
        (torch.float32, 40, 256, 4, _PAGED_DEFAULT),
        # the tensor-core kernel (bf16, D 64 and 128) at every group size
        *((torch.bfloat16, w, D, G, _PAGED_DEFAULT)
          for D in (64, 128) for G in (1, 2, 4, 8) for w in (None, 40)),
        # page 512: a row over all 8 pages beside rows of one key and position 0
        (torch.bfloat16, None, 128, 4,
         dict(page=512, NB=8, positions=[4095, 0, 512, 7, 1], inactive=[])),
        (torch.bfloat16, 1, 128, 4,
         dict(page=512, NB=8, positions=[4095, 0, 512, 7, 1], inactive=[])),
        # an inactive row far past the batch's last block: it must not widen the read
        (torch.bfloat16, None, 128, 4,
         dict(page=64, NB=32, positions=[100, 2000, 30, 50], inactive=[1])),
        # windows that start inside a chunk of 64 keys
        (torch.bfloat16, 100, 128, 4,
         dict(page=512, NB=4, positions=[1000, 1500, 2047, 1100], inactive=[3])),
        (torch.bfloat16, 700, 64, 8,
         dict(page=128, NB=16, positions=[1000, 1500, 2047, 300], inactive=[])),
        # a page that is not a multiple of the 64-key chunk
        (torch.bfloat16, None, 128, 4,
         dict(page=100, NB=5, positions=[499, 99, 100, 250], inactive=[])),
        # 260 slots: the slots' item prefix (in dynamic shared memory) over
        # several warp-wide rounds
        (torch.bfloat16, None, 128, 4,
         dict(page=16, NB=2, positions=[(7 * i) % 32 for i in range(260)], inactive=[])),
        # G = 8 (H=64, KH=8) with rows over more than 16 and more than 32
        # blocks' runs: the final merge reads its runs' weights in batches of
        # 32 runs, 8 query heads each
        *((torch.bfloat16, None, D, 8, dict(page=512, NB=NB, positions=pos, inactive=[], KH=8))
          for D in (64, 128)
          for NB, pos in ((8, [4095]), (8, [4095, 3000]), (32, [16383]), (32, [16383, 9000]))),
    ],
)
def test_paged_kernel_matches_plain(dtype, window, D, G, layout):
    args, active = _paged_inputs(dtype, D, G, **layout)
    before = kernels.launch_counts()["paged_decode"]
    routes = kernels.by_route(kernels.PAGED_FORMS)
    out = paged_gqa_decode_attention(*args, active=active, window=window)
    assert kernels.launch_counts()["paged_decode"] == before + 1
    route = "mma" if dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS else "cuda_core"
    assert kernels.by_route(kernels.PAGED_FORMS)[route] == routes[route] + 1
    q, k_pool, v_pool, bt, pos = args
    fargs = (q.float(), k_pool.float(), v_pool.float(), bt, pos)
    ref = paged_gqa_decode_attention_plain(*fargs, active=active, window=window)
    bound = None
    if dtype == torch.bfloat16:
        bound = paged_bf16_bound(*fargs, ref, active=active, window=window)
    assert bool(torch.isfinite(out).all())
    _assert_close(out, ref, bound)


@pytest.mark.parametrize("D", [64, 128])
def test_paged_kernel_repeats_bitwise(D):
    """Two calls on the same inputs give bitwise-equal outputs: the
    per-row counters are back at zero after each call and the merge order
    is fixed; a call at another batch shape in between changes neither."""
    layout = dict(page=512, NB=8, positions=[5, 511, 512, 1041, 1836, 4095, 1500, 700],
                  inactive=[6])
    args, active = _paged_inputs(torch.bfloat16, D, 4, KH=8, **layout)
    first = paged_gqa_decode_attention(*args, active=active)
    second = paged_gqa_decode_attention(*args, active=active)
    other, other_active = _paged_inputs(torch.bfloat16, D, 4, KH=8, **_PAGED_DEFAULT)
    paged_gqa_decode_attention(*other, active=other_active, window=40)
    third = paged_gqa_decode_attention(*args, active=active)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, third)


@pytest.mark.parametrize("D", [64, 128])
def test_paged_kernel_off_16_bytes_takes_cuda_core_route(D):
    """bf16 q and pools 8 bytes off a 16-byte boundary cannot feed the
    tensor-core kernel's 16-byte copies: the call takes the CUDA-core
    kernels, counted as such, and still matches the plain twin."""
    layout = dict(page=64, NB=4, positions=[3, 70, 200, 255], inactive=[1], KH=8)
    args, active = _paged_inputs(torch.bfloat16, D, 4, offset=4, **layout)
    assert all(t.data_ptr() % 16 == 8 for t in args[:3])
    routes = kernels.by_route(kernels.PAGED_FORMS)
    out = paged_gqa_decode_attention(*args, active=active)
    assert kernels.by_route(kernels.PAGED_FORMS) == {
        "mma": routes["mma"], "cuda_core": routes["cuda_core"] + 1}
    q, k_pool, v_pool, bt, pos = args
    fargs = (q.float(), k_pool.float(), v_pool.float(), bt, pos)
    ref = paged_gqa_decode_attention_plain(*fargs, active=active)
    _assert_close(out, ref, paged_bf16_bound(*fargs, ref, active=active))


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


# ------------------------------------------------------------- narrow pools
# the pool formats a paged read takes besides q's own (kv_cache_dtype)
_KV = {"bf16": torch.bfloat16, "e4m3": torch.float8_e4m3fn, "e5m2": torch.float8_e5m2}


def _narrow(pool, kv):
    return to_kv_dtype(pool, _KV[kv])


def _assert_within(out, ref, bound):
    diff = (out.float() - ref).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((diff <= bound).all()), (diff / bound).max().item()


_NARROW_CASES = [
    # (q dtype, D, G, window, layout): the tensor-core kernel at both head
    # dims and every group size, the CUDA-core kernels at the tiny model's
    # D 16 and at 256, the main path's shape, a window inside a chunk, 260
    # slots, a page off the 64-key chunk
    *((torch.bfloat16, D, G, w, _PAGED_DEFAULT) for D in (64, 128) for G in (1, 2, 4, 8)
      for w in (None, 40)),
    (torch.bfloat16, 16, 2, None, _PAGED_DEFAULT),
    (torch.bfloat16, 256, 2, 40, _PAGED_DEFAULT),
    (torch.float32, 16, 2, None, _PAGED_DEFAULT),
    (torch.float32, 128, 4, 40, _PAGED_DEFAULT),
    (torch.float32, 64, 8, None, _PAGED_DEFAULT),
    (torch.bfloat16, 128, 4, None,
     dict(page=512, NB=8, positions=[5, 511, 512, 1041, 1836, 4095, 1500, 700], inactive=[6],
          KH=8)),
    (torch.bfloat16, 128, 4, 100,
     dict(page=512, NB=4, positions=[1000, 1500, 2047, 1100], inactive=[3])),
    (torch.bfloat16, 128, 4, None,
     dict(page=16, NB=2, positions=[(7 * i) % 32 for i in range(260)], inactive=[])),
    (torch.bfloat16, 128, 4, None,
     dict(page=100, NB=5, positions=[499, 99, 100, 250], inactive=[])),
]


@pytest.mark.parametrize("kv,fp8_dot", [("e4m3", False), ("e5m2", False), ("e4m3", True),
                                        ("e5m2", True), ("bf16", False)])
@pytest.mark.parametrize("dtype,D,G,window,layout", _NARROW_CASES)
def test_paged_kernel_reads_narrow_pools(dtype, D, G, window, layout, kv, fp8_dot):
    """K1 (the dequant read of a bf16 or fp8 pool) and K2 (the fp8 in-dot
    read) against the plain twin on the same pools: the dequant read of a
    bf16 output within ``paged_bf16_bound`` (the widening is exact), of an
    f32 output within 1e-4; the in-dot read within ``paged_fp8_dot_bound``.
    The call takes the expected route and is counted under its read."""
    if kv == "bf16" and dtype == torch.bfloat16:
        pytest.skip("a bf16 pool under bf16 queries is the native read")
    args, active = _paged_inputs(dtype, D, G, **layout)
    q, k_pool, v_pool, bt, pos = args
    k_pool, v_pool = _narrow(k_pool, kv), _narrow(v_pool, kv)
    route = "mma" if dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS else "cuda_core"
    form = f"{route}:{kv}/{'in_dot' if fp8_dot else 'dequant'}"
    forms = dict(kernels.PAGED_FORMS)
    out = paged_gqa_decode_attention(q, k_pool, v_pool, bt, pos, active=active, window=window,
                                     fp8_dot=fp8_dot)
    assert kernels.PAGED_FORMS[form] == forms[form] + 1
    fargs = (q.float(), k_pool, v_pool, bt, pos)
    ref = paged_gqa_decode_attention_plain(*fargs, active=active, window=window,
                                           fp8_dot=fp8_dot)
    if fp8_dot:
        bound = paged_fp8_dot_bound(*fargs, ref, active=active, window=window)
    elif dtype == torch.bfloat16:
        bound = paged_bf16_bound(*fargs, ref, active=active, window=window)
    else:
        bound = torch.full_like(ref, F32_TOL)
    _assert_within(out, ref, bound)


_PHASE2_LAYOUT = dict(page=512, NB=8, positions=[5, 511, 512, 1041, 1836, 4095, 1500, 700],
                     inactive=[6], KH=8)


@pytest.mark.parametrize("kv", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype,D,G,layout", [
    # the tensor-core kernel and the CUDA-core kernels, at the main path's
    # shape and at the small default one
    (torch.bfloat16, 128, 4, _PHASE2_LAYOUT),
    (torch.bfloat16, 64, 8, _PAGED_DEFAULT),
    (torch.float32, 128, 4, _PHASE2_LAYOUT),
    (torch.float32, 16, 2, _PAGED_DEFAULT),
])
def test_paged_kernel_indot_rounds_p_as_the_twin(dtype, D, G, layout, kv):
    """K2 on ``paged_fp8_dot_probe``'s inputs, where the kernel and the twin
    round every p at the same scale: within ``paged_bf16_bound`` of the
    twin.  The control, K1 (the dequant read) on the same inputs, has the
    same scores and P not rounded to fp8, and misses that bound."""
    (_, _, _, bt, pos), active = _paged_inputs(dtype, D, G, **layout)
    KH = layout.get("KH", 2)
    B, page = len(layout["positions"]), layout["page"]
    P = B * layout["NB"] + 3  # as _paged_inputs: its sentinels lie past P
    q, k_pool, v_pool = (t.cuda() for t in paged_fp8_dot_probe(
        B, KH * G, KH, D, P, page, _KV[kv], dtype, torch.Generator().manual_seed(0)))
    args = (q, k_pool, v_pool, bt, pos)
    ref = paged_gqa_decode_attention_plain(q.float(), *args[1:], active=active, fp8_dot=True)
    bound = paged_bf16_bound(q.float(), *args[1:], ref, active=active)
    _assert_within(paged_gqa_decode_attention(*args, active=active, fp8_dot=True), ref, bound)
    control = paged_gqa_decode_attention(*args, active=active)
    assert not bool(((control.float() - ref).abs() <= bound).all())


@pytest.mark.parametrize("kv,fp8_dot", [("e4m3", False), ("e5m2", True), ("e4m3", True)])
@pytest.mark.parametrize("D", [64, 128])
def test_paged_kernel_narrow_pools_repeat_bitwise(D, kv, fp8_dot):
    layout = dict(page=512, NB=8, positions=[5, 511, 512, 1041, 1836, 4095, 1500, 700],
                  inactive=[6])
    (q, kp, vp, bt, pos), active = _paged_inputs(torch.bfloat16, D, 4, KH=8, **layout)
    args = (q, _narrow(kp, kv), _narrow(vp, kv), bt, pos)
    first = paged_gqa_decode_attention(*args, active=active, fp8_dot=fp8_dot)
    other, other_active = _paged_inputs(torch.bfloat16, D, 4, KH=8, **_PAGED_DEFAULT)
    paged_gqa_decode_attention(*other, active=other_active, window=40)
    second = paged_gqa_decode_attention(*args, active=active, fp8_dot=fp8_dot)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_paged_kernel_refuses_pools_it_does_not_take():
    (q, kp, vp, bt, pos), active = _paged_inputs(torch.bfloat16, 128, 4, **_PAGED_DEFAULT)
    with pytest.raises(ValueError, match="fp8"):  # in-dot needs an fp8 pool
        paged_gqa_decode_attention(q, kp, vp, bt, pos, active=active, fp8_dot=True)
    with pytest.raises(TypeError):  # an f32 pool under bf16 queries
        paged_gqa_decode_attention(q, kp.float(), vp.float(), bt, pos, active=active)
    with pytest.raises(TypeError):  # K and V in two formats
        paged_gqa_decode_attention(q, _narrow(kp, "e4m3"), _narrow(vp, "e5m2"), bt, pos)


# ------------------------------------------------ chunked decode (the legacy slot cache)
def _chunked_inputs(dtype, D, G, *, chunk, NB, positions, inactive, KH=2):
    """Queries and a slot cache ``[B, KH, NB * chunk, D]`` for ``positions``."""
    B, H, S = len(positions), KH * G, NB * chunk
    gen = torch.Generator(device="cuda").manual_seed(3)
    q, k, v = (torch.randn(shape, generator=gen, device="cuda", dtype=dtype)
               for shape in ((B, H, 1, D), (B, KH, S, D), (B, KH, S, D)))
    active = torch.ones(B, dtype=torch.bool)
    active[inactive] = False
    return q, k, v, torch.tensor(positions, dtype=torch.int32, device="cuda"), active.cuda()


def _as_pages(cache, chunk):
    """The slot cache's chunks as a page pool (page ``b * NB + j`` is chunk
    j of row b) and its identity block table."""
    B, KH, S, D = cache.shape
    NB = S // chunk
    pool = cache.reshape(B, KH, NB, chunk, D).transpose(1, 2).reshape(B * NB, KH, chunk, D)
    bt = torch.arange(B * NB, dtype=torch.int32, device=cache.device).reshape(B, NB)
    return pool.contiguous(), bt


_CHUNKED_MAIN = dict(chunk=512, NB=8, positions=[5, 511, 512, 1041, 1836, 4095, 1500, 700],
                     inactive=[6], KH=8)
_CHUNKED_CASES = [
    # the tensor-core kernel at both head dims and three group sizes, the
    # CUDA-core kernels (f32 queries, D 16 and 256), ragged rows on chunk
    # boundaries and an inactive row
    *((torch.bfloat16, D, G, w, dict(chunk=64, NB=8, positions=[0, 63, 64, 300, 511],
                                     inactive=[2]))
      for D in (64, 128) for G in (1, 4, 8) for w in (None, 40)),
    (torch.float32, 16, 2, None, dict(chunk=16, NB=4, positions=[0, 15, 16, 41, 63],
                                      inactive=[3])),
    (torch.float32, 128, 4, 40, dict(chunk=64, NB=8, positions=[0, 63, 64, 300, 511],
                                     inactive=[2])),
    (torch.bfloat16, 256, 2, None, dict(chunk=64, NB=4, positions=[3, 70, 200, 255],
                                        inactive=[])),
    # the main path's shape; a window whose lower bound is past chunk 0; a
    # batch whose hi is 1 (every position inside chunk 0)
    (torch.bfloat16, 128, 4, None, _CHUNKED_MAIN),
    (torch.bfloat16, 128, 4, 100, dict(chunk=512, NB=8, positions=[1000, 1500, 2047, 1100],
                                       inactive=[3], KH=8)),
    (torch.bfloat16, 128, 4, None, dict(chunk=512, NB=8, positions=[0, 0, 3, 511],
                                        inactive=[], KH=8)),
]
_CHUNKED_READS = [(None, False), ("bf16", False), ("e4m3", False), ("e5m2", False),
                  ("e4m3", True), ("e5m2", True)]


@pytest.mark.parametrize("kv,fp8_dot", _CHUNKED_READS)
@pytest.mark.parametrize("dtype,D,G,window,layout", _CHUNKED_CASES)
def test_chunked_kernel_matches_plain(dtype, D, G, window, layout, kv, fp8_dot):
    """The contiguous form of the paged kernels against the chunked twin on
    the same cache: native and dequant bf16 outputs within
    ``chunked_bf16_bound``, f32 within 1e-4, the in-dot read within
    ``chunked_fp8_dot_bound``; counted once under ``chunked_decode`` (and
    its route and read), never under ``paged_decode``."""
    if kv == "bf16" and dtype == torch.bfloat16:
        pytest.skip("a bf16 cache under bf16 queries is the native read")
    q, k, v, pos, active = _chunked_inputs(dtype, D, G, **layout)
    if kv is not None:
        k, v = _narrow(k, kv), _narrow(v, kv)
    chunk = layout["chunk"]
    route = "mma" if dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS else "cuda_core"
    form = f"{route}:{kernels.paged_read(dtype, k.dtype, fp8_dot)}"
    before, forms = kernels.launch_counts(), dict(kernels.CHUNKED_FORMS)
    out = chunked_gqa_decode_attention(q, k, v, pos, chunk=chunk, active=active, window=window,
                                       fp8_dot=fp8_dot)
    after = kernels.launch_counts()
    assert after["chunked_decode"] == before["chunked_decode"] + 1
    assert after["paged_decode"] == before["paged_decode"]
    assert kernels.CHUNKED_FORMS[form] == forms[form] + 1
    kw = dict(chunk=chunk, active=active, window=window)
    ref = chunked_gqa_decode_attention_plain(q.float(), k, v, pos, fp8_dot=fp8_dot, **kw)
    if fp8_dot:
        bound = chunked_fp8_dot_bound(q.float(), k, v, pos, ref, **kw)
    elif dtype == torch.bfloat16:
        bound = chunked_bf16_bound(q.float(), k, v, pos, ref, **kw)
    else:
        bound = torch.full_like(ref, F32_TOL)
    live = active[:, None, None, None].expand_as(ref)  # an inactive row's output is unused
    diff = (out.float() - ref).abs()
    assert bool(torch.isfinite(out[live]).all())
    assert bool((diff <= bound)[live].all()), (diff / bound)[live].max().item()


@pytest.mark.parametrize("kv,fp8_dot", [(None, False), ("e4m3", False), ("e5m2", True)])
@pytest.mark.parametrize("dtype,D,G,window,layout", [
    (torch.bfloat16, 128, 4, None, _CHUNKED_MAIN),
    (torch.bfloat16, 128, 4, 100, _CHUNKED_MAIN),
    (torch.bfloat16, 64, 8, None, dict(chunk=64, NB=8, positions=[0, 63, 64, 300, 511],
                                       inactive=[2])),
    (torch.float32, 128, 4, None, dict(chunk=64, NB=8, positions=[0, 63, 64, 300, 511],
                                       inactive=[2])),
])
def test_chunked_kernel_bit_equal_to_paged(dtype, D, G, window, layout, kv, fp8_dot):
    """The same K/V laid out as pages with an identity block table, read by
    ``paged_decode``, gives the chunked read's bytes: one reduction order,
    the page being the chunk (the JAX package's paged = legacy contract)."""
    q, k, v, pos, active = _chunked_inputs(dtype, D, G, **layout)
    if kv is not None:
        k, v = _narrow(k, kv), _narrow(v, kv)
    chunk = layout["chunk"]
    kp, bt = _as_pages(k, chunk)
    vp, _ = _as_pages(v, chunk)
    kw = dict(active=active, window=window, fp8_dot=fp8_dot)
    contiguous = chunked_gqa_decode_attention(q, k, v, pos, chunk=chunk, **kw)
    paged = paged_gqa_decode_attention(q, kp, vp, bt, pos, **kw)
    torch.cuda.synchronize()
    assert torch.equal(contiguous.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       paged.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))


@pytest.mark.parametrize("kv", ["e4m3", "e5m2"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chunked_kernel_indot_rounds_p_as_the_twin(kv, dtype):
    """K2 over the slot cache on ``paged_fp8_dot_probe``'s inputs (its pages
    as the cache's chunks): within ``chunked_bf16_bound`` of the twin; the
    dequant read of the same scores (the control) misses it."""
    layout = _CHUNKED_MAIN
    B, NB, chunk, KH, G, D = len(layout["positions"]), layout["NB"], layout["chunk"], 8, 4, 128
    _, _, _, pos, active = _chunked_inputs(dtype, D, G, **layout)
    q, kp, vp = paged_fp8_dot_probe(B, KH * G, KH, D, B * NB, chunk, _KV[kv], dtype,
                                    torch.Generator().manual_seed(0))

    def cache(pool):
        return pool.view(torch.uint8).reshape(B, NB, KH, chunk, D).transpose(1, 2) \
            .reshape(B, KH, NB * chunk, D).contiguous().view(_KV[kv]).cuda()

    q, k, v = q.cuda(), cache(kp), cache(vp)
    kw = dict(chunk=chunk, active=active)
    ref = chunked_gqa_decode_attention_plain(q.float(), k, v, pos, fp8_dot=True, **kw)
    bound = chunked_bf16_bound(q.float(), k, v, pos, ref, **kw)
    _assert_within(chunked_gqa_decode_attention(q, k, v, pos, fp8_dot=True, **kw), ref, bound)
    control = chunked_gqa_decode_attention(q, k, v, pos, **kw)
    assert not bool(((control.float() - ref).abs() <= bound).all())


def test_chunked_kernel_in_a_cuda_graph_serves_every_fill():
    """One captured call, replayed after the positions change (short, long,
    a row inactive): the chunk range is read on the device, so every replay
    equals an eager call on the same inputs, bit for bit, and each replay
    counts one launch."""
    q, k, v, pos, active = _chunked_inputs(torch.bfloat16, 128, 4, **_CHUNKED_MAIN)
    store = {}
    side = torch.cuda.Stream()
    with kernels.private_paged_scratch(store):
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            chunked_gqa_decode_attention(q, k, v, pos, chunk=512, active=active)  # warm-up
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches() as rec:
            with torch.cuda.graph(graph, stream=side):
                out = chunked_gqa_decode_attention(q, k, v, pos, chunk=512, active=active)
    assert rec.launches["chunked_decode"] == 1
    for fill, off in (([3, 0, 1, 2, 7, 5, 4, 6], []), ([4095] * 8, [2]),
                      ([100, 600, 1100, 1600, 2100, 2600, 3100, 3600], [0, 7])):
        pos.copy_(torch.tensor(fill, dtype=torch.int32))
        active.fill_(True)
        active[off] = False
        before = kernels.launch_counts()["chunked_decode"]
        graph.replay()
        rec.replayed()
        eager = chunked_gqa_decode_attention(q, k, v, pos, chunk=512, active=active)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["chunked_decode"] == before + 2
        assert torch.equal(out.view(torch.int16), eager.view(torch.int16))


def test_chunked_kernel_refuses_what_it_does_not_take():
    q, k, v, pos, active = _chunked_inputs(torch.bfloat16, 128, 4, chunk=64, NB=4,
                                           positions=[3, 70, 200, 255], inactive=[])
    before = kernels.launch_counts()["chunked_decode"]
    with pytest.raises(ValueError, match="fp8"):  # in-dot needs an fp8 cache
        chunked_gqa_decode_attention(q, k, v, pos, chunk=64, fp8_dot=True)
    with pytest.raises(ValueError, match="chunk=48"):  # 48 does not divide 256
        chunked_gqa_decode_attention(q, k, v, pos, chunk=48)
    with pytest.raises(ValueError, match="divisible by 4"):
        chunked_gqa_decode_attention(q, k, v, pos, chunk=2)
    with pytest.raises(ValueError, match="contiguous"):
        chunked_gqa_decode_attention(q, k[:, :, ::2], v[:, :, ::2], pos, chunk=64)
    with pytest.raises(TypeError):  # an f32 cache under bf16 queries
        chunked_gqa_decode_attention(q, k.float(), v.float(), pos, chunk=64)
    assert kernels.launch_counts()["chunked_decode"] == before


def test_kv_cast_on_the_card_matches_the_cpu():
    """``to_kv_dtype`` on the card gives the CPU's bits (which the CPU tests
    hold to JAX's ``astype``) on a grid over +-500, the e5m2 overflow edge,
    subnormals, inf and NaN, from f32 and from bf16; NaN as NaN."""
    grid = np.concatenate([
        np.linspace(-500, 500, 100_001), [464, -464, 464.0001, 61440, -61440, 61439.99, 57344,
                                          65536, 1e6, np.inf, -np.inf, np.nan, -0.0],
        2.0 ** -np.arange(6, 20), -(2.0 ** -np.arange(6, 20)) * 1.37]).astype(np.float32)
    for src in (torch.float32, torch.bfloat16):
        x = torch.from_numpy(grid).to(src)
        for kv in ("e4m3", "e5m2"):
            cpu = to_kv_dtype(x, _KV[kv])
            card = to_kv_dtype(x.cuda(), _KV[kv]).cpu()
            nan = torch.isnan(cpu.float())
            assert torch.equal(torch.isnan(card.float()), nan)
            assert torch.equal(card.view(torch.uint8)[~nan], cpu.view(torch.uint8)[~nan])


def _tree_inputs(dtype, D, G, *, page, NB, lengths, width=4, depth=4, KH=2, offset=0,
                 stale=()):
    """Pools, tree queries and tree K/V for ``lengths`` (each row's pages a
    random chain, sentinels past its allocation; rows in ``stale`` have
    sentinels inside their length, as a freed slot's stale length would);
    ``offset`` elements of a larger buffer precede each tensor (to put them
    off 16 bytes)."""
    rng = np.random.default_rng(3)
    spec = make_tree_spec(width, depth)
    B, T, H = len(lengths), spec.size, KH * G
    P = B * NB + 3
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    for b, n in enumerate(lengths):
        bt[b, -(-n // page):] = P + b
        if b in stale:
            bt[b, 1:] = P
    gen = torch.Generator(device="cuda").manual_seed(1)

    def mk(*shape):
        n = int(np.prod(shape))
        flat = torch.randn((n + offset,), generator=gen, device="cuda", dtype=dtype)
        return flat[offset:].view(shape)

    q, k_pool, v_pool = mk(B, H, T, D), mk(P, KH, page, D), mk(P, KH, page, D)
    tk, tv = mk(B, KH, T, D), mk(B, KH, T, D)
    return (q, k_pool, v_pool, torch.from_numpy(bt).cuda(),
            torch.tensor(lengths, dtype=torch.int32, device="cuda"), tk, tv,
            torch.from_numpy(spec.anc_mask).cuda(),
            torch.from_numpy(spec.depths).cuda())


def _assert_tree_close(out, args, window):
    q, kp, vp, bt, lengths, tk, tv, anc, depths = args
    fargs = (q.float(), kp.float(), vp.float(), bt, lengths, tk.float(), tv.float(), anc, depths)
    ref = paged_tree_attention_plain(*fargs, window=window)
    bound = paged_tree_bf16_bound(*fargs, ref, window=window) if out.dtype == torch.bfloat16 else None
    assert bool(torch.isfinite(out).all())
    _assert_close(out, ref, bound)


_TREE_MAIN = dict(page=512, NB=8, KH=8, lengths=[105, 355, 485, 915, 0, 4000, 1500, 2848])
# the persistent grid's edges: one row holding most of the keys, every row
# at length 0, trees of 65 and 129 nodes (two and three tree tiles, several
# row chunks) at G 4 and 8, a window whose edge falls inside a 64-key chunk
# and inside a page off the chunk
_TREE_MORE = [
    (torch.bfloat16, None, 128, 4, dict(page=512, NB=8, KH=8, lengths=[4000, 3, 0, 17])),
    (torch.bfloat16, 300, 128, 4, dict(page=512, NB=8, KH=8, lengths=[4000, 3, 0, 17])),
    (torch.bfloat16, None, 128, 4, dict(page=64, NB=4, lengths=[0, 0, 0])),
    (torch.bfloat16, 5, 64, 8, dict(page=64, NB=4, lengths=[0, 0])),
    *((torch.bfloat16, w, D, G, dict(page=64, NB=8, lengths=[0, 1, 70, 511], width=8, depth=8))
      for D, G in ((128, 4), (128, 8), (64, 8)) for w in (None, 90)),
    *((torch.bfloat16, w, 128, G, dict(page=512, NB=4, KH=8, lengths=[1500, 33, 0, 2000],
                                       width=16, depth=8))
      for G in (4, 8) for w in (None, 700)),
    (torch.float32, None, 128, 4, dict(page=64, NB=4, lengths=[0, 9, 200], width=16, depth=8)),
    (torch.bfloat16, 77, 128, 4, dict(page=100, NB=5, lengths=[499, 99, 100, 250])),
    # 16-key pages and a 129-node tree at G 8 (nine row chunks): ~900 items
    # a block, past the 512 a block locates at once
    (torch.bfloat16, None, 128, 8,
     dict(page=16, NB=256, KH=8, lengths=[4000, 4096, 3000, 4096, 2500, 4096, 1, 4090],
          width=16, depth=8)),
]


@pytest.mark.parametrize(
    "dtype,window,D,G,layout",
    [
        # the CUDA-core kernel: f32 at every head dim, bf16 at 16 / 32 / 256
        *((torch.float32, w, D, 2, dict(page=16, NB=6, lengths=[0, 9, 40, 95]))
          for D in (16, 32, 64, 128, 256) for w in (None, 7)),
        *((torch.bfloat16, None, D, 2, dict(page=16, NB=6, lengths=[0, 9, 40, 95]))
          for D in (16, 32, 256)),
        # the tensor-core kernel at every group size, with and without a window
        *((torch.bfloat16, w, D, G, dict(page=64, NB=8, lengths=[0, 1, 63, 64, 300, 511]))
          for D in (64, 128) for G in (1, 2, 4, 8) for w in (None, 40)),
        # the main path's shapes: Llama-3-8B's heads, page 512, ragged rows
        (torch.bfloat16, None, 128, 4, _TREE_MAIN),
        (torch.float32, None, 128, 4, _TREE_MAIN),
        # a window that starts inside a tile, a page off the 64-key tile
        (torch.bfloat16, 100, 128, 4, dict(page=512, NB=4, lengths=[1000, 1500, 2047, 1100])),
        (torch.bfloat16, None, 128, 4, dict(page=100, NB=5, lengths=[499, 99, 100, 250])),
        # G T past 128 rows (G 8, a 33-node tree): a second row chunk
        (torch.bfloat16, None, 128, 8,
         dict(page=512, NB=4, lengths=[2000, 17], width=8, depth=4, KH=8)),
        # one-node and single-branch trees, 33 slots
        (torch.bfloat16, None, 128, 4,
         dict(page=16, NB=4, lengths=[(5 * i) % 64 for i in range(33)], width=1, depth=1)),
        (torch.bfloat16, None, 64, 4, dict(page=32, NB=4, lengths=[3, 77, 127, 0], width=1,
                                           depth=4)),
        # a stale row: sentinel entries inside its length clamp to page P - 1
        (torch.bfloat16, None, 128, 4, dict(page=64, NB=4, lengths=[200, 150], stale=(1,))),
        (torch.float32, None, 128, 4, dict(page=64, NB=4, lengths=[200, 150], stale=(1,))),
        *_TREE_MORE,
    ],
)
def test_paged_tree_kernel_matches_plain(dtype, window, D, G, layout):
    args = _tree_inputs(dtype, D, G, **layout)
    before = kernels.launch_counts()["paged_tree"]
    routes = kernels.by_route(kernels.PAGED_TREE_FORMS)
    out = paged_tree_attention(*args, window=window)
    assert kernels.launch_counts()["paged_tree"] == before + 1
    route = "mma" if dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS else "cuda_core"
    assert kernels.by_route(kernels.PAGED_TREE_FORMS)[route] == routes[route] + 1
    _assert_tree_close(out, args, window)


@pytest.mark.parametrize("D", [64, 128])
def test_paged_tree_kernel_repeats_bitwise(D):
    """Two calls on the same inputs give bitwise-equal outputs (the split's
    counters back at zero, a fixed merge order), also after a call at
    another shape."""
    args = _tree_inputs(torch.bfloat16, D, 4, **_TREE_MAIN)
    first = paged_tree_attention(*args)
    second = paged_tree_attention(*args)
    other = _tree_inputs(torch.bfloat16, D, 4, page=64, NB=8, lengths=[0, 1, 63, 64, 300, 511])
    paged_tree_attention(*other, window=40)
    third = paged_tree_attention(*args)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    assert torch.equal(first, third)


@pytest.mark.parametrize("kv", ["bf16", "e4m3"])
def test_paged_tree_graph_replays_bitwise_at_three_fills(kv):
    """One captured call replays bitwise equal to eager calls at three fills
    of the same buffers (lengths, block tables, pools and tree rewritten in
    place, as the engine rewrites them between ticks and refills its pools
    after a restart): the grid, the scratch and the pools' tensor maps are
    the capture's, the items and their partition follow the new lengths."""
    fills = ([105, 355, 485, 915, 0, 4000, 1500, 2848], [0, 0, 0, 0, 0, 0, 0, 0],
             [4000, 1, 2, 3, 0, 4, 5, 600])
    args = list(_tree_inputs(torch.bfloat16, 128, 4, **dict(_TREE_MAIN, lengths=fills[0])))
    if kv != "bf16":
        args[1], args[2] = _narrow(args[1], kv), _narrow(args[2], kv)
    out = torch.empty_like(args[0])
    store = {}
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream), kernels.private_paged_scratch(store):
        out.copy_(paged_tree_attention(*args))  # warm-up: the graph's scratch
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches() as rec, torch.cuda.graph(graph, stream=stream):
            out.copy_(paged_tree_attention(*args))
    torch.cuda.current_stream().wait_stream(stream)
    assert rec.launches["paged_tree"] == 1
    for n, lengths in enumerate(fills):
        fresh = _tree_inputs(torch.bfloat16, 128, 4, **dict(_TREE_MAIN, lengths=lengths))
        if n:  # new pool values, tree and lengths in the captured buffers
            gen = torch.Generator(device="cuda").manual_seed(20 + n)
            for i in (0, 1, 2, 5, 6):
                args[i].copy_(torch.randn(args[i].shape, generator=gen, device="cuda")
                              .to(args[i].dtype))
            args[3].copy_(fresh[3])
            args[4].copy_(fresh[4])
        graph.replay()
        torch.cuda.synchronize()
        with kernels.private_paged_scratch(store):
            eager = paged_tree_attention(*args)
        torch.cuda.synchronize()
        assert torch.equal(out, eager), lengths
        _assert_tree_close(out, tuple(args), None)


@pytest.mark.parametrize("D", [64, 128])
def test_paged_tree_kernel_off_16_bytes_takes_cuda_core_route(D):
    args = _tree_inputs(torch.bfloat16, D, 4, offset=4, page=64, NB=4, lengths=[3, 70, 200, 0])
    assert all(t.data_ptr() % 16 == 8 for t in (args[0], args[1], args[2]))
    routes = kernels.by_route(kernels.PAGED_TREE_FORMS)
    out = paged_tree_attention(*args)
    assert kernels.by_route(kernels.PAGED_TREE_FORMS) == {
        "mma": routes["mma"], "cuda_core": routes["cuda_core"] + 1}
    _assert_tree_close(out, args, None)


def test_paged_tree_wrapper_refuses_what_it_does_not_take():
    args = list(_tree_inputs(torch.bfloat16, 128, 4, page=64, NB=4, lengths=[3, 70]))
    big = make_tree_spec(8, 8)  # 65 nodes: two tree tiles, served on the tensor cores
    forms = dict(kernels.PAGED_TREE_FORMS)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, tk, tv = (torch.randn(shape, generator=gen, device="cuda", dtype=torch.bfloat16)
                 for shape in ((2, 8, 65, 128), (2, 2, 65, 128), (2, 2, 65, 128)))
    tree = (q, *args[1:5], tk, tv, torch.from_numpy(big.anc_mask).cuda(),
            torch.from_numpy(big.depths).cuda())
    out = paged_tree_attention(*tree)
    assert kernels.PAGED_TREE_FORMS["mma:native"] == forms["mma:native"] + 1
    _assert_tree_close(out, tree, None)
    with pytest.raises(ValueError, match="lengths"):
        paged_tree_attention(*args[:4], args[4].long(), *args[5:])
    with pytest.raises(TypeError):
        paged_tree_attention(args[0].half(), *args[1:])


@pytest.mark.parametrize("kv", ["e4m3", "e5m2", "bf16"])
@pytest.mark.parametrize(
    "dtype,window,D,G,layout",
    [
        (torch.float32, None, 16, 2, dict(page=16, NB=6, lengths=[0, 9, 40, 95])),
        (torch.float32, 7, 128, 4, dict(page=16, NB=6, lengths=[0, 9, 40, 95])),
        (torch.bfloat16, None, 16, 2, dict(page=16, NB=6, lengths=[0, 9, 40, 95])),
        *((torch.bfloat16, w, D, G, dict(page=64, NB=8, lengths=[0, 1, 63, 64, 300, 511]))
          for D in (64, 128) for G in (1, 4, 8) for w in (None, 40)),
        (torch.bfloat16, None, 128, 4, _TREE_MAIN),
        (torch.bfloat16, 100, 128, 4, dict(page=512, NB=4, lengths=[1000, 1500, 2047, 1100])),
        (torch.bfloat16, None, 128, 4, dict(page=64, NB=4, lengths=[200, 150], stale=(1,))),
        *(case for case in _TREE_MORE if case[0] == torch.bfloat16),
    ],
)
def test_paged_tree_kernel_reads_narrow_pools(dtype, window, D, G, layout, kv):
    """K3: the tree read over bf16 / fp8 prefix pages (the tree's own K/V in
    q's dtype) against the twin on the same pools, counted under its read."""
    if kv == "bf16" and dtype == torch.bfloat16:
        pytest.skip("a bf16 pool under bf16 queries is the native read")
    args = list(_tree_inputs(dtype, D, G, **layout))
    args[1], args[2] = _narrow(args[1], kv), _narrow(args[2], kv)
    route = "mma" if dtype == torch.bfloat16 and D in kernels.PAGED_MMA_HEAD_DIMS else "cuda_core"
    form = f"{route}:{kv}/dequant"
    forms = dict(kernels.PAGED_TREE_FORMS)
    out = paged_tree_attention(*args, window=window)
    assert kernels.PAGED_TREE_FORMS[form] == forms[form] + 1
    _assert_tree_close(out, args, window)
    again = paged_tree_attention(*args, window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)


def _knn_inputs(N, D, Q, seed, *, dup_rows=0):
    """Normalised bf16 rows on the card (the last ``dup_rows`` copies of the
    first ones: exact ties) and f32 queries."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, D), generator=g, device="cuda")
    if dup_rows:
        x[N - dup_rows:] = x[:dup_rows]
    x = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    q = torch.randn((Q, D), generator=g, device="cuda")
    return x, q, g


def _assert_topk(x, q, valid, k):
    n0 = kernels.LAUNCHES["knn_topk"]
    scores, ids = topk_scores(x, q, valid, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["knn_topk"] == n0 + 1
    assert scores.shape == (q.shape[0], k) and ids.dtype == torch.int32
    report = topk_agreement(x, q, valid, scores, ids)
    assert not report["problems"], report
    # fewer valid rows than k: the tail holds -inf
    live = int(valid.sum())
    assert int(torch.isfinite(scores).sum(dim=1).min()) == min(k, live)


@pytest.mark.parametrize("k", [1, 16, 1024])
@pytest.mark.parametrize("Q", [1, 8, 130])
@pytest.mark.parametrize("N", [4096, 20480])
@pytest.mark.parametrize("D", [8, 64, 768])
def test_knn_topk_kernel_matches_plain(D, N, Q, k):
    """``knn_topk`` against ``topk_scores_plain``: all rows valid, an
    allow-list of about 1% of the rows, and fewer valid rows than k."""
    x, q, g = _knn_inputs(N, D, Q, seed=N + D + Q + k)
    _assert_topk(x, q, torch.ones(N, dtype=torch.bool, device="cuda"), k)
    _assert_topk(x, q, torch.rand(N, generator=g, device="cuda") < 0.01, k)
    sparse = torch.zeros(N, dtype=torch.bool, device="cuda")
    sparse[torch.randperm(N, generator=g, device="cuda")[: max(1, k // 2)]] = True
    _assert_topk(x, q, sparse, k)


@pytest.mark.parametrize("k", [16, 1024])
def test_knn_topk_kernel_exact_ties(k):
    """Duplicate rows give exact ties (lower row first in the kernel); a
    corpus with no valid row at all returns only -inf slots."""
    N, D = 20480, 64
    x, q, _ = _knn_inputs(N, D, 8, seed=3, dup_rows=4096)
    q[:4] = x[N - 4:].float()  # queries on duplicated rows: ties at the top
    valid = torch.ones(N, dtype=torch.bool, device="cuda")
    _assert_topk(x, q, valid, k)
    scores, ids = topk_scores(x, q, valid, k)
    for i in range(4):  # the copy at N - 4 + i ties with row 4092 + i: lower row first
        top = ids[i, :2].tolist()
        assert scores[i, 0] == scores[i, 1] and top == [4092 + i, N - 4 + i], top
    none = torch.zeros(N, dtype=torch.bool, device="cuda")
    scores, _ = topk_scores(x, q, none, k)
    assert bool(torch.isneginf(scores).all())


@pytest.mark.parametrize(
    "N, D, Q, k",
    [(20480, 64, 1, 16384), (20480, 8, 3, 16385), (20480, 64, 2, 20000), (20480, 8, 1, 20480),
     (40960, 8, 2, 40000)],
)
def test_knn_topk_kernel_large_k(N, D, Q, k):
    """k at and past the shared-memory sort (16,384 keys): the winners are
    sorted in global memory (runs of 16,384, then one or two merge levels),
    with every row valid, with fewer valid rows than k, and with exact ties
    (lower row first)."""
    x, q, g = _knn_inputs(N, D, Q, seed=N + D + Q + k, dup_rows=1024)
    _assert_topk(x, q, torch.ones(N, dtype=torch.bool, device="cuda"), k)
    _assert_topk(x, q, torch.rand(N, generator=g, device="cuda") < 0.6, k)
    q[0] = x[N - 1].float()  # the query on a duplicated row: a tie at the top
    scores, ids = topk_scores(x, q, torch.ones(N, dtype=torch.bool, device="cuda"), k)
    assert scores[0, 0] == scores[0, 1] and ids[0, :2].tolist() == [1023, N - 1]
    assert bool((scores[:, :-1] >= scores[:, 1:]).all())


def test_knn_topk_kernel_refuses_what_it_does_not_take():
    x, q, _ = _knn_inputs(256, 64, 2, seed=1)
    valid = torch.ones(256, dtype=torch.bool, device="cuda")
    with pytest.raises(ValueError, match="k="):
        topk_scores(x, q, valid, 257)
    with pytest.raises(ValueError, match="bf16"):
        topk_scores(x.float(), q, valid, 4)
    with pytest.raises(ValueError, match="multiple of 8"):
        topk_scores(x[:, :60].contiguous(), q[:, :60], valid, 4)


def test_vector_index_on_the_card_matches_the_cpu():
    """The same rows (host adds, a device append, a remove) searched on the
    card and on the CPU.  The staged rows may differ where the two devices'
    f32 norms round a row's bf16 element apart (rare, one bf16 step); the
    tolerance is the summation bound plus what those steps can move a score
    (``sum_d |q_d| |x_card - x_cpu|``, exact for these rows).  Scores agree
    within it, ids agree at ranks further than twice it from their
    neighbours (the 21st result bounds the 20th), and an allow-listed
    search returns only allowed ids."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=(3000, 64)).astype(np.float32)
    b = rng.normal(size=(700, 64)).astype(np.float32)
    q = rng.normal(size=(40, 64)).astype(np.float32)
    out, rows = {}, {}
    for dev in ("cuda", "cpu"):
        index = VectorIndex(64, device=dev)
        index.add(range(3000), a)
        index.search(a[0], k=1)
        index.add_device(range(5000, 5700), torch.from_numpy(b).to(dev))
        index.remove([3, 4, 5])
        out[dev] = (index.search_batch(q, k=21),
                    index.search(q[0], k=10, allowed_ids={7, 99, 5003, 2999}))
        rows[dev] = index._device_index.float().cpu()
    step = (rows["cuda"] - rows["cpu"]).abs()
    assert int((step > 0).sum()) <= step.numel() // 1000
    qn = torch.from_numpy(q / np.linalg.norm(q, axis=1, keepdims=True)).to(torch.bfloat16).float()
    tol = 64 * 2.0 ** -22 * 1.01 + (qn.abs() @ step.T).max(dim=1).values
    compared = 0
    for qi, (card, cpu) in enumerate(zip(out["cuda"][0], out["cpu"][0])):
        assert len(card) == len(cpu) == 21
        t = tol[qi].item()
        assert max(abs(c[1] - p[1]) for c, p in zip(card, cpu)) <= t
        s = [float("inf")] + [p[1] for p in cpu] + [-float("inf")]
        for j in range(20):
            if min(s[j] - s[j + 1], s[j + 1] - s[j + 2]) > 2 * t:
                assert card[j][0] == cpu[j][0], (qi, j)
                compared += 1
    assert compared >= 400
    assert {i for i, _ in out["cuda"][1]} == {i for i, _ in out["cpu"][1]} == {7, 99, 5003, 2999}


# ------------------------------------------------------------------ qgemm
def _qweight(K, N, fmt, g, seed):
    """Random int8 (per-column scales) or packed int4 (per-group scales)
    weights on the card, scales spread over two decades."""
    gen = torch.Generator().manual_seed(seed)
    if fmt == "int8":
        q = torch.randint(-127, 128, (K, N), generator=gen, dtype=torch.int8)
        scale = torch.exp(torch.rand((1, N), generator=gen) * 4.6) * 1e-4
        return QTensor(q.cuda(), scale.cuda())
    q = torch.randint(0, 256, (K // 2, N), generator=gen, dtype=torch.uint8)
    scale = torch.exp(torch.rand((K // g, N), generator=gen) * 4.6) * 1e-3
    return QTensor4(q.cuda(), scale.cuda())


def _check_qgemm(M, K, N, fmt, g, dtype, seed=0):
    w = _qweight(K, N, fmt, g, seed)
    x = torch.randn((M, K), generator=torch.Generator(device="cuda").manual_seed(seed),
                    device="cuda").to(dtype)
    out = qeinsum("me,eo->mo", x, w, dtype)
    ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == (M, N) and bool(torch.isfinite(out).all())
    if dtype == torch.bfloat16:
        bound = qgemm_bf16_bound(x.float(), w, ref)
    else:  # summation order only, relative to |x| . |deq w|
        bound = F32_TOL * torch.matmul(x.abs(), deq(w, torch.float32).abs()) + 1e-6
    err = (out.float() - ref).abs()
    assert bool((err <= bound).all()), (err / bound).max().item()
    return x, w, out


@pytest.mark.parametrize("K,N", [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096),
                                 (4096, 1040), (4096, 1032)])
@pytest.mark.parametrize("M", [1, 8, 16, 37, 64, 65, 128, 200, 512, 1024, 2048])
@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 64), ("int4", 128)])
def test_qgemm_kernel_matches_plain_bf16(fmt, g, M, K, N):
    """bf16 at the projection shapes of Llama-3-8B and two ragged widths
    (N = 1032 is off TMA's multiple of 16, so it takes the direct-load
    kernel at every M), against the f32 plain twin within
    ``qgemm_bf16_bound``; M <= 64 takes the stream kernel, M > 64 the wgmma
    kernel, held at its tile edges (65, 128) and at the sizes of a wave
    prefill (1024, 2048)."""
    _check_qgemm(M, K, N, fmt, g, torch.bfloat16)


@pytest.mark.parametrize("K,N", [(256, 512), (512, 256), (4096, 1040)])
@pytest.mark.parametrize("M", [1, 8, 37, 300])
@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 16), ("int4", 64)])
def test_qgemm_kernel_matches_plain_f32(fmt, g, M, K, N):
    _check_qgemm(M, K, N, fmt, g, torch.float32)


@pytest.mark.parametrize("M,K,N,route", [(8, 4096, 4096, "stream"), (512, 4096, 4096, "wgmma"),
                                         (512, 4096, 1024, "wgmma"), (8, 4096, 1032, "mma")])
@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 64)])
def test_qgemm_kernel_repeats_bitwise_and_counts_its_format(fmt, g, M, K, N, route):
    """A second call equals the first bit for bit, with one launch counted
    by format and by route: decode (M = 8) on the stream kernel (and on the
    direct-load kernel at N = 1032, off TMA's multiple of 16), prefill
    (M = 512) on the wgmma kernel, wk/wv's width there with K split."""
    bits = 8 if fmt == "int8" else 4
    if (M, K, N) == (512, 4096, 1024):
        assert kernels.qgemm_plan(M, N, K, bits, g)[2] > 1
    x, w, out = _check_qgemm(M, K, N, fmt, g, torch.bfloat16, seed=3)
    kernels.reset_counts()
    again = qeinsum("me,eo->mo", x, w, torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(out, again)  # the split-K partials sum in a fixed order
    assert kernels.launch_counts()["qgemm"] == 1
    assert kernels.QGEMM_FORMATS == {"int8": int(fmt == "int8"), "int4": int(fmt == "int4")}
    assert kernels.QGEMM_ROUTES == {r: int(r == route) for r in ("stream", "mma", "wgmma",
                                                                 "cuda_core", "generic")}


# Llama-3-8B's grouped decode projections (QKV; gate/up), the tiny test
# model's, and a member narrower than a tile
QGEMM_GROUPS = [(4096, (4096, 1024, 1024)), (4096, (14336, 14336)), (256, (256, 128, 128)),
                (4096, (1040, 48))]


@pytest.mark.parametrize("K,Ns", QGEMM_GROUPS)
@pytest.mark.parametrize("M", [1, 8, 16, 37, 64])
@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 64), ("int4", 128)])
def test_qgemm_stream_group_matches_plain_and_repeats_bitwise(fmt, g, M, K, Ns):
    """One stream launch for 2-3 members that share x: each output within
    ``qgemm_bf16_bound`` of its f32 plain twin (as is the member's own
    single launch, whose K splits fall elsewhere) and equal bit for bit to
    a repeat of the group."""
    ws = [_qweight(K, n, fmt, g, seed=i) for i, n in enumerate(Ns)]
    x = torch.randn((M, K), generator=torch.Generator(device="cuda").manual_seed(M),
                    device="cuda").to(torch.bfloat16)
    kernels.reset_counts()
    ys = qeinsum_group("me,eo->mo", x, ws, torch.bfloat16)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["qgemm"] == 1 and kernels.QGEMM_ROUTES["stream"] == 1
    again = qeinsum_group("me,eo->mo", x, ws, torch.bfloat16)
    alone = [qeinsum("me,eo->mo", x, w, torch.bfloat16) for w in ws]
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["stream"] == 2 + len(ws)
    for y, y2, y1, w in zip(ys, again, alone, ws):
        ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
        bound = qgemm_bf16_bound(x.float(), w, ref)
        for out in (y, y1):
            assert out.shape == (M, w.q.shape[1]) and bool(torch.isfinite(out).all())
            err = (out.float() - ref).abs()
            assert bool((err <= bound).all()), (err / bound).max().item()
        assert torch.equal(y, y2)


def test_qgemm_group_takes_one_launch_per_member_off_the_stream_route():
    """Past 64 rows (the prefill route), or with a member the stream route
    does not take (N = 1032), ``qeinsum_group`` is one ``qeinsum`` a
    member, each equal to the member's own call."""
    K = 4096
    for M, Ns in ((65, (4096, 1024)), (8, (1024, 1032))):
        ws = [_qweight(K, n, "int8", 0, seed=i) for i, n in enumerate(Ns)]
        x = torch.randn((M, K), device="cuda").to(torch.bfloat16)
        kernels.reset_counts()
        ys = qeinsum_group("me,eo->mo", x, ws, torch.bfloat16)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["qgemm"] == len(ws)
        for y, w in zip(ys, ws):
            assert torch.equal(y, qeinsum("me,eo->mo", x, w, torch.bfloat16))


@pytest.mark.parametrize("M", [1, 8, 37, 64, 70])
@pytest.mark.parametrize("V,E", [(128256, 4096), (512, 256), (1000, 64)])
def test_tied_head_kernel_matches_plain(M, V, E):
    """The tied int8 head (the table ``[V, E]`` K-contiguous, per-E scales
    on x): bf16 on the stream route's K-contiguous form within the int8
    bound of the f32 product on the same scaled x, repeats bitwise; f32 on
    the CUDA-core kernel within 1e-4 of |xs| . |q|^T."""
    gen = torch.Generator().manual_seed(V + M)
    w = QTensor(torch.randint(-127, 128, (V, E), generator=gen, dtype=torch.int8).cuda(),
                (torch.exp(torch.rand((1, E), generator=gen) * 4.6) * 1e-3).cuda())
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((M, E), generator=gen).to(dtype).cuda()
        kernels.reset_counts()
        out = tied_head(x, w, dtype)
        again = tied_head(x, w, dtype)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["qgemm"] == 2 * (-(-M // 64) if dtype == torch.bfloat16 else 1)
        route = "stream" if dtype == torch.bfloat16 else "cuda_core"
        assert kernels.QGEMM_ROUTES[route] == kernels.launch_counts()["qgemm"]
        xs = (x * w.scale.squeeze(-2).to(dtype)).float()
        ref = xs @ w.q.float().T
        assert out.dtype == dtype and out.shape == (M, V) and torch.equal(out, again)
        err = (out.float() - ref).abs()
        if dtype == torch.bfloat16:
            bound = tied_head_bf16_bound(xs, w, ref)
        else:
            bound = F32_TOL * (xs.abs() @ w.q.float().abs().T) + 1e-6
        assert bool((err <= bound).all()), (err / bound).max().item()


def test_qgemm_kernel_refuses_what_it_does_not_take():
    """What no route takes raises on the card (f16 activations, mismatched
    dtypes, a pattern outside x[..., in] . w[in, out]); an int4 group of 24
    and a 60-wide slice, which the tensor-core kernels do not take, run on
    the generic route within the plain twin's tolerance."""
    gen = torch.Generator().manual_seed(1)
    w24 = QTensor4(torch.randint(0, 256, (24, 64), generator=gen, dtype=torch.uint8).cuda(),
                   torch.rand((2, 64), generator=gen).cuda())  # K 48, group 24
    x = torch.randn((2, 48), device="cuda", dtype=torch.bfloat16)
    kernels.reset_counts()
    out = qeinsum("me,eo->mo", x, w24, torch.bfloat16)
    ref = qeinsum_plain("me,eo->mo", x.float(), w24, torch.float32)
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["generic"] == 1
    assert bool(((out.float() - ref).abs() <= qgemm_bf16_bound(x.float(), w24, ref)).all())
    w = _qweight(64, 64, "int8", 0, 2)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        qeinsum("me,eo->mo", torch.randn((2, 64), device="cuda").half(), w, torch.float16)
    with pytest.raises(ValueError, match="activations are"):
        qeinsum("me,eo->mo", torch.randn((2, 64), device="cuda"), w, torch.bfloat16)
    narrow = QTensor(w.q[:, :60], w.scale[:, :60])
    xf = torch.randn((2, 64), device="cuda")
    out = qeinsum("me,eo->mo", xf, narrow, torch.float32)
    ref = qeinsum_plain("me,eo->mo", xf, narrow, torch.float32)
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["generic"] == 2 and out.shape == (2, 60)
    assert (out - ref).abs().max().item() <= F32_TOL
    # a pattern outside x[..., in] . w[in, out] raises on the card (the CPU
    # dequantizes, as JAX does): no plain product runs on a CUDA tensor
    for pattern in ("bse,oe->bso", "...e,ve->...v"):
        with pytest.raises(ValueError, match=f"refuses {pattern!r}.*only"):
            qeinsum(pattern, torch.randn((1, 2, 64), device="cuda"), w, torch.float32)
    w4 = _qweight(64, 64, "int4", 16, 2)
    with pytest.raises(ValueError, match="only"):
        qeinsum("bse,oe->bso", torch.randn((1, 2, 64), device="cuda"), w4, torch.float32)


# the shapes the tensor-core routes do not take (ROADMAP Queue 3 entry 7):
# (K, N, fmt, group): int4 groups of 8, 4 (quant_group_size 6 packs at 4
# at in 4096), 2, 6, 24 and 40 (K off 64 and off 16 too), int8 with K off
# 16 and N off 8
GENERIC_WEIGHTS = [(4096, 4096, "int4", 8), (4096, 4096, "int4", 4), (256, 512, "int4", 2),
                   (96, 64, "int4", 6), (48, 40, "int4", 24), (4104, 1024, "int4", 24),
                   (80, 48, "int4", 40), (4000, 4096, "int4", 40), (40, 44, "int8", 0)]
# and Llama-3-8B's four projections at int4 g 8 at a decode step's rows of x
# (1-16: gate / up and down take two blocks an SM) and a prefill chunk's
GENERIC_SHAPES = list(dict.fromkeys(
    [(M, K, N, fmt, g) for M in (1, 8, 33, 64, 65, 512) for K, N, fmt, g in GENERIC_WEIGHTS]
    + [(M, K, N, "int4", 8) for M in (1, 8, 16, 512)
       for K, N in ((4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096))]))


def _assert_generic_repeat(x, w, out, dtype):
    """One launch on ``"generic"`` per call, and a repeat equal bit for bit
    (the split tiles' partials sum in block order)."""
    kernels.reset_counts()
    again = qeinsum("me,eo->mo", x, w, dtype)
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["generic"] == 1 == kernels.launch_counts()["qgemm"]
    assert torch.equal(out, again)


@pytest.mark.parametrize("M,K,N,fmt,g", GENERIC_SHAPES)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qgemm_generic_route_matches_plain(M, K, N, fmt, g, dtype):
    """The generic route (``qgemm_generic_kernel``) at int4 groups of 2 / 4
    / 6 / 8 / 24 / 40 and widths off 16 and 8: within the plain twin's
    tolerance (``qgemm_bf16_bound`` in bf16, summation order in f32), one
    launch counted on ``"generic"``, bitwise on a repeat."""
    kernels.reset_counts()
    x, w, out = _check_qgemm(M, K, N, fmt, g, dtype, seed=4)
    assert kernels.QGEMM_ROUTES["generic"] == 1 == kernels.launch_counts()["qgemm"]
    _assert_generic_repeat(x, w, out, dtype)


def _offset(t, nbytes):
    """A contiguous copy of ``t`` whose data starts ``nbytes`` past a
    16-byte boundary (a view into a larger buffer)."""
    pad = nbytes // t.element_size()
    buf = torch.empty(t.numel() + pad + 16, dtype=t.dtype, device=t.device)
    view = buf[pad:pad + t.numel()].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == nbytes
    return view


@pytest.mark.parametrize("M", [1, 8, 65, 512])
@pytest.mark.parametrize("what", ["q", "scale", "x"])
@pytest.mark.parametrize("fmt,g", [("int8", 0), ("int4", 64), ("int4", 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_qgemm_generic_route_takes_misaligned_tensors(M, what, fmt, g, dtype):
    """q at a 2-byte offset, the scale at 4 bytes (one f32) or x at one
    element past a 16-byte boundary (views into larger buffers, as a slice
    leaves them): the call takes the generic route and meets the plain
    twin's tolerance, bitwise on a repeat."""
    K, N = 1024, 512
    w = _qweight(K, N, fmt, g, seed=9)
    x = torch.randn((M, K), generator=torch.Generator(device="cuda").manual_seed(9),
                    device="cuda").to(dtype)
    if what == "q":
        w = type(w)(_offset(w.q, 2), w.scale)
    elif what == "scale":
        w = type(w)(w.q, _offset(w.scale, 4))
    else:
        x = _offset(x, x.element_size())
    kernels.reset_counts()
    out = qeinsum("me,eo->mo", x, w, dtype)
    ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["generic"] == 1 == kernels.launch_counts()["qgemm"]
    if dtype == torch.bfloat16:
        bound = qgemm_bf16_bound(x.float(), w, ref)
    else:
        bound = F32_TOL * torch.matmul(x.abs(), deq(w, torch.float32).abs()) + 1e-6
    err = (out.float() - ref).abs()
    assert bool((err <= bound).all()), (err / bound).max().item()
    _assert_generic_repeat(x, w, out, dtype)


def test_qgemm_generic_group_6_packs_at_4_and_matches_plain():
    """``quant_group_size=6`` at in 4096 packs at 4 (``_int4_group``); the
    packed weight runs on the generic route within the bf16 bound."""
    gen = torch.Generator().manual_seed(6)
    w = quantize_tensor_int4(torch.randn((4096, 1024), generator=gen), 6).to("cuda")
    assert w.group_size == 4
    x = torch.randn((8, 4096), generator=gen).to(torch.bfloat16).cuda()
    kernels.reset_counts()
    out = qeinsum("me,eo->mo", x, w, torch.bfloat16)
    ref = qeinsum_plain("me,eo->mo", x.float(), w, torch.float32)
    torch.cuda.synchronize()
    assert kernels.QGEMM_ROUTES["generic"] == 1
    assert bool(((out.float() - ref).abs() <= qgemm_bf16_bound(x.float(), w, ref)).all())


@pytest.mark.parametrize("V,E", [(1000, 40), (1001, 64), (128256, 4040)])
def test_tied_head_generic_route_matches_plain(V, E):
    """A tied int8 table whose E is off 16 (or, in bf16, V off 8) takes the
    generic route's K-contiguous form, within the int8 bound (bf16) or 1e-4
    of |xs| . |q|^T (f32), bitwise on a repeat."""
    gen = torch.Generator().manual_seed(V)
    w = QTensor(torch.randint(-127, 128, (V, E), generator=gen, dtype=torch.int8).cuda(),
                (torch.exp(torch.rand((1, E), generator=gen) * 4.6) * 1e-3).cuda())
    for dtype in (torch.bfloat16, torch.float32):
        for M in (1, 8, 65, 512):
            x = torch.randn((M, E), generator=gen).to(dtype).cuda()
            kernels.reset_counts()
            out = tied_head(x, w, dtype)
            torch.cuda.synchronize()
            route = kernels.qgemm_tied_route(dtype, V, E)  # f32 at E 64: the tied f32 kernel
            assert route == ("cuda_core" if dtype == torch.float32 and E % 16 == 0 else "generic")
            assert kernels.QGEMM_ROUTES[route] == 1 == kernels.launch_counts()["qgemm"]
            xs = (x * w.scale.squeeze(-2).to(dtype)).float()
            ref = xs @ w.q.float().T
            err = (out.float() - ref).abs()
            if dtype == torch.bfloat16:
                bound = tied_head_bf16_bound(xs, w, ref)
            else:
                bound = F32_TOL * (xs.abs() @ w.q.float().abs().T) + 1e-6
            assert bool((err <= bound).all()), (err / bound).max().item()
            assert torch.equal(out, tied_head(x, w, dtype))


# ------------------------------------------------------------------ sampler
def _sample_case(V, dtype, json_rows, ties, seed):
    gen = torch.Generator().manual_seed(seed)
    B, S = 8, 6
    logits = torch.randn((B, V), generator=gen) * 3
    if ties:
        logits = logits.round()
        logits[:, 1000 % V: 1000 % V + 300] = 9.0
    logits = logits.to(dtype)
    temps = torch.tensor([0.0, 0.7, 0.0, 1.0, 1.3, 0.0, 0.8, 0.5])
    top_ps = torch.tensor([0.9, 0.5, 0.95, 1.0, 1.0, 0.95, 0.9, 0.5])
    noise = gumbel_noise(torch.empty((B, 50)), gen)
    kw = dict(temperature=temps, top_k=50, top_p=top_ps, gumbel=noise)
    if json_rows:
        allowed = torch.rand((S, V), generator=gen) < 0.3
        allowed[1] = False
        allowed[1, :7] = True
        kw.update(allowed=allowed, next_state=torch.randint(0, S, (S, V), generator=gen,
                                                            dtype=torch.int32),
                  fsm_state=torch.tensor([0, 1, 2, 3, 0, 4, 5, 1], dtype=torch.int32),
                  jmask=torch.tensor([1, 1, 1, 0, 1, 1, 0, 1], dtype=torch.bool))
    return logits, kw


@pytest.mark.parametrize("V", [512, 128256])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("json_rows", [False, True])
@pytest.mark.parametrize("ties", [False, True])
def test_sample_kernel_matches_plain(V, dtype, json_rows, ties):
    """The fused sampler against its plain twin on the card: equal ids (and
    advanced FSM states), except a sampled row whose top-p boundary margin
    is under 1e-6 (none in these cases); one launch a call."""
    logits, kw = _sample_case(V, dtype, json_rows, ties, seed=V + json_rows + 2 * ties)
    cuda = {k: v.cuda() if isinstance(v, torch.Tensor) else v for k, v in kw.items()}
    kernels.reset_counts()
    got = sample_logits(logits.cuda(), **cuda)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["sample"] == 1
    want = sample_logits_plain(logits.cuda(), **cuda)
    margin = top_p_margin(logits.cuda(), **cuda)
    assert bool((margin >= 1e-6).all()), margin
    if json_rows:
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    else:
        assert torch.equal(got, want)
    again = sample_logits(logits.cuda(), **cuda)
    assert torch.equal(again if not json_rows else again[0], got if not json_rows else got[0])


def test_sample_kernel_refuses_what_it_does_not_take():
    x = torch.randn((2, 512), device="cuda")
    for k in (0, 257, 512):
        with pytest.raises(ValueError, match="top_k"):
            sample_logits(x, top_k=k)


def _adc_inputs(nlist, L, m, Q, P, seed, *, dead_list=True, dups=True):
    """IVF code blocks on the card with planted ties: list 1 repeats list 0
    (equal centroid scores make its slots tie with list 0's bit for bit),
    duplicate code rows inside list 0, and one list all tombstones inside
    its fill.  Each list's fill (its high-water mark) is drawn skewed, a
    probed list empty (fill 0) and one full; validity is false past it.
    Returns (codes, lvalid, rowpos, top_ci, top_c, lut, fill)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    codes = torch.randint(0, 256, (nlist, L, m), generator=g, device="cuda", dtype=torch.uint8)
    lvalid = torch.rand((nlist, L), generator=g, device="cuda") < 0.9
    rowpos = torch.randperm(nlist * L, generator=g, device="cuda").to(torch.int32).reshape(nlist, L)
    skew = torch.rand((nlist,), generator=g, device="cuda") ** 3
    fill = (skew * (L + 1)).to(torch.int32).clamp_(0, L)
    fill[3], fill[4] = L, 0
    if dups:
        codes[0, L // 2:] = codes[0, : L - L // 2]
        codes[1], lvalid[1], fill[1] = codes[0], lvalid[0], fill[0]
    if dead_list:
        lvalid[2] = False
    lvalid &= torch.arange(L, device="cuda")[None, :] < fill[:, None]
    scores = torch.rand((Q, nlist), generator=g, device="cuda")
    scores[:, 1] = scores[:, 0]
    scores[:, :5] += 2.0  # lists 0-4 probed by every query
    top_c, top_ci = torch.sort(scores, dim=1, descending=True, stable=True)
    top_c, top_ci = top_c[:, :P].contiguous(), top_ci[:, :P].to(torch.int32).contiguous()
    lut = torch.randn((Q, m, 256), generator=g, device="cuda")
    return codes, lvalid, rowpos, top_ci, top_c, lut, fill


def _mean_fill(fill) -> int:
    """The lists' mean fill rounded up, as ``ANNIndex`` hands it over."""
    return -(-int(fill.sum()) // fill.numel())


def _adc_case(args, S, fill=None):
    """``ann_adc`` (one launch, its grid planned from the fill's mean)
    against ``adc_shortlist_plain``: scores bit for bit, positions equal
    (keys are unique: ties go lower flat index first)."""
    *tensors, own_fill = args
    fill = own_fill if fill is None else fill
    n0 = kernels.LAUNCHES["ann_adc"]
    got_s, got_p = adc_shortlist(*tensors, S, fill, _mean_fill(fill))
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ann_adc"] == n0 + 1
    want_s, want_p = adc_shortlist_plain(*tensors, S)
    assert torch.equal(got_s, want_s), (S, (got_s - want_s).abs().max().item())
    assert torch.equal(got_p, want_p), S
    return got_s, got_p


@pytest.mark.parametrize("Q", [1, 8, 32, 128])
@pytest.mark.parametrize("m,L", [(96, 256), (12, 128), (6, 64), (200, 64), (48, 100)])
def test_ann_adc_kernel_matches_plain(m, L, Q):
    """``ann_adc`` against ``adc_shortlist_plain`` at m on each code-load
    width (16-byte, 4-byte, single bytes), past the LUT's shared-memory
    chunk (m = 200), with ties, skewed fills (a probed list empty), an
    all-tombstone list, at Q 1, 8, 32 and 128; S 1, 256 and the most (the
    tail of -inf where the probes hold fewer valid slots); the fill passed
    as L (every slot scanned) gives the same result."""
    nlist, P = 16, 6
    args = _adc_inputs(nlist, L, m, Q, P, seed=m + L + Q)
    full = torch.full_like(args[-1], L)
    for S in (1, 256, min(P * L, 2048)):
        got = _adc_case(args, S)
        again = _adc_case(args, S, full)
        assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("L,P,S,density", [(4096, 8, 256, 0.02), (8192, 32, 2048, 1.0),
                                            (30592, 64, 256, 0.016)])
def test_ann_adc_kernel_long_scans(L, P, S, density):
    """Long probes: sparse lists, as k-means leaves them, and full lists at
    S 2,048 (many compactions of a block's candidate buffer); bit-equal
    scores and the same positions."""
    nlist, m, Q = 2 * P, 96, 8
    args = list(_adc_inputs(nlist, L, m, Q, P, seed=L + P))
    g = torch.Generator(device="cuda").manual_seed(S)
    args[1] &= torch.rand(args[1].shape, generator=g, device="cuda") < density
    _adc_case(args, S)


@pytest.mark.parametrize("Q", [1, 8, 32, 128])
@pytest.mark.parametrize("S", [1, 256, 2048])
def test_ann_adc_kernel_fills_tombstones_and_tail(Q, S):
    """Skewed fills over 64 probes of 64 lists (L 1,024, m 96): lists empty,
    short and full, tombstones inside every fill; at S 2,048 on the sparser
    half the probes hold fewer valid slots than S, and the -inf tail takes
    the lowest invalid flat indices (tombstones inside a fill, then the
    slots past it).  top_ci and top_c are slices of wider tensors (a
    top-k's views) and the LUT lies [m, Q, 256] in memory (an einsum's),
    all read through their strides."""
    nlist, L, m, P = 64, 1024, 96, 64
    args = list(_adc_inputs(nlist, L, m, Q, P, seed=Q * 7 + S))
    g = torch.Generator(device="cuda").manual_seed(Q + S)
    args[1] &= torch.rand(args[1].shape, generator=g, device="cuda") < (0.02 if S == 2048 else 0.5)
    for i, extra in ((3, 3), (4, 5)):  # top_ci and top_c as slices of wider tensors
        wide = torch.zeros((Q, P + extra), dtype=args[i].dtype, device="cuda")
        wide[:, :P] = args[i]
        args[i] = wide[:, :P]
    args[5] = args[5].transpose(0, 1).contiguous().transpose(0, 1)  # an einsum's [m, Q, 256]
    got_s, _ = _adc_case(args, S)
    if S == 2048:
        assert bool(torch.isinf(got_s).any())


def test_ann_adc_kernel_replays_in_a_cuda_graph():
    """One launch captured into a CUDA graph (warmed up on the capture
    stream, counted by ``record_graph_launches``): each replay finds the
    ticket counters back at zero and writes the eager call's result bit for
    bit, and each replay counts one launch."""
    args = _adc_inputs(16, 512, 96, 8, 6, seed=11)
    *tensors, fill = args
    mean = _mean_fill(fill)
    want_s, want_p = adc_shortlist(*tensors, 256, fill, mean)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        adc_shortlist(*tensors, 256, fill, mean)
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with kernels.record_graph_launches() as rec, torch.cuda.graph(g, stream=side):
        got_s, got_p = adc_shortlist(*tensors, 256, fill, mean)
    assert rec.launches["ann_adc"] == 1
    for _ in range(3):
        got_s.zero_()
        g.replay()
        rec.replayed()
        torch.cuda.synchronize()
        assert torch.equal(got_s, want_s) and torch.equal(got_p, want_p)


def test_ann_adc_kernel_all_invalid_and_refusals():
    """Every probed list invalid: the shortlist is all -inf, positions in
    flat order; a shortlist past 2,048 or past P L raises, and so does a
    call without the lists' fill or without its mean."""
    args = list(_adc_inputs(8, 64, 16, 2, 3, seed=5, dups=False))
    args[1] = torch.zeros_like(args[1])
    got_s, _ = _adc_case(args, 100)
    assert bool(torch.isinf(got_s).all())
    with pytest.raises(ValueError):
        adc_shortlist(*args[:6], 3 * 64 + 1, args[6], _mean_fill(args[6]))
    with pytest.raises(ValueError, match="fill"):
        adc_shortlist(*args[:6], 10)
    with pytest.raises(ValueError, match="fill"):
        adc_shortlist(*args[:6], 10, args[6])


def _rerank_case(N, D, Q, S, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((N, D), generator=g, device="cuda")
    x[N // 2:] = x[: N - N // 2]  # duplicate rows: exact ties
    tier = (x / x.norm(dim=1, keepdim=True)).to(torch.bfloat16)
    rvalid = torch.rand(N, generator=g, device="cuda") < 0.9
    q = torch.randn((Q, D), generator=g, device="cuda")
    q = q / q.norm(dim=1, keepdim=True)
    sl_pos = torch.randint(0, N, (Q, S), generator=g, device="cuda", dtype=torch.int32)
    sl_scores = torch.rand((Q, S), generator=g, device="cuda")
    sl_scores[:, ::7] = float("-inf")
    return tier, rvalid, q, sl_scores, sl_pos


@pytest.mark.parametrize("Q", [1, 8, 128])
@pytest.mark.parametrize("D,S,k", [(768, 256, 16), (64, 1024, 1024), (20, 100, 7)])
def test_ann_rerank_kernel_matches_plain(D, S, k, Q):
    """``ann_rerank`` against ``rerank_plain`` by ``rerank_agreement``: the
    same finite slots, scores within ``topk_score_bound``, the same
    positions at every rank further than twice the bound from its
    neighbours (duplicate rows tie), and each returned position's own
    score; D off 8 takes the scalar loads."""
    args = _rerank_case(4096, D, Q, S, seed=D + S + Q)
    n0 = kernels.LAUNCHES["ann_rerank"]
    got_s, got_p = rerank(*args, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ann_rerank"] == n0 + 1
    report = rerank_agreement(*args, got_s, got_p)
    assert not report["problems"], report


def test_ann_index_on_the_card_matches_cpu():
    """A trained index on the card (both kernels, ``knn_topk`` for the exact
    tier) against the same rows on the CPU (plain twins): ids equal,
    scores within the bound; each path launched its kernels."""
    dim, n = 64, 6000
    rows = make_clustered(n, dim, seed=0)
    gpu, cpu = ANNIndex(dim, seed=0), ANNIndex(dim, seed=0, device="cpu")
    for ix in (gpu, cpu):
        ix.add(range(n), rows)
    qs = rows[::600] + 0.01
    assert [[i for i, _ in r] for r in gpu.search_batch(qs, k=5)] == \
        [[i for i, _ in r] for r in cpu.search_batch(qs, k=5)]
    for ix in (gpu, cpu):
        ix.train()
    # the two trainings run the same steps in other summation orders: hold
    # the card's search to the card's own exact tier instead
    n0 = dict(kernels.LAUNCHES)
    rec = gpu.probe_recall(n_queries=64, k=10, seed=0)
    assert rec["recall_at_k"] >= 0.9
    assert kernels.LAUNCHES["ann_adc"] == n0["ann_adc"] + 1
    assert kernels.LAUNCHES["ann_rerank"] == n0["ann_rerank"] + 1
    assert kernels.LAUNCHES["knn_topk"] == n0["knn_topk"] + 1


# ------------------------------------------------------------------ MoE
def _capacity(T, X, K, factor):
    from django_assistant_bot_tpu_torch.models.config import DecoderConfig
    from django_assistant_bot_tpu_torch.models.mixtral import expert_capacity

    cfg = DecoderConfig(num_experts=X, experts_per_token=K, expert_capacity_factor=factor)
    return expert_capacity(cfg, T)


def _moe_inputs(T, E, X, F, dtype, seed, *, tie=False, skew=False):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((T, E), generator=g, device="cuda")
    router = torch.randn((E, X), generator=g, device="cuda") * E ** -0.5
    if tie:
        router[:, 2] = router[:, 1]  # equal logits for experts 1 and 2
    if skew:  # a constant feature that sends every token to experts 0 and 1
        x[:, 0] = 10.0
        router[0, :] = -5.0
        router[0, 0], router[0, 1] = 5.0, 4.0
    w_gate = (torch.randn((X, E, F), generator=g, device="cuda") * E ** -0.5).to(dtype)
    w_up = (torch.randn((X, E, F), generator=g, device="cuda") * E ** -0.5).to(dtype)
    w_down = (torch.randn((X, F, E), generator=g, device="cuda") * F ** -0.5).to(dtype)
    return x.to(dtype), router.to(dtype), w_gate, w_up, w_down


def _check_route(x, router, top_k, C):
    """The routing kernel against its twin: ids (the kept slots' experts)
    and gates equal outside near ties, slots equal outside the flagged
    tokens, and everything equal when no token is near a tie."""
    from django_assistant_bot_tpu_torch.ops import moe

    got = moe.moe_route(x, router, top_k, C)
    want = moe.moe_route_plain(x, router, top_k, C)
    torch.cuda.synchronize()
    near, flagged = moe.route_margin(x, router, top_k)
    tok_slot, tok_gate, slot_tok, fill = got
    both = (tok_slot >= 0) & (want[0] >= 0) & ~near[:, None]
    assert bool(((tok_slot // C) == (want[0] // C))[both].all())
    assert bool(((tok_gate - want[1]).abs()[~near] <= 1e-5).all())
    assert bool((tok_slot == want[0])[~flagged].all())
    if not bool(near.any()):
        assert torch.equal(tok_slot, want[0]) and torch.equal(slot_tok, want[2])
        assert torch.equal(fill, want[3])
    return got, want, near


def _off_16(t):
    """A copy of ``t`` one element past a 16-byte boundary."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    off = buf[1:].view(t.shape)
    off.copy_(t)
    assert off.is_contiguous() and off.data_ptr() % 16
    return off


# (T, capacity factor) of the routing cases: one token, the decode tick, a
# ragged tile, a chunk, a [4, 512] prefill, past two 2,048-token prefills,
# and a chunk with drops; (X, K): Mixtral's, the fewest experts and choices,
# the most of both (f32 at X 32 reads a 512 KB router), the most experts
ROUTE_TOKENS = [(1, 1.25), (8, 1.25), (33, 1.25), (512, 1.25), (2048, 1.25), (4100, 1.25),
                (512, 0.25)]
ROUTE_WIDTHS = [(8, 2), (4, 1), (32, 8), (32, 2)]


@pytest.mark.parametrize("X,K", ROUTE_WIDTHS)
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,factor", ROUTE_TOKENS)
@pytest.mark.parametrize("tie", [False, True])
def test_moe_route_kernel_matches_plain(dtype, T, factor, tie, X, K):
    E = 4096
    C = _capacity(T, X, K, factor)
    x, router, *_ = _moe_inputs(T, E, X, 64, dtype, T, tie=tie)
    plan = kernels.moe_route_plan(dtype, T, E, X, K)
    before = kernels.LAUNCHES["moe_route"]
    forms = dict(kernels.MOE_ROUTE_FORMS)
    (tok_slot, _, slot_tok, fill), want, near = _check_route(x, router, K, C)
    assert kernels.LAUNCHES["moe_route"] == before + 1
    assert kernels.MOE_ROUTE_FORMS[plan.form] == forms[plan.form] + 1
    assert plan.form == ("split" if T <= 64 // plan.xmax else "tiles")
    # the test's own data: few near ties (more where more probabilities lie
    # among the top K + 1)
    assert int(near.sum()) <= (max(2, T // 256) if (X, K) == (8, 2) else max(4, T * K * X // 512))
    if factor < 1:
        assert bool((tok_slot < 0).any())
    # slot_tok and fill are the inverse of tok_slot
    for xi in range(X):
        live = slot_tok[xi, : int(fill[xi])]
        assert bool((live >= 0).all()) and bool((slot_tok[xi, int(fill[xi]):] == -1).all())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [8, 300])
def test_moe_route_kernel_reads_rows_off_16_bytes(dtype, T):
    """x and the router one element (two bytes in bf16, four in f32) off a
    16-byte boundary, and E not a multiple of a 16-byte chunk: the kernel
    reads x and copies the router one element at a time."""
    X, K, E = 8, 2, 4100
    C = _capacity(T, X, K, 1.25)
    x, router, *_ = _moe_inputs(T, E, X, 64, dtype, 41 + T)
    _check_route(_off_16(x), _off_16(router), K, C)


@pytest.mark.parametrize("T,E,form", [(8, 4096, "split"), (8, 256, "block"), (512, 4096, "tiles"),
                                      (4100, 4096, "tiles")])
def test_moe_route_graph_replays_match_plain_and_leave_the_counter_at_zero(T, E, form):
    """The routing launch captured in a CUDA graph (its scratch and counter
    the graph's own) replayed on three fresh x, each time equal to the twin
    as ``_check_route`` holds it, the ticket counter back at zero after each
    replay, each replay counted; every form (a short E is one block)."""
    from django_assistant_bot_tpu_torch.ops import moe

    X, K = 8, 2
    C = _capacity(T, X, K, 1.25)
    x, router, *_ = _moe_inputs(T, E, X, 64, torch.bfloat16, 61 + T)
    plan = kernels.moe_route_plan(torch.bfloat16, T, E, X, K)
    assert plan.form == form
    outs = (torch.empty((T, K), dtype=torch.int32, device="cuda"),
            torch.empty((T, K), dtype=torch.float32, device="cuda"),
            torch.empty((X, C), dtype=torch.int32, device="cuda"),
            torch.empty((X,), dtype=torch.int32, device="cuda"))
    store, stream = {}, torch.cuda.Stream()
    with kernels.private_paged_scratch(store):
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            kernels.moe_route(x, router, *outs)  # warm-up: the scratch
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches() as rec:
            with torch.cuda.graph(graph, stream=stream):
                kernels.moe_route(x, router, *outs)
    assert rec.launches["moe_route"] == 1
    counters = [c for (name, *_), (_, c) in store.items() if name == "moe_route"]
    assert len(counters) == (plan.counters > 0)
    g = torch.Generator(device="cuda").manual_seed(T)
    for _ in range(3):
        x.copy_(torch.randn((T, E), generator=g, device="cuda").to(x.dtype))
        before = kernels.LAUNCHES["moe_route"]
        graph.replay()
        rec.replayed()
        torch.cuda.synchronize()
        assert kernels.LAUNCHES["moe_route"] == before + 1
        assert all(int(c.abs().sum()) == 0 for c in counters)
        want = moe.moe_route_plain(x, router, K, C)
        near, flagged = moe.route_margin(x, router, K)
        tok_slot, tok_gate = outs[0], outs[1]
        assert bool(((tok_gate - want[1]).abs()[~near] <= 1e-5).all())
        assert bool((tok_slot == want[0])[~flagged].all())
        if not bool(near.any()):
            assert torch.equal(tok_slot, want[0]) and torch.equal(outs[2], want[2])
            assert torch.equal(outs[3], want[3])


# (T, E, F, skew) of the grouped GEMM's cases: the decode tick at Mixtral's
# width (mma gate/up, mma_split down), a chunk (wgmma), every token on two
# experts (six empty; C 20, wgmma), a shape no tensor-core route takes; then
# the wgmma route at C 640 (five slot tiles), at C 40 (a ragged tile, the
# second warpgroup idle), at C 160 with six empty experts, a chunk and a
# [4, 512] prefill at Mixtral's width (down's 256-feature blocks)
MOE_GEMM_CASES = [(8, 4096, 14336, False), (512, 1024, 2048, False), (64, 256, 512, True),
                  (37, 96, 80, False), (2048, 1024, 2048, False), (128, 1024, 1024, False),
                  (512, 1024, 2048, True), (512, 4096, 14336, False), (2048, 4096, 14336, False)]


def _moe_forms_taken(before):
    """The grouped GEMM launches since ``before`` (a copy of
    ``MOE_GEMM_FORMS``), as sorted "<route>:<epilogue>" keys."""
    return sorted(f for f, n in kernels.MOE_GEMM_FORMS.items() for _ in range(n - before[f]))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,E,F,skew", MOE_GEMM_CASES)
def test_moe_expert_gemm_kernel_matches_plain(dtype, T, E, F, skew):
    from django_assistant_bot_tpu_torch.ops import moe

    X, K = 8, 2
    C = _capacity(T, X, K, 1.25)
    x, router, wg, wu, wd = _moe_inputs(T, E, X, F, dtype, 7 + T, skew=skew)
    tok_slot, tok_gate, slot_tok, fill = moe.moe_route(x, router, K, C)
    if skew:
        assert int((fill > 0).sum()) == 2  # six empty experts
    live = torch.arange(C, device="cuda")[None, :, None] < fill[:, None, None].long()
    before = dict(kernels.MOE_GEMM_FORMS)
    h = moe.moe_expert_gemm(x, slot_tok, fill, wg, wu, epilogue="gate_up")
    ye = moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")
    torch.cuda.synchronize()
    sms = kernels._sm_count(torch.cuda.current_device())
    want = [kernels.moe_gemm_plan(dtype, "gate_up", X, C, E, F, sms=sms).route,
            kernels.moe_gemm_plan(dtype, "down", X, C, F, E, sms=sms).route]
    assert _moe_forms_taken(before) == sorted([f"{want[0]}:gate_up", f"{want[1]}:down"])
    if dtype == torch.float32 or E % 64:
        assert want == ["cuda_core", "cuda_core"]
    elif C >= kernels.MOE_WGMMA_MIN_C:
        assert want == ["wgmma", "wgmma"]
    else:
        assert want[0] == "mma" and want[1] in ("mma", "mma_split")
    for out, args, kind in ((h, (x, slot_tok, wg, wu), "gate_up"), (ye, (h, slot_tok, wd), "down")):
        if dtype == torch.bfloat16:
            ref, bound = moe.moe_gemm_bf16_bound(*args, epilogue=kind)
        else:
            ref = moe.moe_expert_gemm_plain(*args[:2], fill, *args[2:], epilogue=kind)
            bound = torch.full_like(ref, F32_TOL) + 1e-5 * ref.abs()
        ok = ((out.float() - ref).abs() <= bound) | ~live  # a NaN in a live row fails
        assert bool(ok.all()), (kind, ((out.float() - ref).abs() / bound)[live.expand_as(ok)].max().item())


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T,factor", [(8, 1.25), (512, 0.25), (2048, 1.25)])
@pytest.mark.parametrize("layout", ["aligned", "odd_e", "ye_off", "out_off"])
def test_moe_combine_kernel_bit_equal(dtype, T, factor, layout):
    """The combine equals its twin bit for bit: rows of 16-byte vectors, and
    the element path where E (509) is not a multiple of the vector or ye /
    out lies off 16 bytes."""
    from django_assistant_bot_tpu_torch.ops import moe

    E, X, K = 509 if layout == "odd_e" else 512, 8, 2
    C = _capacity(T, X, K, factor)
    x, router, *_ = _moe_inputs(T, E, X, 64, dtype, 3)
    tok_slot, tok_gate, slot_tok, fill = moe.moe_route(x, router, K, C)
    ye = torch.randn((X, C, E), device="cuda").to(dtype)
    if layout == "ye_off":
        ye = _off_16(ye)
    before = kernels.LAUNCHES["moe_combine"]
    if layout == "out_off":
        out = _off_16(torch.zeros((T, E), dtype=dtype, device="cuda"))
        kernels.moe_combine(tok_slot, tok_gate, ye, out)
    else:
        out = moe.moe_combine(tok_slot, tok_gate, ye)
    assert kernels.LAUNCHES["moe_combine"] == before + 1
    want = moe.moe_combine_plain(tok_slot, tok_gate, ye)
    bits = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(out.view(bits), want.view(bits))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_moe_mlp_on_the_card_matches_cpu_and_replays_in_a_graph(dtype):
    """``moe_mlp`` on the card (four kernel launches, counted at each replay
    of a CUDA graph that captured it) against the twins on the CPU."""
    from django_assistant_bot_tpu_torch.models.config import DecoderConfig
    from django_assistant_bot_tpu_torch.models.mixtral import moe_mlp

    cfg = DecoderConfig(hidden_size=256, intermediate_size=512, num_experts=4,
                        experts_per_token=2, dtype=dtype)
    x, router, wg, wu, wd = _moe_inputs(64, 256, 4, 512, dtype, 11)
    p = {"router": router, "w_gate": wg, "w_up": wu, "w_down": wd}
    xb = x.reshape(8, 8, 256)
    before = kernels.launch_counts()
    out = moe_mlp(cfg, p, xb)
    after = kernels.launch_counts()
    assert {k: after[k] - before[k] for k in ("moe_route", "moe_gemm", "moe_combine")} == {
        "moe_route": 1, "moe_gemm": 2, "moe_combine": 1}
    cpu = moe_mlp(cfg, {k: v.cpu() for k, v in p.items()}, xb.cpu()).float().reshape(64, -1)
    err = (out.cpu().float().reshape(64, -1) - cpu).abs()
    if dtype == torch.bfloat16:
        # bf16 products rounded after sums in other orders move h and ye by
        # an ulp here and there: held per row to 2^-7 of its largest value;
        # a token near a routing tie may take another expert and is left out
        from django_assistant_bot_tpu_torch.ops.moe import route_margin

        near, _ = route_margin(x.cpu(), router.cpu(), 2)
        tol = 2.0 ** -6 * cpu.abs() + 2.0 ** -7 * cpu.abs().amax(-1, keepdim=True)
        assert bool((err <= tol)[~near].all()), (err / tol).max().item()
    else:
        assert err.max().item() <= F32_TOL
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        moe_mlp(cfg, p, xb)  # warm-up on the capture stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with kernels.record_graph_launches() as rec:
        with torch.cuda.graph(graph, stream=stream):
            static = moe_mlp(cfg, p, xb)
    assert rec.launches["moe_route"] == 1 and rec.launches["moe_gemm"] == 2
    before = kernels.launch_counts()
    graph.replay()
    rec.replayed()
    torch.cuda.synchronize()
    assert kernels.launch_counts()["moe_combine"] == before["moe_combine"] + 1
    assert torch.equal(static, out)


@pytest.mark.parametrize("T,factor", [(512, 0.25), (2048, 0.25)])
def test_moe_expert_gemm_wgmma_with_drops(T, factor):
    """The wgmma route where the capacity drops choices (every expert full):
    live rows within the bound, the route taken."""
    from django_assistant_bot_tpu_torch.ops import moe

    X, K, E, F = 8, 2, 1024, 2048
    C = _capacity(T, X, K, factor)
    assert C >= kernels.MOE_WGMMA_MIN_C
    x, router, wg, wu, wd = _moe_inputs(T, E, X, F, torch.bfloat16, 5 + T)
    tok_slot, _, slot_tok, fill = moe.moe_route(x, router, K, C)
    assert bool((tok_slot < 0).any()) and bool((fill == C).all())
    before = dict(kernels.MOE_GEMM_FORMS)
    h = moe.moe_expert_gemm(x, slot_tok, fill, wg, wu, epilogue="gate_up")
    ye = moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")
    torch.cuda.synchronize()
    assert _moe_forms_taken(before) == ["wgmma:down", "wgmma:gate_up"]
    for out, args, kind in ((h, (x, slot_tok, wg, wu), "gate_up"), (ye, (h, slot_tok, wd), "down")):
        ref, bound = moe.moe_gemm_bf16_bound(*args, epilogue=kind)
        assert bool(((out.float() - ref).abs() <= bound).all()), kind


def test_moe_decode_down_split_replays_bitwise_in_a_graph():
    """Down at the decode tick's shape (Mixtral's width, C 8) takes the
    split mma form; a CUDA graph that captured it replays the eager call's
    bits (the partials summed in split order, no atomics on the values)
    and counts its launch at each replay."""
    from django_assistant_bot_tpu_torch.ops import moe

    X, K, E, F = 8, 2, 4096, 14336
    C = _capacity(8, X, K, 1.25)
    x, router, wg, wu, wd = _moe_inputs(8, E, X, F, torch.bfloat16, 23)
    _, _, slot_tok, fill = moe.moe_route(x, router, K, C)
    h = moe.moe_expert_gemm(x, slot_tok, fill, wg, wu, epilogue="gate_up")
    plan = kernels.moe_gemm_plan(torch.bfloat16, "down", X, C, F, E,
                                 sms=kernels._sm_count(torch.cuda.current_device()))
    assert plan.route == "mma_split" and plan.ksplit > 1
    live = torch.arange(C, device="cuda")[None, :, None] < fill[:, None, None].long()
    eager = moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")
    ref, bound = moe.moe_gemm_bf16_bound(h, slot_tok, wd, epilogue="down")
    assert bool((((eager.float() - ref).abs() <= bound) | ~live).all())
    again = moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")
    assert torch.equal(torch.where(live, again, 0), torch.where(live, eager, 0))
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    store = {}
    with kernels.private_paged_scratch(store):
        with torch.cuda.stream(stream):
            moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")  # warm-up: scratch
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with kernels.record_graph_launches() as rec:
            with torch.cuda.graph(graph, stream=stream):
                static = moe.moe_expert_gemm(h, slot_tok, fill, wd, epilogue="down")
    assert rec.sub["moe_gemm"]["mma_split:down"] == 1
    before = kernels.MOE_GEMM_FORMS["mma_split:down"]
    for _ in range(3):
        graph.replay()
        rec.replayed()
        torch.cuda.synchronize()
        assert torch.equal(torch.where(live, static, 0), torch.where(live, eager, 0))
    assert kernels.MOE_GEMM_FORMS["mma_split:down"] == before + 3


@pytest.mark.parametrize("route", ["wgmma", "mma"])
def test_moe_gemm_refuses_a_misaligned_operand(monkeypatch, route):
    """A launch the kernel does not take raises (no fallback): the plan
    forced onto a tensor-core route with x two bytes off a 16-byte
    boundary, and gate/up with a K split."""
    from django_assistant_bot_tpu_torch.ops import moe

    X, K, E, F, T = 8, 2, 1024, 2048, 512
    C = _capacity(T, X, K, 1.25)
    x, router, wg, wu, _ = _moe_inputs(T, E, X, F, torch.bfloat16, 3)
    _, _, slot_tok, fill = moe.moe_route(x, router, K, C)
    buf = torch.empty(T * E + 1, dtype=torch.bfloat16, device="cuda")
    off = buf[1:].view(T, E)
    off.copy_(x)
    assert off.is_contiguous() and off.data_ptr() % 16
    monkeypatch.setattr(kernels, "moe_gemm_plan",
                        lambda dtype, epilogue, X, C, K, N, **kw:
                        kernels.MoePlan(route, 1, K, *(2 * [128 if route == "wgmma" else 64])))
    with pytest.raises(RuntimeError, match="moe_gemm"):
        moe.moe_expert_gemm(off, slot_tok, fill, wg, wu, epilogue="gate_up")
    monkeypatch.setattr(kernels, "moe_gemm_plan",
                        lambda dtype, epilogue, X, C, K, N, **kw:
                        kernels.MoePlan(route, 2, K // 2, *(2 * [128 if route == "wgmma" else 64])))
    with pytest.raises(RuntimeError, match="moe_gemm"):
        moe.moe_expert_gemm(x, slot_tok, fill, wg, wu, epilogue="gate_up")
    torch.cuda.synchronize()


def test_moe_wrappers_refuse_what_they_do_not_take():
    from django_assistant_bot_tpu_torch.ops import moe

    x = torch.zeros((4, 64), device="cuda", dtype=torch.float16)
    with pytest.raises(TypeError):
        moe.moe_route(x, torch.zeros((64, 4), device="cuda", dtype=torch.float16), 2, 8)
    with pytest.raises(ValueError):  # more experts than the kernel's lanes
        moe.moe_route(x.float(), torch.zeros((64, 33), device="cuda"), 2, 8)
    with pytest.raises(ValueError):  # a mix of devices
        moe.moe_route(x.float(), torch.zeros((64, 4)), 2, 8)


# ------------------------------------------------------------- paged prefill
# (label, B, H, KH, D, page, NB, C, starts, q dtype, pool dtype, window, pad row)
_BF16, _F32 = torch.bfloat16, torch.float32
_E4M3, _E5M2 = torch.float8_e4m3fn, torch.float8_e5m2
_WAVE = [0, 40, 64, 100]
PREFILL_CASES = [
    *[(f"chunk_start_{s}", 1, 32, 8, 128, 512, 8, 512, [s], _BF16, _BF16, None, False)
      for s in (0, 511, 512, 1536, 3584)],
    *[(f"wave_c{c}_page{pg}", 4, 32, 8, 128, pg, 4096 // pg, c, _WAVE, _BF16, _BF16, None, True)
      for c in (32, 128) for pg in (512, 16)],
    ("window_100", 1, 32, 8, 128, 512, 8, 512, [1536], _BF16, _BF16, 100, False),
    ("e4m3", 1, 32, 8, 128, 512, 8, 512, [1536], _BF16, _E4M3, None, False),
    ("e5m2_window", 1, 32, 8, 128, 512, 8, 512, [1536], _BF16, _E5M2, 100, False),
    ("e4m3_wave", 4, 32, 8, 128, 512, 8, 128, _WAVE, _BF16, _E4M3, None, True),
    ("d64", 1, 32, 8, 64, 512, 8, 512, [1536], _BF16, _BF16, None, False),
    ("bf16_d256", 1, 8, 4, 256, 512, 8, 256, [1000], _BF16, _BF16, None, False),
    ("f32", 1, 8, 2, 128, 512, 8, 512, [1536], _F32, _F32, None, False),
    ("f32_bf16_pool", 1, 8, 2, 128, 512, 8, 512, [1536], _F32, _BF16, 100, False),
    ("f32_e4m3_wave", 4, 8, 2, 128, 512, 8, 128, _WAVE, _F32, _E4M3, None, True),
    ("f32_e5m2", 1, 8, 2, 128, 512, 8, 512, [3584], _F32, _E5M2, None, False),
    ("f32_d16_page16", 4, 4, 2, 16, 16, 16, 32, _WAVE, _F32, _F32, None, True),
]


def _prefill_inputs(B, H, KH, D, page, NB, C, starts, qdt, kvdt, pad, seed):
    """q, the chunk's K/V and the pools (page P the dump page) on the card,
    each row its own chain of pages to its write window's end (sentinels
    past it), row 0 a pad row of sentinels with ``pad``."""
    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    g = torch.Generator(device="cuda").manual_seed(seed)
    S = NB * page
    used = [-(-(min(s, S - C) + C) // page) for s in starts]
    P = sum(used) + 1
    perm = torch.randperm(P, generator=torch.Generator().manual_seed(seed))
    bt = torch.full((B, NB), P, dtype=torch.int32)
    at = 0
    for b, n in enumerate(used):
        bt[b, :n] = perm[at:at + n]
        at += n
    if pad:
        bt[0] = P

    def mk(shape, dt):
        return to_kv_dtype(torch.randn(shape, generator=g, device="cuda"), dt)

    return (mk((B, H, C, D), qdt), mk((B, KH, C, D), kvdt), mk((B, KH, C, D), kvdt),
            mk((P + 1, KH, page, D), kvdt), mk((P + 1, KH, page, D), kvdt), bt.cuda(),
            torch.tensor(starts, dtype=torch.int64, device="cuda"))


def _whole_block_scatter(pool, chunk, bt, st, valids):
    """The page write the token write replaced: the gathered rows with the
    chunk written in, every block overlapping [start, start + valid) written
    back whole, the others to the dump page."""
    from django_assistant_bot_tpu_torch.ops.attention import gather_paged_rows

    P, KH, page, D = pool.shape[0] - 1, pool.shape[1], pool.shape[2], pool.shape[3]
    B, NB = bt.shape
    C = chunk.shape[2]
    rows = gather_paged_rows(pool, bt)
    wpos = st.clamp(max=NB * page - C)[:, None] + torch.arange(C, device=pool.device)[None, :]
    rows[torch.arange(B, device=pool.device)[:, None], :, wpos, :] = chunk.transpose(1, 2)
    blk = torch.arange(NB, device=pool.device)[None, :]
    write = ((blk + 1) * page > st[:, None]) & (blk * page < (st + valids)[:, None])
    tgt = torch.where(write, bt.long().clamp(max=P), P).reshape(-1)
    pool[tgt] = rows.reshape(B, KH, NB, page, D).transpose(1, 2).reshape(B * NB, KH, page, D)


@pytest.mark.parametrize("case", PREFILL_CASES, ids=[c[0] for c in PREFILL_CASES])
def test_paged_prefill_matches_plain_twin(case):
    """The kernel against the f32 twin on the same inputs: bf16 on the
    tensor cores within ``paged_prefill_bf16_bound``, bf16 at D 256 within
    2^-8 |ref| + 1e-4, f32 within 1e-4; each call counted on its form, two
    bf16 calls bitwise equal."""
    from django_assistant_bot_tpu_torch.ops.attention import (
        paged_prefill_attention,
        paged_prefill_attention_plain,
        paged_prefill_bf16_bound,
    )

    label, B, H, KH, D, page, NB, C, starts, qdt, kvdt, window, pad = case
    args = _prefill_inputs(B, H, KH, D, page, NB, C, starts, qdt, kvdt, pad, len(label))
    mma = qdt == _BF16 and D in kernels.PAGED_MMA_HEAD_DIMS
    form = f"{'mma' if mma else 'cuda_core'}:{kernels.paged_read(qdt, kvdt)}"
    before = kernels.PAGED_PREFILL_FORMS[form]
    out = paged_prefill_attention(*args, window=window)
    assert kernels.PAGED_PREFILL_FORMS[form] == before + 1
    wide = [t.float() for t in args[:5]]
    ref = paged_prefill_attention_plain(*wide, args[5], args[6], window=window)
    bound = paged_prefill_bf16_bound(*wide, args[5], args[6], ref, window=window) if mma else None
    torch.cuda.synchronize()
    assert out.shape == (B, H, C, D) and out.dtype == qdt
    _assert_close(out, ref, bound)
    if mma:
        assert torch.equal(out, paged_prefill_attention(*args, window=window))


@pytest.mark.parametrize("case", PREFILL_CASES[:9], ids=[c[0] for c in PREFILL_CASES[:9]])
def test_paged_prefill_token_write_matches_whole_block_scatter(case):
    """The chunk's C tokens written to their pages leave the pages [0, P)
    bitwise as the whole-block scatter it replaced leaves them."""
    from django_assistant_bot_tpu_torch.models import llama

    label, B, H, KH, D, page, NB, C, starts, qdt, kvdt, window, pad = case
    _, kc, _, kp, _, bt, st = _prefill_inputs(B, H, KH, D, page, NB, C, starts, qdt, kvdt, pad,
                                              len(label))
    valids = torch.tensor([0 if pad and b == 0 else C - 3 * b for b in range(B)], device="cuda")
    P = kp.shape[0] - 1
    got, want = kp.clone(), kp.clone()
    pages, offsets = llama._chunk_write_targets(bt, st, valids, C, page, P)
    llama._write_chunk_tokens(got, kc, pages, offsets)
    _whole_block_scatter(want, kc, bt, st, valids)
    assert torch.equal(got[:P].view(torch.uint8), want[:P].view(torch.uint8))


def test_paged_prefill_refuses_what_it_does_not_take():
    """No fallback: a head dim without an instantiation, a chunk in another
    dtype than the pool's, and a mix of devices raise."""
    from django_assistant_bot_tpu_torch.ops.attention import paged_prefill_attention

    q, kc, vc, kp, vp, bt, st = _prefill_inputs(1, 4, 2, 64, 16, 4, 32, [0], _BF16, _BF16,
                                                False, 1)
    with pytest.raises(ValueError, match="head_dim"):
        paged_prefill_attention(q[..., :48], kc[..., :48], vc[..., :48],
                                kp[..., :48].contiguous(), vp[..., :48].contiguous(), bt, st)
    with pytest.raises(TypeError):
        paged_prefill_attention(q, kc.float(), vc.float(), kp, vp, bt, st)
    with pytest.raises(ValueError, match="devices"):
        paged_prefill_attention(q, kc, vc, kp, vp, bt.cpu(), st)


@pytest.mark.parametrize("qdt,kvdt,window", [(_BF16, _BF16, None), (_BF16, _E5M2, 100),
                                            (_F32, _E4M3, None), (_F32, _F32, 24)])
def test_chunked_prefill_matches_plain_twin(qdt, kvdt, window):
    """The kernel's contiguous form over the legacy slot cache (every slot
    row one page of S keys, no dump page; the last slot read too) against
    ``chunked_prefill_attention_plain``: rows from 0 (a pad row aliasing
    slot 3) / 40 / 64 / 700 / the row's end (the write window clamped)."""
    from django_assistant_bot_tpu_torch.ops.attention import (
        chunked_prefill_attention,
        chunked_prefill_attention_plain,
    )
    from django_assistant_bot_tpu_torch.ops.quant import to_kv_dtype

    g = torch.Generator(device="cuda").manual_seed(12)

    def mk(shape, dt):
        return to_kv_dtype(torch.randn(shape, generator=g, device="cuda"), dt)

    D = 128 if qdt == _BF16 else 64
    q = mk((5, 16, 64, D), qdt)
    kc, vc = mk((5, 4, 64, D), kvdt), mk((5, 4, 64, D), kvdt)
    kcache, vcache = mk((4, 4, 1024, D), kvdt), mk((4, 4, 1024, D), kvdt)
    slots = torch.tensor([3, 0, 1, 2, 3], device="cuda")
    starts = torch.tensor([0, 40, 64, 700, 1000], device="cuda")
    out = chunked_prefill_attention(q, kc, vc, kcache, vcache, slots, starts, window=window)
    wide = [t.float() for t in (q, kc, vc, kcache, vcache)]
    ref = chunked_prefill_attention_plain(*wide, slots, starts, window=window)
    bound = None
    if qdt == _BF16:  # paged_prefill_bf16_bound's formula over the slot rows
        a = chunked_prefill_attention_plain(wide[0], wide[1], wide[2].abs(), wide[3],
                                            wide[4].abs(), slots, starts, window=window)
        bound = 2.0 ** -8 * (ref.abs() + a) + 1e-4
    torch.cuda.synchronize()
    _assert_close(out, ref, bound)
