"""The port's ops against the JAX package's on identical numpy inputs.

- flash prefill attention: the port's plain twin vs JAX ``flash_attention``
  run in Pallas interpret mode (the contract of tests/test_ops.py:29-57);
- paged GQA decode attention: plain twin vs the JAX page loop, with ragged
  positions, sentinel block-table entries, inactive rows and a window, in
  f32 and in bf16 (P rounded before P.V), and the JAX loop in bf16 within
  ``paged_bf16_bound``;
- sampling: greedy rows exact, sampled rows identical when the port is fed
  the Gumbel noise ``jax.random.categorical`` draws;
- norms and rope.

The Hopper kernels themselves are held against these plain twins on the
card by tests/test_torch_kernels.py.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.ops import attention as jattn
from django_assistant_bot_tpu.ops import norms as jnorms
from django_assistant_bot_tpu.ops import rope as jrope
from django_assistant_bot_tpu.ops import sampling as jsampling
from django_assistant_bot_tpu_torch.ops.attention import (
    attention,
    dot_product_attention,
    flash_attention,
    flash_attention_plain,
    flash_bf16_bound,
    gqa_dot_product_attention,
    paged_bf16_bound,
    paged_gqa_decode_attention,
)
from django_assistant_bot_tpu_torch.ops.norms import rms_norm
from django_assistant_bot_tpu_torch.ops.rope import apply_rope, rope_frequencies
from django_assistant_bot_tpu_torch.ops.sampling import sample_logits, top_k_hierarchical


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------------ flash
@pytest.fixture(scope="module")
def qkv_gqa():
    rng = np.random.default_rng(0)
    B, H, KH, S, D = 2, 4, 2, 256, 64
    q = rng.normal(size=(B, H, S, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, S, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, S, D)).astype(np.float32)
    return q, k, v


@pytest.mark.parametrize(
    "causal,window",
    [(False, None), (True, None), (True, 64), (True, 100), (True, 256)],
)
def test_flash_plain_matches_jax_flash(qkv_gqa, causal, window):
    """The port's flash twin (GQA: KH < H, heads mapped inside) vs the JAX
    Pallas kernel in interpret mode over KV heads repeated up to H."""
    q, k, v = qkv_gqa
    G = q.shape[1] // k.shape[1]
    ref = jattn.flash_attention(
        jnp.asarray(q), jnp.repeat(jnp.asarray(k), G, axis=1), jnp.repeat(jnp.asarray(v), G, axis=1),
        causal=causal, window=window, interpret=True,
    )
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal, window=window)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=2e-5, rtol=1e-4)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 100), (False, None)])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bf16_bound_holds_for_jax_kernel(D, causal, window):
    """The bound the bf16 flash kernel is held to on the card is the JAX
    kernel's own: its bf16 Pallas kernel (interpret mode, probabilities
    rounded to bf16 before P.V) stays within ``flash_bf16_bound`` of the
    port's f32 plain twin on the same bf16 values."""
    rng = np.random.default_rng(5)
    B, H, KH, S = 1, 4, 2, 256
    q, k, v = (
        jnp.asarray(rng.normal(size=(B, n, S, D)).astype(np.float32), jnp.bfloat16)
        for n in (H, KH, KH)
    )
    G = H // KH
    out = jattn.flash_attention(
        q, jnp.repeat(k, G, axis=1), jnp.repeat(v, G, axis=1),
        causal=causal, window=window, interpret=True,
    )
    qt, kt, vt = (_t(np.asarray(x.astype(jnp.float32))) for x in (q, k, v))
    ref = flash_attention_plain(qt, kt, vt, causal=causal, window=window)
    bound = flash_bf16_bound(qt, kt, vt, ref, causal=causal, window=window)
    diff = (_t(np.asarray(out.astype(jnp.float32))) - ref).abs()
    ratio = float((diff / bound).max())
    # the bound for an f32 P.V (rounding of the output alone), which the
    # JAX kernel does not do, fails it several times over
    f32_pv_ratio = float((diff / (2.0 ** -8 * ref.abs() + 1e-4)).max())
    print(f"D={D} causal={causal} window={window}: worst err/bound {ratio:.3f}, "
          f"under the f32-P.V bound {f32_pv_ratio:.3f}")
    assert ratio <= 1.0
    assert f32_pv_ratio > 1.0


def test_dot_product_and_gqa_attention_match_jax():
    rng = np.random.default_rng(1)
    B, H, KH, Sq, Sk, D = 2, 4, 2, 8, 24, 16
    q = rng.normal(size=(B, H, Sq, D)).astype(np.float32)
    k = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    v = rng.normal(size=(B, KH, Sk, D)).astype(np.float32)
    mask = rng.random((B, 1, Sq, Sk)) > 0.3
    mask[..., 0] = True
    ref = jattn.gqa_dot_product_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), mask=jnp.asarray(mask))
    out = gqa_dot_product_attention(_t(q), _t(k), _t(v), mask=_t(mask))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    ref = jattn.dot_product_attention(
        jnp.asarray(q), jnp.asarray(kr), jnp.asarray(vr), causal=True, q_offset=16, window=12
    )
    out = dot_product_attention(_t(q), _t(kr), _t(vr), causal=True, q_offset=16, window=12)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_attention_dispatch_takes_plain_path_on_cpu(qkv_gqa):
    q, k, v = qkv_gqa
    kr, vr = np.repeat(k, 2, axis=1), np.repeat(v, 2, axis=1)
    out = attention(_t(q), _t(kr), _t(vr), causal=True)
    ref = dot_product_attention(_t(q), _t(kr), _t(vr), causal=True)
    assert torch.equal(out, ref)


# ------------------------------------------------------------------ paged decode
@pytest.fixture(scope="module")
def paged_inputs():
    rng = np.random.default_rng(2)
    B, H, KH, D, page, NB = 5, 8, 2, 16, 32, 6
    P = B * NB + 3
    q = rng.normal(size=(B, H, 1, D)).astype(np.float32)
    k_pool = rng.normal(size=(P, KH, page, D)).astype(np.float32)
    v_pool = rng.normal(size=(P, KH, page, D)).astype(np.float32)
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    positions = np.asarray([0, 31, 32, 100, 191], np.int32)
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1 :] = P + b  # sentinels (>= P) past each allocation
    return q, k_pool, v_pool, bt, positions


@pytest.mark.parametrize("window", [None, 40])
@pytest.mark.parametrize("active", [None, [True, True, False, True, True]])
def test_paged_decode_plain_matches_jax(paged_inputs, window, active):
    q, k_pool, v_pool, bt, positions = paged_inputs
    act = None if active is None else np.asarray(active)
    ref = jattn.paged_gqa_decode_attention(
        jnp.asarray(q), jnp.asarray(k_pool), jnp.asarray(v_pool), jnp.asarray(bt),
        jnp.asarray(positions), active=None if act is None else jnp.asarray(act), window=window,
    )
    out = paged_gqa_decode_attention(
        _t(q), _t(k_pool), _t(v_pool), _t(bt), _t(positions),
        active=None if act is None else _t(act), window=window,
    )
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


@pytest.fixture(scope="module")
def paged_bf16_inputs():
    """Llama-3-8B's decode group (G=4, D=128) in bf16, ragged positions, a
    sentinel past each row's allocation."""
    rng = np.random.default_rng(2)
    B, H, KH, D, page, NB = 4, 32, 8, 128, 64, 8
    P = B * NB + 3
    q, k_pool, v_pool = (
        jnp.asarray(rng.normal(size=shape).astype(np.float32), jnp.bfloat16)
        for shape in ((B, H, 1, D), (P, KH, page, D), (P, KH, page, D))
    )
    bt = rng.permutation(P)[: B * NB].reshape(B, NB).astype(np.int32)
    positions = np.asarray([5, 100, 300, 511], np.int32)
    for b, pos in enumerate(positions):
        bt[b, pos // page + 1 :] = P + b
    return q, k_pool, v_pool, bt, positions


def _paged_jax_and_port(inputs, window, active):
    """(JAX output, port plain-twin output, port inputs as f32 torch
    tensors) on the same bf16 values."""
    q, k_pool, v_pool, bt, positions = inputs
    act = None if active is None else np.asarray(active)
    ref = jattn.paged_gqa_decode_attention(
        q, k_pool, v_pool, jnp.asarray(bt), jnp.asarray(positions),
        active=None if act is None else jnp.asarray(act), window=window,
    )
    f32 = [_t(np.asarray(x.astype(jnp.float32))) for x in (q, k_pool, v_pool)]
    out = paged_gqa_decode_attention(
        *(x.to(torch.bfloat16) for x in f32), _t(bt), _t(positions),
        active=None if act is None else _t(act), window=window,
    )
    return _t(np.asarray(ref.astype(jnp.float32))), out, f32


@pytest.mark.parametrize("window", [None, 150])
@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_paged_decode_plain_matches_jax_bf16(paged_bf16_inputs, window, active):
    """bf16 pools: the plain twin rounds P to bf16 before P.V, as the JAX
    loop does (``p.astype(v_blk.dtype)``), and so stays within one bf16
    rounding of the JAX output; with an f32 P.V it read ~12 of this bound."""
    ref, out, _ = _paged_jax_and_port(paged_bf16_inputs, window, active)
    assert out.dtype == torch.bfloat16
    diff = (out.float() - ref).abs()
    ratio = float((diff / (2.0 ** -8 * ref.abs() + 1e-4)).max())
    print(f"window={window} active={active}: worst err/bound {ratio:.3f}, "
          f"max abs err {float(diff.max()):.3e}")
    assert ratio <= 1.0


@pytest.mark.parametrize("window", [None, 150])
@pytest.mark.parametrize("active", [None, [True, False, True, True]])
def test_paged_bf16_bound_holds_for_jax(paged_bf16_inputs, window, active):
    """The bound the bf16 paged kernels are held to on the card is one the
    JAX function itself meets: run in bf16, it stays within
    ``paged_bf16_bound`` of the port's f32 plain twin on the same values."""
    out, _, (q, k_pool, v_pool) = _paged_jax_and_port(paged_bf16_inputs, window, active)
    _, _, _, bt, positions = paged_bf16_inputs
    act = None if active is None else _t(np.asarray(active))
    args = (q, k_pool, v_pool, _t(bt), _t(positions))
    ref = paged_gqa_decode_attention(*args, active=act, window=window)
    bound = paged_bf16_bound(*args, ref, active=act, window=window)
    ratio = float(((out - ref).abs() / bound).max())
    print(f"window={window} active={active}: JAX bf16 worst err/bound {ratio:.3f}")
    assert ratio <= 1.0


def test_paged_decode_refuses_fp8():
    """An fp8 pool is served now (the dequant read and the in-dot scheme,
    each equal to the JAX function within f32 summation order); what is
    still refused is the JAX refusal: ``fp8_dot`` on a pool that is not fp8
    raises naming fp8."""
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 4, 1, 16)).astype(np.float32)
    k = rng.normal(size=(6, 2, 8, 16)).astype(np.float32)
    v = rng.normal(size=(6, 2, 8, 16)).astype(np.float32)
    bt = np.asarray([[4, 1, 6], [0, 2, 3]], np.int32)  # 6: a sentinel
    pos = np.asarray([13, 20], np.int32)
    jk, jv = (jnp.asarray(a).astype(jnp.float8_e4m3fn) for a in (k, v))
    tk, tv = (_t(np.asarray(a.astype(jnp.float32))).to(torch.float8_e4m3fn) for a in (jk, jv))
    for fp8_dot in (False, True):
        want = np.asarray(jattn.paged_gqa_decode_attention(
            jnp.asarray(q), jk, jv, jnp.asarray(bt), jnp.asarray(pos), fp8_dot=fp8_dot))
        got = paged_gqa_decode_attention(_t(q), tk, tv, _t(bt), _t(pos), fp8_dot=fp8_dot)
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=0)
    with pytest.raises(ValueError, match="fp8"):
        paged_gqa_decode_attention(_t(q), _t(k), _t(v), _t(bt), _t(pos), fp8_dot=True)


# ------------------------------------------------------------------ sampling
@pytest.fixture(scope="module")
def logits_big():
    rng = np.random.default_rng(3)
    B, V = 6, 20_000  # >= 16384: the hierarchical top-k runs; V % 128 != 0 pads
    return (rng.normal(size=(B, V)) * 3).astype(np.float32)


def test_top_k_hierarchical_matches_jax(logits_big):
    vals_j, idx_j = jsampling.top_k_hierarchical(jnp.asarray(logits_big), 50)
    vals_t, idx_t = top_k_hierarchical(_t(logits_big), 50)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))


@pytest.mark.parametrize("top_k", [50, 0])
def test_sample_logits_matches_jax_with_shared_gumbel(logits_big, top_k):
    """Greedy rows exact; sampled rows identical when the port gets the very
    noise ``jax.random.categorical`` draws: gumbel(key, (B, k) or (B, V))."""
    B, V = logits_big.shape
    temps = np.asarray([0.0, 0.7, 0.0, 1.0, 1.3, 0.0], np.float32)
    top_ps = np.asarray([0.9, 0.9, 0.95, 0.95, 1.0, 1.0], np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        ref = jsampling.sample_logits(
            jnp.asarray(logits_big), key, temperature=jnp.asarray(temps), top_k=top_k,
            top_p=jnp.asarray(top_ps),
        )
        noise = jax.random.gumbel(key, (B, top_k if top_k else V), jnp.float32)
        out = sample_logits(
            _t(logits_big), temperature=_t(temps), top_k=top_k, top_p=_t(top_ps),
            gumbel=_t(np.array(noise)),
        )
        np.testing.assert_array_equal(out.numpy(), np.asarray(ref))
        assert out.dtype == torch.int32


def test_sample_logits_generator_draws_in_vocab(logits_big):
    gen = torch.Generator().manual_seed(0)
    out = sample_logits(_t(logits_big), temperature=1.0, top_k=50, top_p=0.9, generator=gen)
    assert out.shape == (logits_big.shape[0],)
    assert bool(((out >= 0) & (out < logits_big.shape[1])).all())


# ------------------------------------------------------------------ norms, rope
def test_rms_norm_and_rope_match_jax():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    w = rng.normal(size=(16,)).astype(np.float32)
    np.testing.assert_allclose(
        rms_norm(_t(x), _t(w), 1e-5).numpy(), np.asarray(jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5)),
        atol=1e-6,
    )
    for scaling in (None, (8.0, 1.0, 4.0, 64.0), ("linear", 2.0)):
        cos_j, sin_j = jrope.rope_frequencies(16, 64, 10_000.0, scaling=scaling)
        cos_t, sin_t = rope_frequencies(16, 64, 10_000.0, scaling=scaling)
        np.testing.assert_array_equal(cos_t, cos_j)
        np.testing.assert_array_equal(sin_t, sin_j)
    cos, sin = rope_frequencies(16, 5, 10_000.0)
    ref = jrope.apply_rope(jnp.asarray(x), jnp.asarray(cos), jnp.asarray(sin))
    out = apply_rope(_t(x), _t(cos), _t(sin))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-6)
