"""Weight-only int8 / grouped int4 in the port (``ops/quant.py``,
``init_int8``/``init_int4``, QTensor bridging, ``quantize`` specs) against
the JAX package on the CPU, tiny geometry.

- The quantizers give the JAX quantizers' bytes (q and scale bit-equal).
- ``qeinsum_plain`` is within 1e-5 of the JAX ``qeinsum`` in f32 at every
  pattern the model uses; in bf16 the JAX function and the port's twin both
  stay inside ``qgemm_bf16_bound`` of the f32 result (int8 at K up to
  14336), the bound the card holds the qgemm kernel to, and that bound
  catches a dropped 16-row step of K at int8.
- Prefill logits through ``params_from_jax`` of quantized JAX trees within
  1e-4 of the JAX ``llama.prefill``; the engine's greedy ids equal the JAX
  engine's at int8 and int4, ``decode_steps`` 1 and 4, piggyback on.
- The registry's ``quantize`` checks carry the JAX messages; a quantized
  spec serves ``/dialog/``; ``weight_bits`` reads 16 / 8 / 4 in the stats,
  ``/healthz`` and the ``dabt_weight_bits`` gauge.
"""

import asyncio

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops import quant as jq
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch import kernels
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama
from django_assistant_bot_tpu_torch.ops import quant as tq
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine, ModelRegistry
from django_assistant_bot_tpu_torch.serving.registry import ModelSpec, _apply_quantize

PATTERNS = ["bse,eo->bso", "bse,ef->bsf", "bsf,fe->bse", "bso,oe->bse", "...e,ev->...v"]
# int4 groups of 16 and 64; SMALL_GROUPS only the generic qgemm route takes
FORMATS = [("int8", 0), ("int4", 16), ("int4", 64)]
SMALL_GROUPS = [("int4", 8), ("int4", 4), ("int4", 2)]


def _quantize_pair(w: np.ndarray, fmt: str, g: int):
    if fmt == "int8":
        return jq.quantize_tensor(jnp.asarray(w)), tq.quantize_tensor(torch.from_numpy(w))
    return (jq.quantize_tensor_int4(jnp.asarray(w), g),
            tq.quantize_tensor_int4(torch.from_numpy(w), g))


# ------------------------------------------------------------ quantizers
@pytest.mark.parametrize("fmt,g", FORMATS + SMALL_GROUPS)
@pytest.mark.parametrize("shape", [(64, 48), (3, 128, 32)])
def test_quantizers_bit_equal_to_jax(fmt, g, shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    ja, tb = _quantize_pair(w, fmt, g)
    assert tb.q.dtype == (torch.int8 if fmt == "int8" else torch.uint8)
    assert np.array_equal(np.asarray(ja.q), tb.q.numpy())
    assert np.array_equal(np.asarray(ja.scale), tb.scale.numpy())
    assert tb.scale.dtype == torch.float32
    if fmt == "int4":
        assert tb.group_size == ja.group_size == g


@pytest.mark.parametrize("dim,g", [(24, 64), (24, 10), (64, 16), (96, 64), (4096, 128), (6, 3)])
def test_int4_group_clamps_like_jax(dim, g):
    assert tq._int4_group(dim, g) == jq._int4_group(dim, g)
    w = np.random.default_rng(3).normal(size=(dim, 8)).astype(np.float32)
    assert tq.quantize_tensor_int4(w, g).group_size == jq.quantize_tensor_int4(w, g).group_size
    with pytest.raises(ValueError, match="even contraction dim"):
        tq._int4_group(7, g)


def test_pack_unpack_int4_roundtrip_and_jax_bytes():
    vals = np.random.default_rng(1).integers(-8, 8, (5, 10, 7)).astype(np.int8)
    packed = tq.pack_int4(vals)
    assert packed.dtype == np.uint8 and packed.shape == (5, 5, 7)
    assert np.array_equal(packed, jq.pack_int4(vals))
    back = tq.unpack_int4(torch.from_numpy(packed))
    assert back.dtype == torch.int8 and np.array_equal(back.numpy(), vals)
    assert np.array_equal(back.numpy(), np.asarray(jq.unpack_int4(jnp.asarray(packed))))
    with pytest.raises(ValueError, match="even"):
        tq.pack_int4(vals[:, :3])


# ------------------------------------------------------------ qeinsum
def _x_for(pattern, K, rng):
    shape = (3, K) if pattern.startswith("...") else (2, 5, K)
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("fmt,g", FORMATS + SMALL_GROUPS)
@pytest.mark.parametrize("pattern", PATTERNS)
def test_qeinsum_plain_matches_jax_f32(pattern, fmt, g):
    rng = np.random.default_rng(4)
    K, N = 128, 48
    ja, tb = _quantize_pair(rng.normal(size=(K, N)).astype(np.float32), fmt, g)
    x = _x_for(pattern, K, rng)
    want = np.asarray(jq.qeinsum(pattern, jnp.asarray(x), ja, jnp.float32))
    got = tq.qeinsum(pattern, torch.from_numpy(x), tb, torch.float32)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert np.abs(got.numpy() - want).max() <= 1e-5
    # the device router sends a CPU tensor to the twin
    assert torch.equal(got, tq.qeinsum_plain(pattern, torch.from_numpy(x), tb, torch.float32))


def test_qeinsum_outside_the_projection_contract_dequantizes_like_jax():
    """A pattern whose weight does not contract on axis -2 takes the
    dequantized weight (JAX ``qeinsum`` :184-187)."""
    rng = np.random.default_rng(5)
    ja, tb = _quantize_pair(rng.normal(size=(48, 64)).astype(np.float32), "int4", 16)
    x = rng.normal(size=(2, 5, 48)).astype(np.float32)
    pattern = "bso,oe->bse"  # contraction on w's axis -2: the group path
    want = np.asarray(jq.qeinsum(pattern, jnp.asarray(x), ja, jnp.float32))
    got = tq.qeinsum(pattern, torch.from_numpy(x), tb, torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5
    pattern = "bse,oe->bso"  # w [O, E] contracted on its last axis: deq
    x2 = rng.normal(size=(2, 5, 64)).astype(np.float32)
    want = np.asarray(jq.qeinsum(pattern, jnp.asarray(x2), ja, jnp.float32))
    got = tq.qeinsum(pattern, torch.from_numpy(x2), tb, torch.float32).numpy()
    assert np.abs(got - want).max() <= 1e-5
    assert np.abs(tq.deq(tb, torch.float32).numpy() - np.asarray(jq.deq(ja, jnp.float32))).max() == 0


def _bf16_meets_the_bound(M, K, N, fmt, g, seed, bitwise=True):
    """The JAX ``qeinsum`` in bf16 and the port's twin (equal to it bit for
    bit, or with ``bitwise`` off within one bf16 ulp of it) inside
    ``qgemm_bf16_bound`` of the f32 result on the same bf16 inputs."""
    rng = np.random.default_rng(seed)
    ja, tb = _quantize_pair(rng.normal(size=(K, N)).astype(np.float32), fmt, g)
    xb = jnp.asarray(rng.normal(size=(M, K)).astype(np.float32)).astype(jnp.bfloat16)
    xf = torch.tensor(np.asarray(xb.astype(jnp.float32)))
    ref = tq.qeinsum_plain("me,eo->mo", xf, tb, torch.float32)
    bound = tq.qgemm_bf16_bound(xf, tb, ref)
    jax_bf16 = torch.tensor(
        np.asarray(jq.qeinsum("me,eo->mo", xb, ja, jnp.bfloat16).astype(jnp.float32)))
    port_bf16 = tq.qeinsum_plain("me,eo->mo", xf.bfloat16(), tb, torch.bfloat16)
    assert port_bf16.dtype == torch.bfloat16
    assert bool(((jax_bf16 - ref).abs() <= bound).all())
    assert bool(((port_bf16.float() - ref).abs() <= bound).all())
    if bitwise:
        assert torch.equal(port_bf16.float(), jax_bf16)
    else:
        # one bf16 ulp of v is at most 2^-7 |v|
        assert bool(((port_bf16.float() - jax_bf16).abs() <= 2.0 ** -7 * jax_bf16.abs()).all())


@pytest.mark.parametrize("fmt,g", FORMATS)
@pytest.mark.parametrize("M", [1, 8, 37])
def test_bf16_qeinsum_meets_the_kernel_bound(M, fmt, g):
    """The bound ``chip_smoke.py`` and the card tests hold the kernel to
    (``2^-6 |ref| + 2^-12 A + 1e-4`` at int8, ``2^-7 |ref| + 2^-8 A + 1e-4``
    at int4) holds for the JAX function itself."""
    _bf16_meets_the_bound(M, 512, 96, fmt, g, seed=M)


@pytest.mark.parametrize("fmt,g", SMALL_GROUPS)
@pytest.mark.parametrize("M", [1, 8, 37])
def test_bf16_qeinsum_at_small_groups_meets_the_kernel_bound(M, fmt, g):
    """The kernel bound at the groups only the generic route takes, for the
    JAX function and the port's twin; at 256 groups a row (g = 2) the two
    sum the groups' f32 products in another order, so the twin is held to
    one bf16 ulp of the JAX result, not to its bits."""
    _bf16_meets_the_bound(M, 512, 96, fmt, g, seed=M, bitwise=False)


@pytest.mark.parametrize("K", [4096, 14336])
def test_bf16_int8_qeinsum_meets_its_bound_at_the_model_depths(K):
    """The int8 bound's ``2^-12 A`` summation term at the contraction depths
    of Llama-3-8B's projections (4096, and 14336 for ``w_down``)."""
    _bf16_meets_the_bound(8, K, 64, "int8", 0, seed=K)


@pytest.mark.parametrize("M", [1, 8, 37])
def test_group_24_quantizer_qeinsum_and_bound_match_jax(M):
    """int4 at group 24 (the width 96 allows it): the quantizer's bytes, the
    f32 ``qeinsum`` within 1e-5 of JAX's, and the JAX bf16 function inside
    ``qgemm_bf16_bound``."""
    rng = np.random.default_rng(24 + M)
    w = rng.normal(size=(96, 40)).astype(np.float32)
    ja, tb = _quantize_pair(w, "int4", 24)
    assert tb.group_size == ja.group_size == 24
    assert np.array_equal(np.asarray(ja.q), tb.q.numpy())
    assert np.array_equal(np.asarray(ja.scale), tb.scale.numpy())
    x = rng.normal(size=(M, 96)).astype(np.float32)
    want = np.asarray(jq.qeinsum("me,eo->mo", jnp.asarray(x), ja, jnp.float32))
    got = tq.qeinsum("me,eo->mo", torch.from_numpy(x), tb, torch.float32)
    assert np.abs(got.numpy() - want).max() <= 1e-5
    _bf16_meets_the_bound(M, 96, 40, "int4", 24, seed=M)


def test_the_int8_bound_sees_a_dropped_k_step():
    """The int8 bound is tight enough to catch a kernel that skips one
    16-row step of K (the unit of its ``mma.sync`` loop) at K = 4096."""
    rng = np.random.default_rng(6)
    K, N = 4096, 64
    _, tb = _quantize_pair(rng.normal(size=(K, N)).astype(np.float32), "int8", 0)
    x = torch.from_numpy(rng.normal(size=(8, K)).astype(np.float32)).bfloat16().float()
    ref = tq.qeinsum_plain("me,eo->mo", x, tb, torch.float32)
    dropped = x.clone()
    dropped[:, 1024:1040] = 0
    wrong = tq.qeinsum_plain("me,eo->mo", dropped.bfloat16(), tb, torch.bfloat16).float()
    outside = (wrong - ref).abs() > tq.qgemm_bf16_bound(x, tb, ref)
    assert outside.float().mean().item() > 0.5


def test_num_weights_and_weight_bits_like_jax():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    q8, q4 = tq.quantize_decoder_params(params), tq.quantize_decoder_params(params, "int4", 16)
    for key in tq.QUANTIZABLE:
        assert isinstance(q8["layers"][key], tq.QTensor)
        assert isinstance(q4["layers"][key], tq.QTensor4)
    assert tq.num_weights(q4) == tq.num_weights(q8) == tq.num_weights(params)
    assert tq.num_weights(params) == jq.num_weights(jparams)
    assert tq.num_weights(q4) == jq.num_weights(jq.quantize_decoder_params(jparams, "int4", 16))
    assert (tq.weight_bits(params), tq.weight_bits(q8), tq.weight_bits(q4)) == (16, 8, 4)
    with pytest.raises(ValueError, match="format"):
        tq.quantize_decoder_params(params, fmt="int2")
    # the stacked leaves were quantized a layer at a time: the JAX bytes
    jq4 = jq.quantize_decoder_params(jparams, "int4", 16)["layers"]["w_down"]
    assert np.array_equal(np.asarray(jq4.q), q4["layers"]["w_down"].q.numpy())
    assert np.array_equal(np.asarray(jq4.scale), q4["layers"]["w_down"].scale.numpy())


def test_layer_slices_q_and_scale():
    params = llama.init_int4(DecoderConfig.tiny(), torch.Generator().manual_seed(0), "cpu",
                             group_size=16)
    for l in range(2):
        p = llama._layer(params, l)
        for key in tq.QUANTIZABLE:
            w, full = p[key], params["layers"][key]
            assert isinstance(w, tq.QTensor4) and w.q.dim() == 2
            assert torch.equal(w.q, full.q[l]) and torch.equal(w.scale, full.scale[l])
            assert w.group_size == 16
        assert torch.equal(p["attn_norm"], params["layers"]["attn_norm"][l])


def test_synthetic_inits_shapes_scales_and_seed():
    cfg = DecoderConfig.tiny()
    E, F = cfg.hidden_size, cfg.intermediate_size
    p8 = llama.init_int8(cfg, torch.Generator().manual_seed(0), "cpu")
    p4 = llama.init_int4(cfg, torch.Generator().manual_seed(0), "cpu", group_size=16)
    wq8, wd4 = p8["layers"]["wq"], p4["layers"]["w_down"]
    assert wq8.q.dtype == torch.int8 and wq8.q.shape == (2, E, cfg.num_heads * cfg.head_dim)
    assert wq8.scale.shape == (2, 1, cfg.num_heads * cfg.head_dim)
    assert int(wq8.q.min()) >= -127
    assert torch.all(wq8.scale == E ** -0.5 / llama.UNIFORM8_STD)
    assert wd4.q.dtype == torch.uint8 and wd4.q.shape == (2, F // 2, E)
    assert wd4.scale.shape == (2, F // 16, E)
    assert torch.all(wd4.scale == np.float32(F ** -0.5 / llama.UNIFORM4_STD))
    # the JAX recipe's constants
    j8 = jllama.init_int8(JaxDecoderConfig.tiny(), jax.random.key(0), host_rng=True)
    assert np.asarray(j8["layers"]["wq"].scale).ravel()[0] == wq8.scale.ravel()[0].item()
    again = llama.init_int8(cfg, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(again["layers"]["w_up"].q, p8["layers"]["w_up"].q)
    assert p8["tok_embed"].dtype == cfg.dtype and p8["lm_head"].shape == (E, cfg.vocab_size)
    pe = llama.init_int8(cfg, torch.Generator().manual_seed(0), "cpu", quantize_embed=True)
    assert isinstance(pe["tok_embed"], tq.QTensor) and pe["tok_embed"].scale.shape == (1, E)
    assert isinstance(pe["lm_head"], tq.QTensor)


# ------------------------------------------------------------ the model
def _jax_trees():
    jcfg = JaxDecoderConfig.tiny()
    key = jax.random.key(0)
    dense = jllama.init(jcfg, key)
    return jcfg, {
        "init_int8": jllama.init_int8(jcfg, key, host_rng=True),
        "init_int4": jllama.init_int4(jcfg, key, group_size=16, host_rng=True),
        "init_int4_g8": jllama.init_int4(jcfg, key, group_size=8, host_rng=True),
        "quantize_int8": jq.quantize_decoder_params(dense),
        "quantize_int4": jq.quantize_decoder_params(dense, "int4", 16),
        "init_int8_embed": jllama.init_int8(jcfg, key, quantize_embed=True, host_rng=True),
    }


@pytest.fixture(scope="module")
def jax_trees():
    return _jax_trees()


@pytest.mark.parametrize("which", ["init_int8", "init_int4", "quantize_int8", "quantize_int4",
                                   "init_int8_embed", "init_int4_g8"])
def test_params_from_jax_prefill_matches_jax(jax_trees, which):
    jcfg, trees = jax_trees
    jparams = trees[which]
    cfg = DecoderConfig.tiny()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    for key in tq.QUANTIZABLE:
        leaf, jleaf = params["layers"][key], jparams["layers"][key]
        assert type(leaf).__name__ == type(jleaf).__name__
        assert np.array_equal(leaf.q.numpy(), np.asarray(jleaf.q))
    ids = np.random.default_rng(2).integers(1, 255, (2, 32)).astype(np.int32)
    lengths = np.array([32, 19], np.int32)
    want, _, _ = jllama.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths))
    got, _, _ = llama.prefill(params, cfg, torch.from_numpy(ids), torch.from_numpy(lengths))
    assert np.abs(got.numpy() - np.asarray(want)).max() <= 1e-4


def test_embed_and_tied_head_of_an_int8_table_match_jax():
    """int8 tables: the gathered rows dequantized (``_embed``), and a tied
    head whose per-E scales land on x (the CPU path; the card takes it on
    the qgemm kernel's K-contiguous form, so the build check accepts it)."""
    import dataclasses

    jcfg = dataclasses.replace(JaxDecoderConfig.tiny(), tie_embeddings=True)
    cfg = dataclasses.replace(DecoderConfig.tiny(), tie_embeddings=True)
    jparams = jllama.init_int8(jcfg, jax.random.key(1), quantize_embed=True, host_rng=True)
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    assert "lm_head" not in params and isinstance(params["tok_embed"], tq.QTensor)
    ids = np.array([[3, 9, 200, 511]], np.int32)
    want = np.asarray(jllama._embed(jparams, jcfg, jnp.asarray(ids)))
    got = llama._embed(params, cfg, torch.from_numpy(ids))
    assert np.abs(got.numpy() - want).max() == 0
    x = np.random.default_rng(3).normal(size=(2, cfg.hidden_size)).astype(np.float32)
    want = np.asarray(jllama._head_logits(jparams, jcfg, jnp.asarray(x)))
    got = llama._head_logits(params, cfg, torch.from_numpy(x))
    assert np.abs(got.numpy() - want).max() <= 1e-5
    assert tq.check_kernel_params(params, cfg.dtype) is None


def _crank(eng, futs, limit=2000):
    for _ in range(limit):
        if all(f.done() for f in futs):
            return
        eng._loop_iteration()
    raise AssertionError("requests did not finish within the crank budget")


def _trace(eng, early, late):
    eng._running = True
    futs = [eng.submit(p, max_tokens=10, temperature=0.0) for p in early]
    for _ in range(2):
        eng._loop_iteration()
    futs += [eng.submit(p, max_tokens=10, temperature=0.0) for p in late]
    _crank(eng, futs)
    eng._running = False
    return [f.result(timeout=0).token_ids for f in futs], eng.decode_path_stats()


@pytest.mark.parametrize("decode_steps", [1, 4])
@pytest.mark.parametrize("which", ["init_int8", "init_int4", "init_int4_g8"])
def test_engine_greedy_ids_identical_to_jax_engine(jax_trees, which, decode_steps):
    jcfg, trees = jax_trees
    jparams = trees[which]
    cfg = DecoderConfig.tiny()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    rng = np.random.default_rng(7)
    early = [rng.integers(1, 255, n).tolist() for n in (9, 40, 20)]
    late = [rng.integers(1, 255, n).tolist() for n in (150, 70)]  # chunks of 64
    kw = dict(max_slots=4, max_seq_len=256, chunk_size=64, decode_steps=decode_steps,
              prefill_piggyback=True)
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                               scheduler=None, prefix_cache_size=0, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    want, _ = _trace(jeng, early, late)
    got, dec = _trace(teng, early, late)
    assert got == want
    assert dec["prefill_chunks_piggybacked"] > 0
    assert dec["weight_bits"] == jeng.weight_bits == (8 if which == "init_int8" else 4)
    if which == "init_int4_g8":
        assert params["layers"]["wq"].group_size == 8


# ------------------------------------------------------------ kernel routing
def test_kernel_refusal_and_engine_build_check():
    """What no qgemm route takes is named before any step runs (activations
    that are neither f32 nor bf16, a weight that is not 2-D); the int4
    groups and widths the JAX package serves but the tensor-core kernels do
    not take (group 24, in 40) now route to the generic kernel, and the
    engine's build check passes them."""
    rng = np.random.default_rng(8)
    ok = tq.quantize_tensor_int4(rng.normal(size=(64, 32)).astype(np.float32), 32)
    assert tq.kernel_refusal(ok, torch.bfloat16) is None
    assert tq.kernel_refusal(ok, torch.float32) is None
    assert "float32 or bfloat16" in tq.kernel_refusal(ok, torch.float16)
    odd = tq.quantize_tensor_int4(rng.normal(size=(48, 32)).astype(np.float32), 24)
    assert odd.group_size == 24
    assert tq.kernel_refusal(odd, torch.bfloat16) is None
    assert kernels.qgemm_route(torch.bfloat16, 8, 32, 48, 24) == "generic"
    narrow = tq.quantize_tensor(rng.normal(size=(40, 32)).astype(np.float32))
    assert tq.kernel_refusal(narrow, torch.bfloat16) is None
    assert kernels.qgemm_route(torch.bfloat16, 8, 32, 40, 0) == "generic"
    stacked = tq.quantize_tensor(rng.normal(size=(2, 64, 32)).astype(np.float32))
    assert "2-D" in tq.kernel_refusal(stacked, torch.bfloat16)
    cfg = DecoderConfig.tiny()
    params = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    params["layers"]["wq"] = tq.quantize_tensor_int4(
        rng.normal(size=(2, 48, 32)).astype(np.float32), 24)
    assert tq.check_kernel_params(params, cfg.dtype) is None
    with pytest.raises(ValueError, match="layers.wq: .*float32 or bfloat16"):
        tq.check_kernel_params(params, torch.float16)
    dense = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    tq.check_kernel_params(tq.quantize_decoder_params(dense, "int4", 32), cfg.dtype)
    tq.check_kernel_params(tq.quantize_decoder_params(dense), cfg.dtype)


LLAMA_PROJECTIONS = [(4096, 4096), (4096, 1024), (4096, 14336), (14336, 4096)]


@pytest.mark.parametrize("bits,g", [(8, 0), (4, 64), (4, 128)])
@pytest.mark.parametrize("M", [1, 8, 16, 37, 65, 512, 2048])
@pytest.mark.parametrize("K,N", LLAMA_PROJECTIONS + [(4096, 128256), (4096, 1040), (4096, 1032)])
def test_qgemm_plan_covers_k_on_group_boundaries(K, N, M, bits, g):
    mt, warps_m, ksplit, kchunk = kernels.qgemm_plan(M, N, K, bits, g)
    blocks = kernels.qgemm_tiles(M, N, mt, warps_m) * ksplit
    if warps_m == 8:  # the wgmma kernel: 128 x 128 outputs a block, K split on 64-row tiles
        assert M > 64 and N % 16 == 0 and mt == 2
        assert kchunk % 64 == 0 and kchunk % (g or 16) == 0  # splits end on group boundaries
        assert ksplit * kchunk >= K  # the splits cover K
        assert (ksplit - 1) * kchunk < K  # and none is empty
        assert ksplit == 1 or ksplit * M * N <= kernels.QGEMM_PARTIAL_FLOATS
        if M == 512 and (K, N) in LLAMA_PROJECTIONS and g in (0, 64):
            # the grid fills the card: 128 tiles (wq/wo, down) leave 4 SMs
            # idle, as a split of them costs more in partials than it
            # saves (PERF.md section 6); wk/wv's 32 tiles split 4 ways
            assert blocks >= 0.95 * 132
        return
    assert M <= 64 or N % 16  # past 64 rows only a width TMA cannot take stays here
    kw = 4 // warps_m
    assert 8 * mt * warps_m >= min(M, 16) and warps_m in (1, 4) and mt in (1, 2, 4)
    assert kchunk % (g or 16) == 0 and kchunk % 16 == 0
    assert ksplit * kw * kchunk >= K  # the splits cover K
    assert (ksplit - 1) * kw * kchunk < K  # and no block's range is empty
    assert ksplit == 1 or blocks <= 4 * 132
    # the f32 partials stay under a quarter of the weight bytes
    assert ksplit == 1 or ksplit * M * N * 8 <= K * N * bits / 8 / 4


def test_qgemm_plan_takes_the_direct_load_kernel_off_tma_boundaries():
    """A pointer off 16 bytes keeps a prefill call on the direct-load
    kernel: TMA takes 16-byte aligned bases only."""
    assert kernels.qgemm_plan(512, 4096, 4096, 8, 0)[1] == 8
    assert kernels.qgemm_plan(512, 4096, 4096, 8, 0, tma=False)[1] == 4


# ------------------------------------------------------------ registry
@pytest.mark.parametrize("spec,match", [
    ({"quantize": "int2"}, "unknown quantize"),
    ({"quantize": "int4", "quant_group_size": 7}, "quant_group_size must be an even int"),
    ({"quantize": "int4", "quant_group_size": 0}, "quant_group_size must be an even int"),
    ({"kind": "encoder", "quantize": "int8"}, "decoder-only"),
])
def test_registry_refuses_bad_quantize_specs(spec, match):
    from django_assistant_bot_tpu.serving.registry import ModelRegistry as JaxModelRegistry
    from django_assistant_bot_tpu.serving.registry import ModelSpec as JaxModelSpec

    full = {"kind": "decoder", "tiny": True, **spec}
    with pytest.raises(ValueError, match=match):
        ModelRegistry.from_config({"m": full}, device="cpu")
    # the same spec built directly, then loaded: the JAX registry's check and message
    direct = ModelSpec(name="m", device="cpu", **full)
    with pytest.raises(ValueError, match=match) as port_err:
        ModelRegistry().load(direct)
    with pytest.raises(ValueError, match=match) as jax_err:
        JaxModelRegistry().load(JaxModelSpec(name="m", **full))
    assert str(port_err.value) == str(jax_err.value)


def test_apply_quantize_no_op_and_mismatch_rules():
    cfg = DecoderConfig.tiny()
    dense = llama.init(cfg, torch.Generator().manual_seed(0), "cpu")
    q4 = tq.quantize_decoder_params(dense, "int4", 32)
    spec4 = ModelSpec(name="m", tiny=True, quantize="int4", quant_group_size=32)
    assert _apply_quantize(spec4, q4) is q4
    assert _apply_quantize(ModelSpec(name="m", quantize="int4"), q4) is q4  # group kept
    with pytest.raises(ValueError, match="already quantized \\(int4\\)"):
        _apply_quantize(ModelSpec(name="m", quantize="int8"), q4)
    q8 = _apply_quantize(ModelSpec(name="m", quantize="int8"), dense)
    assert tq.weight_bits(q8) == 8 and tq.weight_bits(dense) == 16


def test_quantized_specs_serve_dialog_and_report_weight_bits():
    """Three tiny specs (dense, int8, int4) in one registry behind the app:
    each serves ``/dialog/``; ``weight_bits`` reads 16 / 8 / 4 in the
    engine's stats, ``/healthz`` and the ``dabt_weight_bits`` gauge."""
    from aiohttp.test_utils import TestClient, TestServer

    from django_assistant_bot_tpu_torch.serving.obs import parse_prometheus_text
    from django_assistant_bot_tpu_torch.serving.server import create_app

    base = {"tiny": True, "max_slots": 2, "max_seq_len": 64}
    registry = ModelRegistry.from_config({
        "dense": base,
        "q8": {**base, "quantize": "int8"},
        "q4": {**base, "quantize": "int4", "quant_group_size": 16},
    }, device="cpu")
    want = {"dense": 16, "q8": 8, "q4": 4}
    for name, bits in want.items():
        eng = registry.get_generator(name)
        assert eng.weight_bits == bits and eng.tick_stats()["weight_bits"] == bits
    assert registry.get_generator("q4").params["layers"]["wq"].group_size == 16

    async def go():
        client = TestClient(TestServer(create_app(registry)))
        await client.start_server()
        try:
            for name in want:
                resp = await client.post("/dialog/", json={
                    "model": name, "messages": [{"role": "user", "content": "hi"}],
                    "max_tokens": 3})
                assert resp.status == 200, name
                assert (await resp.json())["response"]["usage"]["completion_tokens"] >= 1
            health = await (await client.get("/healthz")).json()
            fams = parse_prometheus_text(await (await client.get("/metrics")).text())
            return health, fams
        finally:
            await client.close()

    try:
        health, fams = asyncio.run(go())
    finally:
        registry.stop()
    assert {n: g["weight_bits"] for n, g in health["generators"].items()} == want
    gauge = {lab["model"]: v for _, lab, v in fams["dabt_weight_bits"]["samples"]}
    assert gauge == {n: float(b) for n, b in want.items()}
