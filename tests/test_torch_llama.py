"""The port's decoder against the JAX package's, weights bridged through
``convert.params_from_jax`` at the tiny geometry (f32, CPU):

- ``prefill`` logits and K/V;
- ``insert_sequences_paged`` with pad rows and blocks past a row's
  allocation (the drop sentinels): pools equal, every other page untouched;
- ``prefill_chunk_paged`` and ``decode_step_paged`` (inactive rows and a row
  past its allocation write nowhere): logits within 1e-4, pools equal;
- ``load_decoder`` on a ``models/synth.py`` checkpoint against the JAX loader.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig, llama


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


L, KH, D = 2, 2, 16  # tiny geometry
PAGE, NB = 32, 8  # S = 256 = tiny max_seq_len


def _pools(seed: int, P: int):
    rng = np.random.default_rng(seed)
    k = rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32)
    v = rng.normal(size=(L, P, KH, PAGE, D)).astype(np.float32)
    return k, v


def _caches(k, v, lengths):
    """The same pool contents as a JAX PagedKVCache and as the port's (which
    carries one extra dump page at index P)."""
    jc = jllama.PagedKVCache(k=jnp.asarray(k), v=jnp.asarray(v), lengths=jnp.asarray(lengths))
    dump = np.full((L, 1, KH, PAGE, D), np.nan, np.float32)
    tc = llama.PagedKVCache(
        k=_t(np.concatenate([k, dump], axis=1)),
        v=_t(np.concatenate([v, dump], axis=1)),
        lengths=_t(lengths),
    )
    return jc, tc


def _assert_pools(jc, tc, written_atol):
    P = jc.k.shape[1]
    for jp, tp in ((jc.k, tc.k), (jc.v, tc.v)):
        np.testing.assert_allclose(tp[:, :P].numpy(), np.asarray(jp), atol=written_atol, rtol=0)
    np.testing.assert_array_equal(tc.lengths.numpy(), np.asarray(jc.lengths))


def test_prefill_matches_jax(models):
    jcfg, jparams, cfg, params = models
    rng = np.random.default_rng(1)
    ids = rng.integers(1, 255, (3, 64)).astype(np.int32)
    lengths = np.asarray([64, 40, 1], np.int32)
    lj, kj, vj = jllama.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths))
    lt, kt, vt = llama.prefill(params, cfg, _t(ids), _t(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    np.testing.assert_allclose(kt.numpy(), np.asarray(kj), atol=1e-4)
    np.testing.assert_allclose(vt.numpy(), np.asarray(vj), atol=1e-4)


def test_insert_sequences_paged_drops_like_jax():
    """A wave of 4 rows: one batch-pad row (slot and page sentinels) and one
    row whose allocation ends before the bucket (sentinel blocks) — identical
    ks/vs in, identical pools out, every untouched page untouched."""
    P = 20
    k, v = _pools(2, P)
    lengths = np.zeros((4,), np.int32)
    rng = np.random.default_rng(3)
    Sb = 64
    ks = rng.normal(size=(L, 4, KH, Sb, D)).astype(np.float32)
    vs = rng.normal(size=(L, 4, KH, Sb, D)).astype(np.float32)
    bt = np.full((4, NB), P, np.int32)
    bt[1, :2] = [7, 3]
    bt[2, :1] = [11]  # allocation of one page: block 1 of the bucket drops
    bt[3, :3] = [0, 19, 5]
    slots = np.asarray([4, 0, 2, 3], np.int32)  # row 0: pad (slot sentinel)
    row_lens = np.asarray([0, 64, 30, 50], np.int32)
    jc, tc = _caches(k, v, lengths)
    jc = jllama.insert_sequences_paged(
        jc, jnp.asarray(ks), jnp.asarray(vs), jnp.asarray(row_lens), jnp.asarray(slots), jnp.asarray(bt)
    )
    tc = llama.insert_sequences_paged(tc, _t(ks), _t(vs), _t(row_lens), _t(slots), _t(bt))
    _assert_pools(jc, tc, written_atol=0)
    untouched = sorted(set(range(P)) - {7, 3, 11, 0, 19, 5})
    np.testing.assert_array_equal(tc.k[:, untouched].numpy(), k[:, untouched])


def test_prefill_chunk_paged_matches_jax(models):
    jcfg, jparams, cfg, params = models
    P = 20
    k, v = _pools(4, P)
    lengths = np.asarray([0, 70, 0, 0], np.int32)
    rng = np.random.default_rng(5)
    ids = rng.integers(1, 255, (1, 64)).astype(np.int32)
    bt_row = np.full((NB,), P, np.int32)
    bt_row[:4] = [9, 2, 14, 6]
    slot, start, valid = 1, 70, 64
    jc, tc = _caches(k, v, lengths)
    lj, jc = jllama.prefill_chunk_paged(
        jparams, jcfg, jnp.asarray(ids), jc, jnp.asarray(bt_row),
        jnp.asarray(slot, jnp.int32), jnp.asarray(start, jnp.int32), jnp.asarray(valid, jnp.int32),
    )
    lt, tc = llama.prefill_chunk_paged(params, cfg, _t(ids), tc, _t(bt_row), slot, start, valid)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    _assert_pools(jc, tc, written_atol=1e-5)
    untouched = sorted(set(range(P)) - {14, 6})  # blocks 0-1 lie below start, block 4 is unallocated
    np.testing.assert_array_equal(tc.k[:, untouched].numpy(), k[:, untouched])


def test_prefill_chunk_paged_takes_device_tensors(models):
    """``slot`` and ``start`` as [1] tensors (the form a captured CUDA graph
    replays with new values) give the same logits and cache as ints."""
    _, _, cfg, params = models
    P = 20
    k, v = _pools(4, P)
    lengths = np.asarray([0, 70, 0, 0], np.int32)
    ids = np.random.default_rng(6).integers(1, 255, (1, 64)).astype(np.int32)
    bt_row = np.full((NB,), P, np.int32)
    bt_row[:4] = [9, 2, 14, 6]
    out = []
    for slot, start in ((1, 70), (torch.tensor([1]), torch.tensor([70]))):
        _, tc = _caches(k, v, lengths)
        logits, tc = llama.prefill_chunk_paged(params, cfg, _t(ids), tc, _t(bt_row), slot, start, 64)
        out.append((logits, tc.k[:, :P], tc.v[:, :P], tc.lengths))
    for a, b in zip(*out):
        assert torch.equal(a, b)
    assert out[0][3].tolist() == [0, 134, 0, 0]


@pytest.mark.parametrize("with_active", [False, True])
def test_decode_step_paged_matches_jax(models, with_active):
    """Ragged rows; row 2 has run past its allocation (sentinel block) and,
    with ``with_active``, row 3 is inactive: neither writes anywhere."""
    jcfg, jparams, cfg, params = models
    P = 24
    k, v = _pools(6, P)
    lengths = np.asarray([5, 40, 64, 200], np.int32)
    bt = np.full((4, NB), P, np.int32)
    bt[0, :1] = [3]
    bt[1, :2] = [8, 1]
    bt[2, :2] = [12, 13]  # position 64 -> block 2: unallocated, the write drops
    bt[3, :7] = [0, 2, 4, 6, 10, 14, 16]
    tokens = np.asarray([7, 11, 13, 17], np.int32)
    active = np.asarray([True, True, True, False]) if with_active else None
    jc, tc = _caches(k, v, lengths)
    lj, jc = jllama.decode_step_paged(
        jparams, jcfg, jnp.asarray(tokens), jc, jnp.asarray(bt),
        active=None if active is None else jnp.asarray(active),
    )
    lt, tc = llama.decode_step_paged(
        params, cfg, _t(tokens), tc, _t(bt), active=None if active is None else _t(active)
    )
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
    _assert_pools(jc, tc, written_atol=1e-5)
    written = {3, 1} | (set() if with_active else {16})
    untouched = sorted(set(range(P)) - written)
    np.testing.assert_array_equal(tc.k[:, untouched].numpy(), k[:, untouched])
    np.testing.assert_array_equal(tc.v[:, untouched].numpy(), v[:, untouched])


# ------------------------------------------------------------------ HF checkpoint
@pytest.fixture(scope="module")
def synth_dir(tmp_path_factory):
    pytest.importorskip("transformers")
    from django_assistant_bot_tpu.models.synth import synth_decoder

    return synth_decoder(str(tmp_path_factory.mktemp("synth")), max_seq_len=256)


def test_load_decoder_matches_jax_loader(synth_dir):
    from django_assistant_bot_tpu.models.hf_loader import load_decoder as jax_load
    from django_assistant_bot_tpu_torch.models.hf_loader import load_decoder
    from django_assistant_bot_tpu_torch.serving.tokenizer import HFTokenizer, load_tokenizer

    jcfg, jparams = jax_load(synth_dir, dtype=jnp.float32)
    cfg, params = load_decoder(synth_dir, dtype=torch.float32, device="cpu")
    jfields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    tfields = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg) if f.name != "dtype"}
    assert tfields == jfields
    tok = load_tokenizer(synth_dir)
    assert isinstance(tok, HFTokenizer)
    ids = np.asarray([tok.encode_chat([{"role": "user", "content": "the quick brown fox"}])], np.int32)
    lengths = np.asarray([ids.shape[1]], np.int32)
    lj, _, _ = jllama.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths))
    lt, _, _ = llama.prefill(params, cfg, _t(ids), _t(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)


@pytest.mark.parametrize("family", ["mistral", "qwen2", "gemma", "phi3", "mixtral"])
def test_load_decoder_families_match_jax_loader(family, tmp_path):
    """The family-specific mappings: Mistral's sliding window, Qwen2's qkv
    biases and max_window_layers split, Gemma's (1+w) norm fold, GeGLU,
    scaled and tied embeddings, Phi-3's fused projections, Mixtral's router
    and stacked experts."""
    transformers = pytest.importorskip("transformers")
    from django_assistant_bot_tpu.models.hf_loader import load_decoder as jax_load
    from django_assistant_bot_tpu_torch.models.hf_loader import load_decoder

    common = dict(
        vocab_size=300, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, max_position_embeddings=128,
    )
    config_cls, model_cls, extra = {
        "mistral": ("MistralConfig", "MistralForCausalLM", dict(sliding_window=16)),
        "qwen2": ("Qwen2Config", "Qwen2ForCausalLM",
                  dict(use_sliding_window=True, sliding_window=16, max_window_layers=1)),
        "gemma": ("GemmaConfig", "GemmaForCausalLM", dict(head_dim=16)),
        "phi3": ("Phi3Config", "Phi3ForCausalLM", dict(pad_token_id=0)),
        "mixtral": ("MixtralConfig", "MixtralForCausalLM", dict(num_local_experts=4)),
    }[family]
    torch.manual_seed(0)
    model = getattr(transformers, model_cls)(getattr(transformers, config_cls)(**common, **extra))
    model.save_pretrained(str(tmp_path), safe_serialization=True)
    jcfg, jparams = jax_load(str(tmp_path), dtype=jnp.float32)
    cfg, params = load_decoder(str(tmp_path), dtype=torch.float32, device="cpu")
    assert (cfg.sliding_window, cfg.window_layer_start, cfg.attn_bias, cfg.tie_embeddings) == (
        jcfg.sliding_window, jcfg.window_layer_start, jcfg.attn_bias, jcfg.tie_embeddings
    )
    ids = np.random.default_rng(0).integers(1, 299, (1, 40)).astype(np.int32)
    lengths = np.asarray([40], np.int32)
    lj, _, _ = jllama.prefill(jparams, jcfg, jnp.asarray(ids), jnp.asarray(lengths))
    lt, _, _ = llama.prefill(params, cfg, _t(ids), _t(lengths))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), atol=1e-4)
