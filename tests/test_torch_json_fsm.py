"""JSON-constrained decoding in the port (``ops/json_fsm.py``, the engine's
JSON mode, the sampler's mask and FSM advance) against the JAX package.

The FSM tables are the JAX function's bit for bit; the port's DFA accepts and
rejects what the JAX tests say; the sampler's plain twin with a JSON mask
matches the JAX mask + ``sample_logits`` + ``next_tab`` under the same noise;
and the JSON engine's greedy ids are the JAX JSON engine's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import DecoderConfig as JaxDecoderConfig
from django_assistant_bot_tpu.models import llama as jllama
from django_assistant_bot_tpu.ops import json_fsm as jfsm
from django_assistant_bot_tpu.ops import sampling as jsampling
from django_assistant_bot_tpu.serving import ByteTokenizer as JaxByteTokenizer
from django_assistant_bot_tpu.serving import GenerationEngine as JaxGenerationEngine
from django_assistant_bot_tpu_torch.convert import params_from_jax
from django_assistant_bot_tpu_torch.models import DecoderConfig
from django_assistant_bot_tpu_torch.ops import json_fsm as tfsm
from django_assistant_bot_tpu_torch.ops.attention import NEG_INF
from django_assistant_bot_tpu_torch.ops.sampling import sample_logits, sample_logits_plain
from django_assistant_bot_tpu_torch.serving import ByteTokenizer, GenerationEngine
from django_assistant_bot_tpu_torch.serving.engine import token_fsm


def run_chars(dfa, text: str):
    state = dfa.initial
    for b in text.encode("utf-8"):
        state = int(dfa.table[state, b])
        if state == dfa.dead:
            return None
    return state


# ------------------------------------------------------------ tables vs JAX
def _assert_fsm_equal(a, b):
    np.testing.assert_array_equal(a.next_state, b.next_state)
    np.testing.assert_array_equal(a.allowed, b.allowed)
    np.testing.assert_array_equal(a.accepting, b.accepting)
    assert (a.initial, a.dead) == (b.initial, b.dead)
    assert a.next_state.dtype == b.next_state.dtype and a.allowed.dtype == b.allowed.dtype


@pytest.mark.parametrize("max_depth", [3, 4])
def test_char_dfa_equals_jax(max_depth):
    t, j = tfsm.build_char_dfa(max_depth), jfsm.build_char_dfa(max_depth)
    np.testing.assert_array_equal(t.table, j.table)
    np.testing.assert_array_equal(t.accepting, j.accepting)
    assert (t.initial, t.dead) == (j.initial, j.dead)
    if max_depth == 4:
        assert t.table.shape[0] == 903  # the state count the device tables are sized by


def test_byte_tokenizer_fsm_equals_jax():
    _assert_fsm_equal(tfsm.fsm_for_tokenizer(ByteTokenizer()),
                      jfsm.fsm_for_tokenizer(JaxByteTokenizer()))


def _hf_pair():
    from tokenizers import Tokenizer
    from tokenizers.decoders import Metaspace as DecMeta
    from tokenizers.models import WordLevel
    from tokenizers.pre_tokenizers import Metaspace as PreMeta
    from transformers import PreTrainedTokenizerFast

    from django_assistant_bot_tpu.serving.tokenizer import HFTokenizer as JaxHF
    from django_assistant_bot_tpu_torch.serving.tokenizer import HFTokenizer

    vocab = {"<unk>": 0, "<s>": 1, "</s>": 2, "▁true": 3, "▁:": 4, "{": 5, "}": 6,
             '"': 7, "a": 8, "▁1": 9, ",": 10, "[": 11, "]": 12}
    t = Tokenizer(WordLevel(vocab, unk_token="<unk>"))
    t.pre_tokenizer = PreMeta()
    t.decoder = DecMeta()
    hf = PreTrainedTokenizerFast(tokenizer_object=t, unk_token="<unk>", bos_token="<s>",
                                 eos_token="</s>")
    return HFTokenizer(hf), JaxHF(hf), hf


def test_hf_anchor_token_bytes_and_fsm_equal_jax():
    """The anchor rendering keeps a SentencePiece token's leading space (a
    bare decode drops it), and the HF tokenizer's tables equal JAX's."""
    tok, jtok, hf = _hf_pair()
    assert hf.decode([3]) == "true"
    tb = tfsm.token_bytes_for(tok)
    assert tb == jfsm.token_bytes_for(jtok)
    assert tb[3] == b" true" and tb[tok.eos_id] == b""
    _assert_fsm_equal(tfsm.fsm_for_tokenizer(tok), jfsm.fsm_for_tokenizer(jtok))


def test_token_fsm_is_cached_per_tokenizer():
    tok = ByteTokenizer()
    assert token_fsm(tok) is token_fsm(tok)
    assert token_fsm(ByteTokenizer()) is not token_fsm(tok)


# ---------------------------------------------------------------- the DFA
@pytest.mark.parametrize(
    "text",
    [
        '{}',
        '{"a": 1}',
        '{"a": -0.5e+3, "b": [true, false, null]}',
        '{"nested": {"x": [1, 2, {"y": "z"}]}}',
        '  {"ws" :\n[ 1 , 2 ]\t}',
        '{"esc": "a\\"b\\\\c\\u00e9", "utf8": "héllo"}',
        '[]',
        '[{"a": []}]',
        '{"num0": 0, "neg": -12.5}',
    ],
)
def test_dfa_accepts_valid_json(text):
    dfa = tfsm.build_char_dfa(max_depth=4)
    state = run_chars(dfa, text)
    assert state is not None and dfa.accepting[state], text
    json.loads(text)


@pytest.mark.parametrize(
    "text",
    ['{', '{"a" 1}', '{"a": 1,}', '{"a": 01}', '[1, ]', '{"a": tru}', '"bare"', '{"a": 1}}',
     "{'a': 1}"],
)
def test_dfa_rejects_invalid_json(text):
    dfa = tfsm.build_char_dfa(max_depth=4)
    state = run_chars(dfa, text)
    assert state is None or not dfa.accepting[state], text


def test_dfa_depth_limit():
    dfa = tfsm.build_char_dfa(max_depth=3)
    assert run_chars(dfa, '{"a": {"b": [1]}}') is not None
    assert run_chars(dfa, '{"a": {"b": [[1]]}}') is None


def test_token_fsm_eos_only_when_complete():
    tok = ByteTokenizer()
    fsm = tfsm.fsm_for_tokenizer(tok)
    assert fsm.allowed[fsm.initial, ord("{")] and fsm.allowed[fsm.initial, ord(" ")]
    assert not fsm.allowed[fsm.initial, tok.eos_id]
    assert not fsm.allowed[fsm.initial, ord("x")]
    s = fsm.next_state[fsm.initial, ord("{")]
    s = fsm.next_state[s, ord("}")]
    assert fsm.accepting[s] and fsm.allowed[s, tok.eos_id] and fsm.allowed[s].sum() == 1


# ------------------------------------------------------ the sampler vs JAX
def _jax_json_sample(logits, allowed, nxt, states, jmask, temps, top_ps, key, top_k):
    """The JAX JSON tick's sampling: where(mask) + sample_logits + next_tab."""
    lg = jnp.asarray(logits)
    ok = jnp.asarray(allowed)[jnp.asarray(states)]
    lg = jnp.where(jnp.asarray(jmask)[:, None] & ~ok, NEG_INF, lg)
    ids = jsampling.sample_logits(lg, key, temperature=jnp.asarray(temps), top_k=top_k,
                                  top_p=jnp.asarray(top_ps))
    safe = jnp.minimum(ids, allowed.shape[1] - 1)
    adv = jnp.where(jnp.asarray(jmask), jnp.asarray(nxt)[jnp.asarray(states), safe],
                    jnp.asarray(states))
    return np.asarray(ids), np.asarray(adv)


def _tables(V, S, rng):
    """Allowed / next tables: the byte tokenizer's real FSM in the first
    columns, random rows past it, and two states that allow fewer than k
    tokens (the masked lanes then tie inside the top k)."""
    fsm = tfsm.fsm_for_tokenizer(ByteTokenizer())
    allowed = rng.random((S, V)) < 0.3
    nxt = rng.integers(0, S, (S, V)).astype(np.int32)
    n = min(S, fsm.allowed.shape[0])
    w = fsm.allowed.shape[1]
    allowed[:n, :w] = fsm.allowed[:n]
    nxt[:n, :w] = np.minimum(fsm.next_state[:n], S - 1)
    allowed[1] = False
    allowed[1, rng.choice(V, 7, replace=False)] = True
    allowed[2] = False
    allowed[2, [0, V - 1]] = True
    return allowed, nxt


@pytest.mark.parametrize("V", [512, 20_000])  # flat and hierarchical top-k
@pytest.mark.parametrize("ties", [False, True])
def test_sampler_json_mask_and_advance_match_jax(V, ties):
    """Ids and advanced states equal the JAX tick's, rows greedy and sampled,
    JSON and plain, fed the noise ``jax.random.categorical`` draws; with
    ``ties`` the logits take a handful of values (a planted tie block:
    equal values order as lax.top_k / the hierarchical top-k order them)."""
    rng = np.random.default_rng(5 + V + ties)
    B, S, k = 8, 6, 50
    logits = (rng.normal(size=(B, V)) * 3).astype(np.float32)
    if ties:
        logits = np.round(logits).astype(np.float32)
        logits[:, 1000 % V: 1000 % V + 300] = 9.0  # a block of equal maxima
    allowed, nxt = _tables(V, S, rng)
    states = np.asarray([0, 1, 2, 3, 0, 4, 5, 1], np.int32)
    jmask = np.asarray([1, 1, 1, 0, 1, 1, 0, 1], bool)
    temps = np.asarray([0.0, 0.7, 0.0, 1.0, 1.3, 0.0, 0.8, 0.5], np.float32)
    top_ps = np.asarray([0.9, 0.5, 0.95, 1.0, 1.0, 0.95, 0.9, 0.5], np.float32)
    for seed in range(3):
        key = jax.random.key(seed)
        want_ids, want_states = _jax_json_sample(logits, allowed, nxt, states, jmask, temps,
                                                 top_ps, key, k)
        noise = np.array(jax.random.gumbel(key, (B, k), jnp.float32))
        ids, adv = sample_logits(
            torch.from_numpy(logits), temperature=torch.from_numpy(temps), top_k=k,
            top_p=torch.from_numpy(top_ps), gumbel=torch.from_numpy(noise),
            allowed=torch.from_numpy(allowed), fsm_state=torch.from_numpy(states),
            jmask=torch.from_numpy(jmask), next_state=torch.from_numpy(nxt),
        )
        np.testing.assert_array_equal(ids.numpy(), want_ids)
        np.testing.assert_array_equal(adv.numpy(), want_states)
        assert ids.dtype == adv.dtype == torch.int32
        # a JSON row only takes what its state allows
        for b in np.flatnonzero(jmask):
            assert allowed[states[b], ids[b]]


def test_sampler_without_json_is_the_plain_sampler():
    """No FSM inputs: ids only, the same as with an all-False JSON mask."""
    rng = np.random.default_rng(9)
    B, V, k = 4, 20_000, 50
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32))
    noise = torch.from_numpy(rng.gumbel(size=(B, k)).astype(np.float32))
    temps = torch.tensor([0.0, 0.8, 1.0, 0.6])
    plain = sample_logits_plain(logits, temperature=temps, top_k=k, top_p=0.9, gumbel=noise)
    allowed, nxt = _tables(V, 3, rng)
    ids, states = sample_logits_plain(
        logits, temperature=temps, top_k=k, top_p=0.9, gumbel=noise,
        allowed=torch.from_numpy(allowed), fsm_state=torch.zeros(B, dtype=torch.int32),
        jmask=torch.zeros(B, dtype=torch.bool), next_state=torch.from_numpy(nxt),
    )
    assert torch.equal(plain, ids) and torch.equal(states, torch.zeros(B, dtype=torch.int32))


# ------------------------------------------------------------- the engine
@pytest.fixture(scope="module")
def tiny_models():
    jcfg = JaxDecoderConfig.tiny()
    jparams = jllama.init(jcfg, jax.random.key(0))
    cfg = DecoderConfig.tiny()
    return jcfg, jparams, cfg, params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")


def _crank(eng, futs, limit=6000):
    """Crank the loop single-threaded until ``futs`` resolve (submit after
    setting ``eng._running``, or an engine that is not running drains it)."""
    eng._running = True
    n = 0
    while not all(f.done() for f in futs):
        eng._loop_iteration()
        n += 1
        assert n < limit, "engine made no progress"
    eng._running = False


def test_json_engine_greedy_token_identical_to_jax(tiny_models):
    """Greedy JSON requests (and a plain one beside them) give the JAX JSON
    engine's token ids, at the default fused depth (downgraded to single
    steps while JSON slots are live) with chunked prefill."""
    jcfg, jparams, cfg, params = tiny_models
    rng = np.random.default_rng(3)
    prompts = [rng.integers(1, 255, n).tolist() for n in (9, 40, 100, 20)]
    json_rows = [True, True, True, False]
    kw = dict(max_slots=4, max_seq_len=256, chunk_size=64, decode_steps=8)
    jeng = JaxGenerationEngine(jcfg, jparams, JaxByteTokenizer(), kv_layout="paged",
                               scheduler=None, prefix_cache_size=0, **kw)
    teng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", **kw)
    out = []
    for eng in (jeng, teng):
        eng._running = True
        futs = [eng.submit(p, max_tokens=40, temperature=0.0, json_format=j)
                for p, j in zip(prompts, json_rows)]
        _crank(eng, futs)
        out.append([f.result(timeout=0).token_ids for f in futs])
    assert out[1] == out[0]
    assert teng.tick_stats()["json_downgraded_ticks"] > 0
    dfa = tfsm.build_char_dfa(4)
    for ids, j in zip(out[1], json_rows):
        if j:
            assert run_chars(dfa, bytes(i for i in ids if i < 256).decode("utf-8", "replace"))


def test_engine_mixed_json_and_plain_batch(tiny_models):
    """A plain greedy request sharing the batch with a JSON one gives its
    solo ids, token for token (the JAX contract)."""
    _, _, cfg, params = tiny_models
    tok = ByteTokenizer()
    eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=4, max_seq_len=128)
    eng._running = True
    solo = eng.submit(tok.encode("plain"), max_tokens=8, temperature=0.0)
    _crank(eng, [solo])
    eng._running = True
    futs = [eng.submit(tok.encode("plain"), max_tokens=8, temperature=0.0),
            eng.submit(tok.encode("json"), max_tokens=64, temperature=0.5, json_format=True)]
    _crank(eng, futs)
    plain, constrained = futs[0].result(timeout=0), futs[1].result(timeout=0)
    assert plain.token_ids == solo.result(timeout=0).token_ids
    if not constrained.length_limited:
        json.loads(constrained.text)
    else:
        assert run_chars(tfsm.build_char_dfa(4), constrained.text) is not None


def test_engine_json_mode_parses_at_high_temperature():
    """20 constrained generations at temperature 0.8 on random weights:
    every finished one parses, a length-limited one is a live prefix, and
    most finish within 96 tokens (the JAX contract, on the CPU port)."""
    cfg = DecoderConfig.tiny()
    jparams = jllama.init(JaxDecoderConfig.tiny(), jax.random.key(11))  # the JAX test's weights
    params = params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    tok = ByteTokenizer()
    eng = GenerationEngine(cfg, params, tok, device="cpu", max_slots=4, max_seq_len=160)
    eng._running = True
    futs = [eng.submit(tok.encode(f"reply with json #{i}"), max_tokens=96, temperature=0.8,
                       json_format=True) for i in range(20)]
    _crank(eng, futs)
    dfa = tfsm.build_char_dfa(max_depth=4)
    parsed = 0
    for f in futs:
        r = f.result(timeout=0)
        if not r.length_limited:
            assert isinstance(json.loads(r.text), (dict, list)), r.text
            parsed += 1
        else:
            assert run_chars(dfa, r.text) is not None, r.text
    assert parsed >= 15, parsed


def test_json_slots_downgrade_fused_tick_to_single_step(tiny_models):
    """While a JSON slot is live the engine issues single-step ticks (and
    counts them); plain traffic afterwards takes the fused tick again.
    ``warmup(json=True)`` builds the FSM before the first request."""
    _, _, cfg, params = tiny_models
    eng = GenerationEngine(cfg, params, ByteTokenizer(), device="cpu", max_slots=4,
                           max_seq_len=128, decode_steps=4, prefix_cache_size=0)
    eng.warmup(json=True)
    assert eng._fsm is not None and eng._fsm_allowed_dev.shape == (903, cfg.vocab_size)
    eng._running = True
    f = eng.submit([1, 2, 3], max_tokens=8, temperature=0.0, json_format=True)
    steps0 = eng.steps
    _crank(eng, [f])
    st = eng.tick_stats()
    assert st["json_downgraded_ticks"] > 0 and st["decode_steps"] == 4
    assert eng.steps - steps0 == st["json_downgraded_ticks"]  # one step a JSON tick
    eng._running = True
    f = eng.submit([1, 2, 3], max_tokens=6, temperature=0.0)
    _crank(eng, [f])
    assert eng.tick_stats()["decode_steps_effective"] == 4
    assert eng.tick_stats()["json_downgraded_ticks"] == st["json_downgraded_ticks"]
