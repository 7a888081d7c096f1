"""The port's BERT encoder against the JAX package's, weights bridged through
``convert.encoder_params_from_jax`` (CPU):

- ``EncoderConfig.from_hf`` / ``tiny`` and ``layer_norm``;
- ``forward`` and ``encode`` (normalised and not) on a padded batch, within
  1e-5 in f32 and within the JAX tests' bf16 bound (2e-2) in bf16;
- ``load_encoder`` on a ``models/synth.py`` checkpoint (with and without the
  ``bert.`` prefix) against the JAX loader, and the port's encoder against
  Hugging Face ``BertModel`` as ``tests/test_models.py`` holds the JAX one.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from django_assistant_bot_tpu.models import EncoderConfig as JaxEncoderConfig
from django_assistant_bot_tpu.models import encoder as jencoder
from django_assistant_bot_tpu.models.hf_loader import load_encoder as jax_load_encoder
from django_assistant_bot_tpu.ops.norms import layer_norm as jax_layer_norm
from django_assistant_bot_tpu_torch.convert import encoder_params_from_jax
from django_assistant_bot_tpu_torch.models import EncoderConfig, encoder
from django_assistant_bot_tpu_torch.models.hf_loader import load_encoder
from django_assistant_bot_tpu_torch.ops import layer_norm

F32_TOL = 1e-5
BF16_TOL = 2e-2  # the JAX tests' bound for bf16 scoring against f32 math


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _batch(seed=0, B=4, S=24, vocab=512):
    rng = np.random.default_rng(seed)
    ids = rng.integers(1, vocab, (B, S)).astype(np.int32)
    lengths = [S, 17, 5, 1][:B]
    mask = np.zeros((B, S), np.int32)
    for b, n in enumerate(lengths):
        mask[b, :n] = 1
        ids[b, n:] = 0
    return ids, mask


def _models(dtype_j, dtype_t):
    import dataclasses

    jcfg = dataclasses.replace(JaxEncoderConfig.tiny(), dtype=dtype_j)
    jparams = jencoder.init(jcfg, jax.random.key(0))
    cfg = dataclasses.replace(EncoderConfig.tiny(), dtype=dtype_t)
    params = encoder_params_from_jax(jax.tree.map(np.asarray, jparams), cfg, "cpu")
    return jcfg, jparams, cfg, params


def test_encoder_config_from_hf_and_tiny():
    hf = {"vocab_size": 1000, "hidden_size": 96, "intermediate_size": 192,
          "num_hidden_layers": 3, "num_attention_heads": 6, "max_position_embeddings": 64,
          "type_vocab_size": 1, "layer_norm_eps": 1e-7, "pad_token_id": 2}
    for ours, theirs in ((EncoderConfig.from_hf(hf), JaxEncoderConfig.from_hf(hf)),
                         (EncoderConfig.from_hf({k: hf[k] for k in list(hf)[:5]}),
                          JaxEncoderConfig.from_hf({k: hf[k] for k in list(hf)[:5]})),
                         (EncoderConfig.tiny(), JaxEncoderConfig.tiny()),
                         (EncoderConfig(), JaxEncoderConfig())):
        a, b = vars(ours).copy(), vars(theirs).copy()
        assert str(a.pop("dtype")).split(".")[-1] == np.dtype(b.pop("dtype")).name
        assert a == b
        assert ours.head_dim == theirs.head_dim
    assert EncoderConfig.from_hf(hf, dtype=torch.float32).dtype == torch.float32


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_jax(dtype):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 7, 64)).astype(np.float32) * 3 + 1
    w = rng.normal(size=(64,)).astype(np.float32)
    b = rng.normal(size=(64,)).astype(np.float32)
    want = jax_layer_norm(jnp.asarray(x, dtype), jnp.asarray(w, dtype), jnp.asarray(b, dtype))
    got = layer_norm(_t(x).to(getattr(torch, dtype)), _t(w).to(getattr(torch, dtype)),
                     _t(b).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else 2 ** -7  # one bf16 rounding of the output
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), atol=tol * 4,
                               rtol=tol)


def test_encoder_forward_matches_jax_f32():
    jcfg, jparams, cfg, params = _models(jnp.float32, torch.float32)
    ids, mask = _batch()
    want = np.asarray(jencoder.forward(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = encoder.forward(params, cfg, _t(ids), _t(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=F32_TOL, rtol=0)


@pytest.mark.parametrize("normalize", [False, True])
def test_encoder_encode_matches_jax_f32(normalize):
    jcfg, jparams, cfg, params = _models(jnp.float32, torch.float32)
    ids, mask = _batch(seed=2)
    want = np.asarray(jencoder.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                      normalize=normalize))
    got = encoder.encode(params, cfg, _t(ids), _t(mask), normalize=normalize)
    assert got.dtype == torch.float32 and got.shape == (4, cfg.hidden_size)
    np.testing.assert_allclose(got.numpy(), want, atol=F32_TOL, rtol=0)
    if normalize:
        np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0, atol=1e-5)


@pytest.mark.parametrize("normalize", [False, True])
def test_encoder_encode_matches_jax_bf16(normalize):
    """bf16 weights and activations on both sides: the two frameworks round
    at other places, so the pooled embeddings agree to the JAX tests' bf16
    bound, taken relative to the largest element."""
    jcfg, jparams, cfg, params = _models(jnp.bfloat16, torch.bfloat16)
    ids, mask = _batch(seed=3)
    want = np.asarray(jencoder.encode(jparams, jcfg, jnp.asarray(ids), jnp.asarray(mask),
                                      normalize=normalize))
    got = encoder.encode(params, cfg, _t(ids), _t(mask), normalize=normalize).numpy()
    assert np.isfinite(got).all()
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= BF16_TOL * scale


def test_encoder_init_draws_from_its_generator():
    cfg = EncoderConfig.tiny()
    a = encoder.init(cfg, torch.Generator().manual_seed(5), "cpu")
    b = encoder.init(cfg, torch.Generator().manual_seed(5), "cpu")
    jparams = jencoder.init(JaxEncoderConfig.tiny(), jax.random.key(0))
    for key in ("tok_embed", "pos_embed", "type_embed"):
        assert a[key].shape == tuple(jparams[key].shape)
        assert torch.equal(a[key], b[key])
    for key, w in a["layers"].items():
        assert w.shape == tuple(jparams["layers"][key].shape) and w.dtype == torch.float32
    # E^-0.5 scale, as the JAX init
    assert abs(a["layers"]["wq"].std().item() - cfg.hidden_size ** -0.5) < 0.02


@pytest.fixture(scope="module")
def bert_dirs(tmp_path_factory):
    """A synth BERT checkpoint and a copy whose tensors carry the ``bert.``
    prefix (as a BertForPreTraining checkpoint names them)."""
    from safetensors.numpy import load_file, save_file
    from transformers import BertModel

    from django_assistant_bot_tpu.models.synth import synth_encoder

    d = str(tmp_path_factory.mktemp("tiny_bert"))
    synth_encoder(d)
    prefixed = tmp_path_factory.mktemp("tiny_bert_prefixed")
    import os
    import shutil

    for f in os.listdir(d):
        if f.endswith(".safetensors"):
            t = load_file(os.path.join(d, f))
            save_file({f"bert.{k}": v for k, v in t.items()}, str(prefixed / f))
        else:
            shutil.copy(os.path.join(d, f), prefixed / f)
    model = BertModel.from_pretrained(d)
    model.eval()
    return d, str(prefixed), model


def test_load_encoder_matches_jax_loader(bert_dirs):
    d, prefixed, _ = bert_dirs
    for path in (d, prefixed):
        jcfg, jparams = jax_load_encoder(path, dtype=jnp.float32)
        cfg, params = load_encoder(path, dtype=torch.float32, device="cpu")
        assert cfg.num_layers == jcfg.num_layers and cfg.hidden_size == jcfg.hidden_size
        assert cfg.vocab_size == jcfg.vocab_size and cfg.dtype == torch.float32
        flat_j = {k: v for k, v in jparams.items() if k != "layers"}
        flat_j.update({f"layers.{k}": v for k, v in jparams["layers"].items()})
        flat_t = {k: v for k, v in params.items() if k != "layers"}
        flat_t.update({f"layers.{k}": v for k, v in params["layers"].items()})
        assert set(flat_j) == set(flat_t)
        for k, v in flat_j.items():
            np.testing.assert_array_equal(flat_t[k].numpy(), np.asarray(v), err_msg=k)
    cfg, params = load_encoder(d, device="cpu")
    assert cfg.dtype == torch.bfloat16 and params["layers"]["wq"].dtype == torch.bfloat16


def test_encoder_matches_hf(bert_dirs):
    d, _, hf_model = bert_dirs
    cfg, params = load_encoder(d, dtype=torch.float32, device="cpu")
    ids = np.array([[5, 9, 17, 3, 0, 0], [8, 2, 0, 0, 0, 0]], np.int32)
    mask = np.array([[1, 1, 1, 1, 0, 0], [1, 1, 0, 0, 0, 0]], np.int32)
    with torch.no_grad():
        hf_out = hf_model(input_ids=torch.tensor(ids, dtype=torch.long),
                          attention_mask=torch.tensor(mask, dtype=torch.long)).last_hidden_state
        ours = encoder.forward(params, cfg, _t(ids), _t(mask))
    # padding positions diverge (they stay in the residual stream): real tokens only
    for b in range(ids.shape[0]):
        n = mask[b].sum()
        np.testing.assert_allclose(ours[b, :n].numpy(), hf_out[b, :n].numpy(), atol=2e-4,
                                   rtol=1e-3)
