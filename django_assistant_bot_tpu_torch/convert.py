"""Bridge from the JAX package's params to the port's.

:func:`params_from_jax` (decoders) and :func:`encoder_params_from_jax` take
the JAX param pytree with its leaves already turned into numpy arrays
(``jax.tree.map(np.asarray, params)`` on the JAX side — this module never
imports JAX) and return the port's params dict: the same keys and layouts,
as tensors in ``cfg.dtype`` on ``device``.
A quantized decoder leaf (the JAX ``QTensor``/``QTensor4`` NamedTuple, here
a tuple with ``q`` and ``scale`` fields of numpy arrays) becomes the port's
:class:`~.ops.quant.QTensor` (int8 ``q``) or :class:`~.ops.quant.QTensor4`
(uint8 ``q``) with the same bytes and layout and f32 scales.  A MoE
(Mixtral) tree's ``router``, ``w_gate``, ``w_up`` and ``w_down`` come across
unchanged; quantized experts are refused (ROADMAP Queue 1 item 17).
:func:`kv_cache_from_jax` and :func:`kv_cache_to_numpy` carry a legacy slot
cache (the JAX ``KVCache``: ``k``, ``v``, ``lengths``) across both ways with
its bytes unchanged, fp8 and bf16 leaves included, so that both packages
can start from one cache state.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from .device import DeviceLike, resolve_device
from .models.config import DecoderConfig, EncoderConfig
from .models.llama import KVCache
from .models.mixtral import QUANTIZED_EXPERTS
from .ops.quant import QTensor, QTensor4

_LAYER_KEYS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down", "attn_norm", "mlp_norm")
_BIAS_KEYS = ("bq", "bk", "bv")
# a Mixtral layer's MoE leaves: the router [L, E, X] and the expert stacks
# [L, X, in, out], carried across as they are
_MOE_KEYS = ("router", "w_gate", "w_up", "w_down")


def _tensor(name: str, leaf: Any, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    if isinstance(leaf, tuple) or not hasattr(leaf, "dtype"):
        raise TypeError(f"param {name!r} is a {type(leaf).__name__}, not an array")
    arr = np.asarray(leaf)
    # bfloat16 leaves come as ml_dtypes' bfloat16, which numpy does not
    # class as floating
    if not (np.issubdtype(arr.dtype, np.floating) or arr.dtype.name == "bfloat16"):
        raise TypeError(f"param {name!r} has dtype {arr.dtype}, not a float type")
    # numpy has no bfloat16: widen (exactly) to float32 before torch
    return torch.tensor(arr.astype(np.float32)).to(device=device, dtype=dtype)


def _leaf(name: str, leaf: Any, dtype: torch.dtype, device: torch.device):
    """A dense leaf as :func:`_tensor`, or a quantized one (``q`` and
    ``scale`` fields: int8 ``q`` -> QTensor, uint8 -> QTensor4) as the
    port's type, bytes unchanged."""
    if not (hasattr(leaf, "q") and hasattr(leaf, "scale")):
        return _tensor(name, leaf, dtype, device)
    q, scale = np.asarray(leaf.q), np.asarray(leaf.scale, np.float32)
    kinds = {np.dtype(np.int8): QTensor, np.dtype(np.uint8): QTensor4}
    if q.dtype not in kinds:
        raise TypeError(f"param {name!r}: quantized q of dtype {q.dtype} (int8 or uint8 expected)")
    return kinds[q.dtype](torch.from_numpy(q.copy()).to(device),
                          torch.from_numpy(scale.copy()).to(device))


def params_from_jax(
    tree: Mapping[str, Any], cfg: DecoderConfig, device: DeviceLike = "cuda"
) -> dict:
    """JAX decoder params (numpy leaves) -> the port's params dict."""
    dev = resolve_device(device)
    layers_in = tree["layers"]
    keys = _LAYER_KEYS + (_BIAS_KEYS if cfg.attn_bias else ())
    if cfg.is_moe:
        quantized = [k for k in _MOE_KEYS if hasattr(layers_in[k], "q")]
        if quantized:
            raise NotImplementedError(
                f"quantized MoE experts ({', '.join(quantized)}) are not ported yet; "
                f"{QUANTIZED_EXPERTS}"
            )
        keys += ("router",)
    layers = {k: _leaf(f"layers.{k}", layers_in[k], cfg.dtype, dev) for k in keys}
    out = {
        "tok_embed": _leaf("tok_embed", tree["tok_embed"], cfg.dtype, dev),
        "final_norm": _tensor("final_norm", tree["final_norm"], cfg.dtype, dev),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        out["lm_head"] = _leaf("lm_head", tree["lm_head"], cfg.dtype, dev)
    return out


_ENCODER_TOP_KEYS = ("tok_embed", "pos_embed", "type_embed", "embed_ln_w", "embed_ln_b")
_ENCODER_LAYER_KEYS = ("wq", "bq", "wk", "bk", "wv", "bv", "wo", "bo", "attn_ln_w",
                       "attn_ln_b", "w1", "b1", "w2", "b2", "mlp_ln_w", "mlp_ln_b")


def encoder_params_from_jax(
    tree: Mapping[str, Any], cfg: EncoderConfig, device: DeviceLike = "cuda"
) -> dict:
    """JAX encoder params (numpy leaves) -> the port's params dict."""
    dev = resolve_device(device)
    out = {k: _tensor(k, tree[k], cfg.dtype, dev) for k in _ENCODER_TOP_KEYS}
    out["layers"] = {
        k: _tensor(f"layers.{k}", tree["layers"][k], cfg.dtype, dev) for k in _ENCODER_LAYER_KEYS
    }
    return out


_ANN_TENSORS = {"centroids": np.float32, "codebooks": np.float32, "codes": np.uint8,
                "lvalid": np.bool_, "rowpos": np.int32, "rvalid": np.bool_}


def ann_from_jax(arrays: Mapping[str, Any], device: DeviceLike = "cuda"):
    """The JAX ``ANNIndex``'s state (numpy arrays) -> a port
    :class:`~.storage.ann.ANNIndex` holding exactly that state.

    Keys: ``dim``, ``nlist``, ``m``, ``nprobe``, ``rerank_depth``, ``seed``;
    ``ids`` (position order) and ``mat`` (the host f32 rows, ``[n, dim]``);
    ``dead`` (tombstoned positions, optional); and, for a trained index,
    ``centroids``, ``codebooks``, ``codes``, ``lvalid``, ``rowpos``,
    ``row_list``, ``row_slot``, ``list_counts``; the rerank tier as
    ``rerank_bits`` (its bf16 bits, uint16 ``[cap, dim]``), ``rvalid`` and
    ``rerank_count``; ``list_sums`` (the drift gauge's, optional).  Tensors land on ``device`` with their bytes
    unchanged."""
    from .storage.ann import ANNIndex

    index = ANNIndex(int(arrays["dim"]), nlist=int(arrays["nlist"]), m=int(arrays["m"]),
                     nprobe=int(arrays["nprobe"]), rerank_depth=int(arrays["rerank_depth"]),
                     seed=int(arrays.get("seed", 0)), device=device)
    ids = [int(i) for i in np.asarray(arrays["ids"]).reshape(-1)]
    mat = np.asarray(arrays["mat"], np.float32).reshape(len(ids), index.dim)
    with index._lock:
        index._grow_host(len(ids))
        index._mat[: len(ids)] = mat
        index._n = len(ids)
        index._ids = ids
        index._dead = {int(p) for p in np.asarray(arrays.get("dead", ())).reshape(-1)}
        index._id_pos = {i: p for p, i in enumerate(ids) if p not in index._dead}
        dev = index.device
        if "rerank_bits" in arrays:
            bits = np.array(np.asarray(arrays["rerank_bits"]).view(np.int16), copy=True)
            index._rerank = torch.from_numpy(bits).view(torch.bfloat16).to(dev)
            index._rvalid = torch.from_numpy(np.array(arrays["rvalid"], np.bool_)).to(dev)
            index._rerank_count = int(arrays["rerank_count"])
            index._snapshot_ids = index._ids
            index._rerank_dirty = False
        if "centroids" in arrays:
            for key, dtype in _ANN_TENSORS.items():
                if key != "rvalid":
                    arr = np.array(arrays[key], dtype, copy=True)
                    setattr(index, "_" + key, torch.from_numpy(arr).to(dev))
            n = len(ids)
            index._row_list[:n] = np.asarray(arrays["row_list"], np.int32)[:n]
            index._row_slot[:n] = np.asarray(arrays["row_slot"], np.int32)[:n]
            index._set_counts_locked(np.asarray(arrays["list_counts"], np.int64).copy())
            index._list_sums = np.asarray(
                arrays.get("list_sums", np.zeros((index.nlist, index.dim))), np.float32).copy()
            index._list_nums = index._list_counts.copy()
            index._trained = True
    return index


# the narrow cache dtypes by numpy name (ml_dtypes' names) and their bits
_NARROW = {"bfloat16": (torch.bfloat16, np.int16), "float8_e4m3fn": (torch.float8_e4m3fn, np.uint8),
           "float8_e5m2": (torch.float8_e5m2, np.uint8)}


def _cache_leaf(arr: Any, device: torch.device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name in _NARROW:
        tdt, bits = _NARROW[a.dtype.name]
        return torch.from_numpy(np.ascontiguousarray(a).view(bits).copy()).view(tdt).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def kv_cache_from_jax(cache: Any, device: DeviceLike = "cuda") -> KVCache:
    """A JAX legacy ``KVCache`` with numpy leaves (``jax.tree.map(np.asarray,
    cache)``; fields ``k``, ``v`` ``[L, B, KH, S, D]`` and ``lengths``) -> the
    port's :class:`~.models.llama.KVCache` on ``device``, the same bytes
    (f32, bf16, e4m3fn or e5m2 leaves)."""
    dev = resolve_device(device)
    return KVCache(k=_cache_leaf(cache.k, dev), v=_cache_leaf(cache.v, dev),
                   lengths=_cache_leaf(cache.lengths, dev).to(torch.int32))


def kv_cache_to_numpy(cache: KVCache) -> dict:
    """The port's legacy cache -> ``{"k", "v", "lengths"}`` numpy arrays with
    the same bytes: f32 as f32, bf16 and fp8 as ``ml_dtypes`` arrays (numpy
    has no such dtypes), which ``jnp.asarray`` takes as they are."""
    by_dtype = {tdt: (n, bits) for n, (tdt, bits) in _NARROW.items()}
    out = {}
    for name in ("k", "v"):
        t = getattr(cache, name).detach().cpu().contiguous()
        if t.dtype not in by_dtype:
            out[name] = t.numpy().copy()
            continue
        import ml_dtypes  # the narrow formats' numpy dtypes, for the caller's arrays

        n, bits = by_dtype[t.dtype]
        raw = t.view(torch.int16 if bits is np.int16 else torch.uint8).numpy()
        out[name] = raw.copy().view(getattr(ml_dtypes, n))
    out["lengths"] = cache.lengths.detach().cpu().numpy().astype(np.int32)
    return out
