"""Llama-3-family decoder (port of ``models/llama.py``, the serving path).

Params are a dict shaped like the JAX package's pytree: ``tok_embed``
``[V, E]``, ``lm_head`` ``[E, V]`` (untied), ``final_norm`` ``[E]`` and a
``layers`` dict of tensors stacked on a leading layer axis (``wq`` ``[L, E,
H*D]``, ..., weights ``[in, out]``).  The JAX package's ``lax.scan`` over that
axis becomes a Python loop over layers (:func:`_layer_windows` keeps the
full/sliding-window split of ``_scan_window_split``).  A projection leaf may
be a quantized weight (``ops.quant.QTensor`` / ``QTensor4``, from
``quantize_decoder_params``, :func:`init_int8` or :func:`init_int4`), and
the embedding and head tables int8 ``QTensor``s.  With ``cfg.is_moe`` (Mixtral)
the MLP is :func:`.mixtral.moe_mlp`: a ``router`` ``[L, E, X]`` and expert
stacks ``w_gate`` / ``w_up`` ``[L, X, E, F]``, ``w_down`` ``[L, X, F, E]``.

Legacy KV: :class:`KVCache` is the JAX package's contiguous slot cache,
``[L, B, KH, S, D]``, one row of ``max_len`` positions per slot (the JAX
layout, which ``insert_prefix`` / ``extract_prefix`` keep).
:func:`decode_step` reads it through the chunked kernel
(:func:`~..ops.attention.chunked_gqa_decode_attention`, ``kv_chunk``) or,
with ``kv_chunk=None``, plain attention over the whole row, as the JAX
function does.  Writes follow ``dynamic_update_slice``: a window that
would run past a row starts earlier so that it ends at the row's end, and
rows a batch writes twice (a prefill wave's pad rows alias its first
slot, before it) take the later row's values, as JAX's in-order scan.

Paged KV: :class:`PagedKVCache` holds ``[L, P + 1, KH, page, D]`` pools.
Pages ``0..P-1`` are the JAX package's pool; page ``P`` is a dump page that is
written and never read.  The JAX code drops out-of-range scatter rows
(``mode="drop"``, index ``P``); PyTorch has no such mode and an index of P
would fault, so writes aimed at P land in the dump page instead — no host
round trip per layer — and every read clamps block-table entries to the
logical ``P - 1`` as the JAX code does.  The pools may hold another dtype
than the model's (``init_paged_cache(dtype=)``: bf16, or fp8 to halve the
bytes); every write casts through :func:`~..ops.quant.to_kv_dtype`, JAX's
``astype`` bit for bit, and every read widens as the JAX functions do.
The functions that write the cache
update its tensors in place (``lengths`` included) and return the cache, so
a CUDA graph that captured the tensors' addresses keeps reading the live
state.

Speculative decoding's paged plane: :func:`verify_tree_step_paged` is a
read-only forward over a flattened speculation tree (its attention reads
the verified prefix in place, :func:`~..ops.attention.paged_tree_attention`)
and :func:`commit_tree_path_paged` writes the accepted path's K/V through
the block table, every other write going to the dump page.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional

import torch

from ..device import DeviceLike, resolve_device
from ..ops.attention import (
    chunked_prefill_attention,
    dot_product_attention,
    flash_attention,
    flash_eligible,
    gqa_dot_product_attention,
    chunked_gqa_decode_attention,
    paged_gqa_decode_attention,
    paged_prefill_attention,
    paged_tree_attention,
)
from ..ops.norms import rms_norm
from ..ops.quant import (INT4_GROUP_SIZE, QTensor, QTensor4, QuantizedWeight, _int4_group,
                         qeinsum, qeinsum_group, tied_head, to_kv_dtype)
from ..ops.rope import apply_rope, rope_frequencies
from .config import DecoderConfig
from .mixtral import QUANTIZED_EXPERTS, moe_mlp

Params = Dict[str, Any]


def init(cfg: DecoderConfig, generator: torch.Generator, device: DeviceLike = "cuda") -> Params:
    """Random params like the JAX ``init``: normal(0, E^-0.5) projections,
    normal(0, F^-0.5) down projection, unit-scale embeddings, unit norms.
    Drawn by ``generator`` (which must live on ``device``) directly in
    ``cfg.dtype``, so full-width weights are made on the card without a
    host copy."""
    device = resolve_device(device)
    E, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = E ** -0.5

    def dense(shape, scale=s):
        w = torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype)
        return w.mul_(scale)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    layers = {
        "attn_norm": ones((L, E)),
        "wq": dense((L, E, H * D)),
        "wk": dense((L, E, KH * D)),
        "wv": dense((L, E, KH * D)),
        "wo": dense((L, H * D, E)),
        "mlp_norm": ones((L, E)),
    }
    if cfg.is_moe:  # Mixtral: the router and X experts per layer
        X = cfg.num_experts
        layers["router"] = dense((L, E, X))
        layers["w_gate"] = dense((L, X, E, F))
        layers["w_up"] = dense((L, X, E, F))
        layers["w_down"] = dense((L, X, F, E), scale=F ** -0.5)
    else:
        layers["w_gate"] = dense((L, E, F))
        layers["w_up"] = dense((L, E, F))
        layers["w_down"] = dense((L, F, E), scale=F ** -0.5)
    if cfg.attn_bias:
        for name, width in (("bq", H * D), ("bk", KH * D), ("bv", KH * D)):
            layers[name] = torch.zeros((L, width), device=device, dtype=cfg.dtype)
    params: Params = {
        "tok_embed": dense((cfg.vocab_size, E), scale=1.0),
        "final_norm": ones((E,)),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense((E, cfg.vocab_size))
    return params


# uniform int8 in [-127, 127] has std ~127/sqrt(3), uniform int4 in [-8, 7]
# sqrt((16^2 - 1) / 12): the synthetic inits' constant scales divide them out
UNIFORM8_STD = 127.0 / (3.0 ** 0.5)
UNIFORM4_STD = (255.0 / 12.0) ** 0.5


def _synth_quant_params(
    cfg: DecoderConfig,
    generator: torch.Generator,
    device: DeviceLike,
    *,
    proj_fmt: str,
    group_size: int = INT4_GROUP_SIZE,
    quantize_embed: bool = False,
) -> Params:
    """What :func:`init_int8` and :func:`init_int4` share: random integer
    payloads drawn on ``device`` by ``generator`` straight into their final
    dtype (int8 in [-127, 127], or one random byte as two int4 nibbles), one
    leaf at a time, with the JAX package's constant scales, so dequantized
    magnitudes match :func:`init`'s normal(0, E^-0.5).  Norms, embeddings
    and the head stay in ``cfg.dtype`` (``quantize_embed``: int8 tables)."""
    device = resolve_device(device)
    E, F, L = cfg.hidden_size, cfg.intermediate_size, cfg.num_layers
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    s = E ** -0.5
    if cfg.is_moe:
        raise NotImplementedError(f"quantized MoE experts are not ported yet; {QUANTIZED_EXPERTS}")

    def qdense8(shape, target_std=None):
        q = torch.randint(-127, 128, shape, generator=generator, device=device, dtype=torch.int8)
        scale = torch.full(shape[:-2] + (1, shape[-1]), (target_std or s) / UNIFORM8_STD,
                           dtype=torch.float32, device=device)
        return QTensor(q, scale)

    def qdense4(shape, target_std=None):
        *lead, dim, out_dim = shape
        g = _int4_group(dim, group_size)
        q = torch.randint(0, 256, tuple(lead) + (dim // 2, out_dim), generator=generator,
                          device=device, dtype=torch.uint8)
        scale = torch.full(tuple(lead) + (dim // g, out_dim), (target_std or s) / UNIFORM4_STD,
                           dtype=torch.float32, device=device)
        return QTensor4(q, scale)

    def ndense(shape, scale=1.0):
        w = torch.randn(shape, generator=generator, device=device, dtype=cfg.dtype)
        return w.mul_(scale)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=cfg.dtype)

    qdense = qdense4 if proj_fmt == "int4" else qdense8
    layers: Dict[str, Any] = {
        "attn_norm": ones((L, E)),
        "wq": qdense((L, E, H * D)),
        "wk": qdense((L, E, KH * D)),
        "wv": qdense((L, E, KH * D)),
        "wo": qdense((L, H * D, E)),
        "mlp_norm": ones((L, E)),
        "w_gate": qdense((L, E, F)),
        "w_up": qdense((L, E, F)),
        "w_down": qdense((L, F, E), target_std=F ** -0.5),
    }
    if cfg.attn_bias:
        for name, width in (("bq", H * D), ("bk", KH * D), ("bv", KH * D)):
            layers[name] = torch.zeros((L, width), device=device, dtype=cfg.dtype)
    # embedding and head tables are int8 in both formats (quantize_embed)
    params: Params = {
        "tok_embed": (qdense8((cfg.vocab_size, E), target_std=1.0) if quantize_embed
                      else ndense((cfg.vocab_size, E))),
        "final_norm": ones((E,)),
        "layers": layers,
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = (qdense8((E, cfg.vocab_size)) if quantize_embed
                             else ndense((E, cfg.vocab_size), s))
    return params


def init_int8(cfg: DecoderConfig, generator: torch.Generator, device: DeviceLike = "cuda",
              *, quantize_embed: bool = False) -> Params:
    """Synthetic int8 params drawn on ``device`` (the JAX ``init_int8``):
    the layer projections are :class:`~..ops.quant.QTensor` (int8 and
    per-output-channel f32 scales), as ``quantize_decoder_params`` makes
    them; decode throughput does not depend on the weights' values, so this
    benches like a quantized checkpoint of the same geometry without staging
    weights through the host."""
    return _synth_quant_params(cfg, generator, device, proj_fmt="int8",
                               quantize_embed=quantize_embed)


def init_int4(cfg: DecoderConfig, generator: torch.Generator, device: DeviceLike = "cuda",
              *, group_size: int = INT4_GROUP_SIZE, quantize_embed: bool = False) -> Params:
    """Synthetic grouped-int4 params drawn on ``device`` (the JAX
    ``init_int4``): the layer projections are :class:`~..ops.quant.QTensor4`
    (two values a byte along the contraction axis, f32 scales per
    ``group_size`` rows and output channel)."""
    return _synth_quant_params(cfg, generator, device, proj_fmt="int4", group_size=group_size,
                               quantize_embed=quantize_embed)


def _layer(params: Params, l: int) -> Params:
    """Layer ``l``'s slice of the stacked ``layers`` dict (views; a quantized
    leaf slices its q and its scale; a MoE layer's ``[L, X, ...]`` expert
    stacks give ``[X, ...]``)."""
    return {name: w.layer(l) if isinstance(w, QuantizedWeight) else w[l]
            for name, w in params["layers"].items()}


def _embed(params: Params, cfg: DecoderConfig, ids: torch.Tensor) -> torch.Tensor:
    """Token embedding lookup; Gemma scales by sqrt(E) in model dtype.  An
    int8 table gathers int8 rows and dequantizes only those."""
    w = params["tok_embed"]
    if isinstance(w, QTensor):
        x = w.q[ids.long()].to(cfg.dtype) * w.scale[0].to(cfg.dtype)
    else:
        x = w[ids.long()].to(cfg.dtype)
    if cfg.embed_multiplier != 1.0:
        x = x * torch.tensor(cfg.embed_multiplier, dtype=cfg.dtype)
    return x


def _head_logits(params: Params, cfg: DecoderConfig, x: torch.Tensor) -> torch.Tensor:
    """Logits projection ``[..., E] -> [..., V]`` in model dtype.  Untied,
    through ``qeinsum`` (an int8 head launches the qgemm kernel on the
    card).  A tied int8 table ``[V, E]`` carries per-E scales, which land on
    ``x`` (x . (q s)^T == (x s) . q^T, as in JAX): ``tied_head``, on the
    card the qgemm kernel's K-contiguous form over the table."""
    if cfg.tie_embeddings:
        w = params["tok_embed"]
        if isinstance(w, QTensor):
            return tied_head(x, w, cfg.dtype)
        return torch.einsum("...e,ve->...v", x, w.to(cfg.dtype))
    return qeinsum("...e,ev->...v", x, params["lm_head"], cfg.dtype)


def _mlp(cfg: DecoderConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.is_moe:
        return moe_mlp(cfg, p, x)
    if cfg.hidden_act == "gelu_tanh":
        act = functools.partial(torch.nn.functional.gelu, approximate="tanh")
    else:
        act = torch.nn.functional.silu
    # gate and up in one qgemm launch where the stream route takes them
    gate, up = qeinsum_group("bse,ef->bsf", x, (p["w_gate"], p["w_up"]), cfg.dtype)
    h = act(gate) * up
    return qeinsum("bsf,fe->bse", h, p["w_down"], cfg.dtype)


def _qkv(cfg: DecoderConfig, p: Params, x: torch.Tensor):
    """Q/K/V projections (+ Qwen2 biases): [B, S, H*D], [B, S, KH*D] x2;
    quantized, one qgemm launch where the stream route takes them."""
    q, k, v = qeinsum_group("bse,eo->bso", x, (p["wq"], p["wk"], p["wv"]), cfg.dtype)
    if cfg.attn_bias:
        q = q + p["bq"]
        k = k + p["bk"]
        v = v + p["bv"]
    return q, k, v


def _attn_proj(cfg: DecoderConfig, p: Params, x: torch.Tensor, cos, sin):
    """QKV projections + RoPE.  Returns q:[B,H,S,D], k/v:[B,KH,S,D]."""
    B, S, _ = x.shape
    H, KH, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q.reshape(B, S, H, D), cos, sin)
    k = apply_rope(k.reshape(B, S, KH, D), cos, sin)
    v = v.reshape(B, S, KH, D)
    return q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)


def _repeat_kv(cfg: DecoderConfig, k: torch.Tensor) -> torch.Tensor:
    """[B,KH,S,D] -> [B,H,S,D] in contiguous blocks of KV heads."""
    if cfg.q_per_kv == 1:
        return k
    return k.repeat_interleave(cfg.q_per_kv, dim=1)


@functools.lru_cache(maxsize=16)
def _rope_cached(head_dim, max_len, theta, scaling, deployed_len, device: str):
    cos, sin = rope_frequencies(
        head_dim, max_len, theta, scaling=scaling, deployed_len=deployed_len
    )
    return torch.from_numpy(cos).to(device), torch.from_numpy(sin).to(device)


def _rope_tables(cfg: DecoderConfig, max_len: int, device: torch.device):
    """(cos, sin) [max_len, D/2] f32 on ``device``; ``deployed_len`` pins
    seq-regime-dependent scalings (longrope) to one factor list across
    prefill and decode tables, as in the JAX package."""
    return _rope_cached(
        cfg.head_dim, max_len, cfg.rope_theta, cfg.rope_scaling, cfg.max_seq_len, str(device)
    )


def _window_split(cfg: DecoderConfig) -> int:
    """Index of the first sliding-window layer (== num_layers -> none windowed)."""
    if cfg.sliding_window is None:
        return cfg.num_layers
    return min(max(cfg.window_layer_start, 0), cfg.num_layers)


def _layer_windows(cfg: DecoderConfig):
    """Per-layer attention window: layers [0, split) full, [split, L) the
    sliding window — ``_scan_window_split``'s two scans as one loop."""
    split = _window_split(cfg)
    return [None if l < split else cfg.sliding_window for l in range(cfg.num_layers)]


def prefill(
    params: Params,
    cfg: DecoderConfig,
    input_ids: torch.Tensor,  # [B, S] right-padded bucket
    lengths: torch.Tensor,  # [B] true lengths
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Run prompts through the model -> (last-token logits [B, V] f32,
    ks [L, B, KH, S, D], vs).  No pad mask is needed: the input is
    right-padded, so causal masking already keeps real queries on real keys,
    and the call stays mask-free so long buckets take the flash kernel."""
    B, S = input_ids.shape
    cos, sin = _rope_tables(cfg, S, input_ids.device)
    x = _embed(params, cfg, input_ids)
    ks, vs = [], []
    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(cfg, p, h, cos, sin)
        if flash_eligible(q, k):
            # the kernel maps query heads to KV heads itself
            o = flash_attention(q, k, v, causal=True, window=window)
        else:
            o = dot_product_attention(
                q, _repeat_kv(cfg, k), _repeat_kv(cfg, v), causal=True, window=window
            )
        o = o.transpose(1, 2).reshape(B, S, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
        ks.append(k)
        vs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last_idx = torch.clamp(lengths.long() - 1, min=0).to(x.device)
    last = x[torch.arange(B, device=x.device), last_idx]  # [B, E]
    logits = _head_logits(params, cfg, last)
    return logits.float(), torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# Legacy KV cache: the contiguous slot cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class KVCache:
    """The contiguous slot cache: ``k``/``v`` ``[L, B, KH, S, D]`` and
    ``lengths`` ``[B]`` int32 tokens present per slot."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def max_len(self) -> int:
        return self.k.shape[3]


def init_cache(
    cfg: DecoderConfig,
    batch: int,
    max_len: int,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> KVCache:
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, batch, cfg.num_kv_heads, max_len, cfg.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _one(v, device: torch.device) -> torch.Tensor:
    """An int or a tensor as a ``[1]`` int64 tensor on ``device`` (no copy
    of an int64 device tensor, ``torch.full`` for an int: capture-safe)."""
    if torch.is_tensor(v):
        return v.reshape(1).long()
    return torch.full((1,), int(v), dtype=torch.int64, device=device)


def _write_cache(cache_k: torch.Tensor, new_k: torch.Tensor, starts: torch.Tensor) -> None:
    """Per row ``dynamic_update_slice``, in place: ``cache_k`` ``[B, KH, S,
    D]``, ``new_k`` ``[B, KH, Sn, D]`` at positions ``starts[b] + [0, Sn)``,
    each start clamped to ``[0, S - Sn]`` as JAX clamps it."""
    B, _, S, _ = cache_k.shape
    Sn = new_k.shape[2]
    st = starts.long().clamp(0, S - Sn)
    idx = st[:, None] + torch.arange(Sn, device=cache_k.device)[None, :]  # [B, Sn]
    rows = torch.arange(B, device=cache_k.device)[:, None]
    # advanced indices (dims 0 and 2) around a slice: values [B, Sn, KH, D]
    cache_k[rows, :, idx, :] = to_kv_dtype(new_k.transpose(1, 2), cache_k.dtype)


def _last_writer(slots: torch.Tensor) -> torch.Tensor:
    """``[B]`` -> for each row, the last row of the batch with the same slot.
    A scatter that writes row ``last[b]``'s values wherever row ``b`` would
    writes equal values at every repeated index, so it lands what JAX's
    in-order scan lands (the later row wins) whatever order the writes
    take."""
    B = slots.shape[0]
    same = slots[:, None] == slots[None, :]
    order = torch.arange(B, device=slots.device)
    return torch.where(same, order[None, :], -1).amax(dim=1)


def insert_sequences(
    cache: KVCache,
    ks: torch.Tensor,  # [L, B, KH, Sb, D] from prefill
    vs: torch.Tensor,
    lengths: torch.Tensor,  # [B]
    slots: torch.Tensor,  # [B] target slot per prefilled row (pad rows alias a real one)
) -> KVCache:
    """Write prefilled K/V rows into their slots (positions [0, Sb)) and set
    the slots' lengths, in place.  A slot named twice takes the later row
    (:func:`_last_writer`), as the JAX scan's row order does."""
    Sb = ks.shape[3]
    sl = slots.long()
    last = _last_writer(sl)
    cache.k[:, sl, :, :Sb] = to_kv_dtype(ks[:, last], cache.k.dtype)
    cache.v[:, sl, :, :Sb] = to_kv_dtype(vs[:, last], cache.v.dtype)
    cache.lengths[sl] = lengths.to(cache.lengths.dtype)[last]
    return cache


def prefill_suffix(
    params: Params,
    cfg: DecoderConfig,
    input_ids: torch.Tensor,  # [B, C] right-padded suffix tokens (C a bucket)
    cache: KVCache,
    slots: torch.Tensor,  # [B] target slot per row (pad rows alias a real one)
    starts: torch.Tensor,  # [B] tokens already present (the prefix length)
    valids: torch.Tensor,  # [B] real (non-pad) tokens per row
) -> tuple[torch.Tensor, KVCache]:
    """Continue each row from the prefix already in its slot row: the
    suffix runs at RoPE positions ``start + i`` against its row up to its
    own position (:func:`~..ops.attention.chunked_prefill_attention`: the
    row as it was with the suffix's K/V written at ``start``, clamped
    inside the row, as the JAX function's plain attention reads it), then
    each slot takes the suffix K/V of the last row that names it (the JAX
    scan's row order, :func:`_last_writer`) and ``lengths[slot] = start +
    valid``.  Returns (last-token logits [B, V] f32, cache), the cache
    updated in place."""
    B, C = input_ids.shape
    S = cache.max_len
    dev = input_ids.device
    starts = starts.long()
    pos = starts[:, None] + torch.arange(C, device=dev)[None, :]  # [B, C]
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    rope_pos = pos.clamp(max=S - 1)
    cos, sin = cos_t[rope_pos], sin_t[rope_pos]
    x = _embed(params, cfg, input_ids)
    sl = slots.long()
    last = _last_writer(sl)
    # the last writer's window, written wherever any row of its slot writes
    wpos = (starts.clamp(0, S - C)[:, None] + torch.arange(C, device=dev)[None, :])[last]
    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(cfg, p, h, cos, sin)
        kc = to_kv_dtype(k, cache.k.dtype)
        vc = to_kv_dtype(v, cache.v.dtype)
        o = chunked_prefill_attention(q, kc, vc, cache.k[l], cache.v[l], sl, starts,
                                      window=window)
        # advanced indices (dims 0 and 2) around a slice: values [B, C, KH, D]
        cache.k[l][sl[:, None], :, wpos, :] = kc[last].transpose(1, 2)
        cache.v[l][sl[:, None], :, wpos, :] = vc[last].transpose(1, 2)
        o = o.transpose(1, 2).reshape(B, C, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
    cache.lengths[sl] = (starts + valids.long()).to(cache.lengths.dtype)[last]
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last_tok = x[torch.arange(B, device=dev), (valids.long() - 1).clamp(min=0)]
    logits = _head_logits(params, cfg, last_tok)
    return logits.float(), cache


def prefill_chunk(
    params: Params,
    cfg: DecoderConfig,
    input_ids: torch.Tensor,  # [1, C] one chunk of one prompt
    cache: KVCache,
    slot,  # int, or a [1] int64 tensor on the cache's device
    start,  # tokens already written for this slot: int, or a [1] int64 tensor
    valid,  # real (non-pad) tokens in this chunk: int, or a [1] int64 tensor
) -> tuple[torch.Tensor, KVCache]:
    """Extend one slot's row by a chunk of prompt tokens: a one-row
    :func:`prefill_suffix` (logits [1, V] f32 at chunk index ``valid - 1``;
    ``lengths[slot] = start + valid``).  With ``slot`` and ``start`` as
    device tensors the call makes no host round trip and its shapes do not
    depend on them, so one CUDA graph serves every chunk."""
    dev = input_ids.device
    return prefill_suffix(params, cfg, input_ids, cache, _one(slot, dev), _one(start, dev),
                          _one(valid, dev))


def insert_prefix(
    cache: KVCache,
    pk: torch.Tensor,  # [L, KH, Pb, D] roped prefix K (positions [0, Pb))
    pv: torch.Tensor,
    slot,  # int, or a [1] int tensor
) -> KVCache:
    """Copy a cached prefix's K/V into a slot's row (positions [0, Pb)), in
    place.  ``Pb`` may exceed the prefix's length (bucket padding); the
    suffix prefill overwrites or masks the tail and sets the length."""
    sl = _one(slot, cache.k.device)
    Pb = pk.shape[2]
    cache.k[:, sl, :, :Pb] = to_kv_dtype(pk[:, None], cache.k.dtype)
    cache.v[:, sl, :, :Pb] = to_kv_dtype(pv[:, None], cache.v.dtype)
    return cache


def extract_prefix(cache: KVCache, slot, pb: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The first ``pb`` positions of a slot's row -> ([L, KH, pb, D]) x2, a
    copy (post-RoPE K at absolute positions [0, pb), right for every later
    consumer, which places the prefix at the same offsets)."""
    sl = _one(slot, cache.k.device)
    return (cache.k.index_select(1, sl)[:, 0, :, :pb].clone(),
            cache.v.index_select(1, sl)[:, 0, :, :pb].clone())


def decode_step(
    params: Params,
    cfg: DecoderConfig,
    tokens: torch.Tensor,  # [B] int — last sampled token per slot
    cache: KVCache,
    *,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive slots are frozen
    kv_chunk: Optional[int] = None,  # the chunked, length-aware read
    attn_fp8: bool = False,  # fp8 in-dot attention (needs kv_chunk and an fp8 cache)
) -> tuple[torch.Tensor, KVCache]:
    """One autoregressive step for every active slot over the slot cache ->
    (logits [B, V] f32, cache), in place.  ``kv_chunk`` (dividing the row,
    below it) reads the cache through :func:`chunked_gqa_decode_attention`,
    only the chunks up to the batch's longest live position; ``None`` (or a
    chunk of the whole row) is the full-row read, plain attention under the
    causal mask as the JAX function's.  ``attn_fp8`` needs the chunked
    read.  Slots whose row is full are frozen (``lengths < max_len``).  As
    in the JAX function, every slot, inactive ones too, writes its K/V at
    ``min(lengths, max_len - 1)``: a stale slot's write lands past its
    valid length, where no read looks and the next prefill overwrites."""
    B = tokens.shape[0]
    L, _, KH, S, D = cache.k.shape
    H = cfg.num_heads
    dev = tokens.device
    if kv_chunk is not None and kv_chunk < S and (kv_chunk <= 0 or S % kv_chunk):
        raise ValueError(
            f"kv_chunk={kv_chunk} must divide cache max_len={S} "
            "(or be None / >= max_len for the full-cache read)"
        )
    chunked = kv_chunk is not None and kv_chunk < S
    if attn_fp8 and not chunked:
        raise ValueError(
            "attn_fp8 requires the chunked KV read (set decode_kv_chunk) — "
            "the full-cache gqa path has no in-dot fp8 scheme"
        )
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    active = active & (cache.lengths < S)
    positions = torch.clamp(cache.lengths, max=S - 1)
    pos_l = positions.long()
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    cos = cos_t[pos_l][:, None, :]
    sin = sin_t[pos_l][:, None, :]
    x = _embed(params, cfg, tokens)[:, None, :]  # [B, 1, E]
    rows = torch.arange(B, device=dev)
    kpos = torch.arange(S, device=dev)[None, :]
    causal_keep = (kpos <= positions[:, None])[:, None, None, :]  # [B, 1, 1, S]
    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, p, h)
        q = apply_rope(q.reshape(B, 1, H, D), cos, sin).transpose(1, 2)
        k = apply_rope(k.reshape(B, 1, KH, D), cos, sin).transpose(1, 2)
        v = v.reshape(B, 1, KH, D).transpose(1, 2)
        cache.k[l][rows, :, pos_l, :] = to_kv_dtype(k[:, :, 0, :], cache.k.dtype)
        cache.v[l][rows, :, pos_l, :] = to_kv_dtype(v[:, :, 0, :], cache.v.dtype)
        if chunked:
            o = chunked_gqa_decode_attention(
                q, cache.k[l], cache.v[l], positions, chunk=kv_chunk, active=active,
                window=window, fp8_dot=attn_fp8,
            )  # [B, H, 1, D]
        else:
            mask = causal_keep
            if window is not None:
                mask = mask & (kpos > positions[:, None] - window)[:, None, None, :]
            o = gqa_dot_product_attention(q, cache.k[l], cache.v[l], mask=mask)
        o = o.transpose(1, 2).reshape(B, 1, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
    cache.lengths.add_(active.to(cache.lengths.dtype))
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps)
    logits = _head_logits(params, cfg, x)
    return logits.float(), cache


def verify_tree_step(
    params: Params,
    cfg: DecoderConfig,
    tree: torch.Tensor,  # [B, T] int flat speculation tree (col 0 = input token)
    cache: KVCache,
    depths: torch.Tensor,  # [T] int node depths (root = 0)
    anc_mask: torch.Tensor,  # [T, T] bool — anc_mask[t, u]: u ancestor-or-self of t
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The tree-verify forward against the slot cache -> (logits [B, T, V]
    f32, tks, tvs [L, B, KH, T, D]), read-only: node t of row b runs at
    position ``lengths[b] + depths[t]`` (clamped to the row) and attends,
    through plain attention over the row's keys followed by the tree's own
    as the JAX function's, to the verified prefix (positions < lengths) and
    its root-path ancestors.  The caller commits the accepted path
    (:func:`commit_tree_path`)."""
    B, T = tree.shape
    S = cache.max_len
    dev = tree.device
    lengths = cache.lengths.long()
    depths_l = depths.long().to(dev)
    pos = (lengths[:, None] + depths_l[None, :]).clamp(max=S - 1)  # [B, T]
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    cos, sin = cos_t[pos], sin_t[pos]
    x = _embed(params, cfg, tree)  # [B, T, E]
    kpos = torch.arange(S, device=dev)[None, None, None, :]
    prefix_keep = (kpos < lengths[:, None, None, None]).expand(B, 1, T, S)
    anc = anc_mask.to(dev)[None, None]  # [1, 1, T, T]
    tks, tvs = [], []
    for l, window in enumerate(_layer_windows(cfg)):
        cache_mask, tree_keep = prefix_keep, anc
        if window is not None:
            cache_mask = cache_mask & (kpos > pos[:, None, :, None] - window)
            upos = lengths[:, None, None, None] + depths_l[None, None, None, :]
            tree_keep = tree_keep & (upos > pos[:, None, :, None] - window)
        attn_mask = torch.cat([cache_mask, tree_keep.expand(B, 1, T, T)], dim=3)
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(cfg, p, h, cos, sin)
        keys = torch.cat([cache.k[l].to(k.dtype), k], dim=2)
        vals = torch.cat([cache.v[l].to(v.dtype), v], dim=2)
        o = gqa_dot_product_attention(q, keys, vals, mask=attn_mask)
        o = o.transpose(1, 2).reshape(B, T, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
        tks.append(k)
        tvs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _head_logits(params, cfg, x)
    return logits.float(), torch.stack(tks), torch.stack(tvs)


def commit_tree_path(
    cache: KVCache,
    tks: torch.Tensor,  # [L, B, KH, T, D] from verify_tree_step
    tvs: torch.Tensor,
    path_idx: torch.Tensor,  # [B, C] flat tree ids: root + winning branch
) -> KVCache:
    """Write the path's K/V at positions ``[lengths, lengths + C)`` of
    every row, in place (the start clamped inside the row, as
    ``dynamic_update_slice``).  Positions past the accepted run take the
    rejected rest of the branch: garbage past the new valid length, masked
    by every later read and overwritten when real tokens land there, the
    contiguous layout's discipline.  ``cache.lengths`` is not advanced."""
    L, B, KH, S, D = cache.k.shape
    C = path_idx.shape[1]
    pk = _gather_tree_path(tks, path_idx)  # [L, B, KH, C, D]
    pv = _gather_tree_path(tvs, path_idx)
    st = cache.lengths.long().clamp(0, S - C)
    idx = st[:, None] + torch.arange(C, device=st.device)[None, :]  # [B, C]
    rows = torch.arange(B, device=st.device)[:, None]
    # advanced indices (dims 1 and 3) around a slice: values [B, C, L, KH, D]
    cache.k[:, rows, :, idx, :] = to_kv_dtype(pk.permute(1, 3, 0, 2, 4), cache.k.dtype)
    cache.v[:, rows, :, idx, :] = to_kv_dtype(pv.permute(1, 3, 0, 2, 4), cache.v.dtype)
    return cache


# ---------------------------------------------------------------------------
# Paged KV cache
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PagedKVCache:
    """Page pools ``k``/``v`` of ``[L, P + 1, KH, page, D]`` (page ``P`` is the
    write-only dump page, see the module docstring) and ``lengths`` ``[slots]``
    int32 tokens present per slot."""

    k: torch.Tensor
    v: torch.Tensor
    lengths: torch.Tensor

    @property
    def n_pages(self) -> int:
        return self.k.shape[1] - 1

    @property
    def page_size(self) -> int:
        return self.k.shape[3]


def init_paged_cache(
    cfg: DecoderConfig,
    batch: int,
    n_pages: int,
    page_size: int,
    dtype: Optional[torch.dtype] = None,
    device: Optional[torch.device] = None,
) -> PagedKVCache:
    dtype = dtype or cfg.dtype
    shape = (cfg.num_layers, n_pages + 1, cfg.num_kv_heads, page_size, cfg.head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        lengths=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def _chunk_write_targets(
    block_tables: torch.Tensor,  # [B, NB]
    starts: torch.Tensor,  # [B] int64
    valids: torch.Tensor,  # [B]
    C: int,
    page: int,
    P: int,
) -> tuple:
    """Where a chunk's C tokens land: ``(pages, offsets)``, both [B, C].
    Token i of row b sits at ``min(start, S - C) + i`` (the write window,
    clamped inside the row as ``dynamic_update_slice`` does) and goes to
    that position's page when its logical block overlaps ``[start, start +
    valid)``, the JAX write mask; else, and for a sentinel entry, to the
    dump page ``P``.  Blocks below are shared prefix pages, which must never
    be rewritten.  The pools so get the bytes the JAX scatter of whole
    written blocks gives them: a written block's other positions keep the
    page's own values."""
    NB = block_tables.shape[1]
    S = NB * page
    wpos = starts.clamp(max=S - C)[:, None] + torch.arange(C, device=starts.device)[None, :]
    nb = torch.arange(NB, device=starts.device)[None, :]
    written = ((nb + 1) * page > starts[:, None]) & (nb * page < (starts + valids.long())[:, None])
    blk = wpos // page
    write = torch.gather(written, 1, blk)
    phys = torch.gather(block_tables.long(), 1, blk)
    return torch.where(write, phys.clamp(max=P), P), wpos % page


def _write_chunk_tokens(pool: torch.Tensor, chunk: torch.Tensor, pages: torch.Tensor,
                        offsets: torch.Tensor) -> None:
    """``pool`` [P + 1, KH, page, D] (one layer) takes ``chunk`` [B, KH, C,
    D] (in the pool's dtype) at (``pages``, ``offsets``) [B, C], in place."""
    # advanced indices (dims 0 and 2) around a slice: values [B, C, KH, D]
    pool[pages, :, offsets, :] = chunk.transpose(1, 2)


def _set_lengths(lengths: torch.Tensor, slots: torch.Tensor, values: torch.Tensor) -> None:
    """``lengths.at[slots].set(values, mode="drop")``, in place: slots >=
    len(lengths) (the pad-row sentinel) drop, without a host round trip."""
    n = lengths.shape[0]
    ext = torch.cat([lengths, lengths.new_zeros(1)])
    ext[slots.long().clamp(max=n)] = values.to(lengths.dtype)
    lengths.copy_(ext[:n])


def insert_sequences_paged(
    cache: PagedKVCache,
    ks: torch.Tensor,  # [L, B, KH, Sb, D] from prefill
    vs: torch.Tensor,
    lengths: torch.Tensor,  # [B]
    slots: torch.Tensor,  # [B] target slot (slot-count sentinel = pad row)
    block_tables: torch.Tensor,  # [B, NB]; pad rows carry the P sentinel
) -> PagedKVCache:
    """Write prefilled K/V rows into their slots' pages (positions [0, Sb)).
    Blocks past a row's allocation and pad rows go to the dump page."""
    L, P1, KH, page, D = cache.k.shape
    P = P1 - 1
    B, Sb = ks.shape[1], ks.shape[3]
    NB = block_tables.shape[1]
    nbw = min(NB, -(-Sb // page))
    pad_s = nbw * page - Sb
    if pad_s:
        ks = torch.nn.functional.pad(ks, (0, 0, 0, pad_s))
        vs = torch.nn.functional.pad(vs, (0, 0, 0, pad_s))
    for j in range(nbw):
        tgt = block_tables[:, j].long().clamp(max=P)
        cache.k[:, tgt] = to_kv_dtype(ks[:, :, :, j * page : (j + 1) * page], cache.k.dtype)
        cache.v[:, tgt] = to_kv_dtype(vs[:, :, :, j * page : (j + 1) * page], cache.v.dtype)
    _set_lengths(cache.lengths, slots, lengths)
    return cache


def copy_pages(cache: PagedKVCache, src: torch.Tensor, dst: torch.Tensor) -> PagedKVCache:
    """Clone whole pages inside the pool, in place (the allocator's
    copy-on-write primitive: a prefix sharer clones the boundary page its own
    suffix will write into).  ``src``/``dst`` are ``[n]`` physical page ids;
    ``dst`` entries >= P land in the dump page (the JAX copy drops them)."""
    P = cache.n_pages
    s = src.long().clamp(0, P - 1)
    d = dst.long().clamp(max=P)
    cache.k[:, d] = cache.k[:, s]
    cache.v[:, d] = cache.v[:, s]
    return cache


def prefill_suffix_paged(
    params: Params,
    cfg: DecoderConfig,
    input_ids: torch.Tensor,  # [B, C] right-padded suffix tokens (C a bucket)
    cache: PagedKVCache,
    block_tables: torch.Tensor,  # [B, NB] each row's full logical page chain
    slots: torch.Tensor,  # [B] (slot-count sentinel = pad row)
    starts: torch.Tensor,  # [B] tokens already present (the prefix length)
    valids: torch.Tensor,  # [B] real (non-pad) tokens per row
) -> tuple[torch.Tensor, PagedKVCache]:
    """Continue each row from its shared prefix: the suffix forward at RoPE
    positions ``start + i`` against the row's keys up to its own position
    (causal; :func:`~..ops.attention.paged_prefill_attention`, which reads
    the row's pages through its block table and the chunk's own K/V, the
    JAX function's gather + write + plain attention), then each layer's
    chunk tokens written into their pages, only in the blocks overlapping
    ``[start, start + valid)``.  Blocks below are the shared prefix pages,
    physically shared with other requests, so they are never rewritten (the
    other tokens land in the dump page).  Returns (last-token logits [B, V]
    f32, cache)."""
    B, C = input_ids.shape
    P, page = cache.n_pages, cache.page_size
    S = block_tables.shape[1] * page
    dev = input_ids.device
    starts = starts.long()
    pos = starts[:, None] + torch.arange(C, device=dev)[None, :]
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    rope_pos = pos.clamp(max=S - 1)
    cos, sin = cos_t[rope_pos], sin_t[rope_pos]
    x = _embed(params, cfg, input_ids)
    pages, offsets = _chunk_write_targets(block_tables, starts, valids, C, page, P)
    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(cfg, p, h, cos, sin)
        kc = to_kv_dtype(k, cache.k.dtype)
        vc = to_kv_dtype(v, cache.v.dtype)
        o = paged_prefill_attention(q, kc, vc, cache.k[l], cache.v[l], block_tables, starts,
                                    window=window)
        _write_chunk_tokens(cache.k[l], kc, pages, offsets)
        _write_chunk_tokens(cache.v[l], vc, pages, offsets)
        o = o.transpose(1, 2).reshape(B, C, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
    _set_lengths(cache.lengths, slots, starts + valids.long())
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    last = x[torch.arange(B, device=dev), (valids.long() - 1).clamp(min=0)]
    logits = _head_logits(params, cfg, last)
    return logits.float(), cache


def prefill_chunk_paged(
    params: Params,
    cfg: DecoderConfig,
    input_ids: torch.Tensor,  # [1, C] one chunk of one prompt
    cache: PagedKVCache,
    block_table: torch.Tensor,  # [NB] the target slot's page chain
    slot,  # int, or a [1] int64 tensor on the cache's device
    start,  # tokens already written for this slot: int, or a [1] int64 tensor
    valid: int,  # real (non-pad) tokens in this chunk
) -> tuple[torch.Tensor, PagedKVCache]:
    """One chunk of one long prompt extends the slot's page chain: a
    one-row :func:`prefill_suffix_paged`.  With ``slot`` and ``start`` as
    device tensors the call makes no host round trip and its shapes do not
    depend on them, so one CUDA graph serves every chunk."""
    C = input_ids.shape[1]
    S = block_table.shape[0] * cache.page_size
    if isinstance(start, int) and start + C > S:
        raise ValueError(f"chunk [{start}, {start + C}) runs past the cache ({S})")
    dev = input_ids.device
    return prefill_suffix_paged(params, cfg, input_ids, cache, block_table[None, :],
                                _one(slot, dev), _one(start, dev), _one(valid, dev))


def decode_step_paged(
    params: Params,
    cfg: DecoderConfig,
    tokens: torch.Tensor,  # [B] int — last sampled token per slot
    cache: PagedKVCache,
    block_tables: torch.Tensor,  # [B, NB] int32
    *,
    active: Optional[torch.Tensor] = None,  # [B] bool; inactive slots are frozen
    attn_fp8: bool = False,  # fp8 in-dot attention (needs an fp8 pool)
) -> tuple[torch.Tensor, PagedKVCache]:
    """One autoregressive step for every active slot -> (logits [B, V] f32,
    cache).  ``attn_fp8`` reads an fp8 pool with the in-dot scheme
    (``fp8_dot`` of :func:`paged_gqa_decode_attention`).  The K/V write goes
    to ``block_table[b, pos // page]`` at offset ``pos % page``; inactive
    rows and rows past their allocation write the dump page (the JAX code's
    dropped P-sentinel scatter), so a stale row can never land in a page
    re-assigned to another request."""
    B = tokens.shape[0]
    L, P1, KH, page, D = cache.k.shape
    P = P1 - 1
    NB = block_tables.shape[1]
    S = NB * page
    H = cfg.num_heads
    dev = tokens.device
    if active is None:
        active = torch.ones((B,), dtype=torch.bool, device=dev)
    active = active & (cache.lengths < S)
    positions = torch.clamp(cache.lengths, max=S - 1)
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    cos = cos_t[positions.long()][:, None, :]
    sin = sin_t[positions.long()][:, None, :]

    x = _embed(params, cfg, tokens)[:, None, :]  # [B, 1, E]
    blk = (positions // page).long()
    off = (positions % page).long()
    phys = torch.gather(block_tables.long(), 1, blk[:, None])[:, 0]
    phys_w = torch.where(active, torch.clamp(phys, max=P), P)
    bt = block_tables.to(torch.int32)

    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _qkv(cfg, p, h)
        q = apply_rope(q.reshape(B, 1, H, D), cos, sin).transpose(1, 2)
        k = apply_rope(k.reshape(B, 1, KH, D), cos, sin).transpose(1, 2)
        v = v.reshape(B, 1, KH, D).transpose(1, 2)
        cache.k[l][phys_w, :, off, :] = to_kv_dtype(k[:, :, 0, :], cache.k.dtype)
        cache.v[l][phys_w, :, off, :] = to_kv_dtype(v[:, :, 0, :], cache.v.dtype)
        o = paged_gqa_decode_attention(
            q, cache.k[l, :P], cache.v[l, :P], bt, positions,
            active=active, window=window, fp8_dot=attn_fp8,
        )  # [B, H, 1, D]
        o = o.transpose(1, 2).reshape(B, 1, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
    cache.lengths.add_(active.to(cache.lengths.dtype))
    x = rms_norm(x[:, 0], params["final_norm"], cfg.rms_norm_eps)
    logits = _head_logits(params, cfg, x)
    return logits.float(), cache



# ---------------------------------------------------------------------------
# Speculative decoding: the tree verify forward and the accepted-path commit
# ---------------------------------------------------------------------------


def verify_tree_step_paged(
    params: Params,
    cfg: DecoderConfig,
    tree: torch.Tensor,  # [B, T] int flat speculation tree (col 0 = input token)
    cache: PagedKVCache,
    block_tables: torch.Tensor,  # [B, NB] int32
    depths: torch.Tensor,  # [T] int32 node depths (root = 0)
    anc_mask: torch.Tensor,  # [T, T] bool — anc_mask[t, u]: u ancestor-or-self of t
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One forward over every tree node -> (logits [B, T, V] f32, tks, tvs
    [L, B, KH, T, D]).  Node t of row b runs at position ``lengths[b] +
    depths[t]`` (RoPE at that position, clamped to the row), attends to the
    row's verified prefix (positions < lengths) read in place from the page
    pool plus its own root-path ancestors through the tree's fresh K/V.
    Read-only with respect to the cache: the caller commits the accepted
    path's K/V (:func:`commit_tree_path_paged`).  The projections are
    :func:`_attn_proj` at the nodes' positions: the JAX ``_tree_qkv`` only
    keeps the tree dim out of the mesh's sequence sharding, and the port
    has no mesh."""
    B, T = tree.shape
    L, P1, KH, page, D = cache.k.shape
    P = P1 - 1
    NB = block_tables.shape[1]
    S = NB * page
    dev = tree.device
    lengths = cache.lengths
    pos = (lengths.long()[:, None] + depths.long()[None, :]).clamp(max=S - 1)
    cos_t, sin_t = _rope_tables(cfg, S, dev)
    cos, sin = cos_t[pos], sin_t[pos]  # [B, T, D/2]
    bt = block_tables.to(torch.int32)
    x = _embed(params, cfg, tree)  # [B, T, E]
    tks, tvs = [], []
    for l, window in enumerate(_layer_windows(cfg)):
        p = _layer(params, l)
        h = rms_norm(x, p["attn_norm"], cfg.rms_norm_eps)
        q, k, v = _attn_proj(cfg, p, h, cos, sin)
        o = paged_tree_attention(
            q, cache.k[l, :P], cache.v[l, :P], bt, lengths, k, v, anc_mask, depths,
            window=window,
        )  # [B, H, T, D]
        o = o.transpose(1, 2).reshape(B, T, -1)
        x = x + qeinsum("bso,oe->bse", o, p["wo"], cfg.dtype)
        h = rms_norm(x, p["mlp_norm"], cfg.rms_norm_eps)
        x = x + _mlp(cfg, p, h)
        tks.append(k)
        tvs.append(v)
    x = rms_norm(x, params["final_norm"], cfg.rms_norm_eps)
    logits = _head_logits(params, cfg, x)  # [B, T, V]
    return logits.float(), torch.stack(tks), torch.stack(tvs)


def _gather_tree_path(tks: torch.Tensor, path_idx: torch.Tensor) -> torch.Tensor:
    """[L, B, KH, T, D] tree K/V stack + [B, C] flat node ids -> [L, B, KH, C, D]."""
    L, B, KH, T, D = tks.shape
    C = path_idx.shape[1]
    idx = path_idx.long()[None, :, None, :, None].expand(L, B, KH, C, D)
    return torch.gather(tks, 3, idx)


def commit_tree_path_paged(
    cache: PagedKVCache,
    tks: torch.Tensor,  # [L, B, KH, T, D] from verify_tree_step_paged
    tvs: torch.Tensor,
    path_idx: torch.Tensor,  # [B, C] flat tree ids: root + winning branch
    block_tables: torch.Tensor,  # [B, NB]
    n_commit: torch.Tensor,  # [B] tokens of the path to commit (1 + accepted)
    active: torch.Tensor,  # [B] bool
) -> PagedKVCache:
    """Write the accepted path's K/V at positions ``lengths + j`` through the
    block table, in place: page ``block_table[b, (lengths + j) // page]``,
    offset ``(lengths + j) % page``.  Only ``j < n_commit`` of active rows,
    at a position inside the row and a block-table entry < P, lands in the
    pool; every other write goes to the dump page (the JAX function's
    dropped scatter): a write past the accepted run could alias a page
    handed to another request.  ``cache.lengths`` is not advanced (the
    caller does that once acceptance is known)."""
    L, P1, KH, page, D = cache.k.shape
    P = P1 - 1
    B, C = path_idx.shape
    NB = block_tables.shape[1]
    S = NB * page
    lengths = cache.lengths.long()
    n_commit = n_commit.long()
    pk = _gather_tree_path(tks, path_idx)  # [L, B, KH, C, D]
    pv = _gather_tree_path(tvs, path_idx)
    bt = block_tables.long()
    for j in range(C):
        pos = lengths + j
        ok = active & (j < n_commit) & (pos < S)
        blk = torch.clamp(pos // page, max=NB - 1)
        off = torch.where(ok, pos % page, 0)
        phys = torch.gather(bt, 1, blk[:, None])[:, 0]
        phys_w = torch.where(ok, torch.clamp(phys, max=P), P)
        # advanced indices (dims 1 and 3) around a slice put the batch dim
        # first: values [B, L, KH, D]
        cache.k[:, phys_w, :, off, :] = to_kv_dtype(
            pk[:, :, :, j, :].transpose(0, 1), cache.k.dtype)
        cache.v[:, phys_w, :, off, :] = to_kv_dtype(
            pv[:, :, :, j, :].transpose(0, 1), cache.v.dtype)
    return cache
