"""Projection products and weight-only int8 / grouped int4 (port of ``ops/quant.py``).

On a plain weight, the JAX package's ``qeinsum`` is an einsum in the model
dtype that XLA lowers to a matrix product; here every projection pattern of
the model (``x[..., in] . w[in, out]``) goes straight to ``torch.matmul``,
and other patterns to ``torch.einsum``.

Quantized weights keep the JAX layouts.  :class:`QTensor` is int8 ``q`` of
the weight's shape with f32 per-output-channel scales (contracted axis -2
of size 1); :class:`QTensor4` packs two int4 values per byte along the
contraction axis (uint8 ``[..., in/2, out]``, the low nibble the even
index) with f32 scales per (group, output channel), ``[..., in/g, out]``.
The quantizers run on the host in numpy, as the JAX ones do, and give the
same bytes.  In JAX the two types are NamedTuples, so ``qt[l]`` would be a
field; here they are classes, and a layer's slice is :meth:`QTensor.layer`.

:func:`qeinsum` on a quantized weight routes by device: a CPU tensor takes
the plain twin :func:`qeinsum_plain`, a CUDA tensor the weight-only GEMM
kernel (``csrc/qgemm.cu`` via :func:`~..kernels.qgemm`), which reads only
the integers and dequantizes in registers.  A call the kernel does not take
(a pattern outside ``x[..., in] . w[in, out]``, or what
:func:`kernel_refusal` names) raises; there is no fallback.
:func:`qeinsum_group` runs projections of one x (QKV, gate/up) as one
launch of the kernel's stream route where it takes them, and
:func:`tied_head` a tied int8 embedding table as the head (the kernel's
K-contiguous form on the card, :func:`tied_head_plain` on the CPU).
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import numpy as np
import torch

QUANTIZABLE = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")

# default int4 group width along the contraction axis (the JAX package's)
INT4_GROUP_SIZE = 64

# the JAX engine's kv_cache_dtype knob -> pool dtype (None: the model's);
# "bf16" is bfloat16 even under an f32 model, fp8 halves the pool's bytes
KV_CACHE_DTYPES = {
    None: None,
    "bf16": torch.bfloat16,
    "fp8": torch.float8_e4m3fn,
    "fp8_e5m2": torch.float8_e5m2,
}
FP8_DTYPES = (torch.float8_e4m3fn, torch.float8_e5m2)
# |x| past which ml_dtypes (and so JAX's astype) rounds to NaN in e4m3fn
# (the midpoint of 448 and the 480 the format lacks; 464 itself rounds to
# even, 448), and to inf in e5m2 (the midpoint of 57344 and 65536)
_E4M3_NAN_FROM = 464.0
_E5M2_INF_FROM = 61440.0


def to_kv_dtype(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x.astype(dtype)`` as JAX computes it, for a page-pool write.
    On the CPU torch's ``.to(float8_e4m3fn)`` saturates (464.1, 1000 and
    inf become +-448) where ml_dtypes gives NaN past 464; inside that range
    the two round alike (round to nearest even, subnormals included).  So
    on the CPU the values past the edge are set to JAX's result first (NaN
    for e4m3fn, signed inf for e5m2), then cast.  On the card torch's cast
    already gives those bits (c10's scalar conversion, no saturation), so a
    CUDA tensor takes ``.to`` alone: the fix-up would cost five elementwise
    launches a write.  ``chip_smoke.py`` phase 2 and the card tests hold
    the card's bits to the CPU's on a grid past both formats' edges.  Plain
    elementwise torch either way, which a CUDA graph captures.  Other
    dtypes cast as ``.to``."""
    if x.dtype == dtype or x.device.type == "cuda":
        return x.to(dtype)
    if dtype == torch.float8_e4m3fn:
        x = torch.where(x.abs() > _E4M3_NAN_FROM, torch.full_like(x, float("nan")), x)
    elif dtype == torch.float8_e5m2:
        x = torch.where(x.abs() >= _E5M2_INF_FROM, x * float("inf"), x)
    return x.to(dtype)


def quantize_fp8(x: torch.Tensor, axis: int = -1, dtype: torch.dtype = torch.float8_e4m3fn):
    """Symmetric per-vector fp8 quantization along ``axis`` -> ``(q, scale)``,
    the JAX function's arithmetic: ``scale = max(amax / finfo.max, 1e-12)``
    in f32 (kept with size 1 on ``axis``), ``q = x / scale`` cast to
    ``dtype`` (:func:`to_kv_dtype`).  The in-dot decode quantizes its query
    with it; the card's kernels do the same arithmetic in their prologue."""
    fmax = float(torch.finfo(dtype).max)
    xf = x.float()
    amax = xf.abs().amax(dim=axis, keepdim=True)
    scale = torch.clamp_min(amax / fmax, 1e-12)
    return to_kv_dtype(xf / scale, dtype), scale


class QuantizedWeight:
    """What the two formats share: the integer payload ``q``, the f32
    ``scale``, and the layer slice of a layer-stacked leaf."""

    bits = 16

    def __init__(self, q: torch.Tensor, scale: torch.Tensor):
        self.q = q
        self.scale = scale

    def layer(self, l: int) -> "QuantizedWeight":
        """Layer ``l`` of a layer-stacked weight (views of q and scale)."""
        return type(self)(self.q[l], self.scale[l])

    def to(self, device) -> "QuantizedWeight":
        return type(self)(self.q.to(device), self.scale.to(device))

    @property
    def device(self) -> torch.device:
        return self.q.device

    @property
    def nbytes(self) -> int:
        return self.q.numel() * self.q.element_size() + self.scale.numel() * 4

    @property
    def in_features(self) -> int:
        return self.q.shape[-2]

    def __repr__(self) -> str:
        return f"{type(self).__name__}(q={tuple(self.q.shape)}, scale={tuple(self.scale.shape)})"


class QTensor(QuantizedWeight):
    """Weight-only int8: ``q`` int8 of the weight's shape, ``scale`` f32 of
    the same rank with the contracted axis (-2) of size 1."""

    bits = 8


class QTensor4(QuantizedWeight):
    """Group-quantized int4: ``q`` uint8 ``[..., in/2, out]`` (low nibble the
    even contraction index, high nibble the odd one, each a two's-complement
    value in [-8, 7]); ``scale`` f32 ``[..., in/g, out]``.  The group size
    follows from the shapes, as in the JAX type."""

    bits = 4

    @property
    def group_size(self) -> int:
        return 2 * self.q.shape[-2] // self.scale.shape[-2]

    @property
    def in_features(self) -> int:
        return 2 * self.q.shape[-2]


def _host_f32(w) -> np.ndarray:
    if isinstance(w, torch.Tensor):
        return w.detach().to("cpu", torch.float32).numpy()
    return np.asarray(w, np.float32)


def _quantize8_np(wf: np.ndarray):
    amax = np.max(np.abs(wf), axis=-2, keepdims=True)
    scale = np.maximum(amax / 127.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(wf / scale), -127, 127).astype(np.int8)
    return q, scale


def quantize_tensor(w) -> QTensor:
    """Symmetric per-output-channel int8 over contraction axis -2, on the
    host (numpy; the JAX function's arithmetic).  The result lies on the
    CPU."""
    q, scale = _quantize8_np(_host_f32(w))
    return QTensor(torch.from_numpy(q), torch.from_numpy(scale))


def _int4_group(dim: int, group_size: int) -> int:
    """The group width for a contraction dim: the largest even divisor of
    ``dim`` that is <= ``group_size``."""
    g = max(2, min(int(group_size), dim))
    while dim % g or g % 2:
        g -= 1
        if g < 2:
            raise ValueError(
                f"int4 needs an even contraction dim with an even divisor "
                f"group size; got dim={dim}, group_size={group_size}"
            )
    return g


def pack_int4(vals: np.ndarray) -> np.ndarray:
    """Pack ints in [-8, 7] two per byte along axis -2 -> uint8 with half the
    axis length.  Low nibble = even index, high nibble = odd."""
    if vals.shape[-2] % 2:
        raise ValueError(f"contraction dim {vals.shape[-2]} must be even to pack")
    u = (np.asarray(vals).astype(np.int16) & 0xF).astype(np.uint8)
    return (u[..., 0::2, :] | (u[..., 1::2, :] << 4)).astype(np.uint8)


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """uint8 ``[..., P, O]`` -> int8 ``[..., 2P, O]`` (sign-extended nibbles)."""
    lo = (q & 0xF).to(torch.int8)
    hi = (q >> 4).to(torch.int8)
    lo = (lo ^ 8) - 8
    hi = (hi ^ 8) - 8
    both = torch.stack([lo, hi], dim=-2)  # [..., P, 2, O]
    return both.reshape(q.shape[:-2] + (2 * q.shape[-2], q.shape[-1]))


def _quantize4_np(wf: np.ndarray, group_size: int):
    dim, out_dim = wf.shape[-2], wf.shape[-1]
    g = _int4_group(dim, group_size)
    grp = wf.reshape(wf.shape[:-2] + (dim // g, g, out_dim))
    amax = np.max(np.abs(grp), axis=-2, keepdims=True)  # [..., G, 1, O]
    scale = np.maximum(amax / 7.0, 1e-12).astype(np.float32)
    q = np.clip(np.rint(grp / scale), -8, 7).astype(np.int8)
    return pack_int4(q.reshape(wf.shape)), np.squeeze(scale, axis=-2)


def quantize_tensor_int4(w, group_size: int = INT4_GROUP_SIZE) -> QTensor4:
    """Symmetric per-(group, output-channel) int4 over contraction axis -2,
    on the host like :func:`quantize_tensor`."""
    q, scale = _quantize4_np(_host_f32(w), group_size)
    return QTensor4(torch.from_numpy(q), torch.from_numpy(scale))


def deq(w: Any, dtype: torch.dtype) -> torch.Tensor:
    """The dequantized weight in ``dtype`` (pass-through for a dense one)."""
    if isinstance(w, QTensor4):
        vals = unpack_int4(w.q).float()  # [..., dim, O]
        dim, out_dim = vals.shape[-2], vals.shape[-1]
        G = w.scale.shape[-2]
        grp = vals.reshape(vals.shape[:-2] + (G, dim // G, out_dim))
        grp = grp * w.scale[..., :, None, :]
        return grp.reshape(vals.shape).to(dtype)
    if isinstance(w, QTensor):
        return (w.q.float() * w.scale).to(dtype)
    return w


@functools.lru_cache(maxsize=64)
def _is_projection(pattern: str) -> bool:
    """``"<x>c,co-><x>o"``: contract x's last axis with w's first, keep the rest."""
    lhs, out = pattern.replace(" ", "").split("->")
    xs, ws = lhs.split(",")
    return len(ws) == 2 and xs[-1] == ws[0] and out == xs[:-1] + ws[1]


def qeinsum_plain(pattern: str, x: torch.Tensor, w: Any, dtype: torch.dtype) -> torch.Tensor:
    """The JAX ``qeinsum``'s arithmetic in plain PyTorch, rounding where it
    rounds.  int8: ``(x . q) * scale``, the product rounded to ``dtype``
    and the scale rounded to ``dtype`` before the multiply.  int4: each
    group's partial product ``x[..., G, g] . q[G, g, O]`` rounded to
    ``dtype``, times the ``dtype``-rounded scale, summed over the groups in
    f32 and rounded once.  A pattern outside the ``[..., in, out]`` contract
    takes the dequantized weight, as in JAX."""
    if isinstance(w, QTensor4):
        xs, rest = pattern.replace(" ", "").split(",")
        ws, os_ = rest.split("->")
        if not (xs[-1] == ws[-2] and ws[-1] == os_[-1]):
            return torch.einsum(pattern, x, deq(w, dtype))
        vals = unpack_int4(w.q).to(dtype)  # [..., dim, O]
        dim, out_dim = vals.shape[-2], vals.shape[-1]
        G = w.scale.shape[-2]
        grp_w = vals.reshape(vals.shape[:-2] + (G, dim // G, out_dim))
        grp_x = x.to(dtype).reshape(x.shape[:-1] + (G, dim // G))
        partial = torch.einsum(
            f"{xs[:-1]}GZ,{ws[:-2]}GZ{ws[-1]}->{os_[:-1]}G{os_[-1]}", grp_x, grp_w
        )
        out = torch.einsum(
            f"{os_[:-1]}G{os_[-1]},{ws[:-2]}G{ws[-1]}->{os_}",
            partial.float(), w.scale.to(dtype).float(),
        )
        return out.to(dtype)
    if isinstance(w, QTensor):
        if _is_projection(pattern):
            y = torch.matmul(x.to(dtype), w.q.to(dtype))
        else:
            y = torch.einsum(pattern, x.to(dtype), w.q.to(dtype))
        return y * w.scale.squeeze(-2).to(dtype)
    if _is_projection(pattern):
        return torch.matmul(x, w)
    return torch.einsum(pattern, x, w)


def kernel_refusal(w: Any, dtype: torch.dtype) -> Optional[str]:
    """Why no route of the weight-only GEMM kernel takes a projection onto
    the quantized weight ``w`` with activations in ``dtype`` (None if one
    does): the activations must be f32 or bf16 and the weight 2-D.  Every
    shape and alignment the JAX package serves has a route
    (``kernels.qgemm_route``): int4 groups that are not a multiple of 16,
    widths off the tensor-core kernels' multiples and unaligned tensors take
    the generic one."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"activations must be float32 or bfloat16, got {dtype}"
    if w.q.dim() != 2:
        return f"the kernel takes a 2-D weight, got q of shape {tuple(w.q.shape)}"
    return None


def tied_head_refusal(w: Any, dtype: torch.dtype) -> Optional[str]:
    """Why the qgemm kernel cannot take the tied table ``w`` (``q`` ``[V,
    E]``, K-contiguous) as the head with activations in ``dtype`` (None if
    it can): f32 or bf16 and a 2-D int8 table.  Any E and V: what the stream
    form does not take runs on the generic route
    (``kernels.qgemm_tied_route``)."""
    if dtype not in (torch.float32, torch.bfloat16):
        return f"activations must be float32 or bfloat16, got {dtype}"
    if not isinstance(w, QTensor) or w.q.dim() != 2:
        return f"the tied head takes a 2-D int8 table, got {w!r}"
    return None


def check_kernel_params(params: Dict[str, Any], dtype: torch.dtype) -> None:
    """Refuse, before any step runs, decoder params whose quantized
    projections or tied int8 head the kernel would not take on the card
    (ValueError naming the leaf and the reason)."""
    leaves = [(f"layers.{k}", w) for k, w in params["layers"].items()]
    leaves.append(("lm_head", params.get("lm_head")))
    for name, w in leaves:
        if isinstance(w, QuantizedWeight):
            one = w.layer(0) if w.q.dim() == 3 else w
            why = kernel_refusal(one, dtype)
            if why is not None:
                raise ValueError(f"{name}: the qgemm kernel does not take this weight: {why}")
    if "lm_head" not in params and isinstance(params["tok_embed"], QuantizedWeight):
        why = tied_head_refusal(params["tok_embed"], dtype)
        if why is not None:
            raise ValueError(f"tok_embed: the qgemm kernel does not take this tied head: {why}")


def qeinsum(pattern: str, x: torch.Tensor, w: Any, dtype: torch.dtype) -> torch.Tensor:
    """``einsum(pattern, x, w)`` in ``dtype``.  A dense weight goes to
    ``torch.matmul`` (a projection pattern) or ``torch.einsum``.  A
    quantized one on the CPU takes :func:`qeinsum_plain`; on the card it
    launches the weight-only GEMM kernel, and a call the kernel does not
    take (a pattern other than ``x[..., in] . w[in, out]``, or a weight or
    dtype :func:`kernel_refusal` names) raises."""
    if not isinstance(w, QuantizedWeight):
        if _is_projection(pattern):
            return torch.matmul(x, w)
        return torch.einsum(pattern, x, w)
    if x.device.type != "cuda":
        return qeinsum_plain(pattern, x, w, dtype)
    if not _is_projection(pattern):
        why = "it takes x[..., in] . w[in, out] only"
    elif x.dtype != dtype:
        why = f"activations are {x.dtype}, the call asks for {dtype}"
    else:
        why = kernel_refusal(w, dtype)
    if why is not None:
        raise ValueError(f"qgemm kernel refuses {pattern!r}: {why}")
    from .. import kernels

    K, N = w.in_features, w.q.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    y = torch.empty((x2.shape[0], N), dtype=dtype, device=x.device)
    if x2.shape[0]:
        kernels.qgemm(x2, w.q.contiguous(), w.scale.contiguous(), y,
                      group=w.group_size if w.bits == 4 else 0)
    return y.reshape(x.shape[:-1] + (N,))


def _stream_group(x: torch.Tensor, ws, dtype: torch.dtype) -> Optional[list]:
    """The members of a grouped projection as one stream-route launch, or
    None where the stream route does not take the call (see
    :func:`qeinsum_group`)."""
    first = ws[0]
    if not (x.device.type == "cuda" and x.dtype == dtype == torch.bfloat16
            and 1 <= len(ws) <= 3 and isinstance(first, QuantizedWeight)):
        return None
    K = first.in_features
    group = first.group_size if first.bits == 4 else 0
    if x.shape[-1] != K:
        return None
    from .. import kernels

    x2 = x.reshape(-1, K).contiguous()
    for w in ws:
        if not (type(w) is type(first) and w.q.dim() == 2 and w.in_features == K
                and (w.group_size if w.bits == 4 else 0) == group
                and w.q.is_contiguous() and w.scale.is_contiguous()):
            return None
        aligned = not kernels._misaligned(x2, w.q, w.scale)
        route = kernels.qgemm_route(dtype, x2.shape[0], w.q.shape[-1], K, group,
                                    qs_aligned=aligned, aligned=aligned)
        if route != "stream":
            return None
    Ns = [w.q.shape[-1] for w in ws]
    outs = [torch.empty((x2.shape[0], n), dtype=dtype, device=x.device) for n in Ns]
    kernels.qgemm_stream(x2, [w.q for w in ws], [w.scale for w in ws], outs, group=group)
    return [y.reshape(x.shape[:-1] + (n,)) for y, n in zip(outs, Ns)]


def qeinsum_group(pattern: str, x: torch.Tensor, ws, dtype: torch.dtype) -> list:
    """``[qeinsum(pattern, x, w, dtype) for w in ws]``: projections of one
    x (QKV; gate and up).  On the card, when every member is a quantized
    weight of one format that the stream route takes (bf16, at most 64 rows
    of x, widths a multiple of 16, 16-byte aligned tensors), the products
    run in one launch of the stream kernel; otherwise (the CPU's plain
    twin, dense weights, the prefill route past 64 rows, a member the stream
    route does not take) each member is its own ``qeinsum`` call.  The
    weights stay separate leaves: nothing is concatenated or copied."""
    if _is_projection(pattern):
        ys = _stream_group(x, list(ws), dtype)
        if ys is not None:
            return ys
    return [qeinsum(pattern, x, w, dtype) for w in ws]


def tied_head_plain(x: torch.Tensor, w: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """The JAX ``_head_logits`` on a tied int8 table ``[V, E]`` (per-E
    scales): the scales land on x in ``dtype`` (``x . (q s)^T == (x s) .
    q^T``), then the product over E in ``dtype``."""
    xs = x * w.scale.squeeze(-2).to(dtype)
    return torch.einsum("...e,ve->...v", xs, w.q.to(dtype))


def tied_head(x: torch.Tensor, w: QTensor, dtype: torch.dtype) -> torch.Tensor:
    """Logits of a tied int8 table: on the CPU :func:`tied_head_plain`; on
    the card x is scaled as there (a PyTorch product in ``dtype``) and the
    qgemm kernel reads the table (``kernels.qgemm_tied``: the K-contiguous
    stream form, or the generic route where that does not take E or V);
    what :func:`tied_head_refusal` names raises."""
    if x.device.type != "cuda":
        return tied_head_plain(x, w, dtype)
    why = tied_head_refusal(w, dtype)
    if why is None and x.dtype != dtype:
        why = f"activations are {x.dtype}, the call asks for {dtype}"
    if why is not None:
        raise ValueError(f"qgemm kernel refuses the tied head: {why}")
    from .. import kernels

    V, E = w.q.shape
    xs = (x * w.scale.squeeze(-2).to(dtype)).reshape(-1, E).contiguous()
    y = torch.empty((xs.shape[0], V), dtype=dtype, device=x.device)
    if xs.shape[0]:
        kernels.qgemm_tied(xs, w.q.contiguous(), y)
    return y.reshape(x.shape[:-1] + (V,))


def qgemm_bf16_bound(x: torch.Tensor, w: Any, ref: torch.Tensor) -> torch.Tensor:
    """Per-element bound on a bf16 ``qeinsum`` output against the f32
    ``ref`` on the same (bf16-valued) ``x``, ``A = |x| . |deq w|``; bf16
    rounds to within ``u = 2^-8`` relative.  int8, ``2^-6 |ref| + 2^-12 A +
    1e-4``: the sum, the scale and the product each round once (under
    ``4u = 2^-6`` of ``|ref|`` together), and ``2^-12 A`` is the f32
    summation order of both sides (``K 2^-24 A``, the worst case, at K =
    4096; beyond it the error of a sum of exact products grows as sqrt(K)
    in practice).  int4, ``2^-7 |ref| + 2^-8 A + 1e-4``: the sum rounds
    once, and each group's partial, its scale and their product round (up
    to ``3u`` of that group's share of ``A``, errors that partly cancel
    across groups; the tier-1 tests show the JAX function inside it)."""
    a = torch.matmul(x.float().abs(), deq(w, torch.float32).abs())
    return _bound_from(a, w.bits, ref)


def tied_head_bf16_bound(xs: torch.Tensor, w: QTensor, ref: torch.Tensor) -> torch.Tensor:
    """:func:`qgemm_bf16_bound`'s int8 bound for the tied head: ``ref`` the
    f32 product of the bf16 ``xs`` (x already scaled) with the table, ``A =
    |xs| . |q|^T`` (only the sum rounds; the int8 bound's margin stays)."""
    a = torch.matmul(xs.float().abs(), w.q.float().abs().T)
    return _bound_from(a, 8, ref)


def _bound_from(a: torch.Tensor, bits: int, ref: torch.Tensor) -> torch.Tensor:
    if bits == 4:
        return 2.0 ** -7 * ref.abs() + 2.0 ** -8 * a + 1e-4
    return 2.0 ** -6 * ref.abs() + 2.0 ** -12 * a + 1e-4


QGEMM_BF16_BOUND_TEXT = {
    8: "2^-6*|ref| + 2^-12*A + 1e-4, A = |x|.|deq W|",
    4: "2^-7*|ref| + 2^-8*A + 1e-4, A = |x|.|deq W|",
}


def _quantize_leaf(w, fmt: str, group_size: int):
    """One stacked leaf, a layer at a time (the host holds one layer's f32
    copy, not the stack's); the bytes equal a whole-stack quantization, since
    every reduction is within a layer.  The result lies on ``w``'s device."""
    dev = w.device if isinstance(w, torch.Tensor) else torch.device("cpu")
    one = (lambda a: _quantize4_np(a, group_size)) if fmt == "int4" else _quantize8_np
    if getattr(w, "ndim", 0) >= 3:
        parts = [one(_host_f32(w[l])) for l in range(w.shape[0])]
        q = np.stack([p[0] for p in parts])
        scale = np.stack([p[1] for p in parts])
    else:
        q, scale = one(_host_f32(w))
    cls = QTensor4 if fmt == "int4" else QTensor
    return cls(torch.from_numpy(q).to(dev), torch.from_numpy(scale).to(dev))


def quantize_decoder_params(
    params: Dict[str, Any], fmt: str = "int8", group_size: int = INT4_GROUP_SIZE
) -> Dict[str, Any]:
    """Quantize every layer projection (``QUANTIZABLE``) on the host, one
    leaf at a time; norms, biases, embeddings and the head stay as they are.
    ``fmt``: "int8" (per channel) or "int4" (per ``group_size`` group)."""
    if fmt not in ("int8", "int4"):
        raise ValueError(f"unknown quantization format {fmt!r}")
    layers = dict(params["layers"])
    for key in QUANTIZABLE:
        if key in layers:
            layers[key] = _quantize_leaf(layers[key], fmt, group_size)
    out = dict(params)
    out["layers"] = layers
    return out


def _leaves(tree: Any):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def num_weights(params: Any) -> int:
    """Model weight count, packed int4 counted unpacked, scales excluded."""
    total = 0
    for leaf in _leaves(params):
        if isinstance(leaf, QTensor4):
            total += 2 * leaf.q.numel()
        elif isinstance(leaf, QTensor):
            total += leaf.q.numel()
        else:
            total += leaf.numel()
    return total


def weight_bits(params: Any) -> int:
    """Dominant layer-projection weight width in bits (4 / 8 / 16)."""
    layers = params.get("layers", params) if isinstance(params, dict) else params
    leaves = layers.values() if isinstance(layers, dict) else [layers]
    bits = 16
    for leaf in leaves:
        if isinstance(leaf, QTensor4):
            return 4
        if isinstance(leaf, QTensor):
            bits = 8
    return bits
