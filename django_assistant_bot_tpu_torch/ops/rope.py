"""Rotary position embeddings (port of ``ops/rope.py``).

:func:`rope_frequencies` is host numpy and is a copy of the JAX package's
table code (llama3, linear, longrope and yarn scalings); :func:`apply_rope`
is its PyTorch counterpart.
"""

from __future__ import annotations

import warnings

import numpy as np
import torch


def rope_frequencies(
    head_dim: int,
    max_len: int,
    theta: float = 500_000.0,
    scaling: "tuple | None" = None,
    deployed_len: "int | None" = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Return (cos, sin) tables of shape [max_len, head_dim//2] in float32.

    ``scaling`` selects a long-context frequency remap:

    - 4-tuple ``(factor, low_freq_factor, high_freq_factor, original_max_len)``
      — Llama-3.1;
    - ``("linear", factor)`` — position interpolation;
    - ``("longrope", short_factors, long_factors, original_max,
      attention_factor)`` — Phi-3 128k; the long list engages when the
      deployed context (``deployed_len``) exceeds the pretrained one;
    - ``("yarn", factor, beta_fast, beta_slow, original_max,
      attention_factor, truncate)`` — NTK-by-parts.
    """
    dim = head_dim
    inv_freq = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    attention_factor = 1.0
    if scaling is not None and scaling[0] == "linear":
        inv_freq = inv_freq / float(scaling[1])
    elif scaling is not None and scaling[0] == "longrope":
        _, short_f, long_f, orig, attention_factor = scaling
        use_long = (deployed_len or max_len) > orig
        if use_long:
            warnings.warn(
                f"longrope: deployed context {deployed_len or max_len} > "
                f"pretrained {orig}; committing to the LONG factor list for "
                "ALL sequences — short prompts diverge from HF, which flips "
                "short/long per sequence. Deploy with max_seq_len <= "
                f"{orig} if exact short-prompt HF parity matters.",
                stacklevel=2,
            )
        ext = np.asarray(long_f if use_long else short_f, np.float64)
        inv_freq = 1.0 / (ext * theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    elif scaling is not None and scaling[0] == "yarn":
        _, factor, beta_fast, beta_slow, orig, attention_factor, truncate = scaling
        pos_freqs = theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim)
        inv_extra = 1.0 / pos_freqs
        inv_inter = 1.0 / (factor * pos_freqs)

        def corr_dim(num_rot):
            return (dim * np.log(orig / (num_rot * 2 * np.pi))) / (2 * np.log(theta))

        low, high = corr_dim(beta_fast), corr_dim(beta_slow)
        if truncate:
            low, high = np.floor(low), np.ceil(high)
        low, high = max(low, 0.0), min(high, dim - 1.0)
        if low == high:
            high += 0.001  # prevent singularity
        ramp = np.clip((np.arange(dim // 2, dtype=np.float64) - low) / (high - low), 0.0, 1.0)
        extra_factor = 1.0 - ramp
        inv_freq = inv_inter * (1.0 - extra_factor) + inv_extra * extra_factor
    elif scaling is not None:
        factor, low_f, high_f, orig = scaling
        wavelen = 2.0 * np.pi / inv_freq
        low_wavelen = orig / low_f
        high_wavelen = orig / high_f
        smooth = np.clip((orig / wavelen - low_f) / (high_f - low_f), 0.0, 1.0)
        interp = (1.0 - smooth) * inv_freq / factor + smooth * inv_freq
        inv_freq = np.where(
            wavelen > low_wavelen,
            inv_freq / factor,
            np.where(wavelen < high_wavelen, inv_freq, interp),
        )
    t = np.arange(max_len, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    cos = (np.cos(freqs) * attention_factor).astype(np.float32)
    sin = (np.sin(freqs) * attention_factor).astype(np.float32)
    return cos, sin


def apply_rope(
    x: torch.Tensor,  # [..., seq, heads, head_dim]
    cos: torch.Tensor,  # [..., seq, head_dim//2] (already gathered at positions)
    sin: torch.Tensor,
) -> torch.Tensor:
    """Rotate pairs (x[..i], x[..i+D/2]) — the half-split ("rotate_half")
    convention of HF Llama checkpoints.  ``cos``/``sin`` broadcast over heads."""
    xf = x.float()
    x1, x2 = xf.chunk(2, dim=-1)
    c = cos.unsqueeze(-2)
    s = sin.unsqueeze(-2)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)
