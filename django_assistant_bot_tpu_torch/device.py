"""Device selection: ``"cuda"`` (the default everywhere) or ``"cpu"``.

There is no silent fallback: asking for CUDA on a machine without a card
raises, so a run that was meant for the card can never quietly measure the
CPU instead.
"""

from __future__ import annotations

from typing import Union

import torch

DeviceLike = Union[str, torch.device]


def resolve_device(device: DeviceLike = "cuda") -> torch.device:
    """``"cuda"``/``"cuda:N"``/``"cpu"`` (or a ``torch.device``) -> ``torch.device``.

    Raises ``RuntimeError`` for CUDA when ``torch.cuda.is_available()`` is
    false, and ``ValueError`` for any other device type."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was requested but no CUDA device is available; "
                "pass device='cpu' (--device cpu) to run on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}; expected 'cuda' or 'cpu'")
