"""PyTorch/CUDA port of ``django_assistant_bot_tpu`` for NVIDIA Hopper (H100).

The module tree mirrors the JAX package's (``models/``, ``ops/``,
``serving/``, ``cli/``) so each function's counterpart is found under the
same name.  Plain tensor code is PyTorch; the JAX package's hand-written
device kernels are hand-written CUDA C++ for ``sm_90a`` (``csrc/``, built and
bound by :mod:`.kernels`), each with a plain PyTorch twin that runs only for
tensors on the CPU.

Nothing here imports JAX or the JAX package.  Entry points run on the card
(``device="cuda"``) unless the caller asks for the CPU; asking for CUDA on a
machine without a card raises instead of falling back.
"""

from .device import resolve_device

__all__ = ["resolve_device"]
