"""The one place the port resolves its torch device.

Entry points run on the CUDA device by default. The CPU is used only
when a caller asks for it explicitly (``set_default_device("cpu")``,
as the tests do); with no CUDA device and no explicit choice,
``default_device()`` raises instead of quietly running the plain
versions on the CPU.
"""

from __future__ import annotations

import threading
from typing import Optional, Union

import torch

_lock = threading.Lock()
_explicit: Optional[torch.device] = None  # guarded-by: _lock


def set_default_device(device: Union[str, torch.device, None]) -> None:
    """Pin the port's device (``"cpu"``, ``"cuda"``, ``"cuda:1"``);
    None returns to the default (CUDA, or raise)."""
    global _explicit
    with _lock:
        _explicit = None if device is None else torch.device(device)


def default_device() -> torch.device:
    """The device the port's entry points run on."""
    with _lock:
        explicit = _explicit
    if explicit is not None:
        return explicit
    if not torch.cuda.is_available():
        raise RuntimeError(
            "nomad_tpu_torch needs a CUDA device; call "
            "nomad_tpu_torch.device.set_default_device('cpu') to run the "
            "plain PyTorch versions on the CPU instead")
    return torch.device("cuda")
