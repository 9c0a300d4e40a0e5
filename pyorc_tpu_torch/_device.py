"""Device selection: the port's counterpart of ``pyorc_tpu._platform``.

Every op of the port runs on the device returned by :func:`get_device`.
The default is ``"cuda"``; running on the CPU takes an explicit
``set_device("cpu")``, so nothing quietly carries on without the card.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["set_device", "get_device"]

_device: Optional[torch.device] = None


def set_device(device: Union[str, torch.device]) -> None:
    """Select the device the port computes on ("cuda", "cuda:1", "cpu", ...)."""
    global _device
    _device = torch.device(device)


def get_device() -> torch.device:
    """The selected device; raises when it is a CUDA device and CUDA is absent."""
    device = _device if _device is not None else torch.device("cuda")
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyorc_tpu_torch computes on CUDA by default, but torch.cuda.is_available() is False. "
            "Call pyorc_tpu_torch.set_device('cpu') to run on the CPU."
        )
    return device
