"""Device selection and host<->device copies: the port's counterpart of ``pyorc_tpu._platform``.

Every op of the port runs on the device returned by :func:`get_device`.
The default is ``"cuda"``; running on the CPU takes an explicit
``set_device("cpu")``, or, for a process that cannot call it (the CLI in a
child process), the environment variable ``PYORC_TPU_TORCH_DEVICE=cpu``. So
nothing quietly carries on without the card.

Frames, index maps and results cross between host and device through
:func:`to_device`, :func:`to_host` and :class:`PinnedUploader`, which add the
bytes they move to :data:`COPY_BYTES`.

:func:`local_devices` lists the devices a mesh of this process may use
(:mod:`pyorc_tpu_torch.parallel`): every visible card, or on the CPU as many
CPU shards as ``PYORC_TPU_CPU_DEVICES`` asks for.
"""

from __future__ import annotations

import os
import threading
from typing import Optional, Union

import numpy as np
import torch

__all__ = ["set_device", "get_device", "local_devices", "to_device", "to_host", "torch_dtype", "PinnedUploader", "COPY_BYTES"]

_device: Optional[torch.device] = None

# Bytes copied host -> device ("h2d") and device -> host ("d2h") by the
# helpers below since import, or since a caller reset them to 0. They count
# the frames, maps and results the port moves, on the CPU device too (where
# the copy is a no-op), so that tests can hold a chain to what it moves.
COPY_BYTES = {"h2d": 0, "d2h": 0}
_COUNT_LOCK = threading.Lock()  # the prefetch thread uploads while the caller downloads


def set_device(device: Union[str, torch.device]) -> None:
    """Select the device the port computes on ("cuda", "cuda:1", "cpu", ...)."""
    global _device
    _device = torch.device(device)


def get_device() -> torch.device:
    """The selected device; raises when it is a CUDA device and CUDA is absent.

    Without :func:`set_device`, the device is ``PYORC_TPU_TORCH_DEVICE`` when
    it is set (a string ``torch.device`` takes; anything else raises), else
    ``"cuda"``.
    """
    device = _device
    if device is None:
        name = os.environ.get("PYORC_TPU_TORCH_DEVICE") or "cuda"
        try:
            device = torch.device(name)
        except RuntimeError as err:
            raise ValueError(f"PYORC_TPU_TORCH_DEVICE={name!r} is not a torch device: {err}") from err
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "pyorc_tpu_torch computes on CUDA by default, but torch.cuda.is_available() is False. "
            "Call pyorc_tpu_torch.set_device('cpu'), or set PYORC_TPU_TORCH_DEVICE=cpu, to run on the CPU."
        )
    return device


def local_devices() -> list:
    """The devices of this process's mesh, counterpart of ``jax.local_devices()``.

    Where :func:`get_device` is a CUDA device: every visible card
    (``torch.cuda.device_count()``). On the CPU: ``PYORC_TPU_CPU_DEVICES``
    (default 1) copies of the CPU device, as the JAX package's
    ``PYORC_TPU_CPU_DEVICES`` gives XLA that many virtual CPU devices. A
    repeated device is a virtual shard: its shards run one after another.
    ``PYORC_TPU_SHARD=0`` gives :func:`get_device` alone.
    """
    device = get_device()
    if os.environ.get("PYORC_TPU_SHARD", "1") == "0":
        return [device]
    if device.type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    if device.type == "cpu":
        return [device] * int(os.environ.get("PYORC_TPU_CPU_DEVICES") or 1)
    return [device]


def _count(direction: str, n_bytes: int) -> None:
    with _COUNT_LOCK:
        COPY_BYTES[direction] += int(n_bytes)


def _same_device(have: torch.device, want: torch.device) -> bool:
    """Whether a tensor on ``have`` is on ``want`` ("cuda" without an index means the current card)."""
    if have.type != want.type:
        return False
    if want.index is None and want.type == "cuda":
        return have.index == torch.cuda.current_device()
    return have.index == want.index


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype."""
    return torch.from_numpy(np.empty(0, np.dtype(dtype))).dtype


def to_device(array, device=None, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A host array (numpy, or a tensor anywhere) on ``device`` (default :func:`get_device`).

    A tensor already on ``device`` is returned as it is (cast to ``dtype`` if
    given); anything else is copied, from pageable memory, and counted.
    """
    device = get_device() if device is None else torch.device(device)
    if torch.is_tensor(array) and _same_device(array.device, device):
        return array if dtype is None else array.to(dtype)
    host = torch.as_tensor(np.ascontiguousarray(array)) if not torch.is_tensor(array) else array
    _count("h2d", host.numel() * host.element_size())
    return host.to(device=device, dtype=dtype)


def to_host(tensor) -> np.ndarray:
    """A tensor as a host numpy array (numpy passes through); counts the bytes of a tensor."""
    if not torch.is_tensor(tensor):
        return np.asarray(tensor)
    _count("d2h", tensor.numel() * tensor.element_size())
    return tensor.detach().cpu().numpy()


class PinnedUploader:
    """Uploads host batches through pinned staging buffers on a side stream.

    :meth:`upload` copies a (possibly strided) host batch into one of
    ``slots`` page-locked buffers, starts its copy to the card on its own
    stream with ``non_blocking=True``, records an event, and makes the
    caller's current stream wait on it; the device tensor is marked as used
    on that stream (``record_stream``), so the allocator keeps it until the
    caller's work on it is done. A buffer is refilled only after the event
    of its last copy has completed. One uploader serves one thread.
    """

    def __init__(self, device: torch.device, slots: int = 2):
        self.device = torch.device(device)
        self._stream = torch.cuda.Stream(self.device)
        self._buffers = [None] * slots
        self._events = [None] * slots
        self._next = 0

    def upload(self, batch: np.ndarray) -> torch.Tensor:
        slot = self._next
        self._next = (slot + 1) % len(self._buffers)
        if self._events[slot] is not None:
            self._events[slot].synchronize()
        buf = self._buffers[slot]
        if buf is None or buf.numel() < batch.nbytes:
            buf = self._buffers[slot] = torch.empty(batch.nbytes, dtype=torch.uint8, pin_memory=True)
        staged = buf[: batch.nbytes].view(torch_dtype(batch.dtype)).view(batch.shape)
        np.copyto(staged.numpy(), batch)
        consumer = torch.cuda.current_stream(self.device)
        with torch.cuda.stream(self._stream):
            out = staged.to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        self._events[slot] = event
        consumer.wait_event(event)
        out.record_stream(consumer)
        _count("h2d", batch.nbytes)
        return out
