"""Faults planted in the port's timed path, to show that a run with one of them comes out not correct.

Each fault is ``plant(setattr_, ensemble)``: it replaces one function of the port through ``setattr_`` (pytest's
``monkeypatch.setattr``, or :class:`Patches` here), for a cell whose PIV is the ensemble or multipass; the port,
numpy and torch are imported only then. A route's ``FAULTS`` binds those its cells can have to a configuration.
The CPU tests plant them at a small size (``tests/test_harness_faults.py``); ``readings.py --fault <name>`` reads
them on the card at the cell's own size. One card: no exchange between chips to leave out.
"""

from __future__ import annotations

import threading


def state_unchanged(setattr_, ensemble):
    """A step that returns its state unchanged: multipass's deformation hands back the pairs undeformed;
    the ensemble chain's normalize hands back its batch."""
    import torch

    from pyorc_tpu_torch.ops import filters, multipass

    if ensemble:
        setattr_(filters, "normalize_with_mean", lambda frames, mean: frames)
    else:
        setattr_(multipass, "deformed_pairs", lambda frames, u, v, rows, cols: torch.stack(
            [frames[:-1], frames[1:]], dim=1).reshape((-1,) + tuple(frames.shape[1:])))


def half_batch(setattr_, ensemble):
    """Half of the pairs left out, the result (for the ensemble: the mean) taken over the rest."""
    import numpy as np

    from pyorc_tpu_torch.velocimetry import engine

    name = "_piv_ensemble" if ensemble else "_piv_timestep"
    real = getattr(engine, name)

    def half(data, time_all, y, x, dt, *args):
        k = data.shape[0] // 2 + 1
        return real(data[:k], time_all[:k], y, x, np.asarray(getattr(dt, "values", dt))[: k - 1], *args)

    setattr_(engine, name, half)


def answer_altered(setattr_, ensemble):
    """One window's displacement moved a quarter pixel where it is produced."""
    from pyorc_tpu_torch.velocimetry import engine

    if ensemble:
        real = engine.piv_ops.u_v_displacement

        def altered(corr, n_rows, n_cols):
            u, v = real(corr, n_rows, n_cols)
            u = u.clone()
            u[..., n_rows // 2, n_cols // 2] += 0.25
            return u, v

        setattr_(engine.piv_ops, "u_v_displacement", altered)
    else:
        real = engine.multipass.piv_multipass

        def altered(*args, **kwargs):
            u, v, cmax, s2n = real(*args, **kwargs)
            u = u.clone()
            u[0, u.shape[1] // 2, u.shape[2] // 2] += 0.25
            return u, v, cmax, s2n

        setattr_(engine.multipass, "piv_multipass", altered)


def frame_altered(setattr_, ensemble):
    """One pixel of every projected batch that the lazy chain's prefetch thread hands to ``get_piv`` raised
    by a level; a batch read again from the main thread is left as it was."""
    from pyorc_tpu_torch.api.video import LazyFrames

    real = LazyFrames.read_batch

    def altered(self, i0, i1, uploader=None):
        out = real(self, i0, i1, uploader)
        if self._ops and threading.current_thread() is not threading.main_thread():
            out = out.clone()
            out[:, 0, 0] += 1
        return out

    setattr_(LazyFrames, "read_batch", altered)


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, answer_altered, frame_altered)}


class Patches:
    """``setattr_`` for a fault outside pytest: every replacement undone by :meth:`undo`."""

    def __init__(self):
        self._old = []

    def __call__(self, owner, name, value):
        self._old.append((owner, name, getattr(owner, name)))
        setattr(owner, name, value)

    def undo(self):
        while self._old:
            owner, name, value = self._old.pop()
            setattr(owner, name, value)
