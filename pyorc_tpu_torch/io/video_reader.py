"""Host-side video decode: the I/O pump feeding the device pipeline.

Port of :mod:`pyorc_tpu.io.video_reader`. Decode stays on the CPU (OpenCV's
C++ core via cv2, like the reference's ``cv2.VideoCapture`` usage at
``pyorc/api/video.py:136-211`` and ``pyorc/cv.py:876-990``); frames are handed
to the device in batches so device compute overlaps the next batch's decode
(see :class:`pyorc_tpu_torch.api.video.LazyFrames`). cv2 and tqdm are imported
inside the functions that use them: the package imports without either.
"""

from __future__ import annotations

import queue
import threading
from typing import List, Optional, Tuple

import numpy as np

__all__ = ["color_scale", "get_frame", "get_time_frames", "get_rotation_code", "warp_affine", "BatchPrefetcher"]


def get_rotation_code(rotation):
    """Degrees (0/90/180/270) -> OpenCV rotation code. Reference pyorc/helpers.py:245-268."""
    if rotation not in [0, 90, 180, 270, None]:
        raise ValueError(f"Rotation code must be in allowed codes 0, 90, 180 or 270. Provided code is {rotation}")
    if rotation in (0, None):
        return None
    import cv2

    return {90: cv2.ROTATE_90_CLOCKWISE, 180: cv2.ROTATE_180, 270: cv2.ROTATE_90_COUNTERCLOCKWISE}[rotation]


def color_scale(img: np.ndarray, method: str) -> np.ndarray:
    """BGR frame -> requested color space. Reference pyorc/cv.py:834-873."""
    import cv2

    if method == "grayscale":
        return cv2.cvtColor(img, cv2.COLOR_BGR2GRAY)
    if method == "rgb":
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if method == "hsv":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    if method == "hue":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 0]
    if method == "sat":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 1]
    if method == "val":
        return cv2.cvtColor(img, cv2.COLOR_BGR2HSV)[:, :, 2]
    return img  # bgr


def warp_affine(img: np.ndarray, m: np.ndarray) -> np.ndarray:
    """Stabilization warp. Reference pyorc/cv.py:549-571."""
    import cv2

    h, w = img.shape[0], img.shape[1]
    return cv2.warpAffine(img, np.asarray(m, dtype=np.float64)[:2], (w, h))


def get_frame(cap, rotation=None, ms=None, method: str = "grayscale"):
    """Read + rotate + stabilize + color-convert one frame. Reference pyorc/cv.py:876-920."""
    import cv2

    ret, img = cap.read()
    if ret and rotation is not None:
        img = cv2.rotate(img, rotation)
    if ret:
        if ms is not None:
            img = warp_affine(img, ms)
        img = color_scale(img, method)
    return ret, img


def _check_valid_frames(cap, frame_number: List[int]) -> Optional[int]:
    """Detect unreadable tail frames via direct seek. Reference pyorc/cv.py:25-61."""
    import cv2

    if not frame_number:
        return None
    idx = len(frame_number) - 1
    while idx >= 0:
        cap.set(cv2.CAP_PROP_POS_FRAMES, np.float64(frame_number[idx]))
        ret, img = cap.read()
        if ret and img is not None:
            return idx + 1
        idx -= 1
    return None


def get_time_frames(
    cap,
    start_frame: int,
    end_frame: int,
    lazy: bool = True,
    fps: Optional[float] = None,
    progress: bool = True,
    **kwargs,
) -> Tuple[list, list, Optional[list]]:
    """Scan valid timestamps/frame numbers (and frames when eager).

    Reference pyorc/cv.py:923-990: stops on non-advancing timestamps,
    trims unreadable tail frames.
    """
    import cv2
    from tqdm import tqdm

    cap.set(cv2.CAP_PROP_POS_FRAMES, np.float64(start_frame))
    pbar = tqdm(
        total=end_frame - start_frame + 1, position=0, desc="Scanning video", disable=not progress, leave=True
    )
    ret, img = get_frame(cap, **kwargs)
    n = start_frame
    time: list = []
    frame_number: list = []
    frames = None if lazy else []
    while ret:
        if n > end_frame:
            break
        if frames is not None:
            frames.append(img)
        t1 = cap.get(cv2.CAP_PROP_POS_MSEC)
        time.append(n * 1000.0 / fps if fps is not None else t1)
        frame_number.append(n)
        n += 1
        ret, img = get_frame(cap, **kwargs)
        pbar.update(1)
        if not ret:
            break
        t2 = cap.get(cv2.CAP_PROP_POS_MSEC)
        if t2 <= 0.0:
            break
    pbar.close()
    if lazy:
        last_valid_idx = _check_valid_frames(cap, frame_number)
        if last_valid_idx is not None:
            time = time[:last_valid_idx]
            frame_number = frame_number[:last_valid_idx]
    return time, frame_number, frames


class BatchPrefetcher:
    """Background-thread decode-ahead: overlap host decode with device compute.

    The reference relies on dask's thread pool for this (reference
    ``pyorc/api/video.py:479-491``); here a single worker thread keeps a
    bounded queue of upcoming batches full while the device works. A worker
    exception is raised in the consumer. Iteration that stops early (a
    ``break``, an exception, a closed generator) calls :meth:`close`, which
    stops the worker, drops the queued batches (on the card they hold device
    memory) and joins the thread.
    """

    _POLL_S = 0.05  # how often a worker blocked on a full queue looks for close()

    def __init__(self, batch_fn, batch_ranges, depth: int = 2):
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._ranges = list(batch_ranges)
        self._batch_fn = batch_fn
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue ``item``, waiting for room; False once close() was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _worker(self):
        try:
            for rng in self._ranges:
                if self._stop.is_set() or not self._put(("ok", self._batch_fn(*rng))):
                    return
        except Exception as e:  # forwarded to the consumer
            self._put(("err", e))
            return
        self._put(("done", None))

    def __iter__(self):
        try:
            while True:
                kind, item = self._queue.get()
                if kind == "done":
                    return
                if kind == "err":
                    raise item
                yield item
        finally:
            self.close()

    def close(self):
        """Stop the worker after its current batch, join it, and drop what it queued."""
        self._stop.set()
        self._thread.join()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                return

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()
