"""Threaded prefetching stereo-pair loader.

The reference decodes PNGs synchronously on the host thread and uploads
with blocking CL_MEM_COPY_HOST_PTR creates (main.cpp:184-186,243-244),
serialising I/O against compute.  This loader decodes ahead on worker
threads (native libpng codec when built, numpy + zlib otherwise) and optionally
stages arrays onto the device so the accelerator never waits for I/O —
the pattern the video-stream config (BASELINE configs[4]) needs.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np


def _decode(path: str) -> np.ndarray:
    from stereo_matchin_tpu.io.png import read_rgb

    return read_rgb(path)


class PairLoader:
    """Iterate (left, right) float32 arrays with background prefetch.

    pairs: sequence of (left_path, right_path).
    depth: number of decoded pairs buffered ahead.
    device_put: stage arrays onto the default JAX device in the worker.
    """

    _SENTINEL = object()

    def __init__(self, pairs: Sequence[Tuple[str, str]], depth: int = 2,
                 device_put: bool = False, loop: bool = False):
        self._pairs = list(pairs)
        self._depth = depth
        self._device_put = device_put
        self._loop = loop

    def __iter__(self) -> Iterator:
        q: "queue.Queue" = queue.Queue(maxsize=self._depth)
        stop = threading.Event()

        def worker():
            # A worker exception (corrupt/missing file) must surface in the
            # consumer, not silently truncate the stream: ship it through
            # the queue and re-raise on the iterating thread.
            error = None
            try:
                while True:
                    for lp, rp in self._pairs:
                        if stop.is_set():
                            return
                        left, right = _decode(lp), _decode(rp)
                        if self._device_put:
                            import jax

                            left, right = jax.device_put((left, right))
                        q.put((left, right))
                    if not self._loop:
                        break
            except BaseException as exc:  # noqa: BLE001 — forwarded, not dropped
                error = exc
            finally:
                q.put((self._SENTINEL, error))

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if isinstance(item, tuple) and item[0] is self._SENTINEL:
                    if item[1] is not None:
                        raise item[1]
                    break
                yield item
        finally:
            stop.set()
            # Drain so the worker can exit its blocking put.
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass

    def __len__(self):
        return len(self._pairs)
