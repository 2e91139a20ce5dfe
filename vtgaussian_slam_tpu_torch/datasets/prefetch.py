"""Asynchronous frame prefetching.

The port's own copy of `vtgaussian_slam_tpu/datasets/prefetch.py`: a small
thread pool decodes the next `lookahead` frames while the engine works on
the current one, so the host's file reads and native decode/resize overlap
the device's work. Frames arrive as the wrapped dataset's numpy tuples;
the engine stages them on the device.

Usage:
    pf = FramePrefetcher(dataset, lookahead=2)
    for t in range(n):
        color, depth, K, pose = pf[t]     # usually already decoded
"""
from __future__ import annotations

import threading
from collections import OrderedDict
from concurrent.futures import CancelledError, Future, ThreadPoolExecutor


class FramePrefetcher:
    def __init__(self, dataset, lookahead: int = 2, workers: int = 2,
                 cache_size: int = 8):
        self._ds = dataset
        self._lookahead = lookahead
        self._cache_size = max(cache_size, 2 * lookahead + 2)
        self._pool = ThreadPoolExecutor(max_workers=workers)
        self._futures: OrderedDict[int, Future] = OrderedDict()
        self._lock = threading.Lock()

    def __len__(self):
        return len(self._ds)

    def _touch(self, idx: int):
        """Submit one index, or move it to the most recent end of the LRU:
        a hit must stay alive while its lookahead submissions evict, or an
        interleaved far read (a keyframe between sequential frames) could
        evict the very future __getitem__ is about to read."""
        if not (0 <= idx < len(self._ds)):
            return
        if idx in self._futures:
            self._futures.move_to_end(idx)
            return
        self._futures[idx] = self._pool.submit(self._ds.__getitem__, idx)
        while len(self._futures) > self._cache_size:
            _, old = self._futures.popitem(last=False)
            old.cancel()  # a still-queued decode of an evicted frame

    def __getitem__(self, idx: int):
        with self._lock:
            self._touch(idx)
            for ahead in range(1, self._lookahead + 1):
                self._touch(idx + ahead)
            fut = self._futures[idx]
        try:
            return fut.result()
        except CancelledError:
            # another reader's lookahead evicted this index before its
            # decode started: read it here
            return self._ds[idx]

    def __getattr__(self, name):
        # the wrapped dataset's attributes (poses, intrinsics, ...); names
        # with a leading underscore raise, so a half-built copy (deepcopy
        # and unpickle probe __setstate__ before __init__) cannot recurse
        if name.startswith("_"):
            raise AttributeError(name)
        return getattr(self._ds, name)

    def close(self):
        self._pool.shutdown(wait=False, cancel_futures=True)
