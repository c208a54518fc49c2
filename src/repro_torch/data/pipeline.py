"""Prefetching data pipeline: background thread fills a bounded queue so
host data work overlaps device compute; fully checkpointable (own copy
of ``repro/data/pipeline.py``)."""
from __future__ import annotations

import queue
import threading
from typing import Dict, Optional

import numpy as np


class DataPipeline:
    def __init__(self, source, global_batch: int, microbatches: int = 1,
                 prefetch: int = 2):
        """source: object with next_batch(n) -> [n, S] int32 (the
        tokens) or a dict of [n, ...] arrays (``tokens`` and, e.g., a
        ``loss_mask``, ``patch_embeds`` [n, P, d] or ``frame_embeds`` [n,
        T, d]), and state()/load_state().  Batches are dicts of arrays
        shaped [microbatches, global_batch // microbatches, ...]."""
        assert global_batch % microbatches == 0
        self.source = source
        self.global_batch = global_batch
        self.m = microbatches
        self._q: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._consumed_state: Optional[Dict] = None

    def _work(self) -> None:
        try:
            while not self._stop.is_set():
                flat = self.source.next_batch(self.global_batch)
                if not isinstance(flat, dict):
                    flat = {"tokens": flat}
                mb = {k: a.reshape((self.m, self.global_batch // self.m)
                                   + a.shape[1:]) for k, a in flat.items()}
                # snapshot the cursor *after* this batch: the consumer
                # records it on get(), so state() is exactly "everything
                # training consumed" regardless of prefetch races
                item = (mb, self.source.state())
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:                   # noqa: BLE001
            self._error = e

    def start(self) -> "DataPipeline":
        if self._consumed_state is None:
            self._consumed_state = self.source.state()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()
        return self

    def next(self) -> Dict[str, np.ndarray]:
        while True:
            if self._error is not None:
                raise self._error
            try:
                batch, st = self._q.get(timeout=1.0)
                self._consumed_state = st
                return batch
            except queue.Empty:
                if self._thread is None or not self._thread.is_alive():
                    raise RuntimeError("data pipeline thread died")

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5)

    # -- checkpointable state -------------------------------------------
    def state(self) -> Dict:
        """Source cursor as of the last *consumed* batch.  Each queued
        item carries the source state snapshotted right after its
        fetch, so prefetched-but-unconsumed batches (including one the
        worker fetched but is still blocked putting — invisible to any
        qsize()-based rewind) never advance the checkpointed cursor.
        Restoring this state replays training's batch sequence exactly."""
        assert self._consumed_state is not None, "pipeline never started"
        return self._consumed_state

    def load_state(self, st: Dict) -> None:
        """Rewind the source to ``st``.  Any batches already prefetched
        from the old cursor are stale: the worker is quiesced and the
        queue discarded before the cursor moves, then prefetch resumes
        from the restored position."""
        running = self._thread is not None
        if running:
            self.stop()
            self._thread = None
            self._stop = threading.Event()
            self._q = queue.Queue(maxsize=self._q.maxsize)
        self.source.load_state(st)
        self._consumed_state = dict(st)
        if running:
            self.start()
