"""Streaming query pipeline: overlapped host IO and device compute.

The reference streams reads with a shared BatchLoader under omp critical
(movi.cpp:274-301, batch_loader.cpp).  Here a producer thread parses
FASTA/FASTQ and packs fixed-shape padded batches into a bounded queue;
the consumer dispatches device work asynchronously (jax dispatch is
async), so host parsing, host->device transfer, and device compute
overlap -- the device analogue of double buffering.
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, List, Optional, Tuple

import numpy as np

from .fastx import ReadBatch, iter_fastx, make_batches


class BatchStream:
    def __init__(self, path: str, lanes: int, width: Optional[int] = None,
                 reverse: bool = False, queue_depth: int = 4):
        self.path = path
        self.lanes = lanes
        self.width = width
        self.reverse = reverse
        self.q: "queue.Queue" = queue.Queue(maxsize=queue_depth)
        self._thread = threading.Thread(target=self._produce, daemon=True)
        self._thread.start()

    def _produce(self):
        try:
            if self.width is None:
                # fast path: C++ parse + pack with no per-read objects
                # (falls back internally if the library is not built)
                from .fastx import batches_from_file

                for b in batches_from_file(self.path, self.lanes,
                                           reverse=self.reverse):
                    self.q.put(b)
                self.q.put(None)
                return
            pending: List[Tuple[str, bytes]] = []
            for name, seq in iter_fastx(self.path):
                pending.append((name, seq))
                if len(pending) == self.lanes:
                    for b in make_batches(pending, self.lanes, self.width,
                                          self.reverse):
                        self.q.put(b)
                    pending = []
            if pending:
                for b in make_batches(pending, self.lanes, self.width,
                                      self.reverse):
                    self.q.put(b)
            self.q.put(None)
        except Exception as e:  # surface parse errors to the consumer
            self.q.put(e)

    def __iter__(self) -> Iterator[ReadBatch]:
        while True:
            item = self.q.get()
            if item is None:
                return
            if isinstance(item, Exception):
                raise item
            yield item


def run_pipeline(path: str, lanes: int, launch: Callable[[ReadBatch], object],
                 collect: Callable[[ReadBatch, object], None],
                 reverse: bool = False, in_flight: int = 2):
    """Double-buffered execution: keep `in_flight` device batches pending
    while the host parses the next ones."""
    stream = BatchStream(path, lanes, reverse=reverse)
    window: List[Tuple[ReadBatch, object]] = []
    for batch in stream:
        window.append((batch, launch(batch)))
        if len(window) > in_flight:
            b, fut = window.pop(0)
            collect(b, fut)
    for b, fut in window:
        collect(b, fut)
