"""Host-side prefetch: batches are read and collated on a background thread
and copied to the device ahead of the step that uses them (counterpart of
``singa_tpu/data/pipeline.py``).

For a CUDA device the worker pins each CPU batch (page-locked memory) and
issues a non-blocking host-to-device copy on the device's current stream, so
the copy runs in order before the step's kernels while the host goes on to
the next batch. For the CPU the batch is handed over as it is.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, Optional

import torch


class Prefetcher:
    """Wrap an iterable of CPU ``ComplexBatch``es with a ``depth``-deep
    background queue of batches on ``device``."""

    def __init__(self, source: Iterable, depth: int = 2, device="cpu"):
        self._source = source
        self._device = torch.device(device)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, batch):
        if self._device.type == "cuda":
            return batch.pin_memory().to(self._device, non_blocking=True)
        return batch.to(self._device)

    def _worker(self):
        try:
            for item in self._source:
                if self._stop.is_set():
                    return
                self._q.put(self._put(item))
        except BaseException as e:  # handed to the consumer, which raises it
            self._err = e
        finally:
            self._q.put(None)

    def __iter__(self) -> Iterator:
        while True:
            item = self._q.get()
            if item is None:
                if self._err is not None:
                    raise self._err
                return
            yield item

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
