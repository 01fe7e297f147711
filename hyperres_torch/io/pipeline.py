"""Double-buffered host -> device input pipeline (``hyperres/io/pipeline.py``).

A background thread stages the next host batch (file read + decode)
while the device consumes the current one. Where the reference calls
``jax.device_put``, a CUDA placement here is:

- the batch's arrays copied into pinned host tensors,
- ``to(device, non_blocking=True)`` on a side ``torch.cuda.Stream`` in
  the loader thread, and an event recorded after the copies,
- at the consumer, its current stream waits on that event before the
  first use, and each device tensor is ``record_stream``'d on that
  stream (it was allocated on the side stream; without it the caching
  allocator could hand its memory to a later copy while the consumer's
  kernels still read it).

The pinned buffers must outlive their copies: the loader keeps the
last ``depth`` batches' buffers and, before letting one go, waits on its
event on the host (the copy is then done). A CPU placement is a plain
``torch.from_numpy`` (no copy).
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Iterable, Iterator, Optional, Sequence

import numpy as np
import torch

from ..device import resolve_device


def _map(item: Any, leaf: type, fn: Callable) -> Any:
    """``fn`` applied to every ``leaf`` of a nested tuple / list / dict
    batch; other leaves (NumPy or Python scalars) are kept as they
    are."""
    if isinstance(item, leaf):
        return fn(item)
    if isinstance(item, (tuple, list)):
        return type(item)(_map(x, leaf, fn) for x in item)
    if isinstance(item, dict):
        return {k: _map(v, leaf, fn) for k, v in item.items()}
    return item


def _tensors(item: Any) -> list:
    """Every tensor of a nested batch."""
    out: list = []
    _map(item, torch.Tensor, out.append)
    return out


class _Placed:
    """A batch on the card and the event after its copies."""

    __slots__ = ("item", "event")

    def __init__(self, item, event):
        self.item = item
        self.event = event


class PrefetchToDevice:
    """Iterate host batches with background prefetch + device placement.

    ``source`` yields numpy arrays / nested tuples, lists or dicts of
    them (scalars in a batch stay on the host); ``depth`` batches are
    kept in flight. ``device`` is where the
    batches land (default: the current CUDA device). Exceptions in the
    loader thread are re-raised at the consuming site. Single use."""

    _SENTINEL = object()

    def __init__(self, source: Iterable[Any], depth: int = 2,
                 device=None, transform: Optional[Callable] = None):
        self.source = source
        self.depth = max(1, int(depth))
        self.device = resolve_device(device)
        self.transform = transform
        self._q: "queue.Queue" = queue.Queue(maxsize=self.depth)
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._iterated = False
        self._stream = None

    def _put(self, item) -> bool:
        """Bounded put that gives up when the consumer is gone — a
        consumer that exits early (break / exception in its loop body)
        must not leave the loader blocked forever on a full queue,
        pinning in-flight buffers and the open source."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def _place_cuda(self, item, pinned: collections.deque) -> "_Placed":
        """Pinned host copies of the batch's arrays, then non-blocking
        copies on the side stream and an event after them. The pinned
        copies join ``pinned`` until their event has completed."""
        host = _map(item, np.ndarray, lambda a: torch.from_numpy(
            np.ascontiguousarray(a)).pin_memory())
        with torch.cuda.stream(self._stream):
            placed = _map(host, torch.Tensor,
                          lambda t: t.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self._stream)
        pinned.append((host, event))
        return _Placed(placed, event)

    def _worker(self):
        # the pinned buffers of the batches still in flight, oldest first
        pinned: collections.deque = collections.deque()
        try:
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
                self._stream = torch.cuda.Stream(self.device)
            for item in self.source:
                if self._stop.is_set():
                    return
                if self.transform is not None:
                    item = self.transform(item)
                if self.device.type == "cuda":
                    placed = self._place_cuda(item, pinned)
                    while len(pinned) > self.depth:
                        pinned.popleft()[1].synchronize()
                else:
                    placed = _map(item, np.ndarray, torch.from_numpy)
                if not self._put(placed):
                    return
            self._put(self._SENTINEL)
        except BaseException as e:  # noqa: BLE001 - reraised at consumer
            self._put(e)
        finally:
            for _, event in pinned:
                event.synchronize()
            pinned.clear()
            close = getattr(self.source, "close", None)
            if close is not None:
                try:
                    close()
                except Exception:
                    pass

    def __iter__(self) -> Iterator[Any]:
        # single-shot: the source generator is consumed by the first
        # pass, and _stop stays set after it — a silent second iteration
        # would hang on the queue (the restarted worker exits without
        # enqueueing the sentinel once _stop is set)
        if self._iterated:
            raise RuntimeError(
                "PrefetchToDevice is single-use; build a new instance "
                "(its source iterable is already consumed)")
        self._iterated = True
        if self.device.type == "cuda" and self.device.index is None:
            # the consumer's current card: the loader thread starts on
            # card 0, and torch.cuda.set_device needs an index
            self.device = torch.device("cuda", torch.cuda.current_device())
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()
        try:
            while True:
                item = self._q.get()
                if item is self._SENTINEL:
                    return
                if isinstance(item, BaseException):
                    raise item
                if isinstance(item, _Placed):
                    stream = torch.cuda.current_stream(self.device)
                    stream.wait_event(item.event)
                    for t in _tensors(item.item):
                        t.record_stream(stream)
                    item = item.item
                yield item
        finally:
            # normal exhaustion or early consumer exit: release the
            # loader (GeneratorExit lands here when the caller breaks)
            self._stop.set()


def band_chunk_reader(dataset_read: Callable[[int, int], np.ndarray],
                      n_bands: int, chunk: int = 32
                      ) -> Iterator[np.ndarray]:
    """Yield (..., chunk) band slabs from a reader callable — the
    generalisation of the reference's tuned 32-band chunking
    (emit_proj.py:969)."""
    for b0 in range(0, n_bands, chunk):
        yield dataset_read(b0, min(b0 + chunk, n_bands))


def tile_batch_reader(
    tiff_reader,
    windows: Sequence,
    batch: int = 8,
    dtype=np.float32,
) -> Iterator[np.ndarray]:
    """Yield (batch, B, h, w) stacks of equally sized tile windows from a
    TiffReader — the streaming feed for sharded tile processing. The
    final partial batch is zero-padded to keep device shapes static."""
    if not windows:
        return
    h, w = windows[0].height, windows[0].width
    buf = []
    for win in windows:
        if win.height != h or win.width != w:
            raise ValueError("All tile windows must share one shape")
        buf.append(tiff_reader.read(window=win).astype(dtype))
        if len(buf) == batch:
            yield np.stack(buf)
            buf = []
    if buf:
        pad = batch - len(buf)
        block = np.stack(buf)
        if pad:
            block = np.concatenate(
                [block, np.zeros((pad,) + block.shape[1:], dtype=dtype)])
        yield block
