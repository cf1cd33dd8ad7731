"""Host-to-device prefetch: the port's copy of `seqrec_tpu/data/prefetch.py`
and the CUDA staging behind it.

`DevicePrefetcher` moves host batch assembly and the host-to-device copy off
the training loop: a background thread pulls `(bucket, host_batch)` pairs
from the source, stages each with the caller's `put_batch`, and keeps up to
`depth` staged batches in a bounded queue. The consumer side is a plain
iterator yielding `(bucket, batch)` in source order; a staged batch that is
a `StagedBatch` is made ready on the consumer's stream as it is taken.

`HostStager` is the port's `put_batch` for a CUDA device: each numpy array
is copied into a pinned host buffer, then to the device with
`non_blocking=True` on a side stream, and an event is recorded after the
copy. `StagedBatch.ready()` (on the consuming thread) makes the current
stream wait on that event and calls `record_stream` on each device tensor,
so the allocator does not hand its memory to the side stream while the
compute stream may still read it. A pinned buffer is not written again
before its last copy's event has completed.

Semantics (as the JAX package's, and tested the same way):
  * order and values are preserved exactly;
  * an exception raised by the source (or by `put_batch`) surfaces in the
    consumer at the position it occurred, not earlier;
  * source exhaustion -> `StopIteration`;
  * `close()` never hangs: it drains or unblocks a feeder stuck on a full
    queue and joins the thread, even for infinite sources.
"""

from __future__ import annotations

import collections
import queue
import threading
from typing import Any, Callable, Deque, Dict, Iterator, Tuple

import numpy as np
import torch

# Queue entries are (kind, payload), so one bounded queue carries data,
# termination and errors in order.
_ITEM = 0
_END = 1
_ERROR = 2


class DevicePrefetcher:
    """Background device-staging iterator over `(bucket, batch)` pairs."""

    def __init__(
        self,
        source: Iterator[Tuple[Any, Any]],
        put_batch: Callable[[Any], Any],
        depth: int = 2,
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._source = source
        self._put = put_batch
        # +1 slot so the final _END/_ERROR entry never waits behind `depth`
        # staged batches.
        self._q: "queue.Queue" = queue.Queue(maxsize=depth + 1)
        self._closed = threading.Event()
        self._exhausted = False
        self._thread = threading.Thread(
            target=self._feed, name="seqrec-device-prefetch", daemon=True
        )
        self._thread.start()

    # ---- feeder thread ----------------------------------------------------

    def _feed(self) -> None:
        try:
            for bucket, host_batch in self._source:
                if self._closed.is_set():
                    return
                staged = self._put(host_batch)
                self._offer((_ITEM, (bucket, staged)))
                if self._closed.is_set():
                    return
            self._offer((_END, None))
        except BaseException as e:  # noqa: BLE001 - must cross threads intact
            self._offer((_ERROR, e))

    def _offer(self, item) -> None:
        """put() that gives up promptly once close() is asked for, so a full
        queue never wedges the feeder."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return
            except queue.Full:
                continue

    # ---- consumer side ----------------------------------------------------

    def __iter__(self) -> "DevicePrefetcher":
        return self

    def __next__(self) -> Tuple[Any, Any]:
        if self._exhausted or self._closed.is_set():
            raise StopIteration
        kind, payload = self._q.get()
        if kind == _ITEM:
            bucket, staged = payload
            if isinstance(staged, StagedBatch):
                staged = staged.ready()
            return bucket, staged
        self._exhausted = True
        if kind == _ERROR:
            raise payload
        raise StopIteration

    def close(self) -> None:
        """Stop the feeder and reclaim the thread. Idempotent, non-blocking
        beyond a short join; safe to call from any thread."""
        self._closed.set()
        # Drain, so that a feeder blocked in _offer sees the flag at its next
        # retry and staged device batches are dropped promptly.
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        if self._thread.is_alive():
            self._thread.join(timeout=5.0)


class StagedBatch:
    """Device tensors (one, or a dict of them) whose copy was queued on a
    side stream, with the event recorded after it."""

    def __init__(self, tensors, event: torch.cuda.Event):
        self.tensors = tensors
        self.event = event

    def ready(self):
        """The tensors, usable on the current stream: it waits for the copy,
        and each tensor is marked as used by it."""
        stream = torch.cuda.current_stream(self.event_device)
        stream.wait_event(self.event)
        for t in _flat(self.tensors):
            t.record_stream(stream)
        return self.tensors

    @property
    def event_device(self) -> torch.device:
        return next(iter(_flat(self.tensors))).device


def _flat(tensors):
    return tensors.values() if isinstance(tensors, dict) else (tensors,)


class HostStager:
    """`put_batch` for a CUDA device: numpy arrays (one, or a dict of them)
    -> a `StagedBatch`, copied through pinned memory on a side stream.

    Pinned buffers are pooled by (shape, dtype), `slots` of each; before a
    buffer is written again the stager waits (on the calling thread, the
    feeder's) for the event of the copy that last read it."""

    def __init__(self, device: torch.device, slots: int = 4):
        self.device = device
        self.slots = max(2, slots)
        self.stream = torch.cuda.Stream(device)
        self._pool: Dict[tuple, Deque] = collections.defaultdict(collections.deque)

    def _pinned(self, a: np.ndarray) -> Tuple[torch.Tensor, list]:
        """A pinned buffer holding `a`, and its pool entry ([buffer, event])."""
        ring = self._pool[(a.shape, a.dtype.str)]
        if len(ring) < self.slots:
            entry = [torch.empty(a.shape, dtype=torch.from_numpy(a[:0]).dtype,
                                 pin_memory=True), None]
        else:
            entry = ring.popleft()
            if entry[1] is not None:
                entry[1].synchronize()  # its last copy has read it
        entry[0].numpy()[...] = a
        ring.append(entry)
        return entry[0], entry

    def __call__(self, batch) -> StagedBatch:
        arrays = batch if isinstance(batch, dict) else {None: batch}
        entries, out = [], {}
        with torch.cuda.stream(self.stream):
            for k, a in arrays.items():
                buf, entry = self._pinned(np.ascontiguousarray(a))
                out[k] = buf.to(self.device, non_blocking=True)
                entries.append(entry)
            event = torch.cuda.Event()
            event.record(self.stream)
        for entry in entries:
            entry[1] = event
        return StagedBatch(out if isinstance(batch, dict) else out[None], event)
