"""Epoch iterator factories with background prefetch: the port of
``a3t_tpu/data/iterator.py``.

The analogue of SequenceIterFactory (espnet2/iterators/sequence_iter_factory.py:27):
epoch-seeded, reproducible order, optional ``num_iters_per_epoch``
windowing, and a producer thread so that host batch assembly overlaps the
device's steps.  On the card :class:`DeviceTransfer` takes the place of the
JAX task's ``to_device_batch`` (``a3t_tpu/tasks/mlm.py:205-219``): the
producer copies each batch from reused pinned buffers on a side stream, and
the consumer's stream waits on the copy's event, so the copy of batch n + 1
overlaps step n.  Items are batches (dicts), chained groups
``("chained", stacked, valid, weights)`` (``chain > 1``) and the
multi-corpus factory's ``(name, batch)``; only the dicts go to the card.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Callable, Iterator, Optional

import numpy as np
import torch

from a3t_tpu_torch.data.batcher import BucketBatcher


class PrefetchIterator:
    """Wrap an iterator with a background producer thread.

    ``transform`` runs in the producer thread on each item, ``finish`` in
    the consumer's thread as it takes the item (for :class:`DeviceTransfer`,
    the copy and the stream wait).  The producer's cumulative seconds of
    batch assembly (``t_gen``), transform (``t_transform``) and waiting on a
    full queue (``t_qfull``, the healthy state) are read by the trainer's
    log line.
    """

    def __init__(self, it: Iterator, depth: int = 2,
                 transform: Optional[Callable] = None,
                 finish: Optional[Callable] = None):
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._done = object()
        self._err: Optional[BaseException] = None
        self._closed = False
        self._finish = finish
        self.t_gen = 0.0
        self.t_transform = 0.0
        self.t_qfull = 0.0
        self.n_produced = 0

        def put(item) -> None:
            while not self._closed:
                try:
                    self.q.put(item, timeout=0.5)
                    return
                except queue.Full:
                    continue

        def produce():
            try:
                while not self._closed:
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    t1 = time.perf_counter()
                    self.t_gen += t1 - t0
                    if self._closed:
                        return
                    if transform is not None:
                        item = transform(item)
                    t2 = time.perf_counter()
                    self.t_transform += t2 - t1
                    put(item)
                    self.t_qfull += time.perf_counter() - t2
                    self.n_produced += 1
            except BaseException as e:  # re-raised in the consumer
                self._err = e
            finally:
                # the sentinel must land for a live consumer; a close()d
                # iterator's consumer is the closer and takes nothing more
                put(self._done)

        self.thread = threading.Thread(target=produce, daemon=True)
        self.thread.start()

    def close(self):
        """Stop the producer and drop queued items (and with them the
        device batches they hold)."""
        self._closed = True
        # the producer exits within one put retry (or after its in-flight
        # batch); drain once it is gone so no put lands after the drain
        self.thread.join(timeout=30.0)
        while True:
            try:
                self.q.get_nowait()
            except queue.Empty:
                break

    def __iter__(self):
        return self

    def __next__(self):
        if self._closed:
            raise StopIteration
        item = self.q.get()
        if item is self._done:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item if self._finish is None else self._finish(item)


def _dict_of(item) -> tuple:
    """(the item's dict of arrays, a function that puts a replacement
    dict back in its place) for a batch, a chained group or a (name,
    batch) pair."""
    if isinstance(item, dict):
        return item, lambda d: d
    if len(item) == 4 and item[0] == "chained":
        return item[1], lambda d: (item[0], d, *item[2:])
    return item[1], lambda d: (item[0], d)


class DeviceTransfer:
    """Host batch (dict of numpy arrays) -> batch on a CUDA device; the
    dict of a chained group or a (name, batch) pair moves the same way.

    ``put`` runs in the producer thread: it copies each array into a pinned
    host buffer, allocated once per (key, shape, dtype) and reused in turns
    of two, and from there to the device with ``non_blocking=True`` on a
    side stream, then records an event.  ``take`` runs in the consumer's
    thread: its current stream waits on that event, and every tensor is
    marked as used on that stream, so the caching allocator does not hand
    its memory to the next copy while the step still reads it.
    """

    SLOTS = 2

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(device=self.device)
        self._pinned: dict = {}  # (key, shape, dtype) -> [slot, bufs, events]

    def _pinned_copy(self, key, arr: np.ndarray):
        """(pinned buffer holding ``arr``, its slot's event list, slot)."""
        tag = (key, arr.shape, arr.dtype.str)
        entry = self._pinned.get(tag)
        if entry is None:
            bufs = [torch.from_numpy(np.empty_like(arr)).pin_memory()
                    for _ in range(self.SLOTS)]
            entry = self._pinned[tag] = [0, bufs, [None] * self.SLOTS]
        i = entry[0]
        entry[0] = (i + 1) % self.SLOTS
        if entry[2][i] is not None:
            entry[2][i].synchronize()  # its last copy to the device is done
        buf = entry[1][i]
        np.copyto(buf.numpy(), arr)
        return buf, entry[2], i

    def put(self, item):
        batch, rebuild = _dict_of(item)
        out, marks = {}, []
        with torch.cuda.stream(self.stream):
            for k, v in batch.items():
                buf, events, i = self._pinned_copy(k, np.asarray(v))
                out[k] = buf.to(self.device, non_blocking=True)
                marks.append((events, i))
            done = torch.cuda.Event()
            done.record(self.stream)
        for events, i in marks:
            events[i] = done
        return rebuild(out), done

    def take(self, put_item):
        item, done = put_item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(done)
        for t in _dict_of(item)[0].values():
            t.record_stream(stream)
        return item


class EpochIterFactory:
    """factory(epoch) -> iterator of batches; pluggable into the Trainer.

    With ``num_iters_per_epoch`` the epoch's plan is cycled (reseeded at
    ``epoch + 1000 k``) until that many batches were produced, as the
    reference windows batches across epochs
    (sequence_iter_factory.py:60-101).  ``transfer`` (a
    :class:`DeviceTransfer`) moves each batch to the card in the producer
    thread.  With ``chain = k > 1`` the items are chained groups of up to k
    same-bucket batches (``BucketBatcher.chained_epoch_iterator``) and
    ``num_iters_per_epoch`` counts their valid sub-steps: the group that
    crosses it has its tail marked invalid (weight 0).  ``rows = (r, W)``:
    rank r's row block of each batch of the unsharded plan
    (``BucketBatcher.make_batch``), one rank of the data axis; it takes no
    chained groups.
    """

    def __init__(
        self,
        batcher: BucketBatcher,
        num_iters_per_epoch: Optional[int] = None,
        shard: tuple[int, int] = (0, 1),
        prefetch: int = 2,
        transfer: Optional[DeviceTransfer] = None,
        chain: int = 1,
        rows: Optional[tuple[int, int]] = None,
    ):
        if rows is not None and chain > 1:
            raise NotImplementedError(
                "chained groups of a rank's row blocks (steps_per_dispatch "
                "> 1 over several ranks)")
        self.batcher = batcher
        self.rows = rows
        self.num_iters = num_iters_per_epoch
        self.shard = shard
        self.prefetch = prefetch
        self.transfer = transfer
        self.chain = chain

    def _batches(self, epoch: int):
        produced = 0
        offset = 0
        while True:
            empty = True
            if self.chain > 1:
                items = self.batcher.chained_epoch_iterator(
                    epoch + offset, self.chain, self.shard)
            else:
                items = self.batcher.epoch_iterator(epoch + offset,
                                                    self.shard, self.rows)
            for item in items:
                empty = False
                n = 1
                if self.chain > 1:
                    tag, stacked, valid, weights = item
                    n = int(valid.sum())
                    if (self.num_iters is not None
                            and produced + n > self.num_iters):
                        n = self.num_iters - produced
                        valid, weights = valid.copy(), weights.copy()
                        valid[n:] = False
                        weights[n:] = 0.0
                        item = (tag, stacked, valid, weights)
                yield item
                produced += n
                if self.num_iters is not None and produced >= self.num_iters:
                    return
            if self.num_iters is None or empty:
                return
            offset += 1000  # reseed for the wrap-around pass

    def __call__(self, epoch: int):
        put = self.transfer.put if self.transfer is not None else None
        take = self.transfer.take if self.transfer is not None else None
        if self.prefetch > 0:
            return PrefetchIterator(self._batches(epoch), self.prefetch,
                                    transform=put, finish=take)
        if self.transfer is None:
            return self._batches(epoch)
        return (take(put(b)) for b in self._batches(epoch))
