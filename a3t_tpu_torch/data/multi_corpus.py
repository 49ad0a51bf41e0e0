"""Multi-corpus, mixed-sample-rate pretraining: the port of
``a3t_tpu/data/multi_corpus.py``.

The reference trains A3T on a mixture of corpora with their own front-end
settings (LibriTTS 0.6, LibriSpeech 0.2, VCTK 0.2 of each epoch's
iterations, 16 kHz overrides, speech-only corpora; espnet2/tasks/mlm.py:
499-591).  Each corpus keeps its own :class:`BucketBatcher` on its own
``LogMelConfig``; :class:`MultiCorpusIterFactory` yields ``(corpus name,
batch)`` with the corpora interleaved by portion, and
:func:`make_multi_corpus_train_step` hands each batch to the step built
for its corpus's front-end and ``speech_only`` flag.  The schedule and the
batches equal the JAX package's bit for bit.  Over the W ranks of the data
axis every rank walks the same schedule and takes its row block of each
batch (``rows``, as ``EpochIterFactory`` does; the task gives each
corpus's batcher ``batch_multiple = max(W, ...)``), and each corpus's step
is ``make_train_step``'s, which reduces over the ranks.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np

from a3t_tpu_torch.data.batcher import BucketBatcher
from a3t_tpu_torch.data.iterator import DeviceTransfer, PrefetchIterator


@dataclasses.dataclass
class CorpusSpec:
    name: str
    batcher: BucketBatcher
    portion: float
    speech_only: bool = False


class MultiCorpusIterFactory:
    """factory(epoch) -> iterator of (corpus name, batch).

    An epoch holds ``round(portion * num_iters)`` batches of each corpus
    (portions normalised; the rounding remainder goes to the first corpus)
    in an order shuffled by ``SeedSequence([seed, epoch, 4242])``; a corpus
    that runs out restarts its plan at ``epoch + 1000 n``.  ``transfer`` (a
    :class:`DeviceTransfer`) moves each batch to the card in the producer
    thread.  ``rows = (r, W)``: rank r's row block of each batch."""

    def __init__(
        self,
        corpora: list[CorpusSpec],
        num_iters_per_epoch: int,
        shard: tuple[int, int] = (0, 1),
        prefetch: int = 2,
        seed: int = 0,
        transfer: Optional[DeviceTransfer] = None,
        rows: Optional[tuple[int, int]] = None,
    ):
        total = sum(c.portion for c in corpora)
        self.corpora = corpora
        self.weights = [c.portion / total for c in corpora]
        self.num_iters = num_iters_per_epoch
        self.shard = shard
        self.prefetch = prefetch
        self.seed = seed
        self.transfer = transfer
        self.rows = rows

    def _corpus_batches(self, spec: CorpusSpec, epoch: int):
        offset = 0
        while True:
            produced = False
            for b in spec.batcher.epoch_iterator(epoch + offset, self.shard,
                                                 self.rows):
                produced = True
                yield b
            if not produced:
                return
            offset += 1000

    def _items(self, epoch: int):
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, epoch, 4242]))
        counts = [int(round(w * self.num_iters)) for w in self.weights]
        counts[0] += self.num_iters - sum(counts)
        schedule = [ci for ci, n in enumerate(counts) for _ in range(n)]
        iters = [self._corpus_batches(spec, epoch) for spec in self.corpora]
        rng.shuffle(schedule)
        for ci in schedule:
            try:
                batch = next(iters[ci])
            except StopIteration:
                continue
            yield (self.corpora[ci].name, batch)

    def __call__(self, epoch: int):
        put = self.transfer.put if self.transfer is not None else None
        take = self.transfer.take if self.transfer is not None else None
        if self.prefetch > 0:
            return PrefetchIterator(self._items(epoch), self.prefetch,
                                    transform=put, finish=take)
        if self.transfer is None:
            return self._items(epoch)
        return (take(put(b)) for b in self._items(epoch))


def make_multi_corpus_train_step(model, frontends: dict,
                                 speech_only: dict, device=None) -> Callable:
    """(state, (name, batch), rng) -> (state, stats): each corpus's step
    (``make_train_step`` with its front-end and its ``speech_only`` flag,
    the matmul-DFT front-end and no normalizer, as in JAX) behind one
    dispatcher."""
    from a3t_tpu_torch.train.train_step import make_train_step

    steps = {name: make_train_step(model, fe, device=device,
                                   speech_only=speech_only.get(name, False))
             for name, fe in frontends.items()}

    def step(state, named_batch, rng):
        name, batch = named_batch
        return steps[name](state, batch, rng)

    return step
