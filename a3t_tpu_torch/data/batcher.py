"""Static-shape bucketed batching: the port of ``a3t_tpu/data/batcher.py``.

Utterances are assigned to a small set of frame-length buckets; each bucket
has fixed (n_samples, n_frames, n_text) shapes, and its batch size comes
from the ``batch_bins`` budget (numel = frames x n_mels), the reference's
numel packing (espnet2/samplers/num_elements_batch_sampler.py:13-110) at a
few static shapes.  The batcher also does the host half of the reference's
collate fn (espnet2/train/collate_fn.py:158-287): token ids, alignment
seconds to frames, T5 phone-span masking and segment positions; the log-mel
half runs on the device in the train step.

Both packages draw every random choice from numpy's generators seeded the
same way, so the port's plans and batches equal the JAX package's bit for
bit.  With a ``spemb_map`` (uid -> x-vector) batches carry a float32
``spemb`` (B, E), zero in empty slots.  With ``duration_collect`` (the
duration-aware TTS variant) they carry int32 ``durations`` and
``reordered_index`` (B, F) and ``reduced_lengths`` (B,)
(``masking.duration_reduction``; empty slots keep durations 1, the
identity order and length 0).  A speech-only dataset's batches hold one
sentinel text token (id 1) and frame spans masked with the reference's
speech-only settings (collate_fn.py:222-231).  Over record shards
(``data/records.py``) the int16 audio is copied from the shards; with
``device_audio`` a batch carries each utterance's ``audio_offset`` in the
flat corpus instead of its audio, and the train step gathers the audio on
the device.  :meth:`BucketBatcher.chained_epoch_iterator` groups up to k
same-bucket batches for chained dispatch (``steps_per_dispatch``).

Over the W ranks of the data axis every rank walks the same unsharded
plan, at ``batch_multiple = W``, and ``rows = (r, W)`` gives rank r the row
block ``[r B / W, (r + 1) B / W)`` of each global batch
(``parallel.mesh.row_block``), equal to the global batch's rows bit for
bit: the span masks are drawn row after row from one epoch-wide generator,
so :meth:`BucketBatcher.make_batch` draws them (and the segment positions)
for every row of the global batch, which takes the utterances' metadata
alone, and reads or decodes audio only for the rank's own rows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.masking import (duration_reduction, phones_masking,
                                   segment_positions)
from a3t_tpu_torch.parallel.mesh import row_block


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    n_frames: int  # static mel-frame count (includes +1 centered frame)
    n_samples: int  # static waveform length
    n_text: int  # static phone-token count
    batch_size: int


@dataclasses.dataclass
class BatcherConfig:
    """The JAX package's ``BatcherConfig`` field for field."""

    batch_bins: int = 3_000_000  # numel budget (frames x n_mels), yaml:2
    bucket_frames: Sequence[int] = (256, 512, 768, 1024, 1536)
    text_pad_multiple: int = 8
    mlm_prob: float = 0.8
    mean_phn_span: float = 8.0
    # the reference multiplies mlm_prob by 0.8 in training and 1.0 at
    # inference (espnet2/tasks/mlm.py:281-285)
    mlm_prob_factor: float = 0.8
    min_frames: int = 16
    drop_overlong: bool = True
    seed: int = 0
    # round batch sizes to a multiple of this (the data-parallel degree)
    batch_multiple: int = 1
    # the duration-aware TTS variant: also emit durations, reordered_index
    # and reduced_lengths (espnet2/train/collate_fn.py:267-271)
    duration_collect: bool = False
    # decode batches with the native C++ thread-pool loader (native/loader);
    # a failed build raises
    use_native_loader: bool = True
    loader_threads: int = 4
    # ship audio as int16 PCM (half the host-to-device bytes; lossless for
    # PCM16 corpora); featurize() converts to float on the device
    audio_int16: bool = True
    # ship each utterance's offset in the flat corpus instead of its audio
    # (a dataset with global_offset, i.e. record shards; others ignore it)
    device_audio: bool = False


class BucketBatcher:
    """Assigns utterances to buckets and assembles static-shape batches."""

    def __init__(
        self,
        dataset: A3TDataset,
        frontend: LogMelConfig,
        config: BatcherConfig = BatcherConfig(),
        n_mels: Optional[int] = None,
        spemb_map: Optional[dict] = None,
    ):
        self.dataset = dataset
        self.fe = frontend
        self.config = config
        self.spemb_map = spemb_map
        self._spemb_dim = (len(next(iter(spemb_map.values())))
                           if spemb_map else 0)
        n_mels = n_mels if n_mels is not None else frontend.n_mels
        hop = frontend.hop_length

        self._loader = None
        # record shards hold no WAV files: their PCM is read directly
        if config.use_native_loader and hasattr(dataset, "wav"):
            from a3t_tpu_torch.data.native_loader import NativeWavLoader

            self._loader = NativeWavLoader(
                [dataset.wav.data[u] for u in dataset.uids],
                config.loader_threads)
            n_samples = self._loader.probe()[0]
        else:
            n_samples = [dataset.num_samples(u) for u in dataset.uids]
        # per-utterance lengths from the headers (the reference reads
        # collect-stats shape files for the same purpose)
        self._frames = {u: 1 + int(n) // hop
                        for u, n in zip(dataset.uids, n_samples)}
        self._texts = {u: dataset.num_phones(u) for u in dataset.uids}
        self._uid_index = {u: i for i, u in enumerate(dataset.uids)}

        self.buckets: list[BucketSpec] = []
        self.bucket_members: list[list[str]] = []
        bounds = sorted(config.bucket_frames)
        for bi, bf in enumerate(bounds):
            lo = bounds[bi - 1] if bi > 0 else config.min_frames
            members = [u for u in dataset.uids if lo < self._frames[u] <= bf]
            if not members:
                continue
            max_text = max(self._texts[u] for u in members)
            m = config.text_pad_multiple
            n_text = max(m, ((max_text + m - 1) // m) * m)
            bs = max(1, config.batch_bins // (bf * n_mels))
            m = config.batch_multiple
            bs = max(m, (bs // m) * m)
            self.buckets.append(BucketSpec(bf, (bf - 1) * hop, n_text, bs))
            self.bucket_members.append(members)
        self.n_dropped = len(dataset.uids) - sum(
            len(m) for m in self.bucket_members)

    def batch_plan(self, epoch: int, shard: tuple[int, int] = (0, 1)):
        """List of (bucket_idx, [uids]) for one epoch, seeded and sharded
        round-robin as ``batches[rank::world]`` (abs_task.py:1302-1525)."""
        rng = np.random.default_rng(self.config.seed + epoch)
        plan: list[tuple[int, list[str]]] = []
        for bi, members in enumerate(self.bucket_members):
            order = list(members)
            rng.shuffle(order)
            bs = self.buckets[bi].batch_size
            plan += [(bi, order[i: i + bs]) for i in range(0, len(order), bs)]
        plan = [plan[i] for i in rng.permutation(len(plan))]
        rank, world = shard
        return plan[rank::world]

    def make_batch(
        self,
        bucket_idx: int,
        uids: Sequence[str],
        rng: np.random.Generator,
        span_boundary: Optional[np.ndarray] = None,
        pad_to_batch: Optional[int] = None,
        rows: Optional[tuple[int, int]] = None,
    ) -> dict:
        """Assemble one host batch with the bucket's static shapes; slots
        past ``len(uids)`` stay zero (no text, nothing masked).  ``rows =
        (r, W)``: rank r's row block of that batch, its audio alone read."""
        spec = self.buckets[bucket_idx]
        cfg = self.config
        b = pad_to_batch if pad_to_batch is not None else spec.batch_size
        own = row_block(b, *rows) if rows is not None else slice(0, b)
        hop = self.fe.hop_length
        speech_only = getattr(self.dataset, "speech_only", False)
        # the native loader and record shards emit int16 PCM codes directly
        # when the batch ships as int16 (no decode-to-float and re-quantize
        # round trip)
        pcm16_direct = cfg.audio_int16 and (
            self._loader is not None or hasattr(self.dataset, "get_pcm16"))
        device_audio = cfg.device_audio and hasattr(self.dataset,
                                                    "global_offset")
        if device_audio:
            audio_offset = np.zeros(b, np.int32)
            audio = None
        else:
            # the rank's rows only (own.start is row 0 of the array)
            audio = np.zeros((own.stop - own.start, spec.n_samples),
                             np.int16 if pcm16_direct else np.float32)
        audio_lengths = np.zeros(b, np.int32)
        text = np.zeros((b, spec.n_text), np.int32)
        text_mask = np.zeros((b, spec.n_text), bool)
        masked = np.zeros((b, spec.n_frames), bool)
        ssp = np.zeros((b, spec.n_frames), np.int32)
        tsp = np.zeros((b, spec.n_text), np.int32)
        if cfg.duration_collect:
            durations = np.ones((b, spec.n_frames), np.int32)
            reordered = np.tile(np.arange(spec.n_frames, dtype=np.int32),
                                (b, 1))
            reduced_lengths = np.zeros(b, np.int32)

        own_uids = uids[own]
        if self._loader is not None and own_uids and not device_audio:
            idx = [self._uid_index[u] for u in own_uids]
            load = (self._loader.load_batch_i16 if pcm16_direct
                    else self._loader.load_batch)
            load(idx, spec.n_samples, out=audio[: len(idx)])

        for i, uid in enumerate(uids):
            mine = own.start <= i < own.stop
            if device_audio:
                item = self.dataset.get_meta(uid)
                audio_offset[i] = self.dataset.global_offset(uid)
                wav_len = min(self.dataset.num_samples(uid), spec.n_samples)
            elif self._loader is not None:
                item = self.dataset.get_meta(uid)
                wav_len = min((self._frames[uid] - 1) * hop, spec.n_samples)
            elif not mine:
                # another rank's row: its span mask needs its length only
                item = self.dataset.get_meta(uid)
                wav_len = min(self.dataset.num_samples(uid), spec.n_samples)
            elif pcm16_direct:
                item = self.dataset.get_meta(uid)
                pcm = self.dataset.get_pcm16(uid)[: spec.n_samples]
                audio[i - own.start, : len(pcm)] = pcm
                wav_len = len(pcm)
            else:
                item = self.dataset[uid]
                wav = item["audio"][: spec.n_samples]
                audio[i - own.start, : len(wav)] = wav
                wav_len = len(wav)
            audio_lengths[i] = wav_len
            n_f = 1 + wav_len // hop

            if speech_only:
                # the sentinel text token; frame spans masked with the
                # reference's speech-only settings (collate_fn.py:222-231)
                t_len = 0
                starts = ends = np.zeros(0, np.int32)
                text[i, 0] = 1
                text_mask[i, 0] = True
                masked[i] = phones_masking(spec.n_frames, starts, ends, 0,
                                           0.15, 0, rng,
                                           span_boundary=span_boundary)
            else:
                ids = item["text_ids"][: spec.n_text]
                t_len = len(ids)
                text[i, :t_len] = ids
                text_mask[i, :t_len] = True
                starts = np.minimum(self.fe.seconds_to_frames(
                    item["align_start_sec"])[:t_len], n_f)
                ends = np.minimum(self.fe.seconds_to_frames(
                    item["align_end_sec"])[:t_len], n_f)
                masked[i] = phones_masking(
                    spec.n_frames, starts, ends, t_len,
                    cfg.mlm_prob * cfg.mlm_prob_factor, cfg.mean_phn_span,
                    rng, span_boundary=span_boundary)
            masked[i, n_f:] = False
            ssp[i], tsp[i] = segment_positions(spec.n_frames, spec.n_text,
                                               starts, ends, t_len)
            if cfg.duration_collect and t_len > 0:
                reordered[i], durations[i], reduced_lengths[i] = \
                    duration_reduction(spec.n_frames, starts, ends, t_len,
                                       masked[i], n_f)

        if (audio is not None and cfg.audio_int16
                and audio.dtype != np.int16):
            # round-to-nearest x32768: the exact inverse of the /32768
            # decode, so PCM16 sources round-trip bit for bit
            audio = np.clip(np.rint(audio * 32768.0), -32768,
                            32767).astype(np.int16)
        out = dict(text=text, text_mask=text_mask, masked_position=masked,
                   speech_segment_pos=ssp, text_segment_pos=tsp,
                   audio_lengths=audio_lengths)
        if device_audio:
            out["audio_offset"] = audio_offset
        else:
            out["audio"] = audio
        if self.spemb_map is not None:
            spemb = np.zeros((b, self._spemb_dim), np.float32)
            for i, uid in enumerate(uids):
                spemb[i] = self.spemb_map[uid]
            out["spemb"] = spemb
        if cfg.duration_collect:
            out.update(durations=durations, reordered_index=reordered,
                       reduced_lengths=reduced_lengths)
        if rows is not None:
            # every array but the audio (already the rank's rows)
            out = {k: v if k == "audio" else v[own] for k, v in out.items()}
        return out

    def epoch_iterator(self, epoch: int, shard: tuple[int, int] = (0, 1),
                       rows: Optional[tuple[int, int]] = None):
        """Yield host batches for one epoch (reproducibly seeded); with
        ``rows = (r, W)`` rank r's row block of each."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.seed, epoch, 777]))
        for bi, uids in self.batch_plan(epoch, shard):
            yield self.make_batch(bi, uids, rng, rows=rows)

    def chained_plan(self, epoch: int, k: int,
                     shard: tuple[int, int] = (0, 1)):
        """The epoch's plan in same-bucket runs of up to ``k`` batches:
        list of (bucket_idx, [[uids] per batch]).  Runs, not batches, are
        permuted and sharded round-robin."""
        rng = np.random.default_rng(self.config.seed + epoch)
        runs: list[tuple[int, list[list[str]]]] = []
        for bi, members in enumerate(self.bucket_members):
            order = list(members)
            rng.shuffle(order)
            bs = self.buckets[bi].batch_size
            chunks = [order[i: i + bs] for i in range(0, len(order), bs)]
            runs += [(bi, chunks[j: j + k]) for j in range(0, len(chunks), k)]
        runs = [runs[i] for i in rng.permutation(len(runs))]
        rank, world = shard
        return runs[rank::world]

    def chained_epoch_iterator(self, epoch: int, k: int,
                               shard: tuple[int, int] = (0, 1)):
        """Yield ("chained", stacked, valid, weights) groups of ``k``
        (:func:`stack_group`), reproducibly seeded."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.seed, epoch, 777]))
        for bi, chunks in self.chained_plan(epoch, k, shard):
            yield stack_group([self.make_batch(bi, c, rng) for c in chunks],
                              k)


def stack_group(batches: list, k: int):
    """Stack up to ``k`` same-shape host batches into one chained group
    ("chained", stacked, valid, weights): every array gains a leading k
    axis; a short group is padded by repeating its last batch, with
    ``valid`` False and weight 0 at the padded entries (the weights are the
    batches' sizes)."""
    m = len(batches)
    weights = np.array([float(len(b["audio_lengths"])) for b in batches]
                       + [0.0] * (k - m), np.float32)
    valid = np.array([True] * m + [False] * (k - m))
    padded = batches + [batches[-1]] * (k - m)
    stacked = {key: np.stack([b[key] for b in padded]) for key in padded[0]}
    return ("chained", stacked, valid, weights)
