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
``spemb`` (B, E), zero in empty slots.  Not ported: duration collection for
the TTS variant (A9), device-resident audio (needs the record shards of
A7-rest) and chained superbatches (A6); each raises.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np

from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.dsp.frontend import LogMelConfig
from a3t_tpu_torch.masking import phones_masking, segment_positions


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
    duration_collect: bool = False  # not ported (ROADMAP A9)
    # decode batches with the native C++ thread-pool loader (native/loader);
    # a failed build raises
    use_native_loader: bool = True
    loader_threads: int = 4
    # ship audio as int16 PCM (half the host-to-device bytes; lossless for
    # PCM16 corpora); featurize() converts to float on the device
    audio_int16: bool = True
    device_audio: bool = False  # not ported (record shards, ROADMAP A7-rest)


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
        if config.duration_collect:
            raise NotImplementedError(
                "duration_collect is not ported (ROADMAP A9)")
        if config.device_audio:
            raise NotImplementedError(
                "device_audio needs record shards, not ported (ROADMAP "
                "A7-rest)")
        self.dataset = dataset
        self.fe = frontend
        self.config = config
        self.spemb_map = spemb_map
        self._spemb_dim = (len(next(iter(spemb_map.values())))
                           if spemb_map else 0)
        n_mels = n_mels if n_mels is not None else frontend.n_mels
        hop = frontend.hop_length

        self._loader = None
        if config.use_native_loader:
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
    ) -> dict:
        """Assemble one host batch with the bucket's static shapes; slots
        past ``len(uids)`` stay zero (no text, nothing masked)."""
        spec = self.buckets[bucket_idx]
        cfg = self.config
        b = pad_to_batch if pad_to_batch is not None else spec.batch_size
        hop = self.fe.hop_length
        # the native loader emits int16 PCM codes directly when the batch
        # ships as int16 (no decode-to-float and re-quantize round trip)
        pcm16_direct = cfg.audio_int16 and self._loader is not None
        audio = np.zeros((b, spec.n_samples),
                         np.int16 if pcm16_direct else np.float32)
        audio_lengths = np.zeros(b, np.int32)
        text = np.zeros((b, spec.n_text), np.int32)
        text_mask = np.zeros((b, spec.n_text), bool)
        masked = np.zeros((b, spec.n_frames), bool)
        ssp = np.zeros((b, spec.n_frames), np.int32)
        tsp = np.zeros((b, spec.n_text), np.int32)

        if self._loader is not None and uids:
            idx = [self._uid_index[u] for u in uids]
            load = (self._loader.load_batch_i16 if pcm16_direct
                    else self._loader.load_batch)
            load(idx, spec.n_samples, out=audio[: len(idx)])

        for i, uid in enumerate(uids):
            if self._loader is not None:
                item = self.dataset.get_meta(uid)
                wav_len = min((self._frames[uid] - 1) * hop, spec.n_samples)
            else:
                item = self.dataset[uid]
                wav = item["audio"][: spec.n_samples]
                audio[i, : len(wav)] = wav
                wav_len = len(wav)
            audio_lengths[i] = wav_len
            n_f = 1 + wav_len // hop

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
                cfg.mlm_prob * cfg.mlm_prob_factor, cfg.mean_phn_span, rng,
                span_boundary=span_boundary)
            masked[i, n_f:] = False
            ssp[i], tsp[i] = segment_positions(spec.n_frames, spec.n_text,
                                               starts, ends, t_len)

        if cfg.audio_int16 and audio.dtype != np.int16:
            # round-to-nearest x32768: the exact inverse of the /32768
            # decode, so PCM16 sources round-trip bit for bit
            audio = np.clip(np.rint(audio * 32768.0), -32768,
                            32767).astype(np.int16)
        out = dict(text=text, text_mask=text_mask, masked_position=masked,
                   speech_segment_pos=ssp, text_segment_pos=tsp,
                   audio_lengths=audio_lengths, audio=audio)
        if self.spemb_map is not None:
            spemb = np.zeros((b, self._spemb_dim), np.float32)
            for i, uid in enumerate(uids):
                spemb[i] = self.spemb_map[uid]
            out["spemb"] = spemb
        return out

    def epoch_iterator(self, epoch: int, shard: tuple[int, int] = (0, 1)):
        """Yield host batches for one epoch (reproducibly seeded)."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.config.seed, epoch, 777]))
        for bi, uids in self.batch_plan(epoch, shard):
            yield self.make_batch(bi, uids, rng)
