"""The port's data pipeline (a3t_tpu_torch/data/) against the JAX package's
(a3t_tpu/data/): miniature corpora equal file for file for one seed; the
native loader, built from native/loader's sources into the port's _build/,
decodes what scipy reads; buckets, epoch plans and every array of every
batch equal JAX's bit for bit over two epochs, with the native loader on
and off; the prefetch iterator keeps order, re-raises the producer's error
and stops its producer on close(); and the options that came later (the
speech-only dataset, device_audio, chained groups) build, while a failed
native loader build still raises."""

import filecmp
import os
import threading
import time

import numpy as np
import pytest

from a3t_tpu.data import batcher as jax_batcher
from a3t_tpu.data import dataset as jax_dataset
from a3t_tpu.data import miniature as jax_miniature
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu.text import build_token_list as jax_build_token_list
from a3t_tpu_torch.data import miniature, native_loader
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text, read_wav
from a3t_tpu_torch.data.iterator import EpochIterFactory, PrefetchIterator
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.text import TokenIDConverter, build_token_list

FE = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200, n_mels=20,
          fmin=80.0, fmax=7600.0)
# 24 kHz speech-like utterances of 37-198 frames: three buckets, a few
# batches each, with ragged last batches
BATCHER = dict(batch_bins=20 * 128 * 3, bucket_frames=(64, 128, 256),
               min_frames=16)


def _same_tree(a, b):
    """Every file under ``a`` equals its twin under ``b``; wav.scp's paths
    differ only by the directory."""
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    for n in names:
        pa, pb = os.path.join(a, n), os.path.join(b, n)
        if os.path.isdir(pa):
            _same_tree(pa, pb)
        elif n == "wav.scp":
            ta = open(pa).read().replace(a, "D")
            assert ta == open(pb).read().replace(b, "D")
        else:
            assert filecmp.cmp(pa, pb, shallow=False), n


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same speech-like corpus written by both packages."""
    d = tmp_path_factory.mktemp("speechlike")
    kw = dict(n_utts=24, n_speakers=3, fs=24000, n_phones_range=(4, 18),
              seed=5)
    port = miniature.generate_speechlike_corpus(str(d / "port"), **kw)
    jax = jax_miniature.generate_speechlike_corpus(str(d / "jax"), **kw)
    return port, jax


def test_speechlike_corpus_equals_jax(corpora):
    _same_tree(*corpora)


def test_mini_corpus_equals_jax(tmp_path):
    for fs, seed in ((24000, 0), (8000, 3)):
        port = miniature.generate_mini_corpus(str(tmp_path / f"p{fs}"),
                                              n_utts=5, fs=fs, seed=seed)
        jax = jax_miniature.generate_mini_corpus(str(tmp_path / f"j{fs}"),
                                                 n_utts=5, fs=fs, seed=seed)
        _same_tree(port, jax)


def test_native_loader_builds_into_the_port_and_decodes_like_scipy(corpora):
    from scipy.io import wavfile

    path = native_loader.build()
    assert os.path.realpath(os.path.dirname(path)) == os.path.realpath(
        os.path.join(os.path.dirname(native_loader.__file__), "..", "_build"))
    assert os.path.basename(path).startswith("liba3t_loader_")
    paths = sorted(read_2column_text(
        os.path.join(corpora[0], "wav.scp")).values())
    loader = native_loader.NativeWavLoader(paths, 2)
    ns, sr = loader.probe()
    pcm = [wavfile.read(p)[1] for p in paths]
    assert (sr == 24000).all() and list(ns) == [len(x) for x in pcm]
    n_max = 20000
    f32, lengths = loader.load_batch(range(len(paths)), n_max)
    i16, lengths16 = loader.load_batch_i16(range(len(paths)), n_max)
    for i, x in enumerate(pcm):
        n = min(len(x), n_max)
        assert lengths[i] == lengths16[i] == n
        np.testing.assert_array_equal(i16[i, :n], x[:n])
        np.testing.assert_array_equal(f32[i, :n],
                                      x[:n].astype(np.float32) / 32768.0)
        assert not i16[i, n:].any()
        fs, wav = native_loader.read_file(paths[i])
        assert fs == 24000
        np.testing.assert_array_equal(wav, read_wav(paths[i])[1])
        assert native_loader.probe_file(paths[i]) == (len(x), 24000)


def test_native_flac_decode_equals_jax_decoder(tmp_path, rng):
    """Mono FLAC read through the native decoder equals the JAX package's
    read; a multi-channel file goes to the port's Python decoder and comes
    back as (n, ch), equal to JAX's."""
    from a3t_tpu.data.fileio import read_wav as jax_read_wav
    from a3t_tpu.data.flac import write_flac

    wav = (rng.standard_normal(5000) * 3000).astype(np.int16)
    path = str(tmp_path / "u.flac")
    write_flac(path, 16000, wav)
    fs, got = read_wav(path)
    want_fs, want = jax_read_wav(path)
    assert fs == want_fs == 16000
    np.testing.assert_array_equal(got, want)
    stereo = str(tmp_path / "s.flac")
    write_flac(stereo, 16000, np.stack([wav, wav], axis=1))
    fs, got = read_wav(stereo)
    want_fs, want = jax_read_wav(stereo)
    assert fs == want_fs == 16000 and got.shape == (5000, 2)
    np.testing.assert_array_equal(got, want)


def _batchers(corpora, **cfg):
    port_dir, jax_dir = corpora
    texts = read_2column_text(os.path.join(port_dir, "text")).values()
    port = BucketBatcher(
        A3TDataset(port_dir, TokenIDConverter(build_token_list(texts))),
        LogMelConfig(**FE), BatcherConfig(**BATCHER, **cfg))
    jax = jax_batcher.BucketBatcher(
        jax_dataset.A3TDataset(jax_dir, JaxTokenIDConverter(
            jax_build_token_list(texts))),
        JaxLogMelConfig(**FE), jax_batcher.BatcherConfig(**BATCHER, **cfg))
    return port, jax


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("int16", [True, False], ids=["int16", "float32"])
def test_batches_equal_jax_bit_for_bit(corpora, native, int16):
    port, jax = _batchers(corpora, use_native_loader=native,
                          audio_int16=int16)
    assert (port._loader is not None) == native
    assert [vars(b) for b in port.buckets] == [vars(b) for b in jax.buckets]
    assert len(port.buckets) == 3 and port.n_dropped == jax.n_dropped
    assert port.bucket_members == jax.bucket_members
    n = 0
    for epoch in (1, 2):
        assert port.batch_plan(epoch) == jax.batch_plan(epoch)
        assert port.batch_plan(epoch, (1, 2)) == jax.batch_plan(epoch, (1, 2))
        for a, b in zip(port.epoch_iterator(epoch), jax.epoch_iterator(epoch),
                        strict=True):
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype, k
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            n += 1
    assert n >= 6
    assert port.batch_plan(1) != port.batch_plan(2)


def test_epoch_factory_windows_like_jax(corpora):
    port, jax = _batchers(corpora)
    from a3t_tpu.data.iterator import EpochIterFactory as JaxEpochIterFactory

    # 11 iterations: more than one epoch's plan, so the plan is cycled
    got = list(EpochIterFactory(port, 11, prefetch=2)(3))
    want = list(JaxEpochIterFactory(jax, 11, prefetch=0)(3))
    assert len(got) == len(want) == 11
    for a, b in zip(got, want):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_prefetch_iterator_keeps_order_and_reraises():
    it = PrefetchIterator(iter(range(50)), depth=3, transform=lambda x: 2 * x,
                          finish=lambda x: x + 1)
    assert list(it) == [2 * i + 1 for i in range(50)]

    def failing():
        yield 1
        raise KeyError("producer failed")

    it = PrefetchIterator(failing(), depth=2)
    assert next(it) == 1
    with pytest.raises(KeyError, match="producer failed"):
        next(it)


def test_prefetch_iterator_close_stops_the_producer():
    produced = []

    def endless():
        i = 0
        while True:
            produced.append(i)
            yield i
            i += 1

    it = PrefetchIterator(endless(), depth=2)
    assert next(it) == 0
    it.close()
    assert not it.thread.is_alive()
    n = len(produced)
    time.sleep(0.3)
    assert len(produced) == n
    assert it.q.qsize() == 0
    with pytest.raises(StopIteration):
        next(it)
    assert threading.active_count() < 50


def test_refusals(corpora, monkeypatch, tmp_path):
    port_dir = corpora[0]
    # speech-only datasets are ported (tests/test_torch_speech_only.py
    # holds them against JAX's)
    assert A3TDataset(port_dir, speech_only=True).num_phones(
        A3TDataset(port_dir, speech_only=True).uids[0]) == 0
    ds = A3TDataset(port_dir, TokenIDConverter(build_token_list(
        read_2column_text(os.path.join(port_dir, "text")).values())))
    fe = LogMelConfig(**FE)
    # speaker embeddings are ported (tests/test_torch_spemb.py holds the
    # batches against JAX's)
    with_spemb = BucketBatcher(ds, fe, BatcherConfig(**BATCHER), spemb_map={
        u: np.ones(3, np.float32) for u in ds.uids})
    assert next(with_spemb.epoch_iterator(0))["spemb"].shape[1] == 3
    # duration collection is ported (tests/test_torch_tts_variant.py holds
    # the batches against JAX's)
    with_durations = BucketBatcher(ds, fe, BatcherConfig(
        **BATCHER, duration_collect=True))
    assert next(with_durations.epoch_iterator(0))["durations"].dtype \
        == np.int32
    # device_audio needs a dataset with global_offset (record shards,
    # tests/test_torch_records.py); over wav files the audio is shipped
    wav_batch = next(BucketBatcher(ds, fe, BatcherConfig(
        **BATCHER, device_audio=True)).epoch_iterator(0))
    assert "audio" in wav_batch and "audio_offset" not in wav_batch
    # chained groups are ported (tests/test_torch_chained.py)
    batcher = BucketBatcher(ds, fe, BatcherConfig(**BATCHER))
    tag, stacked, valid, weights = next(iter(
        EpochIterFactory(batcher, chain=2, prefetch=0)(0)))
    assert tag == "chained" and stacked["audio"].shape[0] == 2
    # a failed build of the native loader raises; nothing falls back
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native_loader, "library_path",
                        lambda: str(tmp_path / "build" / "liba3t_loader_x.so"))
    monkeypatch.setattr(native_loader, "CXX_FLAGS",
                        ("--no-such-option",))
    with pytest.raises(RuntimeError, match="building native/loader failed"):
        BucketBatcher(ds, fe, BatcherConfig(**BATCHER))
    assert not os.listdir(tmp_path / "build")
