"""Record shards and the corpus on the device in the port
(a3t_tpu_torch/data/records.py, bin/pack_records.py, the batcher's
``device_audio``) against the JAX package, on the CPU.

* ``pack_records`` in both packages on the same corpus, one utterance per
  shard (``shard_mb=0``) so that the offsets cross shards: the index equals
  JAX's key for key (values and dtypes), the shards, ``meta.json`` and
  ``text`` byte for byte.
* Each package's RecordDataset reads the other's shards: the same uids,
  metadata, PCM, global offsets and flat corpus.
* Batches over records, with host audio and with ``device_audio``, equal
  JAX's bit for bit over two epochs; the port's ``gather_audio`` of a
  ``device_audio`` batch equals the host batch's int16 audio bit for bit.
* A ``device_audio`` train step (dropout on) equals the host-audio step
  bit for bit on the CPU: loss and every parameter.
* ``bin.pack_records`` then ``bin.train --device cpu`` on the records with
  ``batcher.device_audio=true``: the losses equal the same run with host
  audio exactly, and the log names the uploaded corpus.
"""

import json
import logging
import os

import numpy as np
import pytest
import torch

from a3t_tpu.data.batcher import BatcherConfig as JaxBatcherConfig
from a3t_tpu.data.batcher import BucketBatcher as JaxBucketBatcher
from a3t_tpu.data.dataset import A3TDataset as JaxA3TDataset
from a3t_tpu.data.records import RecordDataset as JaxRecordDataset
from a3t_tpu.data.records import pack_records as jax_pack_records
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.text import TokenIDConverter as JaxTokenIDConverter
from a3t_tpu_torch.bin.pack_records import main as pack_main
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
from a3t_tpu_torch.data.records import RecordDataset, pack_records
from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.models import A3TModelConfig, build_model
from a3t_tpu_torch.models.conformer import EncoderConfig
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from a3t_tpu_torch.train import (OptimConfig, create_train_state,
                                 make_optimizer, make_train_step)
from a3t_tpu_torch.train.train_step import gather_audio

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")
FE = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200, n_mels=20,
          fmin=80.0, fmax=7600.0)
BATCHER = dict(batch_bins=20 * 128 * 3, bucket_frames=(64, 128, 256),
               min_frames=16)
@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    """(wav dir, port-packed dir, JAX-packed dir, token list)."""
    d = tmp_path_factory.mktemp("records")
    data = generate_speechlike_corpus(str(d / "data"), n_utts=14,
                                      n_speakers=3, fs=24000,
                                      n_phones_range=(4, 16), seed=2)
    tokens = build_token_list(read_2column_text(
        os.path.join(data, "text")).values())
    port = pack_records(A3TDataset(data, TokenIDConverter(tokens)),
                        str(d / "port"), shard_mb=0)
    jax_ = jax_pack_records(JaxA3TDataset(data, JaxTokenIDConverter(tokens)),
                            str(d / "jax"), shard_mb=0)
    return data, port, jax_, tokens


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the toy models' many small ops run no slower,
    and the test workers running beside this one do not oversubscribe the
    cores (with a thread pool per worker, a Trainer run here took 40 times
    its time alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pack_equals_jax(packed):
    _, port, jax_, _ = packed
    names = sorted(os.listdir(port))
    assert names == sorted(os.listdir(jax_))
    assert sum(n.startswith("shard_") for n in names) == 14
    for n in names:
        if n == "index.npz":
            continue
        with open(os.path.join(port, n), "rb") as a, \
                open(os.path.join(jax_, n), "rb") as b:
            assert a.read() == b.read(), n
    with np.load(os.path.join(port, "index.npz")) as a, \
            np.load(os.path.join(jax_, "index.npz")) as b:
        assert sorted(a.files) == sorted(b.files)
        for k in b.files:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_each_package_reads_the_others_shards(packed, writer):
    d = packed[1] if writer == "port" else packed[2]
    port, jax_ = RecordDataset(d), JaxRecordDataset(d)
    assert port.uids == jax_.uids and port.fs == jax_.fs == 24000
    for uid in port.uids:
        a, b = port[uid], jax_[uid]
        assert sorted(a) == sorted(b)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        np.testing.assert_array_equal(port.get_pcm16(uid),
                                      jax_.get_pcm16(uid))
        assert port.global_offset(uid) == jax_.global_offset(uid)
        assert port.num_samples(uid) == jax_.num_samples(uid)
        assert port.num_phones(uid) == jax_.num_phones(uid)
    np.testing.assert_array_equal(port.flat_pcm(77), jax_.flat_pcm(77))
    assert RecordDataset(d, speech_only=True).get_meta(port.uids[0]) == \
        JaxRecordDataset(d, speech_only=True).get_meta(port.uids[0])


def test_flat_pcm_refuses_int32_overflow(packed):
    with pytest.raises(ValueError, match="int32"):
        RecordDataset(packed[1]).flat_pcm(pad_samples=2 ** 31)


@pytest.mark.parametrize("device_audio", [False, True])
def test_record_batches_equal_jax(packed, device_audio):
    _, port_dir, jax_dir, _ = packed
    port = BucketBatcher(RecordDataset(port_dir), LogMelConfig(**FE),
                         BatcherConfig(**BATCHER, device_audio=device_audio))
    jax_ = JaxBucketBatcher(JaxRecordDataset(jax_dir), JaxLogMelConfig(**FE),
                            JaxBatcherConfig(**BATCHER,
                                             device_audio=device_audio))
    host = BucketBatcher(RecordDataset(port_dir), LogMelConfig(**FE),
                         BatcherConfig(**BATCHER))
    corpus = torch.from_numpy(port.dataset.flat_pcm(
        max(b.n_samples for b in port.buckets)))
    n = 0
    for epoch in (1, 2):
        for got, want, h in zip(port.epoch_iterator(epoch),
                                jax_.epoch_iterator(epoch),
                                host.epoch_iterator(epoch), strict=True):
            assert sorted(got) == sorted(want)
            for k in want:
                assert got[k].dtype == want[k].dtype, k
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
            if device_audio:
                assert "audio" not in got
                audio = gather_audio(corpus, got, FE["hop_length"])
                np.testing.assert_array_equal(audio.numpy(), h["audio"])
            n += 1
    assert n >= 6


def test_device_audio_step_equals_host_step(packed):
    _, port_dir, _, tokens = packed
    rec = RecordDataset(port_dir)
    kw = dict(**BATCHER, mlm_prob_factor=1.0)
    b_host = BucketBatcher(rec, LogMelConfig(**FE), BatcherConfig(**kw))
    b_dev = BucketBatcher(rec, LogMelConfig(**FE),
                          BatcherConfig(**kw, device_audio=True))
    corpus = torch.from_numpy(rec.flat_pcm(
        max(b.n_samples for b in b_dev.buckets)))
    bi, uids = b_dev.batch_plan(epoch=1)[0]
    x_h = b_host.make_batch(bi, uids, np.random.default_rng(0))
    x_d = b_dev.make_batch(bi, uids, np.random.default_rng(0))
    enc = EncoderConfig(num_blocks=1, attention_dim=32, attention_heads=2,
                        linear_units=48, cnn_module_kernel=7)
    cfg = A3TModelConfig(vocab_size=len(tokens), odim=20, encoder=enc,
                         decoder=None, postnet_layers=1, postnet_chans=24)
    fe = LogMelFrontend(LogMelConfig(**FE), device="cpu")
    out = []
    for batch, kw_step in ((x_h, {}), (x_d, {"corpus": corpus})):
        model = build_model(cfg, device="cpu", seed=0)
        state = create_train_state(model, make_optimizer(
            OptimConfig(warmup_steps=10)), device="cpu")
        step = make_train_step(model, fe, device="cpu", **kw_step)
        state, stats = step(state, batch, 3)
        out.append((stats, model.state_dict()))
    (s_h, p_h), (s_d, p_d) = out
    assert torch.equal(s_h["loss"], s_d["loss"])
    for k in p_h:
        assert torch.equal(p_h[k], p_d[k]), k


def _argv(train, valid, exp, tokens, *sets):
    out = [f"train_data_dir={train}", f"valid_data_dir={valid}",
           f"exp_dir={exp}", f"token_list={tokens}",
           "model.postnet_layers=2", "model.postnet_chans=16",
           f"batcher.batch_bins={20 * 128 * 3}",
           "batcher.bucket_frames=[128,256]", "frontend.n_mels=20",
           "trainer.max_epoch=1", "trainer.num_iters_per_epoch=3",
           "trainer.log_interval=1", *sets]
    out += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
            for k, v in dict(attention_dim=32, attention_heads=2,
                             linear_units=32, num_blocks=1).items()]
    argv = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in out:
        argv += ["--set", s]
    return argv


def test_pack_cli_then_train_on_records(packed, tmp_path, caplog):
    data = packed[0]
    out = str(tmp_path / "rec")
    pack_main(["--data-dir", data, "--out", out, "--shard-mb", "1"])
    with open(os.path.join(out, "meta.json")) as f:
        assert json.load(f) == {"fs": 24000, "n_shards": 1, "n_utts": 14}
    tokens = os.path.join(out, "tokens.txt")
    runs = {}
    for device_audio in (False, True):
        caplog.clear()
        with caplog.at_level(logging.INFO, logger="a3t_tpu_torch"):
            trainer, state = train_main(_argv(
                out, data, str(tmp_path / f"exp{device_audio}"), tokens,
                f"batcher.device_audio={str(device_audio).lower()}"))
        uploaded = [r.getMessage() for r in caplog.records
                    if "device-resident corpus" in r.getMessage()]
        assert bool(uploaded) == device_audio
        runs[device_audio] = ([r["loss"] for r in trainer.step_log], {
            phase: {k: v for k, v in stats.items() if not k.endswith("time")}
            for phase, stats in trainer.reporter.history[1].items()})
        assert isinstance(trainer.train_iter_factory.batcher.dataset,
                          RecordDataset)
    assert len(runs[True][0]) == 3 and all(np.isfinite(runs[True][0]))
    assert runs[True] == runs[False]
