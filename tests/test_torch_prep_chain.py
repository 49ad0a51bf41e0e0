"""The port's data-preparation chain against the JAX package's, on one 48 kHz
mini corpus of 6 utterances (one source rewritten as a stereo FLAC):
format_data (a3t_tpu_torch/data/format_wav.py, bin/format_data.py) ->
align (a3t_tpu_torch/align/native.py, bin/align.py) -> tokenize_text ->
collect_stats, each against its a3t_tpu counterpart.

Tolerances.  Everything is compared byte for byte or bit for bit, save the
statistics' sums: the formatted audio (the same scipy resampler and a copy
of the FLAC encoder), the alignments and the aligner's model file (both
packages build native/aligner/aligner.cc with the Makefile's flags on this
machine, so the Viterbi decisions agree), the vocabularies (the same
stdlib code).  The statistics pass through each package's rfft front-end
(torch.fft against XLA's FFT), whose log-mels differ by ~1e-6; their float64
sums over ~1,700 frames agree within rtol 1e-5, the tolerance
tests/test_torch_normalize.py states for the same sums; counts and the
shape files are equal.
"""

import os
import shutil

import numpy as np
import pytest

from a3t_tpu.align import native as jax_align
from a3t_tpu.bin.collect_stats import main as jax_collect_stats
from a3t_tpu.bin.tokenize_text import main as jax_tokenize
from a3t_tpu.data import format_wav as jax_format
from a3t_tpu.data.miniature import generate_mini_corpus as jax_mini_corpus
from a3t_tpu_torch.align import native as port_align
from a3t_tpu_torch.bin.align import main as port_align_main
from a3t_tpu_torch.bin.collect_stats import main as port_collect_stats
from a3t_tpu_torch.bin.format_data import main as port_format_main
from a3t_tpu_torch.bin.tokenize_text import main as port_tokenize
from a3t_tpu_torch.data import format_wav
from a3t_tpu_torch.data.fileio import (load_num_sequence_text,
                                       read_2column_text, read_wav,
                                       write_2column_text)
from a3t_tpu_torch.data.flac import read_flac, write_flac
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.text import TokenIDConverter

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AN4 = os.path.join(ROOT, "artifacts", "aligner", "aligner_an4.bin")
PINS = ["--add-symbol", "<blank>:0", "--add-symbol", "<unk>:1",
        "--add-symbol", "<sos/eos>:-1"]
N_UTTS = 6
STATS_RTOL = 1e-5


def _same_bytes(a: str, b: str) -> bool:
    with open(a, "rb") as f, open(b, "rb") as g:
        return f.read() == g.read()


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    """The 48 kHz sources without their oracle alignments; utt001 is
    rewritten as a stereo FLAC (its second channel a scaled copy), so that
    formatting reads it through the Python decoder and downmixes it."""
    d = str(tmp_path_factory.mktemp("raw"))
    generate_mini_corpus(d, n_utts=N_UTTS, fs=48000)
    for f in ("mfa_start", "mfa_end"):
        os.remove(os.path.join(d, f))
    scp = read_2column_text(os.path.join(d, "wav.scp"))
    fs, wav = read_wav(scp["utt001"], always_float=False)
    stereo = os.path.join(d, "utt001_stereo.flac")
    write_flac(stereo, fs, np.stack([wav, wav // 2], axis=1))
    scp["utt001"] = stereo
    write_2column_text(os.path.join(d, "wav.scp"), scp)
    return d


@pytest.fixture(scope="module")
def jax_aligner_lib(tmp_path_factory):
    """JAX's aligner built by its own ``make`` in a private copy of
    native/aligner, so that no other process's build races it."""
    dst = tmp_path_factory.mktemp("jax_aligner")
    for name in ("aligner.cc", "Makefile"):
        shutil.copy(os.path.join(ROOT, "native", "aligner", name), dst)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_align, "_NATIVE_DIR", str(dst))
        mp.setattr(jax_align, "_LIB_PATH", str(dst / "liba3t_aligner.so"))
        mp.setattr(jax_align, "_lib", None)
        yield jax_align


@pytest.fixture(scope="module")
def formatted(raw, tmp_path_factory):
    """{audio format: (port's dir, JAX's dir, port's report, JAX's)}."""
    out = {}
    for fmt in ("wav", "flac"):
        base = tmp_path_factory.mktemp(f"fmt_{fmt}")
        port, jax = str(base / "port"), str(base / "jax")
        report = port_format_main([
            "--data-dir", raw, "--out", port, "--fs", "24000",
            "--expected-source-fs", "48000", "--audio-format", fmt,
            "--device", "cpu"])
        want = jax_format.format_data_dir(raw, jax, 24000,
                                          expected_source_fs=48000,
                                          audio_format=fmt)
        out[fmt] = (port, jax, report, want)
    return out


@pytest.mark.parametrize("fmt", ["wav", "flac"])
def test_format_data_matches_jax(formatted, fmt):
    """Every formatted file equals JAX's byte for byte, with the same report
    and the same copied text files; the port reads each back at 24 kHz, and
    the FLAC through the native decoder equals the Python decoder."""
    port, jax, report, want = formatted[fmt]
    assert report == want == {"n_utts": N_UTTS, "target_fs": 24000,
                              "source_fs_counts": {48000: N_UTTS}}
    ours = read_2column_text(os.path.join(port, "wav.scp"))
    theirs = read_2column_text(os.path.join(jax, "wav.scp"))
    assert sorted(ours) == sorted(theirs)
    for uid in ours:
        assert ours[uid].endswith(f"{uid}.{fmt}")
        assert _same_bytes(ours[uid], theirs[uid]), uid
        fs, wav = read_wav(ours[uid])
        assert fs == 24000 and wav.ndim == 1
        if fmt == "flac":
            _, ints, bps = read_flac(ours[uid])
            np.testing.assert_array_equal(
                wav, ints.astype(np.float32) / float(1 << (bps - 1)))
    for name in ("text", "utt2spk"):
        assert _same_bytes(os.path.join(port, name), os.path.join(jax, name))
    format_wav.validate_data_dir_fs(port, 24000)
    jax_format.validate_data_dir_fs(port, 24000)
    with pytest.raises(ValueError, match="format_data"):
        format_wav.validate_data_dir_fs(port, 16000)


def test_format_helpers_match_jax():
    """to_mono and resample equal JAX's bit for bit."""
    rng = np.random.default_rng(5)
    st = rng.uniform(-0.5, 0.5, (4801, 2)).astype(np.float32)
    np.testing.assert_array_equal(format_wav.to_mono(st),
                                  jax_format.to_mono(st))
    for fs_in, fs_out in ((48000, 24000), (22050, 24000), (16000, 16000)):
        np.testing.assert_array_equal(
            format_wav.resample(st[:, 0], fs_in, fs_out),
            jax_format.resample(st[:, 0], fs_in, fs_out))


def test_format_refuses_other_source_fs(raw, tmp_path):
    """A source at another fs than the expected one raises in both."""
    with pytest.raises(ValueError, match="expected 16000"):
        format_wav.format_data_dir(raw, str(tmp_path / "a"), 24000,
                                   expected_source_fs=16000)
    with pytest.raises(ValueError, match="expected 16000"):
        jax_format.format_data_dir(raw, str(tmp_path / "b"), 24000,
                                   expected_source_fs=16000)


@pytest.fixture(scope="module")
def aligned(formatted, jax_aligner_lib, tmp_path_factory):
    """bin.align (port) and align_corpus (JAX) on copies of the FLAC data
    dir at 24 kHz, 4 iterations, the models saved."""
    port_fmt = formatted["flac"][0]
    base = tmp_path_factory.mktemp("aligned")
    port, jax = str(base / "port"), str(base / "jax")
    shutil.copytree(port_fmt, port)
    shutil.copytree(port_fmt, jax)
    port_model, jax_model = str(base / "port.bin"), str(base / "jax.bin")
    port_align_main(["--data-dir", port, "--sample-rate", "24000",
                     "--iters", "4", "--save-model", port_model,
                     "--device", "cpu"])
    jax_aligner_lib.align_corpus(jax, sample_rate=24000, n_iterations=4,
                                 model_path=jax_model)
    return port, jax, port_model, jax_model


def test_align_corpus_matches_jax(aligned):
    """mfa_text, mfa_start, mfa_end and the model file (and its phone list)
    equal JAX's byte for byte; every utterance has one monotone span per
    phone."""
    port, jax, port_model, jax_model = aligned
    for name in ("mfa_text", "mfa_start", "mfa_end"):
        assert _same_bytes(os.path.join(port, name),
                           os.path.join(jax, name)), name
    assert _same_bytes(port_model, jax_model)
    assert _same_bytes(port_model + ".phones", jax_model + ".phones")
    text = read_2column_text(os.path.join(port, "mfa_text"))
    starts = load_num_sequence_text(os.path.join(port, "mfa_start"))
    ends = load_num_sequence_text(os.path.join(port, "mfa_end"))
    assert len(text) == N_UTTS
    for uid, phones in text.items():
        s, e = starts[uid], ends[uid]
        assert len(phones.split()) == len(s) == len(e)
        assert (np.diff(s) >= 0).all() and (e >= s).all()


def test_loaded_model_aligns_as_jax(aligned, jax_aligner_lib, tmp_path):
    """The saved model, loaded in both packages, aligns every utterance to
    the same boundaries (with and without optional phones), and saves back
    to the same bytes."""
    port, _, port_model, _ = aligned
    ours = port_align.NativeAligner.load(port_model, 24000)
    theirs = jax_aligner_lib.NativeAligner.load(port_model, 24000)
    assert ours.phone_list == theirs.phone_list and ours.hop == 240
    scp = read_2column_text(os.path.join(port, "wav.scp"))
    text = read_2column_text(os.path.join(port, "text"))
    for uid, path in scp.items():
        wav = read_wav(path)[1]
        phones = text[uid].split()
        np.testing.assert_array_equal(ours.extract(wav), theirs.extract(wav))
        for optional in (None, [i % 2 == 1 for i in range(len(phones))]):
            got = ours.align(wav, phones, optional)
            want = theirs.align(wav, phones, optional)
            for g, w in zip(got, want):
                assert g.dtype == w.dtype == np.float32
                np.testing.assert_array_equal(g, w)
    ours.save(str(tmp_path / "again.bin"))
    assert _same_bytes(str(tmp_path / "again.bin"), port_model)


def test_an4_aligner_boundaries_match_jax(jax_aligner_lib, tmp_path):
    """The trained an4 model of artifacts/aligner, loaded in both packages,
    gives equal boundaries on a 16 kHz mini corpus (phones lower-cased, and
    "uw", which the an4 set lacks, read as "ow")."""
    data = jax_mini_corpus(str(tmp_path / "c"), n_utts=4, fs=16000)
    ours = port_align.NativeAligner.load(AN4, 16000)
    theirs = jax_aligner_lib.NativeAligner.load(AN4, 16000)
    scp = read_2column_text(os.path.join(data, "wav.scp"))
    text = read_2column_text(os.path.join(data, "text"))
    for uid, path in scp.items():
        wav = read_wav(path)[1]
        phones = ["sil"] + text[uid].lower().replace("uw", "ow").split() \
            + ["sil"]
        got, want = ours.align(wav, phones), theirs.align(wav, phones)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        assert (got[1] >= got[0]).all()


@pytest.mark.parametrize("extra", [
    ["--write-vocabulary", *PINS],
    ["--write-vocabulary", "--write-counts", "--cutoff", "1"],
    ["--write-vocabulary", "--vocabulary-size", "6", *PINS],
    [],
])
def test_tokenize_text_matches_jax(aligned, tmp_path, extra):
    """The port's tokenize_text writes JAX's file byte for byte; the
    recipe's pinned vocabulary loads as a token list with blank and unk
    first and sos/eos last."""
    src = os.path.join(aligned[0], "mfa_text")
    ours, theirs = str(tmp_path / "port.txt"), str(tmp_path / "jax.txt")
    port_tokenize(["-i", src, "-o", ours, "--field", "2-", *extra,
                   "--device", "cpu"])
    jax_tokenize(["-i", src, "-o", theirs, "--field", "2-", *extra])
    assert _same_bytes(ours, theirs)
    if extra[:2] == ["--write-vocabulary", *PINS[:1]]:
        conv = TokenIDConverter(ours)
        assert conv.token_list[:2] == ["<blank>", "<unk>"]
        assert conv.token_list[-1] == "<sos/eos>"
        phones = {p for t in read_2column_text(src).values()
                  for p in t.split()}
        assert set(conv.token_list[2:-1]) == phones


def test_collect_stats_matches_jax(aligned, tmp_path):
    """bin.collect_stats (the rfft front-end on the CPU) against JAX's CLI on
    the aligned 24 kHz corpus: equal count and shape files, sum and sqsum
    within STATS_RTOL."""
    data = aligned[0]
    conf = tmp_path / "conf.yaml"
    conf.write_text(
        f"train_data_dir: {data}\n"
        "frontend:\n  fs: 24000\n  n_fft: 1024\n  hop_length: 240\n"
        "  win_length: 960\n  n_mels: 40\n  fmin: 80.0\n  fmax: 7600.0\n")
    ours, theirs = str(tmp_path / "port"), str(tmp_path / "jax")
    info = port_collect_stats(["--config", str(conf), "--data-dir", data,
                               "--out", ours, "--device", "cpu"])
    jax_collect_stats(["--config", str(conf), "--data-dir", data,
                       "--out", theirs])
    for name in ("speech_shape", "text_shape"):
        assert _same_bytes(os.path.join(ours, name),
                           os.path.join(theirs, name)), name
    got = np.load(os.path.join(ours, "feats_stats.npz"))
    want = np.load(os.path.join(theirs, "feats_stats.npz"))
    assert int(got["count"]) == int(want["count"]) == info["count"]
    frames = sum(int(v.split(",")[0]) for v in read_2column_text(
        os.path.join(ours, "speech_shape")).values())
    assert frames == info["count"]
    for key in ("sum", "sqsum"):
        np.testing.assert_allclose(got[key], want[key], rtol=STATS_RTOL)
