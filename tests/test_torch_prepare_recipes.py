"""The port's corpus-preparation recipes (a3t_tpu_torch/recipes/ljspeech.py
and vctk.py) against the JAX package's recipes/ljspeech/prepare.py and
recipes/vctk/prepare.py, each run on tests/test_prepare_recipes.py's
fabricated corpora in the sources' layouts: LJSpeech's metadata.csv +
wavs/ at 22.05 kHz, formatted to 16 kHz; VCTK's txt/ + wav48/ at 48 kHz (3
speakers, one held out), formatted to 24 kHz.

Every file the recipes write equals JAX's byte for byte (wav.scp once the
output directory in its paths is the same): the split lists, the phone
transcriptions and lexicon.txt (the same native g2p), the formatted audio
(the same scipy resampler), and the alignments and the aligner's model
file (both packages build native/aligner/aligner.cc with the Makefile's
flags on this machine, so the Viterbi decisions agree).  The JAX side's
native libraries are built by their own Makefiles in private copies, so
that no other test's build races them.  The printed summaries are equal
too.
"""

import csv
import os
import runpy
import shutil
import sys

import numpy as np
import pytest

from a3t_tpu.align import native as jax_align
from a3t_tpu.text import native_g2p as jax_g2p
from a3t_tpu_torch.data.fileio import write_wav
from a3t_tpu_torch.recipes import ljspeech, vctk
from test_prepare_recipes import synth_word_wav

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_natives(tmp_path, monkeypatch):
    """JAX's g2p and aligner libraries made in private copies."""
    for name, mod, lib, src in (
            ("g2p", jax_g2p, "liba3t_g2p.so", "g2p.cc"),
            ("aligner", jax_align, "liba3t_aligner.so", "aligner.cc")):
        dst = tmp_path / f"native_{name}"
        dst.mkdir()
        for f in (src, "Makefile"):
            shutil.copy(os.path.join(ROOT, "native", name, f), dst / f)
        monkeypatch.setattr(mod, "_NATIVE_DIR", str(dst))
        monkeypatch.setattr(mod, "_LIB_PATH", str(dst / lib))
        monkeypatch.setattr(mod, "_lib", None)


def _run_jax(script: str, argv: list[str]) -> None:
    path = os.path.join(ROOT, "recipes", script, "prepare.py")
    old = sys.argv
    sys.argv = [path] + argv
    try:
        runpy.run_path(path, run_name="__main__")
    finally:
        sys.argv = old


def _files(root: str) -> list[str]:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _assert_same_outputs(port: str, jax: str) -> None:
    names = _files(jax)
    assert _files(port) == names
    assert any(n.endswith("mfa_start") for n in names)
    assert any(n.endswith(".wav") for n in names)
    for name in names:
        with open(os.path.join(port, name), "rb") as f:
            got = f.read()
        with open(os.path.join(jax, name), "rb") as f:
            want = f.read()
        if os.path.basename(name) == "wav.scp":
            want = want.replace(jax.encode(), port.encode())
        assert got == want, name


def _compare(script, module, argv, corpus, tmp_path, capsys):
    port, jax = str(tmp_path / "port"), str(tmp_path / "jax")
    module.main(["--corpus", corpus, "--out", port, *argv, "--device", "cpu"])
    port_log = capsys.readouterr().out
    _run_jax(script, ["--corpus", corpus, "--out", jax, *argv])
    jax_log = capsys.readouterr().out
    assert port_log == jax_log
    _assert_same_outputs(port, jax)
    return port


def test_ljspeech_matches_jax(tmp_path, jax_natives, capsys):
    rng = np.random.default_rng(0)
    corpus = tmp_path / "LJSpeech-1.1"
    os.makedirs(corpus / "wavs")
    rows = []
    for i, text in enumerate(["CALL STELLA NOW", "Ask her, please!",
                              "bring these things", "with her from the store",
                              "six spoons", "of fresh snow peas"]):
        uid = f"LJ001-{i:04d}"
        write_wav(str(corpus / "wavs" / f"{uid}.wav"), 22050,
                  np.concatenate([synth_word_wav(rng, 22050)
                                  for _ in range(2)]))
        rows.append([uid, "Some text", text])
    with open(corpus / "metadata.csv", "w", newline="") as f:
        csv.writer(f, delimiter="|").writerows(rows)
    out = _compare("ljspeech", ljspeech,
                   ["--dev-utts", "1", "--eval-utts", "1", "--fs", "16000"],
                   str(corpus), tmp_path, capsys)
    with open(os.path.join(out, "tr_no_dev", "wav.scp")) as f:
        assert len(f.readlines()) == 4


def test_vctk_matches_jax(tmp_path, jax_natives, capsys):
    rng = np.random.default_rng(1)
    corpus = tmp_path / "VCTK-Corpus"
    words = ["PLEASE", "CALL", "STELLA", "ASK", "HER"]
    for spk in ("p225", "p226", "p227"):
        os.makedirs(corpus / "wav48" / spk)
        os.makedirs(corpus / "txt" / spk)
        for i in range(3):
            uid = f"{spk}_{i:03d}"
            write_wav(str(corpus / "wav48" / spk / f"{uid}.wav"), 48000,
                      np.concatenate([synth_word_wav(rng, 48000)
                                      for _ in range(2)]))
            with open(corpus / "txt" / spk / f"{uid}.txt", "w") as f:
                f.write(" ".join(words[i:i + 2]) + "\n")
    out = _compare("vctk", vctk,
                   ["--unseen-speakers", "p227", "--dev-per-spk", "1",
                    "--target-fs", "24000"], str(corpus), tmp_path, capsys)
    with open(os.path.join(out, "eval_unseen", "utt2spk")) as f:
        assert {line.split()[1] for line in f} == {"p227"}
