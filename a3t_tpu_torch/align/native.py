"""ctypes binding of the native C++ forced aligner (``native/aligner``): the
port of ``a3t_tpu/align/native.py``, with the same C signatures.

The batch interface mirrors espnet2/bin/align_english.py:248-318: given a
data dir with wav.scp + text (phones or words + lexicon), train or load the
monophone models, align every utterance, and write
``mfa_text / mfa_start / mfa_end`` second-level phone timing files — the
exact inputs the A3T data pipeline consumes.

The reference corrects HTK's frame timing by 125 ms/10 (0.0125 s) per
boundary (align_english.py:127-128, 216-217); the extractor indexes frames
at their window start, so the analogous correction is half a window, applied
in :meth:`NativeAligner.align`.

The library is compiled at first use with the host C++ compiler from
``native/aligner/aligner.cc`` into ``a3t_tpu_torch/_build/``, under a name
keyed by a hash of the source and the flags; nothing is written into
``native/aligner/``.  The flags are the Makefile's
(``-O3 -march=native -std=c++17 -fPIC -Wall -shared``), so the JAX
package's ``make`` build and this one compile the same code the same way
and their Viterbi decisions agree bit for bit on one machine.  A failed
build raises.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional, Sequence

import numpy as np

from a3t_tpu_torch import host_build

NATIVE_DIR = os.path.join(host_build.ROOT, "native", "aligner")
SOURCES = ("aligner.cc",)
BUILD_DIR = host_build.BUILD_DIR
CXX_FLAGS = ("-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-shared")

_lib = None


def library_path() -> str:
    return host_build.library_path("liba3t_aligner", NATIVE_DIR, SOURCES,
                                   CXX_FLAGS, BUILD_DIR)


def build() -> str:
    """Compile the aligner unless it is built; returns the library's path."""
    return host_build.build(library_path(), NATIVE_DIR, SOURCES, CXX_FLAGS)


def _load_library() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build())
    f32p = ctypes.POINTER(ctypes.c_float)
    i64p = ctypes.POINTER(ctypes.c_int64)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.mfcc_new.restype = ctypes.c_void_p
    lib.mfcc_new.argtypes = [ctypes.c_int]
    lib.mfcc_free.argtypes = [ctypes.c_void_p]
    lib.mfcc_feat_dim.restype = ctypes.c_int
    lib.mfcc_feat_dim.argtypes = [ctypes.c_void_p]
    lib.mfcc_hop.restype = ctypes.c_int
    lib.mfcc_hop.argtypes = [ctypes.c_void_p]
    lib.mfcc_extract.restype = ctypes.c_int
    lib.mfcc_extract.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64, f32p]

    lib.aligner_new.restype = ctypes.c_void_p
    lib.aligner_new.argtypes = [ctypes.c_int] * 3
    lib.aligner_free.argtypes = [ctypes.c_void_p]
    lib.aligner_flat_start.argtypes = [ctypes.c_void_p, f32p, ctypes.c_int64]
    lib.aligner_train_iteration.restype = ctypes.c_float
    lib.aligner_train_iteration.argtypes = [
        ctypes.c_void_p, f32p, i64p, i32p, i64p, ctypes.c_int]
    lib.aligner_align.restype = ctypes.c_float
    lib.aligner_align.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, i32p, ctypes.c_int, i32p, i32p]
    lib.aligner_align_opt.restype = ctypes.c_float
    lib.aligner_align_opt.argtypes = [
        ctypes.c_void_p, f32p, ctypes.c_int, i32p, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint8), i32p, i32p]
    lib.aligner_save.restype = ctypes.c_int
    lib.aligner_save.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.aligner_split_mixtures.argtypes = [ctypes.c_void_p]
    lib.aligner_n_mixtures.restype = ctypes.c_int
    lib.aligner_n_mixtures.argtypes = [ctypes.c_void_p]
    lib.aligner_load.restype = ctypes.c_void_p
    lib.aligner_load.argtypes = [ctypes.c_char_p]
    lib.aligner_feat_dim.restype = ctypes.c_int
    lib.aligner_feat_dim.argtypes = [ctypes.c_void_p]
    lib.aligner_n_phones.restype = ctypes.c_int
    lib.aligner_n_phones.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def _f32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeAligner:
    """Monophone GMM-HMM forced aligner over the C++ core."""

    N_STATES = 3

    def __init__(self, phone_list: Sequence[str], sample_rate: int = 16000):
        self.lib = _load_library()
        self.phone_list = list(phone_list)
        self.phone2id = {p: i for i, p in enumerate(self.phone_list)}
        self.fs = sample_rate
        self.mfcc = self.lib.mfcc_new(sample_rate)
        self.feat_dim = self.lib.mfcc_feat_dim(self.mfcc)
        self.hop = self.lib.mfcc_hop(self.mfcc)
        self.handle = self.lib.aligner_new(
            len(self.phone_list), self.N_STATES, self.feat_dim)

    def __del__(self):
        try:
            if getattr(self, "handle", None):
                self.lib.aligner_free(self.handle)
            if getattr(self, "mfcc", None):
                self.lib.mfcc_free(self.mfcc)
        except Exception:
            pass

    # -- features --------------------------------------------------------
    def extract(self, wav: np.ndarray) -> np.ndarray:
        wav = np.ascontiguousarray(wav, np.float32)
        max_frames = max(0, 1 + (len(wav) - int(self.fs * 0.025)) // self.hop)
        out = np.empty((max_frames, self.feat_dim), np.float32)
        n = self.lib.mfcc_extract(self.mfcc, _f32p(wav), len(wav), _f32p(out))
        return out[:n]

    # -- training --------------------------------------------------------
    @property
    def n_mixtures(self) -> int:
        return self.lib.aligner_n_mixtures(self.handle)

    def train(
        self,
        utterances: Sequence[tuple[np.ndarray, Sequence[str]]],
        n_iterations: int = 10,
        n_mixtures: int = 1,
        verbose: bool = False,
    ) -> list[float]:
        """Flat-start + embedded Viterbi-EM over (wav, phones) pairs.

        ``n_mixtures`` > 1 enables HERest-style mixture doubling: after
        each (n_iterations) block the Gaussians split (1 -> 2 -> 4 ...)
        until the target count, with another EM block after each split.
        """
        feats, phone_ids = [], []
        for wav, phones in utterances:
            f = self.extract(wav)
            ids = [self.phone2id[p] for p in phones]
            if len(f) >= len(ids) and ids:
                feats.append(f)
                phone_ids.append(np.asarray(ids, np.int32))
        if not feats:
            raise ValueError("no trainable utterances")

        all_feats = np.ascontiguousarray(np.concatenate(feats, 0), np.float32)
        f_off = np.zeros(len(feats) + 1, np.int64)
        f_off[1:] = np.cumsum([len(f) for f in feats])
        all_phones = np.ascontiguousarray(np.concatenate(phone_ids), np.int32)
        p_off = np.zeros(len(phone_ids) + 1, np.int64)
        p_off[1:] = np.cumsum([len(p) for p in phone_ids])

        self.lib.aligner_flat_start(
            self.handle, _f32p(all_feats), len(all_feats))
        lls = []
        i64p = ctypes.POINTER(ctypes.c_int64)
        i32p = ctypes.POINTER(ctypes.c_int32)

        def em_block():
            for it in range(n_iterations):
                ll = self.lib.aligner_train_iteration(
                    self.handle, _f32p(all_feats), f_off.ctypes.data_as(i64p),
                    all_phones.ctypes.data_as(i32p),
                    p_off.ctypes.data_as(i64p), len(feats))
                lls.append(float(ll))
                if verbose:
                    print(f"aligner EM iter {len(lls)}: {ll:.3f} ll/frame "
                          f"({self.n_mixtures} mix)")

        em_block()
        while self.n_mixtures < n_mixtures:
            self.lib.aligner_split_mixtures(self.handle)
            em_block()
        return lls

    # -- alignment -------------------------------------------------------
    def align(self, wav: np.ndarray, phones: Sequence[str],
              optional: Sequence[bool] | None = None):
        """(wav, phones) -> (start_sec, end_sec) arrays per phone.

        ``optional[i]`` marks skippable phones ('sp' short pauses between
        words — the HVite optional-silence topology): the Viterbi path may
        bypass them; skipped phones get zero-length spans."""
        f = np.ascontiguousarray(self.extract(wav), np.float32)
        ids = np.asarray([self.phone2id[p] for p in phones], np.int32)
        starts = np.zeros(len(ids), np.int32)
        ends = np.zeros(len(ids), np.int32)
        i32p = ctypes.POINTER(ctypes.c_int32)
        if optional is not None:
            flags = np.asarray(optional, np.uint8)
            ll = self.lib.aligner_align_opt(
                self.handle, _f32p(f), len(f), ids.ctypes.data_as(i32p),
                len(ids), flags.ctypes.data_as(
                    ctypes.POINTER(ctypes.c_uint8)),
                starts.ctypes.data_as(i32p), ends.ctypes.data_as(i32p))
        else:
            ll = self.lib.aligner_align(
                self.handle, _f32p(f), len(f), ids.ctypes.data_as(i32p),
                len(ids), starts.ctypes.data_as(i32p),
                ends.ctypes.data_as(i32p))
        if ll <= -1e29:
            raise RuntimeError("alignment failed (utterance too short?)")
        # window-center correction (see module docstring)
        half_win = 0.0125
        start_sec = starts * self.hop / self.fs + half_win
        end_sec = ends * self.hop / self.fs + half_win
        start_sec[0] = max(0.0, starts[0] * self.hop / self.fs)
        end_sec[-1] = min(len(wav) / self.fs, end_sec[-1])
        return start_sec.astype(np.float32), end_sec.astype(np.float32)

    def save(self, path: str):
        if self.lib.aligner_save(self.handle, path.encode()) != 0:
            raise IOError(f"failed to save aligner to {path}")
        with open(path + ".phones", "w") as f:
            f.write("\n".join(self.phone_list))

    @classmethod
    def load(cls, path: str, sample_rate: int = 16000) -> "NativeAligner":
        with open(path + ".phones") as f:
            phones = [ln.strip() for ln in f if ln.strip()]
        obj = cls(phones, sample_rate)
        lib = obj.lib
        lib.aligner_free(obj.handle)
        obj.handle = lib.aligner_load(path.encode())
        if not obj.handle:
            raise IOError(f"failed to load aligner from {path}")
        return obj


def align_corpus(
    data_dir: str,
    out_dir: Optional[str] = None,
    lexicon: Optional[dict[str, list[str]]] = None,
    sample_rate: int = 16000,
    n_iterations: int = 10,
    model_path: Optional[str] = None,
) -> str:
    """Batch alignment (align_english.py:248-318 analogue).

    Reads ``wav.scp`` + ``text`` (phone strings, or words when a lexicon is
    given), trains monophone models on the corpus itself (flat start), and
    writes mfa_text/mfa_start/mfa_end to ``out_dir`` (defaults to data_dir).
    """
    from a3t_tpu_torch.data.fileio import (SoundScpReader, read_2column_text,
                                           write_2column_text,
                                           write_num_sequence_text)
    from a3t_tpu_torch.inference.sedit import clean_words

    out_dir = out_dir or data_dir
    wav = SoundScpReader(os.path.join(data_dir, "wav.scp"))
    text = read_2column_text(os.path.join(data_dir, "text"))

    def to_phones(line: str) -> tuple[list[str], list[bool]]:
        if lexicon is None:
            toks = line.split()
            return toks, [t == "sp" for t in toks]
        phones: list[str] = []
        optional: list[bool] = []
        words = clean_words(line)
        for wi, w in enumerate(words):
            wp = lexicon[w.upper()]
            phones.extend(wp)
            optional.extend([False] * len(wp))
            if wi < len(words) - 1:
                # optional inter-word short pause (HVite sp topology)
                phones.append("sp")
                optional.append(True)
        return phones, optional

    utts = []
    uids = []
    optionals = []
    for uid in wav.keys():
        if uid not in text:
            continue
        fs, x = wav[uid]
        phones, optional = to_phones(text[uid])
        if not phones:
            continue
        utts.append((x, phones))
        optionals.append(optional)
        uids.append(uid)

    phone_set = sorted({p for _, phones in utts for p in phones})
    aligner = NativeAligner(phone_set, sample_rate)
    aligner.train(utts, n_iterations=n_iterations)
    if model_path:
        aligner.save(model_path)

    mfa_text, mfa_start, mfa_end = {}, {}, {}
    for uid, (x, phones), optional in zip(uids, utts, optionals):
        try:
            s, e = aligner.align(
                x, phones, optional if any(optional) else None)
        except RuntimeError:
            continue
        # drop skipped zero-length sp entries (the reference's .aligned
        # parse also omits them)
        keep = [i for i in range(len(phones)) if e[i] > s[i]
                or not optional[i]]
        kept_phones = [phones[i] for i in keep]
        mfa_text[uid] = " ".join(kept_phones)
        mfa_start[uid] = np.round(s[keep], 4)
        mfa_end[uid] = np.round(e[keep], 4)

    write_2column_text(os.path.join(out_dir, "mfa_text"), mfa_text)
    write_num_sequence_text(os.path.join(out_dir, "mfa_start"), mfa_start)
    write_num_sequence_text(os.path.join(out_dir, "mfa_end"), mfa_end)
    return out_dir
