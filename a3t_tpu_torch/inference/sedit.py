"""Speech editing and prompt TTS (``a3t_tpu/inference/sedit.py:43-605``).

* :func:`words2phns` — text -> phones via a lexicon and a letter-to-sound
  callable for OOV words;
* :func:`diff_phone_spans` — longest common word prefix/suffix to find the
  edited phone span, with ``[MASK]`` and append (prompt) modes;
* :func:`duration_adjust_factor` — trimmed-mean speaking-rate ratio;
* :class:`SpeechEditor` — build the new phone timeline, zero-fill the edited
  span's waveform, mask it, reconstruct it with the teacher-forced A3T
  forward, vocode, and splice ``wav[:t0] + generated[t0':t1'] + wav[t1:]``;
  prompt TTS is the append-mode special case.

The host-side logic is a copy of the JAX package's, so both give the same
spans as integers; the front-end, model and vocoder run on the editor's
device.  Inputs are padded to frame buckets of 64 and text buckets of 8.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from a3t_tpu_torch.device import resolve_device
from a3t_tpu_torch.dsp.frontend import LogMelConfig, LogMelFrontend
from a3t_tpu_torch.masking.alignment import (
    masked_positions_from_boundary,
    segment_positions,
)

PUNCTUATION = [",", ".", ":", ";", "!", "?", '"', "(", ")", "--", "---"]
MASK_TOKEN = "[MASK]"


def clean_words(line: str) -> list[str]:
    """Strip punctuation and stray apostrophes/hyphens."""
    for pun in PUNCTUATION:
        line = line.replace(pun, " ")
    words = []
    for wrd in line.strip().split():
        if wrd.endswith("-"):
            wrd = wrd[:-1]
        if wrd.startswith("'"):
            wrd = wrd[1:]
        if wrd:
            words.append(wrd)
    return words


def words2phns(
    line: str,
    lexicon: dict[str, list[str]],
    g2p: Optional[Callable[[str], list[str]]] = None,
) -> tuple[list[str], dict[str, list[str]]]:
    """Text -> (phones, {"idx_WORD": phones}); ``lexicon`` maps UPPERCASE
    words to phones and ``g2p`` handles OOV words."""
    phns: list[str] = []
    wrd2phns: dict[str, list[str]] = {}
    for index, wrd in enumerate(clean_words(line)):
        if wrd == MASK_TOKEN:
            wrd2phns[f"{index}_{wrd}"] = [wrd]
            phns.append(wrd)
        elif wrd.upper() not in lexicon:
            if g2p is None:
                raise KeyError(f"OOV word {wrd!r} and no g2p provided")
            p = list(g2p(wrd))
            wrd2phns[f"{index}_{wrd.upper()}"] = p
            phns.extend(p)
        else:
            p = list(lexicon[wrd.upper()])
            wrd2phns[f"{index}_{wrd.upper()}"] = p
            phns.extend(p)
    return phns, wrd2phns


@dataclasses.dataclass
class UtteranceAlignment:
    """Phone-level forced alignment of one utterance."""

    phones: list[str]
    start_sec: np.ndarray  # (n_phones,)
    end_sec: np.ndarray
    word2phns: dict[str, list[str]]  # "idx_WORD" -> phones (incl. sp entries)


def _word_entries(word2phns: dict[str, list[str]]) -> list[tuple[int, str, list[str]]]:
    out = []
    for key, phones in word2phns.items():
        idx, word = key.split("_", 1)
        out.append((int(idx), word, list(phones)))
    return out


def diff_phone_spans(
    alignment: UtteranceAlignment,
    old_str: str,
    new_str: str,
    lexicon: dict[str, list[str]],
    g2p: Optional[Callable] = None,
) -> tuple[list[str], list[int], list[int]]:
    """Phone spans that differ between old and new text.

    Returns ``(new_phns, edit_span_old, edit_span_new)``: half-open phone
    index intervals into the old and new phone sequences.  Silence ("sp")
    entries, which exist only on the aligned side, are transparent; append
    mode is prompt TTS; a full-utterance replacement keeps the new text.
    """
    old_phns = alignment.phones
    old_words = _word_entries(alignment.word2phns)
    new_phns_all, new_map = words2phns(new_str, lexicon, g2p)
    n_old, n_new = len(old_phns), len(new_phns_all)

    # common word prefix: phones from the old alignment (so sp stays in)
    prefix: list[str] = []
    new_consumed = 0
    sil_seen = 0
    edit_old = [0, n_old - 1]
    edit_new = [0, n_new - 1]
    for widx, word, phones in old_words:
        if word == "sp":
            sil_seen += 1
            prefix.append("sp")
            continue
        match = new_map.get(f"{widx - sil_seen}_{word}")
        if match is None:
            edit_old[0] = edit_new[0] = len(prefix)
            break
        new_consumed += len(match)
        prefix.extend(phones)

    if old_str == new_str[: len(old_str)]:
        # append mode (prompt TTS): everything after the prefix is new
        middle = new_phns_all[new_consumed:]
        edit_old[0] = edit_new[0] = len(prefix)
        edit_new[1] = len(prefix) + len(middle)
        edit_old[1] = n_old
        return prefix + middle, edit_old, edit_new

    # common word suffix, word indices aligned from the right
    suffix: list[str] = []
    new_tail = 0
    sil_seen = 0
    middle: list[str] = []
    last_old = old_words[-1][0]
    last_new = _word_entries(new_map)[-1][0] if new_map else 0
    for widx, word, phones in reversed(old_words):
        if word == "sp":
            sil_seen += 1
            suffix = ["sp"] + suffix
            continue
        mirrored = last_new - (last_old - widx - sil_seen)
        match = new_map.get(f"{mirrored}_{word}")
        if match is not None:
            new_tail += len(match)
            suffix = phones + suffix
            continue
        edit_old[1] = n_old - len(suffix)
        middle = new_phns_all[new_consumed: n_new - new_tail]
        edit_new[1] = len(prefix) + len(middle)
        if not middle:
            # texts differ but the word-level diff collapsed: widen the
            # edit window by one phone on each side
            edit_new[0] = max(0, edit_new[0] - 1)
            edit_new[1] = min(edit_new[1] + 1, n_new)
            edit_old[0] = max(0, edit_old[0] - 1)
            edit_old[1] = min(edit_old[1] + 1, n_old)
        break

    return prefix + middle + suffix, edit_old, edit_new


def duration_adjust_factor(
    original_dur: Sequence[float], pred_dur: Sequence[float],
    phns: Sequence[str],
) -> float:
    """Trimmed-mean ratio of true to predicted durations: non-silence
    ratios sorted, two smallest and two largest dropped; fewer than 5
    usable phones -> 1.0."""
    ori = np.asarray(list(original_dur), dtype=float)
    pred = np.asarray(list(pred_dur), dtype=float)
    usable = (pred != 0) & np.asarray([p != "sp" for p in phns], dtype=bool)
    ratios = np.sort(ori[usable] / pred[usable])
    if ratios.size < 5:
        return 1.0
    return float(ratios[2:-2].mean())


def masked_mel_boundary(
    start_sec, end_sec, fs: int, hop_length: int, phone_span: Sequence[int]
) -> list[int]:
    """Phone-index span -> [frame_start, frame_end]."""
    a_start = np.floor(fs * np.asarray(start_sec) / hop_length).astype(int)
    a_end = np.floor(fs * np.asarray(end_sec) / hop_length).astype(int)
    if phone_span[0] >= len(a_start):
        return [int(a_end[-1]), int(a_end[-1])]
    return [int(a_start[phone_span[0]]), int(a_end[phone_span[1] - 1])]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass
class EditResult:
    prediction: np.ndarray  # full vocoded edited waveform
    origin_replaced: np.ndarray  # original wav with only the span replaced
    origin: np.ndarray
    mel_original: np.ndarray
    mel_edited: np.ndarray
    old_span_boundary: list[int]
    new_span_boundary: list[int]


class SpeechEditor:
    """End-to-end speech editing / prompt TTS on ``device``.

    Args:
        model: an ``A3TMLMModel`` on ``device`` (see ``models.mlm.build_model``).
        frontend_config: the front-end matching the model's training.
        token_converter: phone vocabulary.
        vocoder: callable (B, F, n_mels) log-mel tensor -> (B, S) waveform
            tensor, e.g. a ``ParallelWaveGANGenerator``.  Griffin-Lim, the
            JAX package's default, is not ported: without a vocoder,
            vocoding raises.
        duration_fn: callable (phones, wav) -> per-phone seconds; needed
            for text replacement and prompt TTS, not for [MASK] editing.
        lexicon / g2p: word -> phones resources for new text.
        device: where the front-end runs; cuda unless the caller asks for
            the CPU.
    """

    def __init__(
        self,
        model,
        frontend_config: LogMelConfig,
        token_converter,
        vocoder: Optional[Callable] = None,
        duration_fn: Optional[Callable] = None,
        lexicon: Optional[dict[str, list[str]]] = None,
        g2p: Optional[Callable] = None,
        frame_bucket: int = 64,
        text_bucket: int = 8,
        device=None,
    ):
        self.device = resolve_device(device)
        self.model = model
        self.fe = LogMelFrontend(frontend_config, device=self.device)
        self.tokens = token_converter
        self.vocoder = vocoder
        self.duration_fn = duration_fn
        self.lexicon = lexicon or {}
        self.g2p = g2p
        self.frame_bucket = frame_bucket
        self.text_bucket = text_bucket

    # -- helpers ---------------------------------------------------------
    def mel(self, wav: np.ndarray) -> np.ndarray:
        """Model-domain log-mel of a waveform, (1 + len // hop, n_mels)."""
        feats, _ = self.fe(torch.as_tensor(wav[None]))
        n_f = 1 + len(wav) // self.fe.config.hop_length
        return feats[0, :n_f].cpu().numpy()

    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        if self.vocoder is None:
            raise NotImplementedError(
                "Griffin-Lim is not ported: pass a vocoder (models/pwg.py)")
        with torch.inference_mode():
            wav = self.vocoder(torch.as_tensor(mel[None], device=self.device))
        return wav[0].float().cpu().numpy()

    # -- timeline construction -------------------------------------------
    def _new_timeline(
        self,
        wav: np.ndarray,
        alignment: UtteranceAlignment,
        old_str: str,
        new_str: str,
        duration_adjust: bool = True,
        mask_reconstruct: bool = False,
    ):
        c = self.fe.config
        fs, hop = c.fs, c.hop_length
        mfa_start = list(np.asarray(alignment.start_sec, float))
        mfa_end = list(np.asarray(alignment.end_sec, float))
        old_phns = alignment.phones

        new_phns, span_replaced, span_added = diff_phone_spans(
            alignment, old_str, new_str, self.lexicon, self.g2p)

        if MASK_TOKEN in new_str and mask_reconstruct:
            # pure masked reconstruction: original timeline and span
            boundary = masked_mel_boundary(
                mfa_start, mfa_end, fs, hop, span_replaced)
            return wav, old_phns, mfa_start, mfa_end, boundary, boundary

        if self.duration_fn is None:
            raise ValueError("text replacement needs a duration_fn")
        old_durations = list(self.duration_fn(old_phns, wav))
        original_old_durations = [e - s for e, s in zip(mfa_end, mfa_start)]

        if MASK_TOKEN in new_str:
            new_phns = list(old_phns)
            span_added = list(span_replaced)
            d_left = duration_adjust_factor(
                original_old_durations[: span_replaced[0]],
                old_durations[: span_replaced[0]],
                old_phns[: span_replaced[0]])
            d_right = duration_adjust_factor(
                original_old_durations[span_replaced[1]:],
                old_durations[span_replaced[1]:],
                old_phns[span_replaced[1]:])
            d_factor = (d_left + d_right) / 2
            new_durations_adjusted = [d_factor * i for i in old_durations]
        else:
            d_factor = (
                duration_adjust_factor(
                    original_old_durations, old_durations, old_phns)
                if duration_adjust else 1.0
            )
            new_durations = list(self.duration_fn(new_phns, wav))
            new_durations_adjusted = [d_factor * i for i in new_durations]
            # keep the original durations of unchanged boundary phones
            if (span_replaced[0] < len(old_phns)
                    and old_phns[span_replaced[0]] == new_phns[span_added[0]]):
                new_durations_adjusted[span_added[0]] = \
                    original_old_durations[span_replaced[0]]
            if span_replaced[1] < len(old_phns) and span_added[1] < len(new_phns):
                if old_phns[span_replaced[1]] == new_phns[span_added[1]]:
                    new_durations_adjusted[span_added[1]] = \
                        original_old_durations[span_replaced[1]]

        new_span_dur = sum(new_durations_adjusted[span_added[0]: span_added[1]])
        old_span_dur = sum(
            original_old_durations[span_replaced[0]: span_replaced[1]])
        offset = new_span_dur - old_span_dur

        new_mfa_start = mfa_start[: span_replaced[0]]
        new_mfa_end = mfa_end[: span_replaced[0]]
        for d in new_durations_adjusted[span_added[0]: span_added[1]]:
            prev = new_mfa_end[-1] if new_mfa_end else 0.0
            new_mfa_start.append(prev)
            new_mfa_end.append(prev + d)
        new_mfa_start += [t + offset for t in mfa_start[span_replaced[1]:]]
        new_mfa_end += [t + offset for t in mfa_end[span_replaced[1]:]]

        # zero-filled waveform for the edited span
        if span_replaced[0] >= len(mfa_start):
            left = right = len(wav)
        else:
            left = int(np.floor(mfa_start[span_replaced[0]] * fs))
            right = int(np.ceil(mfa_end[span_replaced[1] - 1] * fs))
        blank = np.zeros(int(np.ceil(new_span_dur * fs)), wav.dtype)
        new_wav = np.concatenate([wav[:left], blank, wav[right:]])

        old_boundary = masked_mel_boundary(
            mfa_start, mfa_end, fs, hop, span_replaced)
        new_boundary = masked_mel_boundary(
            new_mfa_start, new_mfa_end, fs, hop, span_added)
        return new_wav, new_phns, new_mfa_start, new_mfa_end, old_boundary, \
            new_boundary

    # -- model decode ----------------------------------------------------
    def build_inputs(self, wav: np.ndarray, phones: list[str],
                     start_sec, end_sec, span_boundary: list[int]) -> dict:
        """Bucket-padded model inputs for one utterance, on the device."""
        c = self.fe.config
        hop = c.hop_length
        n_f = 1 + len(wav) // hop
        f_pad = _round_up(n_f, self.frame_bucket)
        t_len = len(phones)
        t_pad = _round_up(max(t_len, 1), self.text_bucket)
        s_pad = (f_pad - 1) * hop

        audio = np.zeros(s_pad, np.float32)
        audio[: len(wav)] = wav[:s_pad]
        feats, _ = self.fe(torch.as_tensor(audio[None]), [len(wav)])

        a_start = np.minimum(
            np.floor(c.fs * np.asarray(start_sec) / hop).astype(np.int32), n_f)
        a_end = np.minimum(
            np.floor(c.fs * np.asarray(end_sec) / hop).astype(np.int32), n_f)
        masked = masked_positions_from_boundary(f_pad, np.asarray(span_boundary))
        speech_mask = np.arange(f_pad) < n_f
        masked &= speech_mask
        ssp, tsp = segment_positions(f_pad, t_pad, a_start, a_end, t_len)
        ids = np.zeros(t_pad, np.int64)
        ids[:t_len] = self.tokens.tokens2ids(phones)
        text_mask = np.arange(t_pad) < t_len
        host = dict(text=ids, masked_position=masked, speech_mask=speech_mask,
                    text_mask=text_mask, speech_segment_pos=ssp.astype(np.int64),
                    text_segment_pos=tsp.astype(np.int64))
        out = {k: torch.as_tensor(v[None], device=self.device)
               for k, v in host.items()}
        out["speech"] = feats
        return out

    def _reconstruct(self, wav: np.ndarray, phones: list[str],
                     start_sec, end_sec, span_boundary: list[int]) -> np.ndarray:
        """Teacher-forced reconstruction of the span; the full mel with the
        generated span spliced in."""
        n_f = 1 + len(wav) // self.fe.config.hop_length
        inputs = self.build_inputs(wav, phones, start_sec, end_sec,
                                   span_boundary)
        with torch.inference_mode():
            before, after = self.model(**inputs)
        gen = (after if after is not None else before)[0].cpu().numpy()
        orig = inputs["speech"][0].cpu().numpy()
        s, e = span_boundary
        out = np.concatenate([orig[:s], gen[s:e], orig[e:]], axis=0)
        return out[:n_f]

    # -- public API ------------------------------------------------------
    def edit(
        self,
        wav: np.ndarray,
        alignment: UtteranceAlignment,
        old_str: str,
        new_str: str,
        duration_adjust: bool = True,
        mask_reconstruct: bool = False,
    ) -> EditResult:
        """Replace/regenerate a span of ``wav`` so it says ``new_str``."""
        hop = self.fe.config.hop_length
        new_wav, phones, n_start, n_end, old_b, new_b = self._new_timeline(
            wav, alignment, old_str, new_str,
            duration_adjust=duration_adjust,
            mask_reconstruct=mask_reconstruct)
        mel_edited = self._reconstruct(new_wav, phones, n_start, n_end, new_b)
        mel_original = self.mel(wav)
        replaced_wav = self._vocode(mel_edited)
        t_old = [hop * x for x in old_b]
        t_new = [hop * x for x in new_b]
        origin_replaced = np.concatenate([
            wav[: t_old[0]],
            replaced_wav[t_new[0]: t_new[1]],
            wav[t_old[1]:],
        ])
        return EditResult(
            prediction=replaced_wav,
            origin_replaced=origin_replaced,
            origin=wav,
            mel_original=mel_original,
            mel_edited=mel_edited,
            old_span_boundary=old_b,
            new_span_boundary=new_b,
        )

    def reconstruct_masked_span(
        self, wav: np.ndarray, alignment: UtteranceAlignment,
        old_str: str, masked_str: str,
    ) -> EditResult:
        """Mask the span marked [MASK] in ``masked_str`` and regenerate it
        teacher-forced (the MCD protocol)."""
        return self.edit(wav, alignment, old_str, masked_str,
                         mask_reconstruct=True)

    def prompt_tts(
        self,
        wav: np.ndarray,
        alignment: UtteranceAlignment,
        prompt_str: str,
        full_str: str,
        duration_adjust: bool = True,
    ) -> dict:
        """Generate ``full_str``'s continuation in the prompt speaker's
        voice; ``full_str`` must start with ``prompt_str``."""
        if not full_str.startswith(prompt_str):
            raise ValueError("full_str must extend prompt_str")
        hop = self.fe.config.hop_length
        new_wav, phones, n_start, n_end, old_b, new_b = self._new_timeline(
            wav, alignment, prompt_str, full_str,
            duration_adjust=duration_adjust)
        mel_edited = self._reconstruct(new_wav, phones, n_start, n_end, new_b)
        replaced_wav = self._vocode(mel_edited)
        new_wav_out = replaced_wav[new_b[0] * hop:]
        return {"prompt": wav, "new_wav": new_wav_out,
                "full": np.concatenate([wav[: old_b[0] * hop], new_wav_out]),
                "mel": mel_edited, "span_boundary": new_b}
