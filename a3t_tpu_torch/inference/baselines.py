"""The FastSpeech2 baselines and test-time fine-tuning
(``a3t_tpu/inference/baselines.py``; reference
espnet2/bin/sedit_inference.py:160-260, 748-776).

* :func:`resolve_mask_str` — ``[MASK]`` in a text replaced by the original
  phones it spans;
* :class:`FS2Baselines` — baseline1, FS2 TTS of the new text (GST +
  x-vector conditioned); baseline2, FS2 TTS of only the edited text spliced
  into the original mel at the edited span; baseline3, FS2 TTS of the
  whole new text with the edited span's slice (located by the predicted
  durations) spliced in;
* :func:`dynamic_evaluation` — a few plain-SGD passes of per-word [MASK]
  reconstruction on the prompt utterance before decoding (speaker
  adaptation), on a copy of the editor's model.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from a3t_tpu_torch.dsp.griffin_lim import logmel_to_wav

from a3t_tpu_torch.inference.sedit import (
    MASK_TOKEN,
    SpeechEditor,
    UtteranceAlignment,
    diff_phone_spans,
)
from a3t_tpu_torch.models.mlm import mlm_loss

# the dropout generator's seed in every step, the JAX package's PRNGKey(0)
DROPOUT_SEED = 0


def resolve_mask_str(alignment: UtteranceAlignment, old_str: str,
                     new_str: str, lexicon, g2p=None) -> str:
    """Replace ``[MASK]`` in ``new_str`` with the original phones it
    spans."""
    if MASK_TOKEN not in new_str:
        return new_str
    _, span_replaced, _ = diff_phone_spans(
        alignment, old_str, new_str, lexicon, g2p)
    old_phns = list(alignment.phones)
    filled = " ".join(old_phns[span_replaced[0]:span_replaced[1]])
    return new_str.replace(MASK_TOKEN, filled)


class FS2Baselines:
    """The three baselines from one FastSpeech2 (in eval mode, on its
    device), its token converter, the editor's front-end (a
    ``LogMelFrontend`` on the same device) and a vocoder ((B, F, n_mels) ->
    (B, S) tensors; Griffin-Lim, ``dsp/griffin_lim.py``, when None)."""

    def __init__(self, fs2_model, token_converter, frontend, vocoder=None):
        self.model = fs2_model
        self.tokens = token_converter
        self.fe = frontend
        self.vocoder = vocoder

    def _synthesize(self, text_str: str, prompt_wav=None, spembs=None):
        """(mel (n_frames, n_mels) up to the total duration, the durations
        of the text's tokens and the eos) for ``text_str``."""
        dev = next(self.model.parameters()).device
        ids = self.tokens.text2ids(text_str) + [self.model.config.idim - 1]
        text = torch.as_tensor([ids], device=dev)
        mask = torch.ones_like(text, dtype=torch.bool)
        with torch.inference_mode():
            speech = None
            if prompt_wav is not None and self.model.config.use_gst:
                speech, _ = self.fe(np.asarray(prompt_wav, np.float32)[None])
            sp = (None if spembs is None else torch.as_tensor(
                np.asarray(spembs, np.float32)[None], device=dev))
            out = self.model(text, mask, speech=speech, spembs=sp)
        durations = out["durations"][0].cpu().numpy()
        n_valid = int(durations.sum())
        return out["after"][0, :n_valid].cpu().numpy(), durations

    def _vocode(self, mel: np.ndarray) -> np.ndarray:
        m = torch.as_tensor(mel[None], device=self.fe.device)
        with torch.inference_mode():
            wav = (self.vocoder(m) if self.vocoder is not None
                   else logmel_to_wav(m, self.fe.config))
        return wav[0].float().cpu().numpy()

    def _old_span(self, alignment: UtteranceAlignment, span_replaced):
        c = self.fe.config
        start = alignment.start_sec
        return [int(start[span_replaced[0]] * c.fs / c.hop_length),
                int(start[min(span_replaced[1], len(start) - 1)] * c.fs
                    / c.hop_length)]

    def baseline1(self, new_str: str, prompt_wav=None, spembs=None):
        """Full-utterance FS2 TTS of the new text (ref :160-185)."""
        mel, _ = self._synthesize(new_str, prompt_wav, spembs)
        return self._vocode(mel)

    def baseline2(self, wav, alignment: UtteranceAlignment, full_str: str,
                  new_str: str, target_str: str, lexicon, mel_fn,
                  spembs=None):
        """TTS of only the edited text, spliced into the original mel
        (ref :187-222)."""
        _, span_replaced, _ = diff_phone_spans(
            alignment, full_str, new_str, lexicon)
        old_span = self._old_span(alignment, span_replaced)
        input_feat = mel_fn(wav)
        mel_t, durations = self._synthesize(target_str, wav, spembs)
        eos_dur = int(durations[-1])
        mel_t = mel_t[: len(mel_t) - eos_dur] if eos_dur else mel_t
        out = np.concatenate(
            [input_feat[: old_span[0]], mel_t, input_feat[old_span[1]:]], 0)
        return self._vocode(out)

    def baseline3(self, wav, alignment: UtteranceAlignment, full_str: str,
                  new_str: str, lexicon, mel_fn, spembs=None):
        """TTS of the whole new text, only the edited span's slice spliced
        in, located by the predicted durations (ref :224-260).  For
        ``[MASK]`` reconstruction the original text is synthesized and the
        span is the original one."""
        new_phns, span_replaced, span_added = diff_phone_spans(
            alignment, full_str, new_str, lexicon)
        if MASK_TOKEN in new_str:
            new_phns = list(alignment.phones)
            span_added = list(span_replaced)
            new_str = " ".join(new_phns)
        old_span = self._old_span(alignment, span_replaced)
        input_feat = mel_fn(wav)
        mel_full, d = self._synthesize(new_str, wav, spembs)
        s = int(d[: span_added[0]].sum())
        e = int(d[: span_added[1]].sum())
        out = np.concatenate(
            [input_feat[: old_span[0]], mel_full[s:e],
             input_feat[old_span[1]:]], 0)
        return self._vocode(out)


def dynamic_evaluation(
    editor: SpeechEditor,
    wav,
    alignment: UtteranceAlignment,
    text: str,
    lr: float = 5e-5,
    steps: int = 1,
) -> SpeechEditor:
    """Test-time fine-tuning: one [MASK] reconstruction example per word of
    ``text`` but the last (at least one), ``steps`` passes of plain SGD (no
    momentum) over them, one example per step, with the model in training
    mode (dropout, batch-statistics BatchNorm and, on the card, the
    attention kernel's backward).

    As in the JAX package: BatchNorm normalises with each example's batch
    statistics, but the running statistics stay those of ``editor``'s model
    (JAX throws the updated ones away; here they are restored after every
    step); every step draws its dropout from a generator seeded with
    :data:`DROPOUT_SEED`; and ``editor`` is left as it was.  Returns a
    shallow copy of ``editor`` holding an adapted copy of its model, in eval
    mode."""
    words = text.split()
    examples = []
    for i in range(max(len(words) - 1, 1)):
        masked = " ".join(words[:i] + [MASK_TOKEN] + words[i + 1:])
        new_wav, phones, s_sec, e_sec, _, boundary = editor._new_timeline(
            wav, alignment, text, masked, mask_reconstruct=True)
        examples.append((new_wav, phones, s_sec, e_sec, boundary))

    model = copy.deepcopy(editor.model)
    buffers = list(model.buffers())
    saved = [b.clone() for b in buffers]
    params = [p for p in model.parameters() if p.requires_grad]
    gen = torch.Generator()
    model.train()
    try:
        for _ in range(steps):
            for new_wav, phones, s_sec, e_sec, boundary in examples:
                inputs = editor.build_inputs(new_wav, phones, s_sec, e_sec,
                                             boundary)
                before, after = model(**inputs,
                                      generator=gen.manual_seed(DROPOUT_SEED))
                loss = mlm_loss(before, after, inputs["speech"],
                                inputs["masked_position"])
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                used = [(p, g) for p, g in zip(params, grads) if g is not None]
                with torch.no_grad():
                    # optax.sgd: u = -lr * g, then p + u
                    updates = torch._foreach_mul([g for _, g in used], -lr)
                    torch._foreach_add_([p for p, _ in used], updates)
                    for b, v in zip(buffers, saved):
                        b.copy_(v)
    finally:
        model.eval()
    adapted = copy.copy(editor)
    adapted.model = model
    return adapted
