"""Test-time fine-tuning and the [MASK]-filling helper of the baselines
(``a3t_tpu/inference/baselines.py:33-48`` and ``:145-196``).

* :func:`resolve_mask_str` — ``[MASK]`` in a text replaced by the original
  phones it spans;
* :func:`dynamic_evaluation` — a few plain-SGD passes of per-word [MASK]
  reconstruction on the prompt utterance before decoding (speaker
  adaptation), on a copy of the editor's model.

The FastSpeech2 baselines (``FS2Baselines``) wait for FastSpeech2 (ROADMAP
A9).
"""

from __future__ import annotations

import copy

import torch

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
