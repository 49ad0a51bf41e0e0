"""FastSpeech2-predicted phone durations for speech editing
(``a3t_tpu/inference/durations.py:30-108``).

The reference predicts the durations of new text with a FastSpeech2:
encoder -> GST style embedding from the prompt waveform -> x-vector
integration -> duration predictor, frames to seconds, the trailing eos
dropped (sedit_inference.py:398-424).  Two sources:

* an FS2 experiment directory of ``tasks/fs2.py::FS2Task``, and
* an ESPnet FastSpeech2 ``.pth`` with its ``config.yaml`` alongside
  (``compat/fs2.py::load_espnet_fs2``, the published GST + x-vector
  conformer duration predictors).

Both give ``duration_fn(phones, wav) -> list of seconds`` for
``SpeechEditor(duration_fn=...)``, on the model's device.
"""

from __future__ import annotations

import os
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from a3t_tpu_torch.dsp.frontend import LogMelConfig, LogMelFrontend


def make_fs2_duration_fn(
    model,
    tokens,
    frontend: LogMelConfig | LogMelFrontend,
    spembs: Optional[np.ndarray] = None,
    sp_map: Optional[dict[str, str]] = None,
) -> Callable[[Sequence[str], np.ndarray], list[float]]:
    """``(phones, wav) -> seconds`` from a FastSpeech2 in eval mode: the
    phones (``sp_map`` remaps alignment-only tokens, e.g. silence ``sp`` ->
    ``<blank>``, sedit_inference.py:399) and an eos of id ``idim - 1``; GST
    reads the request's log-mel (the rfft front-end); ``spembs`` (E,) is
    the speaker's x-vector."""
    dev = next(model.parameters()).device
    fe = (LogMelFrontend(frontend, device=dev)
          if isinstance(frontend, LogMelConfig) else frontend)
    c = fe.config
    eos = model.config.idim - 1
    sp = (None if spembs is None else
          torch.as_tensor(np.asarray(spembs, np.float32)[None], device=dev))

    def duration_fn(phones: Sequence[str], wav: np.ndarray) -> list[float]:
        phns = [sp_map.get(p, p) for p in phones] if sp_map else list(phones)
        ids = np.asarray(tokens.tokens2ids(phns) + [eos], np.int64)
        text = torch.as_tensor(ids[None], device=dev)
        mask = torch.ones_like(text, dtype=torch.bool)
        with torch.inference_mode():
            speech = None
            if model.config.use_gst:
                speech, _ = fe(np.asarray(wav, np.float32)[None])
            frames = model.predict_durations(text, mask, speech, sp)[0]
        secs = frames.cpu().numpy().astype(np.float64) * c.hop_length / c.fs
        return [float(x) for x in secs[:-1]]  # drop eos (ref :424)

    return duration_fn


def load_duration_fn(
    path: str,
    spembs: Optional[np.ndarray] = None,
    which: str = "ave",
    device=None,
) -> Callable[[Sequence[str], np.ndarray], list[float]]:
    """The duration function of an FS2 experiment directory (``which``
    checkpoint) or of an ESPnet ``.pth`` (its ``config.yaml`` alongside
    gives the front-end), on ``device`` (cuda unless the caller asks for
    the CPU).  An experiment whose vocabulary lacks ``sp`` reads it as
    ``<unk>``; the ESPnet route maps it to ``<blank>``."""
    from a3t_tpu_torch.text.tokenizer import UNK, TokenIDConverter

    if os.path.isdir(path):
        from a3t_tpu_torch.tasks.fs2 import FS2Task

        model, cfg, conv = FS2Task.build_model_from_dir(path, which=which,
                                                        device=device)
        sp_map = None if "sp" in conv.token2id else {"sp": UNK}
        return make_fs2_duration_fn(model, conv, cfg.frontend,
                                    spembs=spembs, sp_map=sp_map)

    from a3t_tpu_torch.compat.espnet import espnet_frontend_config
    from a3t_tpu_torch.compat.fs2 import load_espnet_fs2
    from a3t_tpu_torch.tasks import yaml_subset

    model, token_list = load_espnet_fs2(path, device=device)
    cfg = yaml_subset.load_file(os.path.join(os.path.dirname(path),
                                             "config.yaml"))
    fe_cfg = espnet_frontend_config(cfg, n_mels_default=model.config.odim)
    return make_fs2_duration_fn(model, TokenIDConverter(token_list), fe_cfg,
                                spembs=spembs, sp_map={"sp": "<blank>"})
