"""End-to-end miniature recipe (the mini_an4-style integration demo): the
port of ``recipes/mini/run.py``.

Stages (mirror egs2/vctk/sedit/run.sh's 7-stage pipeline at toy scale):
  1. synthesize a tiny corpus (data prep)
  2. force-align it with the native C++ aligner (HTK-stage analogue)
  3. pretrain the A3T model (mlm.sh stage 7)
  4. edit an utterance + reconstruct a masked span
  5. MCD evaluation of middle-third reconstruction

Run:  python -m a3t_tpu_torch.recipes.mini [--workdir DIR] [--epochs 3]
      [--n-utts 16] [--device cpu]

The model trains and serves on ``--device``, the CUDA card unless
``--device cpu`` is given; the work directory defaults to ``a3t_mini``
under the temporary directory.
"""

from __future__ import annotations

import argparse
import os
import tempfile


def toy_config(data: str, exp: str, epochs: int) -> dict:
    """The recipe's toy A3T configuration (16 kHz, 64-wide, 2 + 2 blocks)."""
    return {
        "train_data_dir": data,
        "valid_data_dir": data,
        "exp_dir": exp,
        "frontend": {"fs": 16000, "n_fft": 512, "hop_length": 160,
                     "win_length": 480, "n_mels": 40, "fmin": 20.0,
                     "fmax": 7600.0},
        "model": {
            "encoder": {"attention_dim": 64, "attention_heads": 2,
                        "linear_units": 128, "num_blocks": 2,
                        "cnn_module_kernel": 7},
            "decoder": {"attention_dim": 64, "attention_heads": 2,
                        "linear_units": 128, "num_blocks": 2,
                        "cnn_module_kernel": 7},
            "postnet_layers": 2, "postnet_chans": 32,
        },
        "optim": {"model_size": 64, "warmup_steps": 50},
        "batcher": {"batch_bins": 40 * 256 * 8, "bucket_frames": [128, 256],
                    "min_frames": 1},
        "trainer": {"max_epoch": epochs, "num_iters_per_epoch": 10,
                    "keep_nbest_models": 2, "log_interval": 5},
    }


def main(argv=None) -> dict:
    """Run the five stages; returns stage 5's MCD result."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--workdir",
                        default=os.path.join(tempfile.gettempdir(),
                                             "a3t_mini"))
    parser.add_argument("--epochs", type=int, default=3)
    parser.add_argument("--n-utts", type=int, default=16)
    parser.add_argument("--device", default="cuda",
                        help="torch device to train and serve on "
                             "(default cuda)")
    args = parser.parse_args(argv)

    from a3t_tpu_torch.align import align_corpus
    from a3t_tpu_torch.data.miniature import generate_mini_corpus
    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.tasks import yaml_subset

    device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    data = os.path.join(args.workdir, "data")
    exp = os.path.join(args.workdir, "exp")

    print("== stage 1: data prep ==")
    generate_mini_corpus(data, n_utts=args.n_utts, fs=16000)

    print("== stage 2: forced alignment (native aligner) ==")
    for f in ("mfa_start", "mfa_end"):  # drop the oracle alignments
        os.remove(os.path.join(data, f))
    align_corpus(data, sample_rate=16000, n_iterations=8,
                 model_path=os.path.join(args.workdir, "aligner.bin"))
    # the aligner writes mfa_text; training reads `text` + mfa_start/end
    os.replace(os.path.join(data, "mfa_text"), os.path.join(data, "text"))

    print("== stage 3: A3T pretraining ==")
    conf_path = os.path.join(args.workdir, "config.yaml")
    with open(conf_path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dump(toy_config(data, exp, args.epochs)))

    from a3t_tpu_torch.bin.train import main as train_main

    train_main(["--config", conf_path, "--device", str(device)])

    print("== stage 4: speech editing ==")
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text, write_wav
    from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
    from a3t_tpu_torch.tasks.mlm import MLMTask

    model, cfg, conv = MLMTask.build_model_from_dir(exp, device=device)
    texts = read_2column_text(os.path.join(data, "text"))
    lexicon = {p.upper(): [p] for t in texts.values() for p in t.split()}
    editor = SpeechEditor(model, cfg.frontend, conv, lexicon=lexicon,
                          duration_fn=lambda ph, w: [0.15] * len(ph),
                          device=device)
    ds = A3TDataset(data, conv)
    aligner = FileAlignmentSource(data)

    uid = ds.uids[0]
    wav = ds[uid]["audio"]
    words = texts[uid].split()
    masked = " ".join(words[:1] + ["[MASK]"] + words[2:])
    res = editor.reconstruct_masked_span(wav, aligner(uid), texts[uid], masked)
    out_wav = os.path.join(args.workdir, f"{uid}_edited.wav")
    write_wav(out_wav, cfg.frontend.fs, res.origin_replaced)
    print(f"edited waveform: {out_wav} "
          f"(span frames {res.old_span_boundary})")

    print("== stage 5: MCD evaluation ==")
    from a3t_tpu_torch.eval.mcd import (MCDConfig,
                                        evaluate_masked_reconstruction)

    result = evaluate_masked_reconstruction(
        editor, aligner, ds, ds.uids[:8],
        MCDConfig(mcep_dim=24, fftl=512, f0min=70, f0max=700), texts)
    print(f"mean MCD over {result['n']} utts: {result['mean_mcd']:.3f} dB")
    return result


if __name__ == "__main__":
    main()
