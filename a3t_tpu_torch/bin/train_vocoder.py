"""Train a ParallelWaveGAN vocoder on a wav.scp corpus: the port of
``a3t_tpu/bin/train_vocoder.py``, with the multi-resolution STFT loss and an
LSGAN adversarial phase (``a3t_tpu_torch/train/vocoder.py``).

    python -m a3t_tpu_torch.bin.train_vocoder --wav-scp data/train/wav.scp \
        --out exp/vocoder --fs 16000 --n-fft 1024 --hop 200 --win 800 \
        --steps 50000

Trains on the CUDA card unless ``--device cpu`` is given.  The directory
it writes (``state.pt``, ``vocoder.json``, ``history.json``) feeds
``bin.mcd_gate --vocoder DIR``; a run finding ``state.pt`` there resumes.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Parse ``argv`` and train; returns the output directory."""
    ap = argparse.ArgumentParser(description="PWG vocoder training "
                                             "(PyTorch)")
    ap.add_argument("--wav-scp", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fs", type=int, default=24000)
    ap.add_argument("--n-fft", type=int, default=2048)
    ap.add_argument("--hop", type=int, default=300)
    ap.add_argument("--win", type=int, default=1200)
    ap.add_argument("--n-mels", type=int, default=80)
    ap.add_argument("--fmin", type=float, default=80.0)
    ap.add_argument("--fmax", type=float, default=7600.0)
    ap.add_argument("--steps", type=int, default=50000)
    ap.add_argument("--disc-start", type=int, default=20000)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--crop-frames", type=int, default=96)
    ap.add_argument("--max-utts", type=int, default=0)
    ap.add_argument("--corpus-cache", default="",
                    help="npz path caching the cut wavs, mels and MVN")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--save-interval", type=int, default=5000,
                    help="checkpoint every N steps (a run cut short "
                         "resumes from the last save)")
    ap.add_argument("--phase-conv", action="store_true",
                    help="recorded in vocoder.json for the JAX package; "
                         "the port's generator computes the same function "
                         "without it")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.dsp.frontend import LogMelConfig
    from a3t_tpu_torch.train.vocoder import VocoderTrainConfig, train_vocoder

    fe_cfg = LogMelConfig(fs=args.fs, n_fft=args.n_fft, hop_length=args.hop,
                          win_length=args.win, n_mels=args.n_mels,
                          fmin=args.fmin, fmax=args.fmax)
    cfg = VocoderTrainConfig(
        total_steps=args.steps, disc_start_step=args.disc_start,
        batch_size=args.batch_size, crop_frames=args.crop_frames,
        seed=args.seed, phase_conv=args.phase_conv,
        save_interval=args.save_interval)
    return train_vocoder(args.wav_scp, args.out, fe_cfg, cfg,
                         max_utts=args.max_utts or None,
                         corpus_cache=args.corpus_cache or None,
                         device=args.device)


if __name__ == "__main__":
    main()
