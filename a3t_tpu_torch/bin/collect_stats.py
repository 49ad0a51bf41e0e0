"""Feature-statistics collection CLI (collect-stats stage,
mlm.sh:457-546): the port of ``a3t_tpu/bin/collect_stats.py``.

    python -m a3t_tpu_torch.bin.collect_stats --config conf.yaml \
        --data-dir dump/raw/tr_no_dev --out exp/stats/train [--device cpu]
    python -m a3t_tpu_torch.bin.collect_stats --aggregate d1 d2 \
        --out exp/stats/all

Writes ``feats_stats.npz`` (sum, sqsum and count over every valid frame),
``speech_shape`` and ``text_shape``; the log-mel front-end (rfft) runs on
``--device``, the CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import dataclasses


def main(argv=None):
    parser = argparse.ArgumentParser(description="A3T stats collection")
    parser.add_argument("--config", default=None)
    parser.add_argument("--data-dir", default=None)
    parser.add_argument("--out", required=True)
    parser.add_argument("--aggregate", nargs="*", default=None,
                        help="merge these stats dirs instead of collecting")
    parser.add_argument("--device", default="cuda",
                        help="torch device of the front-end (default cuda)")
    args = parser.parse_args(argv)

    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.dsp.normalize import aggregate_stats, collect_stats

    device = resolve_device(args.device)
    if args.aggregate:
        aggregate_stats(args.aggregate, args.out)
        print(f"aggregated {len(args.aggregate)} dirs -> {args.out}")
        return None

    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.tasks.mlm import MLMTask

    cfg = load_config(args.config)
    if args.data_dir:
        # a token list built from the text is built from this directory's
        # (JAX's reads the config's train_data_dir, which need not exist);
        # text_shape counts phones, whatever their ids
        cfg = dataclasses.replace(cfg, train_data_dir=args.data_dir)
    conv = MLMTask.build_token_converter(cfg)
    fe = MLMTask.build_frontend(cfg, device=device)
    ds = A3TDataset(cfg.train_data_dir, conv, speech_only=cfg.speech_only)
    info = collect_stats(fe, ds, args.out)
    print(f"collected stats over {info['count']} frames -> {args.out}")
    return info


if __name__ == "__main__":
    main()
