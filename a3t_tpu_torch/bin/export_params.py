"""Export a params-only (optionally bf16) stash from a training exp dir: the
port of ``a3t_tpu/bin/export_params.py``.

The reference moves weights between runs with --init_param, pointing at a
full ``.pth`` (espnet2/torch_utils/load_pretrained_model.py:43-102).  This
CLI strips a port checkpoint (``train/checkpoint.py``: parameters, BatchNorm
statistics and Adam's moments, ~0.8 GB at the 24 kHz model's width) down to
its parameters, ~1/6 of the bytes in bf16, in a directory that
``trainer.init_params_dir`` warm-starts from:

    <out>/params.pt     {"params": {name: tensor}}
    <out>/tokens.txt    the experiment's token list (when it has one)
    <out>/config.yaml   the experiment's config (when it has one)

    python -m a3t_tpu_torch.bin.export_params --exp exp/a3t \
        --out exp/a3t_params --dtype bfloat16 [--epoch 12]

``--exp`` is an experiment directory of ``bin.train``; ``--epoch`` is
``latest`` (``checkpoints/LATEST``), an epoch number, or a file name in
``checkpoints/`` (e.g. ``ave_5best.pt``).  The out dir is
written under ``<out>.tmp`` and moved into place with ``os.replace``, so an
interrupted export never destroys the stash it replaces.  The work is host
work; like every entry point of the port, the CLI refuses to start without
a CUDA card unless ``--device cpu`` is given.
"""

from __future__ import annotations

import argparse
import os
import shutil

# the BatchNorm statistics of a model's state_dict: not parameters
BUFFER_SUFFIXES = (".running_mean", ".running_var", ".num_batches_tracked")


def checkpoint_file(exp: str, epoch: str = "latest") -> str:
    """The checkpoint file that ``--exp`` and ``--epoch`` name."""
    ckpt_dir = os.path.join(exp, "checkpoints")
    if epoch == "latest":
        with open(os.path.join(ckpt_dir, "LATEST")) as f:
            name = f"epoch_{f.read().strip()}.pt"
    elif epoch.isdigit():
        name = f"epoch_{epoch}.pt"
    else:
        name = epoch
    return os.path.join(ckpt_dir, name)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--exp", required=True, help="experiment directory")
    ap.add_argument("--epoch", default="latest",
                    help="'latest', an epoch number, or a checkpoint file "
                         "name")
    ap.add_argument("--out", required=True)
    ap.add_argument("--dtype", default="bfloat16",
                    choices=["bfloat16", "float32", "keep"])
    ap.add_argument("--device", default="cuda",
                    help="torch device the run is for (default cuda)")
    args = ap.parse_args(argv)

    import torch

    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.train.checkpoint import load_params

    resolve_device(args.device)
    src = checkpoint_file(args.exp, args.epoch)
    params = {k: v for k, v in load_params(src).items()
              if not k.endswith(BUFFER_SUFFIXES)}
    if args.dtype != "keep":
        dt = getattr(torch, args.dtype)
        params = {k: v.to(dt) for k, v in params.items()}
    out = os.path.abspath(args.out)
    tmp = out + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    torch.save({"params": params}, os.path.join(tmp, "params.pt"))
    # the token list and config make the stash self-contained: tokens for
    # grow_vocab warm starts, the config to rebuild the architecture
    for name in ("tokens.txt", "config.yaml"):
        src_f = os.path.join(args.exp, name)
        if os.path.exists(src_f):
            shutil.copy(src_f, os.path.join(tmp, name))
    if os.path.exists(out):
        shutil.rmtree(out)
    os.replace(tmp, out)
    n = sum(v.numel() for v in params.values())
    print(f"exported {n / 1e6:.1f}M params from {src} -> {out} "
          f"({args.dtype})")
    return out


if __name__ == "__main__":
    main()
