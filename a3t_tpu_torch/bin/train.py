"""Training CLI: the port of ``a3t_tpu/bin/train.py`` (the espnet2
mlm_train analogue).

    python -m a3t_tpu_torch.bin.train --config configs/a3t_conformer_24k.yaml \
        --set train_data_dir=dump/raw/tr_no_dev \
        --set valid_data_dir=dump/raw/dev --set exp_dir=exp/a3t

Trains on the CUDA card unless ``--device cpu`` is given.  Training on a
mesh runs one process per card, each with the JAX CLI's
``--coordinator host:port --num-hosts W --host-id r`` (``bin.launch``
appends them): ``--num-hosts`` counts processes, one per card, not
machines: ``dp * sp * tp`` of them for the config's
``mesh.data_parallel`` dp, ``mesh.sequence_parallel`` sp and
``mesh.tensor_parallel`` tp, rank r being data rank ``r // (sp * tp)``,
seq rank ``(r // tp) % sp`` and model rank ``r % tp`` (JAX's
``devices.reshape(dp, sp, tp)``).  ``--set mesh.tensor_parallel=2`` splits a
Conformer model's heads and feed-forward units over pairs of adjacent
ranks; ``--set mesh.sequence_parallel=2`` splits the frames of each row
over the seq ranks (context parallelism; every ``batcher.bucket_frames``
entry must be a multiple of sp).  The processes form a ``torch.distributed`` group (NCCL on the
card, gloo with ``--device cpu``) and rank r trains on
``cuda:{r mod cards}`` (``parallel/``).  NCCL cannot put two ranks of one
group on one card, so a layout with more ranks than cards is refused at
start.  Every process must see the same ``exp_dir`` (a file system shared
by the machines): rank 0 writes the checkpoints and every rank reads them
on resume.  The JAX CLI's
``--prng`` (JAX's PRNG implementations) is not ported; passing it raises.

A resumed run (epoch or mid-epoch) equals an uninterrupted one bit for bit
on the CPU.  On the card it does so only when the caller first sets
``torch.backends.cudnn.deterministic = True``,
``torch.use_deterministic_algorithms(True)`` and ``CUBLAS_WORKSPACE_CONFIG``
(e.g. ``:4096:8``); this CLI sets none of them, because
``nn.Embedding``'s CUDA backward, among others, sums with atomics and the
deterministic implementations are slower.
"""

from __future__ import annotations

import argparse
import logging
import sys


def main(argv=None):
    """Parse ``argv`` and train; returns ``(trainer, final state)``, or
    None with ``--print-config``."""
    parser = argparse.ArgumentParser(description="A3T pretraining (PyTorch)")
    parser.add_argument("--config", default=None)
    parser.add_argument("--print-config", action="store_true",
                        help="print the resolved (or default) config as "
                             "YAML and exit")
    parser.add_argument(
        "--set", action="append", default=[], metavar="KEY=VALUE",
        help="override config entries, e.g. --set optim.lr=0.5")
    parser.add_argument("--log-level", default="INFO")
    parser.add_argument("--detect-anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly: fail at the "
                             "op that produced a NaN (debug only, slow)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda)")
    parser.add_argument("--coordinator", default=None,
                        help="host:port of process 0 (data-parallel only)")
    parser.add_argument("--num-hosts", type=int, default=None,
                        help="number of processes, one per card")
    parser.add_argument("--host-id", type=int, default=None,
                        help="this process's rank")
    parser.add_argument("--prng", default=None, help=argparse.SUPPRESS)
    args = parser.parse_args(argv)
    if args.prng is not None:
        parser.error("--prng is not ported (JAX's PRNG implementations)")
    multihost = (args.coordinator, args.num_hosts, args.host_id)
    if any(v is not None for v in multihost) \
            and any(v is None for v in multihost):
        parser.error("--coordinator, --num-hosts and --host-id go together")

    logging.basicConfig(
        level=getattr(logging, args.log_level.upper()),
        format="%(asctime)s [%(levelname)s] %(name)s: %(message)s")

    from a3t_tpu_torch.tasks.config import (A3TTaskConfig, dump_config,
                                            load_config)
    from a3t_tpu_torch.tasks.mlm import MLMTask

    if args.print_config:
        cfg = (load_config(args.config, args.set) if args.config
               else A3TTaskConfig())
        sys.stdout.write(dump_config(cfg))
        return None
    if args.config is None:
        parser.error("--config is required (or use --print-config)")
    if args.detect_anomaly:
        import torch

        torch.autograd.set_detect_anomaly(True)
    cfg = load_config(args.config, args.set)
    if args.coordinator is None:
        return MLMTask.run(cfg, device=args.device)
    import torch.distributed as dist

    from a3t_tpu_torch.parallel.mesh import initialize_multihost

    initialize_multihost(args.coordinator, args.num_hosts, args.host_id,
                         device=args.device)
    try:
        return MLMTask.run(cfg, device=args.device)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
