#!/usr/bin/env python3
"""Which collectives the card's torch.distributed backends take on CUDA
tensors, and their times at the 24 kHz model's flat-vector size, at the
model axis's activation sizes and at the seq axis's K/V block sizes.

    python3 chip_collectives.py

Two processes on cuda:0 over gloo (NCCL takes one rank per device) try
all_reduce, broadcast, barrier, all_gather, all_gather_into_tensor and
reduce_scatter_tensor on a small tensor, then time all_reduce,
reduce_scatter_tensor and all_gather_into_tensor of 67.7M float32 (271 MB,
the port's ZeRO-1 step; mean of 3 after one warm-up, host clock around
synchronised calls), and all_reduce of the model group's activations, R
rows x L positions x 384 channels (ACTIVATIONS: chip_smoke.py's
tensor-parallel (a), 16 x 264 in float32 and bfloat16, and (d), a data
rank's rows of the trainer's full batches), and all_gather_into_tensor
and reduce_scatter_tensor of the seq axis's K or V blocks, R rows x F / 2
frames x C channels from each of two ranks (KV_BLOCKS: chip_smoke.py's
seq-parallel (a), 16 rows of the 512-frame bucket in float32 and
bfloat16, and (d), the trainer's 73 rows at 1 x 2 x 2, a model rank's 192
channels, and a data rank's 36 rows at 2 x 2 x 1); then one process tries
the same small calls in an NCCL group of one, and with two cards or more
two processes, one a card, time the activations' all_reduce and the K/V
blocks' collectives over NCCL.  Each line names its backend, rank and
collective.
"""

import os
import socket
import sys
import time

N = 67_700_000  # the 24 kHz model's parameters
# (rows, positions, dtype) of the model axis's all-reduces: 384 channels
ACTIVATIONS = ((16, 264, "float32"), (16, 264, "bfloat16"),
               (73, 264, "float32"), (36, 520, "float32"))
# (rows, frames of a rank's block, channels, dtype) of the seq axis's K/V
# all-gathers (and their gradients' reduce-scatters) over two ranks
KV_BLOCKS = ((16, 256, 384, "float32"), (16, 256, 384, "bfloat16"),
             (73, 256, 192, "float32"), (36, 256, 384, "float32"))


def _timed(torch, fn, reps=3):
    """Mean ms of ``fn`` over ``reps`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def _activations(torch, dist, backend, r, dev):
    for rows, length, dt in ACTIVATIONS:
        x = torch.randn(rows, length, 384, device=dev).to(getattr(torch, dt))
        print(f"{backend} rank {r} all_reduce of {rows} x {length} x 384 "
              f"{dt} ({x.numel() * x.element_size() / 1e6:.2f} MB): "
              f"{_timed(torch, lambda: dist.all_reduce(x), reps=10):.3f} ms",
              flush=True)


def _kv_blocks(torch, dist, backend, r, dev, world):
    for rows, frames, ch, dt in KV_BLOCKS:
        x = torch.randn(rows, frames, ch, device=dev).to(getattr(torch, dt))
        whole = torch.empty((world * rows, frames, ch), device=dev,
                            dtype=x.dtype)
        mb = whole.numel() * whole.element_size() / 1e6
        gather = _timed(torch, lambda: dist.all_gather_into_tensor(whole, x),
                        reps=10)
        scatter = _timed(torch, lambda: dist.reduce_scatter_tensor(x, whole),
                         reps=10)
        print(f"{backend} rank {r} K/V block {rows} x {frames} x {ch} {dt} "
              f"over {world} ranks ({mb:.2f} MB gathered): "
              f"all_gather_into_tensor {gather:.3f} ms, "
              f"reduce_scatter_tensor {scatter:.3f} ms", flush=True)


def _work(r, port, backend, world, one_card=True):
    import torch
    import torch.distributed as dist

    card = 0 if one_card else r
    torch.cuda.set_device(card)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=r)
    dev = torch.device("cuda", card)
    if not one_card:
        _activations(torch, dist, backend, r, dev)
        _kv_blocks(torch, dist, backend, r, dev, world)
        dist.destroy_process_group()
        return
    x = torch.arange(6, dtype=torch.float32, device=dev) + r
    tests = [
        ("all_reduce", lambda: dist.all_reduce(x.clone())),
        ("broadcast", lambda: dist.broadcast(x.clone(), 0)),
        ("barrier", dist.barrier),
        ("all_gather", lambda: dist.all_gather(
            [torch.empty_like(x) for _ in range(world)], x)),
        ("all_gather_into_tensor", lambda: dist.all_gather_into_tensor(
            torch.empty(6 * world, device=dev), x)),
        ("reduce_scatter_tensor", lambda: dist.reduce_scatter_tensor(
            torch.empty(6 // world, device=dev), x.clone())),
    ]
    for name, fn in tests:
        try:
            fn()
            torch.cuda.synchronize()
            print(f"{backend} W={world} rank {r} {name}: ok", flush=True)
        except Exception as e:  # report what the backend refuses
            print(f"{backend} W={world} rank {r} {name}: FAIL "
                  f"{type(e).__name__}: {str(e)[:200]}", flush=True)
    if world > 1:
        big = torch.randn(N, device=dev)
        part = torch.empty(N // world, device=dev)
        for name, fn in (
                ("all_reduce", lambda: dist.all_reduce(big)),
                ("reduce_scatter_tensor",
                 lambda: dist.reduce_scatter_tensor(part, big)),
                ("all_gather_into_tensor",
                 lambda: dist.all_gather_into_tensor(big, part))):
            print(f"{backend} rank {r} {name} of {4 * N / 1e6:.1f} MB: "
                  f"{_timed(torch, fn):.1f} ms", flush=True)
        del big, part
        _activations(torch, dist, backend, r, dev)
        _kv_blocks(torch, dist, backend, r, dev, world)
    dist.destroy_process_group()


def _port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main() -> int:
    import torch
    import torch.multiprocessing as mp

    if not torch.cuda.is_available():
        print("chip_collectives: no CUDA device", file=sys.stderr)
        return 1
    print(sys.version.split()[0], torch.__version__, torch.version.cuda,
          torch.cuda.get_device_name(0), flush=True)
    os.system("nvidia-smi --query-gpu=name,power.limit "
              "--format=csv,noheader")
    mp.spawn(_work, args=(_port(), "gloo", 2), nprocs=2)
    mp.spawn(_work, args=(_port(), "nccl", 1), nprocs=1)
    if torch.cuda.device_count() >= 2:
        mp.spawn(_work, args=(_port(), "nccl", 2, False), nprocs=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
