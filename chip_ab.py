#!/usr/bin/env python3
"""Time the serving and train phases of the chip_smoke.py in one checkout,
the longformer step included, for a parent-against-change comparison on one
CUDA card.

    python3 chip_ab.py ROOT TAG

ROOT is a checkout of the port (for the parent, `git archive` of its commit
unpacked into a directory that git ignores); TAG labels every line.  Run it
for parent, change, change, parent in one call on the card, so that both
commits meet the same card and the same host.  It runs ROOT's own
`chip_smoke.slice_phase`, `train_phase` (fp32, then bf16) and
`train_longformer_phase` (the 16 kHz longformer step in bf16 through K3-K5),
with their checks, and prints their timing lines; beside each of the 6 s
request's CUDA-event times it prints the device time per call from
torch.profiler, since at batch 1 the host paces the model forward.
"""

import os
import sys

KEEP = ("median", "breakdown", "busy", "on the device", "in the profiled")


def main() -> int:
    root, tag = os.path.abspath(sys.argv[1]), sys.argv[2]
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("chip_ab: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke
    from a3t_tpu_torch.device import card_label, cuda_ms, wall_time
    from a3t_tpu_torch.ops import banded_attention as ba
    from a3t_tpu_torch.ops import fused_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    chip_smoke.log = lambda msg: (print(f"[{tag}] {msg}", flush=True)
                                  if any(k in msg for k in KEEP) else None)
    # slice_phase times the 6 s request's front-end, model and vocoder, in
    # that order, through the cuda_ms it is given
    parts = iter(["front-end", "model forward", "PWG"])

    def cuda_ms_and_device(fn, iters=20, warmup=3):
        ms = cuda_ms(fn, iters, warmup)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                fn()
            torch.cuda.synchronize()
        dev = sum(e.time_range.end - e.time_range.start for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA) / 5e3
        print(f"[{tag}]   {next(parts, '?')}: events {ms:.3f} ms, device "
              f"activities {dev:.3f} ms per call", flush=True)
        return ms

    label = card_label()
    chip_smoke.slice_phase(torch, np, fa, cuda_ms_and_device, wall_time, label)
    chip_smoke.train_phase(torch, np, fa, wall_time, label)
    chip_smoke.train_phase(torch, np, fa, wall_time, label,
                           compute_dtype="bfloat16")
    chip_smoke.train_longformer_phase(torch, np, ba, wall_time, label)
    return 0


if __name__ == "__main__":
    sys.exit(main())
