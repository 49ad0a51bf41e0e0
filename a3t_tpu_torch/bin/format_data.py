"""Format a data dir's audio: mono PCM16 wav/flac at the recipe rate (the
port of ``a3t_tpu/bin/format_data.py``).

The reference's recipe stage 2 (egs2/vctk/sedit/mlm.sh:294 ->
egs2/TEMPLATE/tts1/scripts/audio/format_wav_scp.sh) converts and resamples
every source file with sox/flac before feature extraction; this CLI is the
host-side equivalent on scipy polyphase resampling.  It prints a JSON
report (utterances, target fs, sources per fs).  The work is host work;
like every entry point of the port, the CLI refuses to start without a CUDA
card unless ``--device cpu`` is given.

    python -m a3t_tpu_torch.bin.format_data --data-dir data/tr_no_dev \
        --out dump/raw/tr_no_dev --fs 24000 [--audio-format flac]
"""

from __future__ import annotations

import argparse
import json


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--data-dir", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--fs", type=int, required=True)
    ap.add_argument("--expected-source-fs", type=int, default=0,
                    help="error if any source file deviates (0 = any)")
    ap.add_argument("--audio-format", default="wav", choices=["wav", "flac"],
                    help="output container (reference format_wav_scp.sh "
                         "defaults to flac storage)")
    ap.add_argument("--device", default="cuda",
                    help="torch device the run is for (default cuda)")
    args = ap.parse_args(argv)

    from a3t_tpu_torch.data.format_wav import format_data_dir
    from a3t_tpu_torch.device import resolve_device

    resolve_device(args.device)

    report = format_data_dir(
        args.data_dir, args.out, args.fs,
        expected_source_fs=args.expected_source_fs or None,
        audio_format=args.audio_format)
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
