#!/usr/bin/env python3
"""Drive the PyTorch port (a3t_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the fused-attention kernel, compiled from csrc/ with nvcc;
3. kernel: the kernel (through its wrapper) against its plain PyTorch
   version on the card, at the slice's shapes, in float32 and bfloat16, with
   and without a padded key tail, out and logsumexp; at dropout rate 0.1
   the keep-masks are read back through one-hot values and must equal the
   plain rule's bit for bit; kernel, plain and library
   (scaled_dot_product_attention) times;
4. slice: the 24 kHz A3T model (d=384, 4+4 Conformer blocks) and the 24 kHz
   ParallelWaveGAN with seeded random weights serve four requests through
   SpeechEditor: the RTF bench's 6 s, 40-phone [MASK] edit of phones 13-27,
   the same at 3 s and 10 s, and one prompt TTS with uniform durations.
   Each is served once to warm up and then 5 times timed; each must give
   finite outputs of the right lengths, launch the kernel 8 times (one per
   attention block) per request and match the plain-attention forward.

It prints the kernel table and the card's name and power limit on lines of
their own, and ends with one JSON line ``{"ok": true, "device": {...}}``.
It exits non-zero on any failure, and when no CUDA device is present.
Float32 products and convolutions run in full float32 (TF32 off).
"""

import json
import os
import sys
import time

T0 = time.perf_counter()


def log(msg: str) -> None:
    print(f"[{time.perf_counter() - T0:8.2f} s] {msg}", flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t = time.perf_counter()
        log(f"phase {self.name}: start")
        return self

    def __exit__(self, exc_type, exc, tb):
        status = "ok" if exc_type is None else f"FAILED ({exc_type.__name__})"
        log(f"phase {self.name}: {status} in "
            f"{time.perf_counter() - self.t:.2f} s")
        return False


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


# fp32: the kernel and the plain version sum the same fp32 products in another
# order (tiles of 32 keys, online rescaling); errors are ~1e-6 of O(1) values.
TOL_F32 = 1e-4
# bf16: both accumulate in fp32 and round the output once to bf16, whose
# spacing is 2^-7 relative (0.0156 at 2..4); allow about one ulp at |out| < 4.
TOL_BF16 = 2e-2
# model forward, flash vs plain attention, fp32: kernel differences of ~1e-6
# pass through 8 blocks and the postnet; outputs are O(1..10) log-mel values.
TOL_MODEL = 1e-3
# timed runs of each request, after one untimed warm-up run
REPEATS = 5

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32, tensor bf16


def attention_bound_ms(b, h, l, d, dtype_name: str):
    """(least ms, what bounds it) for one fused-attention forward."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = 4 * b * h * l * d * esize + b * h * l * l * esize + b * l * 4 \
        + b * h * l * 4
    flops = 4.0 * b * h * l * l * d
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch, fa, cuda_ms):
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    worst = {}
    # the four requests' shapes (L = 552, 296, 872, 696) and a batch of two
    for (b, h, l, d) in ((1, 2, 552, 192), (1, 2, 296, 192), (1, 2, 872, 192),
                         (1, 2, 696, 192), (2, 2, 320, 192)):
        for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
            for pad in (False, True):
                q, k, v = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                           for _ in range(3))
                bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
                mask = torch.ones(b, l, dtype=torch.bool)
                if pad:
                    mask[-1, l - l // 5:] = False
                mask = mask.to(dev)
                for rate in (0.0, 0.1):
                    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask,
                                                      1234, rate)
                    ref, ref_lse = fa.fused_attention_reference(
                        q, k, v, bias, mask, 1234, rate)
                    torch.cuda.synchronize()
                    err = (out.float() - ref.float()).abs().max().item()
                    lerr = (lse - ref_lse).abs().max().item()
                    log(f"  K1 {(b, h, l, d)} {str(dt)[6:]} pad={pad} "
                        f"rate={rate}: max|out-plain| {err:.3g}, "
                        f"max|lse-plain| {lerr:.3g} (tol {tol:g})")
                    check(err <= tol and lerr <= tol,
                          f"K1 {(b, h, l, d)} {dt} pad={pad} rate={rate}")
                    key = (b, h, l, d, str(dt)[6:])
                    worst[key] = max(worst.get(key, 0.0), err)

    # dropout keep-masks read back from the kernel: q = k = 0 and bias = 0
    # make p uniform over valid keys, and v = one-hot columns c0..c0+d-1
    # give out[r, j] = keep[r, c0 + j] / (n_valid (1 - rate)), nonzero iff kept
    b, h, l, d = 1, 2, 552, 192
    for dt in (torch.float32, torch.bfloat16):
        zeros = torch.zeros(b, h, l, d, device=dev, dtype=dt)
        bias = torch.zeros(b, h, l, l, device=dev, dtype=dt)
        mask = torch.ones(b, l, dtype=torch.bool, device=dev)
        mask[0, l - 40:] = False
        got = torch.zeros(b, h, l, l, dtype=torch.bool, device=dev)
        for c0 in range(0, l, d):
            v = torch.zeros(b, h, l, d, device=dev, dtype=dt)
            n = min(d, l - c0)
            v[:, :, c0 + torch.arange(n), torch.arange(n)] = 1
            out, _ = fa.fused_attention_fwd(zeros, zeros, v, bias, mask,
                                            987654321, 0.1)
            got[..., c0:c0 + n] = out[..., :n] != 0
        want = fa.keep_mask(b, h, l, 987654321, 0.1, device=dev) \
            & mask.view(b, 1, 1, l)
        n_diff = int((got != want).sum())
        log(f"  K1 dropout keep-mask {str(dt)[6:]}: {n_diff} of {got.numel()} "
            f"bits differ, keep share {want.float().mean().item():.4f}")
        check(n_diff == 0, f"K1 dropout mask bits ({dt})")

    # times at the requests' shapes in float32, which the slice runs, and at
    # the 6 s request's shape in bfloat16
    rows = {}
    for l, dt in ((552, torch.float32), (552, torch.bfloat16),
                  (296, torch.float32), (696, torch.float32),
                  (872, torch.float32)):
        name = str(dt)[6:]
        q, k, v = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                   for _ in range(3))
        bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
        mask = torch.ones(b, l, dtype=torch.bool, device=dev)
        scale = float(1.0 / d ** 0.5)
        attn_mask = (bias * scale).masked_fill(~mask.view(b, 1, 1, l),
                                               float("-inf"))
        sdpa = torch.nn.functional.scaled_dot_product_attention
        def kernel():
            return fa.fused_attention_fwd(q, k, v, bias, mask, 0, 0.0)[0]

        # in turns: kernel, plain, library, kernel
        t_kernel = cuda_ms(kernel)
        t_plain = cuda_ms(lambda: fa.fused_attention_reference(
            q, k, v, bias, mask, 0, 0.0))
        t_lib = cuda_ms(lambda: sdpa(q, k, v, attn_mask=attn_mask))
        t_kernel2 = cuda_ms(kernel)
        lib_err = (sdpa(q, k, v, attn_mask=attn_mask).float()
                   - kernel().float()).abs().max().item()
        bound, by = attention_bound_ms(b, h, l, d, name)
        log(f"  K1 times {(b, h, l, d)} {name}: kernel {t_kernel:.4f} / "
            f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms "
            f"(max|sdpa-kernel| {lib_err:.3g}), bound {bound:.5f} ms ({by})")
        rows[(l, name)] = dict(ms=t_kernel, plain_ms=t_plain,
                               library_ms=t_lib, bound_ms=bound, bound_by=by,
                               max_abs_err=worst[(b, h, l, d, name)])
    return rows[(552, "float32")]


def make_request(np, fs: int, secs: float, n_phones: int = 40):
    """The RTF bench's utterance: a 180 Hz tone with evenly aligned phones."""
    from a3t_tpu_torch.inference import UtteranceAlignment

    n = int(secs * fs)
    wav = (0.3 * np.sin(2 * np.pi * 180 * np.arange(n) / fs)).astype(np.float32)
    bounds = np.linspace(0, secs, n_phones + 1)
    phones = [f"P{i % 20}" for i in range(n_phones)]
    align = UtteranceAlignment(
        phones, bounds[:-1].astype(np.float32), bounds[1:].astype(np.float32),
        {f"{i}_{p.upper()}": [p] for i, p in enumerate(phones)})
    return wav, phones, align


def slice_phase(torch, np, fa, cuda_ms, wall_time, label, device="cuda"):
    from a3t_tpu_torch.inference import SpeechEditor
    from a3t_tpu_torch.models import build_model, build_vocoder
    from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention
    from a3t_tpu_torch.tasks.config import (FRONTEND_24K, PWG_24K,
                                            a3t_conformer_24k)
    from a3t_tpu_torch.text import TokenIDConverter

    fs, hop = FRONTEND_24K.fs, FRONTEND_24K.hop_length
    model = build_model(a3t_conformer_24k(vocab_size=80), device=device, seed=0)
    pwg = build_vocoder(PWG_24K, device=device, seed=1)
    noise = torch.Generator(device=device)
    vocoder = lambda mel: pwg(mel, generator=noise.manual_seed(3))  # noqa: E731
    attn = [m for m in model.modules()
            if isinstance(m, RelPositionMultiHeadedAttention)]
    check(len(attn) == 8, "8 attention blocks")

    phone_set = [f"P{i}" for i in range(20)]
    conv = TokenIDConverter(["<blank>", "<unk>"] + sorted(phone_set)
                            + ["<sos/eos>"])
    lexicon = {p.upper(): [p] for p in phone_set}
    editor = SpeechEditor(model, FRONTEND_24K, conv, vocoder=vocoder,
                          duration_fn=lambda ph, w: [0.1] * len(ph),
                          lexicon=lexicon, device=device)

    requests = []
    for secs in (6.0, 3.0, 10.0):
        wav, phones, align = make_request(np, fs, secs)
        words = " ".join(phones)
        masked = " ".join(phones[:13] + ["[MASK]"] + phones[27:])
        requests.append((f"edit_{secs:g}s", secs, "mask", wav, align, words,
                         masked))
    wav, phones, align = make_request(np, fs, 6.0)
    words = " ".join(phones)
    cont = " ".join(f"P{(7 * i) % 20}" for i in range(12))
    requests.append(("prompt_tts_6s+12ph", 6.0, "prompt", wav, align, words,
                     words + " " + cont))

    def serve(kind, wav, align, old, new):
        if kind == "mask":
            return editor.reconstruct_masked_span(wav, align, old, new)
        return editor.prompt_tts(wav, align, old, new)

    # one untimed pass brings cuFFT plans and cuDNN algorithms in
    for name, secs, kind, wav, align, old, new in requests:
        serve(kind, wav, align, old, new)

    fa.reset_launches()
    for name, secs, kind, wav, align, old, new in requests:
        walls = []
        for _ in range(REPEATS):
            before = fa.LAUNCHES
            res, dt = wall_time(serve, kind, wav, align, old, new)
            launched = fa.LAUNCHES - before
            check(launched == 8,
                  f"{name}: {launched} kernel launches, expected 8")
            walls.append(dt)
        n_f = 1 + len(wav) // hop
        if kind == "mask":
            mel, out_wav = res.mel_edited, res.origin_replaced
            check(mel.shape == (n_f, 80), f"{name}: mel shape {mel.shape}")
            check(res.prediction.shape == (n_f * hop,),
                  f"{name}: vocoded length {res.prediction.shape}")
            check(out_wav.shape == wav.shape, f"{name}: spliced length")
            audio_secs = secs
            spans = res.new_span_boundary
        else:
            mel, out_wav = res["mel"], res["full"]
            spans = res["span_boundary"]
            check(mel.shape[1] == 80 and mel.shape[0] > n_f,
                  f"{name}: mel shape {mel.shape}")
            audio_secs = len(out_wav) / fs
            check(len(out_wav) > len(wav), f"{name}: output length")
        check(bool(np.isfinite(mel).all() and np.isfinite(out_wav).all()),
              f"{name}: finite outputs")
        med = float(np.median(walls))
        log(f"  {name}: median {med * 1e3:.2f} ms wall (min "
            f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}, n={REPEATS})"
            f" for {audio_secs:.3f} s audio, RTF {med / audio_secs:.5f}, "
            f"8 kernel launches per request, span {spans}, mel {mel.shape} "
            f"[{label}]")
    launches = fa.LAUNCHES
    check(launches == 8 * REPEATS * len(requests),
          f"{launches} launches in all")

    # each request's forward against the plain-attention forward, on the
    # request's own inputs (these launches are outside the counted run)
    for name, secs, kind, wav, align, old, new in requests:
        tl = editor._new_timeline(wav, align, old, new,
                                  mask_reconstruct=kind == "mask")
        new_wav, phones, n_start, n_end, _, new_b = tl
        inputs = editor.build_inputs(new_wav, phones, n_start, n_end, new_b)
        with torch.inference_mode():
            flash = model(**inputs)
            for m in attn:
                m.use_flash = False
            plain = model(**inputs)
            for m in attn:
                m.use_flash = True
        errs = [(a - b).abs().max().item() for a, b in zip(flash, plain)]
        length = inputs["speech"].shape[1] + inputs["text"].shape[1]
        log(f"  {name}: L={length}, max|flash-plain| before {errs[0]:.3g}, "
            f"after {errs[1]:.3g} (tol {TOL_MODEL:g})")
        check(max(errs) <= TOL_MODEL, f"{name}: flash vs plain forward")

    # where a request's time goes, at the 6 s request
    name, secs, kind, wav, align, old, new = requests[0]
    tl = editor._new_timeline(wav, align, old, new, mask_reconstruct=True)
    inputs = editor.build_inputs(tl[0], tl[1], tl[2], tl[3], tl[5])
    audio = torch.zeros(1, (inputs["speech"].shape[1] - 1) * hop, device=device)
    mel = inputs["speech"][:, : 1 + len(wav) // hop]
    with torch.inference_mode():
        t_fe = cuda_ms(lambda: editor.fe(audio, [len(wav)]), iters=10)
        t_model = cuda_ms(lambda: model(**inputs), iters=10)
        t_voc = cuda_ms(lambda: vocoder(mel), iters=5)
    log(f"  6 s request breakdown (CUDA events): front-end {t_fe:.3f} ms, "
        f"model forward {t_model:.3f} ms, PWG {t_voc:.3f} ms [{label}]")
    return launches


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from a3t_tpu_torch.device import card_label, cuda_ms, wall_time
    from a3t_tpu_torch.ops import fused_attention as fa
    from a3t_tpu_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        label = card_label()
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s): {kind}; nvidia-smi: {label}")

    with Phase("build"):
        fa._entry()
        for line in native.build_logs.get("fused_attention", "").splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas: {line.strip()}")

    with Phase("kernel"):
        f32 = kernel_phase(torch, fa, cuda_ms)

    with Phase("slice"):
        launches = slice_phase(torch, np, fa, cuda_ms, wall_time, label)

    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "a3t_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "a3t_tpu/ops/fused_attention.py:92",
        "launches": launches,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }]
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
