#!/usr/bin/env python3
"""Drive the PyTorch port (a3t_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the fused-attention kernels K1 (forward) and K2 (backward),
   compiled from csrc/ with one nvcc each, started together; their ptxas
   registers and spills;
3. kernel: K1 (through its wrapper) against its plain PyTorch version on
   the card, at the slice's shapes, in float32 and bfloat16, with and
   without a padded key tail, out and logsumexp; at dropout rate 0.1 the
   keep-masks are read back through one-hot values and must equal the plain
   rule's bit for bit; kernel, plain and library
   (scaled_dot_product_attention) times, at the serving shapes and at the
   training shape;
4. kernel-bwd: K2, run through FusedAttention.backward, against the plain
   backward (dq, dk, dv, dbias) at the training shape (88, 2, 496, 192) and
   a serving shape, in float32 and bfloat16, at dropout 0 and 0.2, with and
   without a padded key tail; kernel, plain and library (autograd through
   scaled_dot_product_attention with a float mask that takes a gradient)
   times and K2's bound;
5. slice: the 24 kHz A3T model (d=384, 4+4 Conformer blocks) and the 24 kHz
   ParallelWaveGAN with seeded random weights serve four requests through
   SpeechEditor: the RTF bench's 6 s, 40-phone [MASK] edit of phones 13-27,
   the same at 3 s and 10 s, and one prompt TTS with uniform durations.
   Each is served once to warm up and then 5 times timed; each must give
   finite outputs of the right lengths, launch K1 8 times (one per
   attention block) per request and match the plain-attention forward;
6. train: the same model at full width trains through create_train_state ->
   make_train_step -> step on the JAX bench's batch (88 utterances of 432
   frames, 64 phones, vocabulary 80, make_synthetic_batch(default_rng(0)))
   with the yaml's optimizer.  One step at dropout 0 through K1/K2 must
   match the same step through the plain attention branch; then, with the
   yaml's dropout rates, 2 warm-up and 5 timed steps, each with a finite
   loss and grad_norm, no skipped update, and 8 launches of K1 and of K2;
   the median step time, mel-frames/s, peak memory and a CUDA-event split
   into forward, backward and optimizer.

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
# K2 against the plain backward, relative to each gradient's largest |value|:
# fp32 sums the same products in another order (and dq by atomics, in a
# run-dependent order), ~1e-6; bf16 rounds each output once to bf16 (2^-8
# relative) and reads inputs rounded to bf16 on both sides.
TOL_BWD_F32 = 1e-4
TOL_BWD_BF16 = 2e-2
# one train step at dropout 0, K1/K2 against the plain attention branch,
# fp32: the loss and the gradients differ only by the kernels' summation
# order (~1e-6 relative per block).  After Adam's first step a parameter
# moves by +-lr_0 = 384^-0.5 * 4000^-1.5 = 2.0e-7 whatever its gradient's
# size, so a gradient that is rounding noise in both (e.g. the key bias,
# which softmax ignores) can move one way in one and the other way in the
# other: the parameters are held within 5 lr_0.
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD_NORM = 1e-4
TOL_STEP_PARAMS = 1e-6
# timed runs of each request, after one untimed warm-up run
REPEATS = 5

H100_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}  # CUDA-core fp32, tensor bf16


def _bound(nbytes, flops, dtype_name: str):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype_name] * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def attention_bound_ms(b, h, l, d, dtype_name: str):
    """(least ms, what bounds it) for one fused-attention forward (K1):
    q, k, v, out and the bias once, mask and lse; two products of
    2 L^2 d per (b, h)."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = 4 * b * h * l * d * esize + b * h * l * l * esize + b * l * 4 \
        + b * h * l * 4
    return _bound(nbytes, 4.0 * b * h * l * l * d, dtype_name)


def attention_bwd_bound_ms(b, h, l, d, dtype_name: str):
    """(least ms, what bounds it) for one fused-attention backward (K2):
    q, k, v, g, out read and dq, dk, dv written, the bias read and dbias
    written, mask, lse and delta; five products of 2 L^2 d per (b, h)."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = 8 * b * h * l * d * esize + 2 * b * h * l * l * esize \
        + b * l * 4 + 2 * b * h * l * 4
    return _bound(nbytes, 10.0 * b * h * l * l * d, dtype_name)


def kernel_phase(torch, fa, cuda_ms):
    g = torch.Generator().manual_seed(0)
    dev = torch.device("cuda")
    worst = {}
    # the four requests' shapes (L = 552, 296, 872, 696), a batch of two and
    # the training shape (88 utterances of 432 frames + 64 phones)
    for (b, h, l, d) in ((1, 2, 552, 192), (1, 2, 296, 192), (1, 2, 872, 192),
                         (1, 2, 696, 192), (2, 2, 320, 192),
                         (88, 2, 496, 192)):
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
    for b, l, dt in ((1, 552, torch.float32), (1, 552, torch.bfloat16),
                     (1, 296, torch.float32), (1, 696, torch.float32),
                     (1, 872, torch.float32), (88, 496, torch.float32)):
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
        rows[(b, l, name)] = dict(ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=bound,
                                  bound_by=by,
                                  max_abs_err=worst[(b, h, l, d, name)])
    return rows[(1, 552, "float32")], rows[(88, 496, "float32")]


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def kernel_bwd_phase(torch, fa, cuda_ms):
    """K2 through FusedAttention.backward against the plain backward; its
    times at the training shape beside the plain version's and SDPA's."""
    g = torch.Generator().manual_seed(1)
    dev = torch.device("cuda")
    worst = {}
    for (b, h, l, d) in ((88, 2, 496, 192), (1, 2, 552, 192)):
        for dt, tol in ((torch.float32, TOL_BWD_F32),
                        (torch.bfloat16, TOL_BWD_BF16)):
            for pad in (False, True):
                for rate in (0.0, 0.2):
                    q, k, v, go = (torch.randn(b, h, l, d, generator=g).to(
                        dev, dt) for _ in range(4))
                    bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
                    mask = torch.ones(b, l, dtype=torch.bool)
                    if pad:
                        mask[-1, l - l // 5:] = False
                    mask = mask.to(dev)
                    ins = [t.requires_grad_() for t in (q, k, v, bias)]
                    out = fa.fused_attention(*ins, mask, rate, 4321)
                    got = torch.autograd.grad(out, ins, go)
                    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask,
                                                      4321, rate)
                    want = fa.fused_attention_bwd_reference(
                        q.detach(), k.detach(), v.detach(), bias.detach(),
                        mask, 4321, rate, out, lse, go)
                    torch.cuda.synchronize()
                    errs = [_rel_err(a, w) for a, w in zip(got, want)]
                    log(f"  K2 {(b, h, l, d)} {str(dt)[6:]} pad={pad} "
                        f"rate={rate}: max|grad-plain|/max|plain| dq "
                        f"{errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, "
                        f"dbias {errs[3]:.3g} (tol {tol:g})")
                    check(all(a.dtype == w.dtype for a, w in zip(got, want))
                          and max(errs) <= tol,
                          f"K2 {(b, h, l, d)} {dt} pad={pad} rate={rate}")
                    key = (b, h, l, d, str(dt)[6:])
                    worst[key] = max(worst.get(key, 0.0), max(
                        (a.float() - w.float()).abs().max().item()
                        for a, w in zip(got, want)))
                    del q, k, v, go, bias, ins, out, lse, got, want

    # times at the training shape, fp32 as the slice runs it, and bf16
    rows = {}
    b, h, l, d = 88, 2, 496, 192
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        q, k, v, go = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                       for _ in range(4))
        bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
        mask = torch.ones(b, l, dtype=torch.bool, device=dev)
        out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 0, 0.0)
        sdpa = torch.nn.functional.scaled_dot_product_attention
        qs, ks, vs = (t.clone().requires_grad_() for t in (q, k, v))
        am = (bias * float(1.0 / d ** 0.5)).requires_grad_()
        lib_out = sdpa(qs, ks, vs, attn_mask=am)

        def kernel():
            return fa.fused_attention_bwd(q, k, v, bias, mask, 0, 0.0, out,
                                          lse, go)

        # in turns: kernel, plain, library, kernel
        t_kernel = cuda_ms(kernel, iters=10)
        t_plain = cuda_ms(lambda: fa.fused_attention_bwd_reference(
            q, k, v, bias, mask, 0, 0.0, out, lse, go), iters=5, warmup=1)
        t_lib = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qs, ks, vs, am), go, retain_graph=True), iters=10)
        t_kernel2 = cuda_ms(kernel, iters=10)
        bound, by = attention_bwd_bound_ms(b, h, l, d, name)
        log(f"  K2 times {(b, h, l, d)} {name}: kernel {t_kernel:.4f} / "
            f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, sdpa backward "
            f"{t_lib:.4f} ms, bound {bound:.5f} ms ({by})")
        rows[name] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=worst[(b, h, l, d, name)])
        del q, k, v, go, bias, out, lse, qs, ks, vs, am, lib_out
    return rows["float32"]


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


def train_phase(torch, np, fa, wall_time, label, device="cuda"):
    """make_train_step at full width on the JAX bench's batch."""
    import copy
    import dataclasses

    from a3t_tpu_torch.data import make_synthetic_batch
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention
    from a3t_tpu_torch.models.mlm import mlm_loss
    from a3t_tpu_torch.tasks.config import (FRONTEND_24K, OPTIM_24K,
                                            a3t_conformer_24k)
    from a3t_tpu_torch.train import (create_train_state, featurize,
                                     make_optimizer, make_train_step)

    b_size, n_frames, n_text = 88, 432, 64
    batch = make_synthetic_batch(
        np.random.default_rng(0), batch_size=b_size,
        n_samples=FRONTEND_24K.hop_length * (n_frames - 1), n_text=n_text,
        hop_length=FRONTEND_24K.hop_length, vocab_size=80)
    # on the card once, as the JAX bench moves its batch before the loop
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    fe = LogMelFrontend(FRONTEND_24K, device=device)
    cfg = a3t_conformer_24k(vocab_size=80)

    # one step at dropout 0: K1/K2 against the plain attention branch
    def no_dropout(e):
        return dataclasses.replace(e, dropout_rate=0.0,
                                   positional_dropout_rate=0.0,
                                   attention_dropout_rate=0.0)

    cfg0 = dataclasses.replace(cfg, encoder=no_dropout(cfg.encoder),
                               decoder=no_dropout(cfg.decoder))
    flash = build_model(cfg0, device=device, seed=0)
    flash.postnet.dropout.rate = 0.0
    plain = copy.deepcopy(flash)
    for m in plain.modules():
        if isinstance(m, RelPositionMultiHeadedAttention):
            m.use_flash = False
    results = []
    for model in (flash, plain):
        state = create_train_state(model, make_optimizer(OPTIM_24K),
                                   device=device)
        fa.reset_launches()
        state, stats = make_train_step(model, fe, device=device)(
            state, batch, 0)
        torch.cuda.synchronize()
        results.append((float(stats["loss"]), float(stats["grad_norm"]),
                        (fa.LAUNCHES, fa.LAUNCHES_BWD)))
    (lk, gk, nk), (lp, gp, np_) = results
    dparam = max((a - b).abs().max().item() for a, b in
                 zip(flash.parameters(), plain.parameters()))
    dstats = max((a - b).abs().max().item() for a, b in
                 zip(flash.buffers(), plain.buffers()) if a.is_floating_point())
    log(f"  step at dropout 0, kernels vs plain attention: loss {lk:.7g} vs "
        f"{lp:.7g} (rel {abs(lk - lp) / abs(lp):.3g}, tol "
        f"{TOL_STEP_LOSS:g}), grad_norm {gk:.7g} vs {gp:.7g} (rel "
        f"{abs(gk - gp) / gp:.3g}, tol {TOL_STEP_GRAD_NORM:g}), "
        f"max|params| diff {dparam:.3g} (tol {TOL_STEP_PARAMS:g}), "
        f"max|BatchNorm stats| diff {dstats:.3g}; launches K1/K2 {nk} vs "
        f"{np_}")
    check(nk == (8, 8) and np_ == (0, 0), "launches of the compared steps")
    check(abs(lk - lp) <= TOL_STEP_LOSS * abs(lp), "kernel vs plain loss")
    check(abs(gk - gp) <= TOL_STEP_GRAD_NORM * gp,
          "kernel vs plain grad_norm")
    check(dparam <= TOL_STEP_PARAMS and dstats <= TOL_STEP_PARAMS,
          "kernel vs plain updated parameters")
    del flash, plain, model, state, stats
    torch.cuda.empty_cache()

    # the yaml's dropout rates: 2 warm-up and 5 timed steps
    model = build_model(cfg, device=device, seed=0)
    state = create_train_state(model, make_optimizer(OPTIM_24K),
                               device=device)
    step = make_train_step(model, fe, device=device)
    gen = torch.Generator().manual_seed(0)
    walls, launches = [], (0, 0)
    fa.reset_launches()
    for i in range(2 + REPEATS):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        before = (fa.LAUNCHES, fa.LAUNCHES_BWD)
        (state, stats), dt = wall_time(step, state, batch, gen)
        n = (fa.LAUNCHES - before[0], fa.LAUNCHES_BWD - before[1])
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        skipped = int(stats["notfinite_count"])
        log(f"  train step {i} ({'warm-up' if i < 2 else 'timed'}): "
            f"{dt * 1e3:.2f} ms wall, loss {loss:.6g}, grad_norm "
            f"{gnorm:.6g}, notfinite_count {skipped}, launches K1 {n[0]} "
            f"K2 {n[1]}")
        check(np.isfinite(loss) and np.isfinite(gnorm) and skipped == 0,
              f"train step {i}: finite loss and grad_norm, no skip")
        check(n == (8, 8), f"train step {i}: {n} launches, expected 8 and 8")
        if i >= 2:
            walls.append(dt)
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(walls))
    frames = b_size * n_frames
    log(f"  train: median {med * 1e3:.2f} ms per step (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}, n={REPEATS}), "
        f"{frames / med:.1f} mel-frames/s (B*F = {frames}), peak memory "
        f"{peak / 2**30:.2f} GiB [{label}]")

    # where a step's time goes, by CUDA events around the step's parts
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    m = state.model
    m.train()
    ev[0].record()
    mb = featurize(fe, batch)
    before, after = m(**mb, generator=gen)
    loss = mlm_loss(before, after, mb["speech"], mb["masked_position"])
    ev[1].record()
    grads = torch.autograd.grad(loss, state.params)
    ev[2].record()
    state.apply_gradients(grads)
    ev[3].record()
    torch.cuda.synchronize()
    t_fwd, t_bwd, t_opt = (ev[i].elapsed_time(ev[i + 1]) for i in range(3))
    log(f"  train step breakdown (CUDA events): front-end + forward + loss "
        f"{t_fwd:.2f} ms, backward {t_bwd:.2f} ms, optimizer {t_opt:.2f} ms "
        f"[{label}]")

    # one more step under torch.profiler: the device's busy share over the
    # step and the kernels that take its time
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        log("  train step profile: the profiler saw no device activity; "
            "busy share not measured")
        return launches, dict(step_ms=med * 1e3)
    busy, end, by_name = 0.0, spans[0][0], {}
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0)
    window = end - spans[0][0]
    log(f"  train step profile: device busy {busy / 1e3:.2f} ms of "
        f"{window / 1e3:.2f} ms from first to last device activity "
        f"(busy share {busy / window:.4f}), {len(spans)} device activities "
        f"[{label}]")
    for name, us in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        log(f"    {us / 1e3:9.3f} ms  {name[:100]}")
    k1, k2 = (sum(us for name, us in by_name.items() if tag in name) / 1e3
              for tag in ("fused_attention_fwd_kernel",
                          "fused_attention_bwd_kernel"))
    log(f"  in the profiled step: K1 {k1:.2f} ms, K2 {k2:.2f} ms")
    return launches, dict(step_ms=med * 1e3)


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
        native.build_all(fa.LIBRARIES)
        fa._entry()
        fa._entry_bwd()
        for name in fa.LIBRARIES:
            for line in native.build_logs.get(name, "").splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")

    with Phase("kernel"):
        f32, f32_train = kernel_phase(torch, fa, cuda_ms)

    with Phase("kernel-bwd"):
        bwd = kernel_bwd_phase(torch, fa, cuda_ms)

    with Phase("slice"):
        serve_launches = slice_phase(torch, np, fa, cuda_ms, wall_time, label)

    with Phase("train"):
        (train_fwd, train_bwd), split = train_phase(
            torch, np, fa, wall_time, label)
    log(f"  K1 alone at the training shape {f32_train['ms']:.4f} ms x 8 = "
        f"{8 * f32_train['ms']:.2f} ms, K2 {bwd['ms']:.4f} ms x 8 = "
        f"{8 * bwd['ms']:.2f} ms, per step of {split['step_ms']:.2f} ms "
        f"[{label}]")

    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "a3t_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "a3t_tpu/ops/fused_attention.py:92",
        "launches": serve_launches + train_fwd,
        "max_abs_err": f32["max_abs_err"],
        "ms": f32["ms"],
        "plain_ms": f32["plain_ms"],
        "bound_ms": f32["bound_ms"],
        "bound_by": f32["bound_by"],
        "library_ms": f32["library_ms"],
    }, {
        "name": "fused_attention_bwd",
        "route": "cuda",
        "source": "a3t_tpu_torch/csrc/fused_attention_bwd.cu",
        "replaces": "a3t_tpu/ops/fused_attention.py:135",
        "launches": train_bwd,
        "max_abs_err": bwd["max_abs_err"],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
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
