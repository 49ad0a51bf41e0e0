#!/usr/bin/env python3
"""Drive the PyTorch port (a3t_tpu_torch) end to end on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --model-options   # the build and phase 18 alone

Phases, each printing its elapsed seconds:

1. device: the card's name and power limit (nvidia-smi);
2. build: the six kernels' libraries, compiled from csrc/ with one nvcc
   each, all started together: the fused-attention kernels K1 (forward) and
   K2 (backward), the banded-attention kernels K3, K4 and K5, and the fused
   log-mel kernel K6; their ptxas registers and spills; the tensor-core
   (HGMMA) instructions of each K1, K2, K3, K4 and K5 function in the
   compiled code (cuobjdump -sass): every bf16 function must have some and
   no fp32 function any (full fp32, no TF32); beside them, the native WAV
   loader (native/loader) with the host C++ compiler;
3. kernel: K1 (through its wrapper) against its plain PyTorch version on
   the card, at the slice's shapes, in float32 and bfloat16, with and
   without a padded key tail, out and logsumexp; at dropout rate 0.1 the
   keep-masks are read back through one-hot values and must equal the plain
   rule's bit for bit; two runs at a key-split serving shape must agree bit
   for bit, and an utterance whose every key is masked must match the plain
   version through the key split; kernel, plain and library (scaled_dot_product_attention) times,
   at the serving shapes and at the training shape in float32 and bfloat16;
4. kernel-bwd: K2, run through FusedAttention.backward, against the plain
   backward (dq, dk, dv, dbias) at the training shape (88, 2, 496, 192) and
   a serving shape, in float32 and bfloat16, at dropout 0 and 0.2, with and
   without a padded key tail, and with an utterance whose every key is
   masked (its gradients all 0); two runs at the training shape in each dtype,
   at dropout 0 and 0.2, must give dq, dk, dv and dbias equal bit for bit;
   kernel, plain and library (autograd through scaled_dot_product_attention
   with a float mask that takes a gradient) times and K2's bound;
5. kernel-banded: the banded-attention kernels K3 (forward), K4 (dq and the
   text keys' gradients) and K5 (dk, dv) against their plain versions at the
   longformer training shape (4, 2, 8192, 192) with window 512, as the
   encoder calls them (64 text keys) and as the speech-only pre-encoder does
   (ragged lengths, so fully masked rows), at a smaller speech-only shape and
   a small ragged one, float32 and bfloat16, dropout 0 and 0.2, the errors on
   fully masked rows and padded keys bounded apart from the others; K3's
   keep-masks read back through one-hot values; two runs of K3 (out, lse),
   K4 (dq, dk_text, dv_text) and K5 (dk, dv) at the training shape in each
   dtype, at dropout 0 and 0.2, equal bit for bit; kernel, plain and library
   (SDPA over a dense boolean band mask) times and the bounds, and the
   kernels' times at dropout 0.2;
6. kernel-logmel: K6 (through its wrapper) against its plain version at the
   JAX bench's batch (88 x 129,300 samples at 24 kHz, 432 frames, ragged),
   bench_kernels.py's frontend_b32_10s (32 x 240,000 samples, 801 frames),
   the longformer batch (4 x 1,638,200 samples at 16 kHz, 8192 frames), a
   small odd case (8 kHz, n_fft 256, 38 frames) and a non-power-of-two
   n_fft (16 kHz, n_fft 400, 8 x 5 s, the direct-DFT route), each with and
   without sample_lengths: features within 1e-4, tails exactly 0, frame
   lengths equal, two runs equal bit for bit; kernel, plain, library (the
   rfft front-end) and matmul-DFT front-end times beside the bound;
7. slice: the 24 kHz A3T model (d=384, 4+4 Conformer blocks) and the 24 kHz
   ParallelWaveGAN with seeded random weights serve four requests through
   SpeechEditor: the RTF bench's 6 s, 40-phone [MASK] edit of phones 13-27,
   the same at 3 s and 10 s, and one prompt TTS with uniform durations.
   Each is served once to warm up and then 5 times timed; each must give
   finite outputs of the right lengths, launch K1 8 times (one per
   attention block) per request and match the plain-attention forward;
8. frontend: featurize(use_pallas=True), K6's one entry point, against
   featurize() (the matmul-DFT front-end) on the bench and longformer
   batches, with a GlobalMVN normalizer from collect_stats over the bench
   batch's utterances, and with int16 audio served through corpus +
   audio_offset; every key equal (speech within 1e-4), one K6 launch per
   call;
9. train: the same model at full width trains through create_train_state ->
   make_train_step -> step (the matmul-DFT front-end, JAX's default) on the
   JAX bench's batch (88 utterances of 432 frames, 64 phones, vocabulary 80,
   make_synthetic_batch(default_rng(0))) with the yaml's optimizer, in
   float32.  One step at dropout 0 through K1/K2 must match the same step
   through the plain attention branch; then, with the yaml's dropout rates,
   2 warm-up and 5 timed steps, each with a finite loss and grad_norm, no
   skipped update, and 8 launches of K1 and of K2; the median step time,
   mel-frames/s, peak memory, a CUDA-event split into front-end, forward,
   backward and optimizer, and one step under torch.profiler;
10. train-bf16: the same in bfloat16 compute on encoder and decoder, the
   JAX bench's own step (bench.py:79-124);
11. train-longformer: configs/a3t_longformer_16k.yaml at full width and depth
   (2 pre-encoder + 4 encoder blocks, bf16) through make_train_step on its
   largest bucket, 4 utterances of 8192 frames at 16 kHz with 64 phones.
   One step at dropout 0 through K3/K4/K5 must match the same step through
   their plain versions, and so must the gradients of the dropout-0 loss,
   leaf by leaf, on this batch and on full-length utterances (no padded
   rows), in bf16 and float32; then, with the yaml's dropout rates, 2
   warm-up and 5 timed steps, each finite, not skipped, with 6 launches of
   each of K3, K4 and K5; the median step time, mel-frames/s, peak memory, a
   CUDA-event split and one step under torch.profiler;
12. trainer: configs/a3t_conformer_24k.yaml, unedited, through
   a3t_tpu_torch.bin.train.main on a generated 24 kHz corpus (600 training
   utterances generated in six processes, of which it keeps two whole
   batches of each of the yaml's first two buckets, 292 at 256 frames and
   146 at 512, and 64 validation utterances, in a temporary directory):
   run A trains 2 epochs of 4 steps at the yaml's buckets and batch sizes
   (256 x 146, 512 x 73), each step finite and not skipped, 8 K1 launches
   per train and eval step and 8 K2 per train step, config, tokens, epoch
   and average checkpoints written, and build_model_from_dir serves a
   finite forward; run B (stopped after epoch 1, started again) and run C
   (stopped at a mid-epoch save, started again) end equal to A bit for bit
   (parameters, BatchNorm statistics, Adam's moments), all three with
   cudnn.deterministic, torch.use_deterministic_algorithms(True) and
   CUBLAS_WORKSPACE_CONFIG set (the CLI sets none of them); K1 (out, lse)
   and K2 (dq, dk, dv, dbias) against their plain versions at each
   bucket's shape as the step gives it to them (B x (frames + phones), the
   key mask of a real batch), in float32 and bfloat16, at dropout 0 and
   0.2; the batches that reach the step through the prefetch thread and
   DeviceTransfer equal the host's bit for bit, with the consumer's stream
   held back and batches held; then, in fp32 and in bf16 (whose epoch
   launches K1 and K2 8 times a step too), per-bucket step times on the
   device's clock, mel-frames/s (padded and the utterances' own), data
   wait, host time per step and the device's idle time between steps, the
   busy share over an epoch of 3 steps (torch.profiler), the native decode
   and host assembly of one batch, and the bare step on the same bucket.
13. serve-cli: the serving and scoring CLIs on run A's experiment (kept
   with the corpus until this phase ends) and a validation utterance of at
   least 24 phones, through their main(argv) on the card:
   a3t_tpu_torch.bin.sedit reconstruct (the middle third under [MASK]; once
   cold, then 3 times), edit (3 phones replaced by 5 vocabulary phones at
   --uniform-duration 0.1) and prompt (8 phones appended), 3 times each
   (the median's host time is reported), each vocoded
   with Griffin-Lim; edit again with --vocoder set to a parallel_wavegan
   pickle written from seeded tensors (weight_g/weight_v, 24 kHz size) and
   with --dynamic-eval 5e-5,1; then the model written as an ESPnet
   experiment (.pth, config.yaml with its token list) and
   a3t_tpu_torch.bin.mcd_gate --espnet-ckpt on 4 validation utterances with
   Griffin-Lim.  Checks: every wav finite and of the length the span
   boundaries imply, 8 K1 launches per forward, dynamic evaluation's 8 K1
   and 8 K2 launches per example with the adapted parameters moved and the
   original model's parameters and running statistics unchanged bit for
   bit, MCD.json with n = 4 and finite means, --espnet-ckpt and --exp-dir
   giving the same mel_edited bit for bit, K1 and K2 against their plain
   versions at each request's own shape (1, 2, f_pad + t_pad, 192), fp32,
   dropout 0 and 0.2, Griffin-Lim on the card against its CPU run from one
   initial phase (1 and 32 iterations), two runs of istft on the card equal
   bit for bit.  Prints each request's wall time and RTF after its model
   load, the loads, Griffin-Lim against PWG on one mel, the edit request's
   split, dynamic evaluation's seconds per pass and the MCD analysis's host
   seconds per utterance.
14. speaker-fs2: speaker conditioning and the FastSpeech2 path on the
   trainer's corpus (8 speakers), in the same temporary directory: a seeded
   x-vector network (XVectorConfig(), its log-mel MVN from the corpus)
   written in load_xvector's format, build_spk2xvector and
   build_utt2xvector over the corpus; configs/fs2_conformer_24k.yaml (the
   GST + x-vector conformer FastSpeech2, 4 + 4 blocks through K1/K2)
   trained 8 steps through FS2Task.run in fp32 with the spk2xvector table
   (finite, not skipped, 8 K1 per train and eval forward and 8 K2 per
   train step, K1/K2 against their plain versions at the encoder's and the
   decoder's masks: B 16 x text 64 and x 512 frames); the 24 kHz yaml
   with spemb_dim 192 trained 8 steps through bin.train (the same launch
   checks, the zero-initialised speaker offset moved); bin.sedit edit
   --duration-model --spk-xvector (8 + 2 x 4 K1 launches, 4 per duration
   prediction); an edit and a prompt TTS through SpeechEditor(spemb_fn=
   make_spemb_extractor(...)); the context x-vector equal bit for bit with
   the masked span's interior (what reaches no context frame through the
   STFT window and the TDNN) replaced by noise; two runs of the duration
   function equal; bin.batch_decode --fs2-exp --spk-xvector on 4
   validation utterances (six wavs each, of the lengths the spans and the
   summed durations give); bin.mcd_gate --duration-model on the same 4;
   save_espnet_fs2 -> load_duration_fn(.pth) equal to the experiment's
   durations bit for bit.  Prints the FS2 step's device time,
   mel-frames/s, data wait and host batch assembly, the same step on one
   batch with no producer thread running, and medians of 3 after
   a warm-up of the x-vector extraction, the duration function, requests
   with FS2 durations, each baseline and the model loads.
15. side-train: the side trainers on the trainer's corpus, in the same
   temporary directory, fp32 at full width: (a) the duration-aware A3T
   variant, the 24 kHz yaml with model.duration_predictor_layers=2 through
   bin.train for 8 steps over its two buckets (finite, not skipped, 8 K1
   per train and eval forward and 8 K2 per step; per-bucket step times on
   the device's clock and mel-frames/s; the last step profiled), K1/K2
   against their plain versions at each bucket's reduced encoder mask and
   length-regulated decoder mask from the batcher's own batches (fp32 and
   bf16, dropout 0 and 0.2), one dropout-0 step's loss and gradients
   through the kernels against the plain versions leaf by leaf, and
   bin.sedit edit on its experiment (8 K1); (b) train_xvector at
   XVectorConfig() for 30 steps of 32 crops with held-out accuracy on the
   validation split, its directory feeding make_spemb_extractor; (c)
   bin.train_vocoder at its 24 kHz defaults (64 x 30 layers x 3 stacks,
   batch 8, 96-frame crops) for 6 steps, the discriminator from step 3,
   stopped by an exception after its save at step 3 and resumed (restarts
   at 3, keeps the stored mel statistics, finite spectral and adversarial
   losses), load_vocoder's wav of frames x hop samples, and bin.mcd_gate
   --vocoder DIR on 2 validation utterances (8 K1 each).  Prints the step
   times (the x-vector's by crop length, the vocoder's spectral and
   adversarial steps), one profiled call of each kind and the phase's
   main-path launches.
16. train-options: the rest of single-device training, in the same
   temporary directory: (a) configs/a3t_multi_corpus.yaml (a copy whose
   data directories and exp_dir alone differ) through bin.train for one
   epoch of 12 steps, libritts and vctk on the trainer's 24 kHz corpus and
   librispeech, speech-only at 16 kHz, on a generated corpus of 146 + 73
   utterances (whole batches of the yaml's 256- and 512-frame buckets):
   8 / 2 / 2 steps by the portions, each finite, 8 K1 per train and eval
   step and 8 K2 per train step, per-corpus device ms per step and
   mel-frames/s, K1/K2 against their plain versions at the speech-only
   masks (one valid text key per utterance; fp32 and bf16, dropout 0 and
   0.2); (b) the trainer's corpus packed by python -m
   a3t_tpu_torch.bin.pack_records and trained on with
   batcher.device_audio=true in bf16 at steps_per_dispatch 1 and 4 (the
   same launch checks; device ms per step, host ms per call and per step,
   data wait, idle before each call, and the busy share over a profiled
   epoch), the audio gathered on the card from the uploaded corpus equal
   to the host-assembled batch bit for bit for each bucket, and in
   deterministic mode a dropout-0 chained step over 3 batches and a padded
   sub-step equal to 3 sequential steps, and make_train_step(model, None)
   on featurized batches equal to the featurizing step, bit for bit
   (parameters, BatchNorm statistics, Adam's moments); (c) an fp32 run
   with optim.accum_grad=2 and optim.grad_noise_eta=0.01 for 4
   micro-steps: parameters unchanged bit for bit after micro-steps 1 and
   3, Noam's count 2, and each applied update within 1e-6 (relative to its
   largest element) of a plain rule written here (the mean of the two
   gradients plus the noise drawn from SeedSequence([0, count]), clipped,
   Adam, Noam), computed in float32 as optax computes it.
17. prep-chain: the data-preparation chain, in the same temporary
   directory, each stage through its CLI's main(argv) on the card: a 48
   kHz generate_mini_corpus of 12 + 4 utterances (one source rewritten as
   a stereo FLAC, the oracle alignments dropped) -> bin.format_data (24 kHz
   FLAC; every file decodes the same through the native decoder and
   read_flac; validate_data_dir_fs) -> bin.align (8 iterations, the model
   saved; one monotone span per phone) -> bin.tokenize_text (the recipe's
   pinned vocabulary) -> bin.collect_stats (the count is the sum of
   speech_shape's frames) -> bin.train at the 24 kHz yaml's full width in
   fp32 with the chain's token list and GlobalMVN statistics, 4 steps
   (finite, 8 K1 per train and eval step, 8 K2 per train step) ->
   bin.export_params --dtype float32 (the trained parameters bit for bit)
   -> a second bin.train warm-started from the export, whose parameters
   before its step equal the export's bit for bit -> bin.sedit
   reconstruct (the wav's length) and bin.mcd_gate over the validation
   split (a finite MCD) -> python -m a3t_tpu_torch.recipes.mini at its toy
   width; K1/K2 against their plain versions at the chain's bucket (fp32
   and bf16, dropout 0 and 0.2).  Prints each stage's host seconds, the
   steps' device times and the phase's launches.
18. model-options: the last single-device options, in the same temporary
   directory.  (a) configs/a3t_longformer_16k.yaml with attention_dilation
   2 on train-longformer's batch (its pre-encoder dilated too, with no text
   keys): a dropout-0 step's gradients through K3-K5 against their plain
   versions leaf by leaf, 2 warm-up and 5 timed steps at the yaml's dropout
   (6 launches of each kernel a step, peak memory), K3-K5 at the dilated
   shape (8, 2, 4096, 192) against their plain versions with times beside
   them, SDPA's and the bounds; then bin.train with
   --set model.encoder.attention_dilation=2 for 4 steps on a generated 16
   kHz corpus of whole 1024- and 2048-frame batches.  (b) The chunked path
   (use_pallas_attention: false) at full width, a dropout-0 step at
   dilation 1 (its grad_norm beside PR 6's reading through JAX's formula)
   and 2, no banded kernel launched, and the module against
   chunked_attention at (4, 2, 8192, 192) in fp32.  (c) The encoder knobs
   on the 24 kHz bf16 step (bench_batch): remat and remat_attention against
   the plain step at dropout 0.2, bit for bit in deterministic mode and
   within TOL_GRADS_BF16_24K otherwise (gradients, BatchNorm statistics,
   the generator's state), their step times and peak memory (K1 launched
   twice a block: the forward and its recomputation);
   cnn_module_bn_compute_dtype, normalize_before false, conv1d_shifted and
   cnn_module_shifted one step each, the shifted ones' eval outputs bit for
   bit those of conv1d.  (d) bin.train on the trainer's corpus for one
   epoch of 2 steps with num_plot_examples=2: the plot arrays on the card,
   each attention row summing to 1, rendered where matplotlib imports.  (e)
   The trained 16 kHz vocoder (a3t_tpu_torch/weights/vocoder_16k) on
   check.npz's mel and JAX's noise against JAX's wav, ms per call and RTF.
   (f) The LJSpeech and VCTK recipes on tiny corpora in the sources'
   layouts: every split at the target rate, one span per phone.  Prints
   each part's seconds and the phase's K1-K5 launches.

It prints the kernel table and the card's name and power limit on lines of
their own, and ends with one JSON line ``{"ok": true, "device": {...}}``.
It exits non-zero on any failure, and when no CUDA device is present.
Float32 products and convolutions run in full float32 (TF32 off).
"""

import contextlib
import json
import math
import os
import sys
import tempfile
import threading
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
# other: the parameters are held within 5 lr_0.  Two first steps differ by
# at most 2 lr_0 = 4.0e-7, so this check cannot fail; it is kept as a
# readout, and the gradients themselves are what is held (grad_norm here,
# leaf by leaf for the longformer below).
TOL_STEP_LOSS = 1e-5
TOL_STEP_GRAD_NORM = 1e-4
TOL_STEP_PARAMS = 1e-6
# the longformer step at dropout 0 in bf16, K3/K4/K5 against their plain
# versions: both sum fp32 products in another order and round the attention
# output to bf16, so a value near a rounding boundary can land one bf16 ulp
# (2^-8 relative) apart, and the bf16 layers after it carry that on.  The
# loss (a mean over ~26,000 masked frames) within 1e-3 relative, grad_norm
# within 1e-2, the postnet's BatchNorm running statistics (a tenth of one
# batch's statistics) within 1e-3; parameters within 5 lr_0 as above.
TOL_LF_LOSS = 1e-3
TOL_LF_GRAD_NORM = 1e-2
TOL_LF_STATS = 1e-3
# The same comparison leaf by leaf, before the optimizer (grad_norm above is
# dominated by the pre-encoder's fully masked padded rows, and Adam's first
# step moves every parameter by +-lr_0 whatever its gradient, so the two
# checks above see little of K4/K5 on the valid rows): max|kernel - plain|
# over max|plain| of each parameter's gradient.  Read on an H100 80GB HBM3
# at 700 W: worst leaf 7.5e-3 in bf16 (median 3-4e-3), 3.0e-4 in float32 on
# full-length utterances (median 2.7e-5).  The limits sit 2.7x and 10x above
# the readings; a copy of K4 or K5 whose dq or dk is 5% off fails all three.
# The 24 kHz steps (K1/K2 against the plain attention branch) are held the
# same way.  There, on the same card, fp32 reads 2.4e-4 (median 2.9e-5) and
# bf16 1.87e-2 at the postnet's BatchNorm biases (median 3.7e-3), where the
# L1 loss's per-element signs turn on bf16 rounding of the outputs; a copy
# of K2 whose dq or dk is 5% off reads 6.2-7.1e-2 in both.  So bf16 takes
# its own limit, 1.6x above the reading and 2x below the faulty copies.
TOL_GRADS_BF16 = 2e-2
TOL_GRADS_BF16_24K = 3e-2
TOL_GRADS_F32 = 3e-3
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


def banded_bound_ms(b, h, t, d, c, tt, dtype_name: str):
    """(least ms, what bounds it) for one banded-attention forward (K3):
    q, k, v, out, the text keys and values, the masks and lse once; per
    (b, h) T (12 c d + 4 tt d) operations (scores and P.V over 3c band and
    tt text keys)."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = (4 * b * h * t * d + 2 * b * h * tt * d) * esize \
        + b * (t + tt) * 4 + b * h * t * 4
    return _bound(nbytes, b * h * t * (12.0 * c * d + 4.0 * tt * d),
                  dtype_name)


def banded_dq_bound_ms(b, h, t, d, c, tt, dtype_name: str,
                       text_grads: bool = True):
    """(least ms, what bounds it) for one query-chunk backward pass (K4): q,
    k, v, g read and dq written, the text keys and values (and their fp32
    gradients), masks, lse and delta; per (b, h) T (18 c d + 6 tt d)
    operations (scores, dp and dq over band and text keys) plus 4 T tt d
    for dk_text and dv_text."""
    esize = 4 if dtype_name == "float32" else 2
    nbytes = (5 * b * h * t * d + 2 * b * h * tt * d) * esize \
        + (2 * b * h * tt * d * 4 if text_grads else 0) + b * (t + tt) * 4 \
        + 2 * b * h * t * 4
    flops = b * h * t * (18.0 * c * d + (10.0 if text_grads else 6.0) * tt * d)
    return _bound(nbytes, flops, dtype_name)


def banded_dkv_bound_ms(b, h, t, d, c, dtype_name: str):
    """(least ms, what bounds it) for one key-chunk backward pass (K5): q, k,
    v, g read and dk, dv written, the speech mask, lse and delta; four
    products of 2 c^2 d for each of the 3 nc - 2 (key chunk, query chunk)
    pairs that exist, per (b, h)."""
    esize = 4 if dtype_name == "float32" else 2
    nc = t // c
    nbytes = 6 * b * h * t * d * esize + b * t * 4 + 2 * b * h * t * 4
    return _bound(nbytes, b * h * (3 * nc - 2) * 8.0 * c * c * d, dtype_name)


def hgmma_counts(lib_path: str, nvcc: str) -> dict:
    """{kernel function: number of HGMMA (wgmma) instructions} in the SASS
    of a built library, read with the toolkit's cuobjdump."""
    import subprocess
    tool = os.path.join(os.path.dirname(nvcc), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib_path], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :")[1].strip()
            counts[name] = 0
        elif name is not None and "HGMMA" in line:
            counts[name] += 1
    return counts


def check_tensor_cores(native, paths: dict) -> None:
    """The bf16 functions of K1, K2, K3, K4 and K5 run their products on
    wgmma; their fp32 functions on the CUDA cores alone."""
    import re
    nvcc = native.find_nvcc()
    for name in ("fused_attention", "fused_attention_bwd",
                 "banded_attention_fwd", "banded_attention_bwd_dq",
                 "banded_attention_bwd_dkv"):
        n_bf16 = 0
        for fn, n in sorted(hgmma_counts(paths[name], nvcc).items()):
            m = re.search(r"\d((?:fused|banded)_attention_[a-z0-9_]+?_kernel)"
                          r"I(\w*?)EE", fn)
            short = (f"{m.group(1)}<{','.join(re.findall(r'Li(\d+)E', m.group(2) + 'E'))}>"
                     if m else fn[:60])
            log(f"  sass {name}: {short}: {n} HGMMA")
            if "bf16_kernel" in fn:
                n_bf16 += 1
                check(n > 0, f"{fn}: no HGMMA in a bf16 function")
            elif "f32_kernel" in fn:
                check(n == 0, f"{fn}: HGMMA in an fp32 function")
        check(n_bf16 > 0, f"{name}: no bf16 function found in the SASS")


def device_ms_per_call(torch, fn, tags, calls: int = 20) -> float:
    """Device time per call of ``fn`` in the kernels whose names hold one of
    ``tags`` (torch.profiler): at the serving shapes back-to-back wrapper
    calls are paced by the host, so CUDA events around them read the host's
    rate; this reads what the launches themselves take.  NaN when the
    profiler sees no device activity."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = sum(e.time_range.end - e.time_range.start for e in prof.events()
                if e.device_type == torch.autograd.DeviceType.CUDA
                and any(t in e.name for t in tags))
    return total / 1e3 / calls if total else float("nan")


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

    # an utterance whose every key is masked, through the key split (36 row
    # tiles at (2, 2, 552)): out 0 and lse -1e30 + log L as in the plain
    # version, the other utterance unchanged
    b, h, l, d = 2, 2, 552, 192
    for dt, tol in ((torch.float32, TOL_F32), (torch.bfloat16, TOL_BF16)):
        q, k, v = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                   for _ in range(3))
        bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
        mask = torch.ones(b, l, dtype=torch.bool, device=dev)
        mask[0] = False
        for rate in (0.0, 0.2):
            out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 55, rate)
            ref, ref_lse = fa.fused_attention_reference(q, k, v, bias, mask,
                                                        55, rate)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lerr = (lse - ref_lse).abs().max().item()
            log(f"  K1 {(b, h, l, d)} {str(dt)[6:]} rate={rate}, utterance 0 "
                f"fully masked: max|out-plain| {err:.3g}, max|lse-plain| "
                f"{lerr:.3g} (tol {tol:g})")
            check(err <= tol and lerr <= tol,
                  f"K1 fully masked utterance {dt} rate={rate}")

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

    # two runs at a key-split serving shape give the same bits: the key
    # ranges' partials are combined in a fixed order
    b, h, l, d = 1, 2, 552, 192
    check(fa._fwd_plan(b, h, l)[0] > 1, "K1 at (1, 2, 552) splits its keys")
    for dt in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.2):
            q, k, v = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                       for _ in range(3))
            bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
            mask = torch.ones(b, l, dtype=torch.bool, device=dev)
            mask[0, l - 40:] = False
            first = fa.fused_attention_fwd(q, k, v, bias, mask, 77, rate)
            second = fa.fused_attention_fwd(q, k, v, bias, mask, 77, rate)
            same = all(torch.equal(x, y) for x, y in zip(first, second))
            rows = fa.ROW_TILE if dt == torch.float32 else fa.ROW_TILE_BF16
            log(f"  K1 {(b, h, l, d)} {str(dt)[6:]} rate={rate}, "
                f"{fa._fwd_plan(b, h, l, rows=rows)[0]} key ranges: two runs "
                f"{'equal' if same else 'DIFFER'} bit for bit")
            check(same, f"K1 deterministic ({dt}, rate {rate})")

    # times at the requests' shapes in float32, which the slice runs, at
    # the 6 s request's shape in bfloat16 and at the training shape in both
    rows = {}
    for b, l, dt in ((1, 552, torch.float32), (1, 552, torch.bfloat16),
                     (1, 296, torch.float32), (1, 696, torch.float32),
                     (1, 872, torch.float32), (88, 496, torch.float32),
                     (88, 496, torch.bfloat16)):
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
        dev_ms = device_ms_per_call(torch, kernel, ("fused_attention_fwd_",
                                                    "fused_attention_combine_"))
        # at the training shape also with the yaml's attention dropout: the
        # keep-mask hash runs on every score
        drop = ""
        if b > 1:
            t_drop = cuda_ms(lambda: fa.fused_attention_fwd(
                q, k, v, bias, mask, 0, 0.2)[0])
            drop = f"; at dropout 0.2 {t_drop:.4f} ms"
        log(f"  K1 times {(b, h, l, d)} {name}: kernel {t_kernel:.4f} / "
            f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, sdpa {t_lib:.4f} ms "
            f"(max|sdpa-kernel| {lib_err:.3g}), bound {bound:.5f} ms ({by}); "
            f"the kernel's launches alone on the device {dev_ms:.4f} ms{drop}")
        rows[(b, l, name)] = dict(ms=t_kernel, plain_ms=t_plain,
                                  library_ms=t_lib, bound_ms=bound,
                                  bound_by=by,
                                  max_abs_err=worst[(b, h, l, d, name)])
    return (rows[(1, 552, "float32")], rows[(88, 496, "float32")],
            rows[(88, 496, "bfloat16")])


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

    # an utterance whose every key is masked: zero gradients there, the
    # other utterance against the plain backward
    b, h, l, d = 2, 2, 552, 192
    for dt, tol in ((torch.float32, TOL_BWD_F32),
                    (torch.bfloat16, TOL_BWD_BF16)):
        q, k, v, go = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                       for _ in range(4))
        bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
        mask = torch.ones(b, l, dtype=torch.bool, device=dev)
        mask[0] = False
        for rate in (0.0, 0.2):
            out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 56, rate)
            got = fa.fused_attention_bwd(q, k, v, bias, mask, 56, rate, out,
                                         lse, go)
            want = fa.fused_attention_bwd_reference(q, k, v, bias, mask, 56,
                                                    rate, out, lse, go)
            torch.cuda.synchronize()
            errs = [_rel_err(a, w) for a, w in zip(got, want)]
            zero = all(bool((a[0] == 0).all()) for a in got)
            log(f"  K2 {(b, h, l, d)} {str(dt)[6:]} rate={rate}, utterance 0 "
                f"fully masked: max|grad-plain|/max|plain| "
                + ", ".join(f"{e:.3g}" for e in errs)
                + f"; its gradients all 0: {zero} (tol {tol:g})")
            check(max(errs) <= tol and zero,
                  f"K2 fully masked utterance {dt} rate={rate}")

    # two runs at the training shape give the same bits: no atomics
    b, h, l, d = 88, 2, 496, 192
    for dt in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.2):
            q, k, v, go = (torch.randn(b, h, l, d, generator=g).to(dev, dt)
                           for _ in range(4))
            bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
            mask = torch.ones(b, l, dtype=torch.bool, device=dev)
            mask[-1, l - l // 5:] = False
            out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 99, rate)
            first = fa.fused_attention_bwd(q, k, v, bias, mask, 99, rate, out,
                                           lse, go)
            second = fa.fused_attention_bwd(q, k, v, bias, mask, 99, rate,
                                            out, lse, go)
            same = [torch.equal(x, y) for x, y in zip(first, second)]
            log(f"  K2 {(b, h, l, d)} {str(dt)[6:]} rate={rate}: two runs "
                f"equal bit for bit: dq {same[0]}, dk {same[1]}, dv "
                f"{same[2]}, dbias {same[3]}")
            check(all(same), f"K2 deterministic ({dt}, rate {rate})")
            del q, k, v, go, bias, out, lse, first, second

    # times at the training shape, fp32 as the slice runs it, and bf16
    rows = {}
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
        t_drop = cuda_ms(lambda: fa.fused_attention_bwd(
            q, k, v, bias, mask, 0, 0.2, out, lse, go), iters=10)
        bound, by = attention_bwd_bound_ms(b, h, l, d, name)
        log(f"  K2 times {(b, h, l, d)} {name}: kernel {t_kernel:.4f} / "
            f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, sdpa backward "
            f"{t_lib:.4f} ms, bound {bound:.5f} ms ({by}); at dropout 0.2 "
            f"{t_drop:.4f} ms")
        rows[name] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                          bound_ms=bound, bound_by=by,
                          max_abs_err=worst[(b, h, l, d, name)])
        del q, k, v, go, bias, out, lse, qs, ks, vs, am, lib_out
    return rows["float32"]


def _banded_inputs(torch, g, b, h, t, d, tt, dt, lengths):
    """q, k, v, k_text, v_text, the output gradient, txm and spm on the card;
    batch entry i has ``lengths[i]`` valid frames (a padded tail of two
    chunks or more makes query rows whose every band key is masked) and,
    with text, the last entry's last two text tokens are padding."""
    dev = torch.device("cuda")
    q, k, v, go = (torch.randn(b, h, t, d, generator=g).to(dev, dt)
                   for _ in range(4))
    kt, vt = (torch.randn(b, h, tt, d, generator=g).to(dev, dt)
              for _ in range(2))
    spm = (torch.arange(t)[None, :]
           < torch.tensor(lengths)[:, None]).to(torch.int32)
    txm = torch.ones(b, tt, dtype=torch.int32)
    txm[-1, tt - 2:] = 0
    return q, k, v, kt, vt, go, txm.to(dev), spm.to(dev)


def _masked_rows(torch, ba, txm, spm, c: int):
    """(B, T) bool: the query rows whose every key, band and text, is
    masked."""
    seen = ba.band_mask(spm, c).any(-1) | (txm > 0).any(-1, keepdim=True)
    return (~seen).repeat_interleave(c, dim=1)


def _split_rel_err(torch, got, want, rows):
    """max|got - want| / max|want| of (B, H, T, d) tensors over the rows
    (B, T) where ``rows`` holds, and apart over the other rows, each relative
    to its own largest |want|; 0 for an empty set."""
    diff = (got.float() - want.float()).abs()
    ref = want.float().abs()
    errs = []
    for sel in (rows, ~rows):
        if not bool(sel.any()):
            errs.append(0.0)
            continue
        m = sel[:, None, :, None]
        top = torch.where(m, ref, 0.0).amax().clamp_min(1e-30)
        errs.append((torch.where(m, diff, 0.0).amax() / top).item())
    return errs


def chunked_attention(torch, q, k, v, kt, vt, txm, spm, window: int):
    """The JAX package's other formula for the same attention, its
    chunked-einsum path (windowed_attention.py:147-177), in float32: phantom
    edge neighbours are zeros, masked scores the float32 minimum, and no
    stand-in text block.  Written here apart from the port, as the oracle
    that the port's chunked path (use_pallas_attention: false) is held
    against."""
    b, h, t, d = q.shape
    c = window // 2
    nc = t // c

    def band(x):
        xc = x.float().reshape(b, x.shape[1], nc, c, -1)
        z = torch.zeros_like(xc[:, :, :1])
        return torch.cat([torch.cat([z, xc[:, :, :-1]], 2), xc,
                          torch.cat([xc[:, :, 1:], z], 2)], 3)

    qc = q.float().reshape(b, h, nc, c, d)
    s = torch.cat([torch.einsum("bhncd,bhnkd->bhnck", qc, band(k)),
                   torch.einsum("bhncd,bhsd->bhncs", qc, kt.float())], -1)
    ok = torch.cat([band(spm.view(b, 1, t, 1))[..., 0][:, :, :, None, :]
                    .expand(b, h, nc, c, 3 * c) > 0,
                    (txm > 0).view(b, 1, 1, 1, -1).expand(
                        b, h, nc, c, kt.shape[2])], -1)
    p = torch.softmax((s * float(1.0 / d ** 0.5)).masked_fill(
        ~ok, torch.finfo(torch.float32).min), -1)
    out = torch.einsum("bhnck,bhnkd->bhncd", p[..., :3 * c], band(v)) \
        + torch.einsum("bhncs,bhsd->bhncd", p[..., 3 * c:], vt.float())
    return out.reshape(b, h, t, d), ~ok.any(-1).reshape(b, h, t)


def kernel_banded_phase(torch, ba, cuda_ms):
    """K3, K4 and K5 against their plain versions on the card, at the
    training shape (B=4, H=2, T=8192, d=192, window 512) as the encoder calls
    them (64 text keys) and as the pre-encoder does (speech only, the 128-key
    masked text block, ragged lengths, K4 without text gradients), at a
    smaller speech-only shape with text gradients and at a small shape with
    ragged tiles (c=4, 5 text keys); float32 and bfloat16, dropout 0 and 0.2;
    errors on the fully masked rows apart from the others.  Then K3's
    keep-mask bits read back, two runs of each kernel at the training shape
    equal bit for bit, and the times at the training shape beside the plain
    versions', SDPA's and the bounds."""
    g = torch.Generator().manual_seed(2)
    worst = {}
    cases = [
        # the encoder's blocks: 64 text keys, the last utterance a chunk short
        ((4, 2, 8192, 192), 512, 64, (8192, 8192, 8192, 7936), True),
        # the pre-encoder's blocks: speech only (the 128-key masked stand-in
        # block), the frame lengths of train-longformer's batch (padded tails
        # of 0 to 12 chunks), K4 without the text gradients, as
        # BandedAttention calls it there
        ((4, 2, 8192, 192), 512, 0, (8192, 5444, 5133, 6229), False),
        # the stand-in block with its text gradients, a tail of 3 chunks
        ((2, 2, 2048, 192), 512, 0, (2048, 1280), True),
        # ragged tiles: c = 4, 5 text keys
        ((2, 2, 64, 16), 8, 5, (64, 52), True)]
    for (b, h, t, d), window, tt, lengths, text_grads in cases:
        c = window // 2
        for dt, tol in ((torch.float32, TOL_BWD_F32),
                        (torch.bfloat16, TOL_BWD_BF16)):
            for rate in (0.0, 0.2):
                q, k, v, kt, vt, go, txm, spm = _banded_inputs(
                    torch, g, b, h, t, d, tt, dt, lengths)
                if tt == 0:
                    kt = torch.zeros(b, h, ba.EMPTY_TEXT, d, device=q.device,
                                     dtype=dt)
                    vt = torch.zeros_like(kt)
                    txm = torch.zeros(b, ba.EMPTY_TEXT, dtype=torch.int32,
                                      device=q.device)
                args = (q, k, v, kt, vt, txm, spm, window, 777, rate)
                out, lse = ba.banded_attention_fwd(*args)
                ref, ref_lse = ba.banded_attention_reference(*args)
                delta = (go.float() * out.float()).sum(-1)
                bwd = (777, rate, go, lse, delta)
                got = ba.banded_attention_bwd_dq(*args[:8], *bwd,
                                                 text_grads=text_grads) \
                    + ba.banded_attention_bwd_dkv(q, k, v, spm, window, *bwd)
                want = ba.banded_attention_bwd_dq_reference(*args[:8], *bwd) \
                    + ba.banded_attention_bwd_dkv_reference(q, k, v, spm,
                                                            window, *bwd)
                torch.cuda.synchronize()
                # out and dq apart on the fully masked query rows (where the
                # Pallas semantics make them tens of times larger), dk and dv
                # apart on the padded keys, each against its own largest value
                rows = _masked_rows(torch, ba, txm, spm, c)
                keys = spm > 0
                split = {"out": (out, ref, ~rows),
                         "dq": (got[0], want[0], ~rows),
                         "dk": (got[3], want[3], keys),
                         "dv": (got[4], want[4], keys)}
                errs = {n: _split_rel_err(torch, a, w, sel)
                        for n, (a, w, sel) in split.items()}
                text = [_rel_err(a, w) for a, w in zip(got[1:3], want[1:3])] \
                    if text_grads else []
                lerr = (lse - ref_lse).abs().max().item()
                log(f"  K3/K4/K5 {(b, h, t, d)} c={c} tt={tt} "
                    f"{str(dt)[6:]} rate={rate}, {int(rows.sum())} fully "
                    f"masked query rows: max|kernel-plain|/max|plain| on valid"
                    f" | fully masked rows (valid | padded keys for dk, dv) "
                    + ", ".join(f"{n} {e[0]:.3g} | {e[1]:.3g}"
                                for n, e in errs.items())
                    + (f"; dk_text {text[0]:.3g}, dv_text {text[1]:.3g}"
                       if text_grads else "; no text gradients asked")
                    + f"; max|lse-plain| {lerr:.3g} (tol {tol:g}; text "
                    f"grads and lse {TOL_BWD_F32:g})")
                check(out.dtype == ref.dtype
                      and all(a.dtype == w.dtype for a, w, _ in split.values())
                      and all(max(e) <= tol for e in errs.values())
                      and all(e <= TOL_BWD_F32 for e in text)
                      and (text_grads or got[1] is None and got[2] is None)
                      and lerr <= TOL_F32,
                      f"K3/K4/K5 {(b, h, t, d)} tt={tt} {dt} rate={rate}")
                key = (b, h, t, d, str(dt)[6:])
                pairs = [(out, ref)] + [(a, w) for a, w in zip(got, want)
                                        if a is not None]
                for kern, outs in (("K3", pairs[:1]), ("K4", pairs[1:-2]),
                                   ("K5", pairs[-2:])):
                    worst[(kern,) + key] = max(
                        [worst.get((kern,) + key, 0.0)]
                        + [(a.float() - w.float()).abs().max().item()
                           for a, w in outs])
                del q, k, v, kt, vt, go, out, lse, ref, ref_lse, got, want
                del pairs, delta, args, bwd, split, rows, keys
    torch.cuda.empty_cache()

    # the JAX package's two formulas differ on query rows whose every key is
    # masked; K3 follows the Pallas kernel, so it shows that difference too
    # (speech only, 3 padded chunks; the chunked path has no text block)
    q, k, v, kt, vt, _, _, spm = _banded_inputs(torch, g, 2, 2, 2048, 192, 0,
                                                torch.float32, (2048, 1280))
    zt = torch.zeros(2, 2, ba.EMPTY_TEXT, 192, device=q.device)
    out, _ = ba.banded_attention_fwd(
        q, k, v, zt, zt, torch.zeros(2, ba.EMPTY_TEXT, dtype=torch.int32,
                                     device=q.device), spm, 512, 0, 0.0)
    chunked, masked = chunked_attention(
        torch, q, k, v, kt, vt, torch.zeros(2, 0, dtype=torch.int32,
                                            device=q.device), spm, 512)
    diff = (out - chunked).abs().amax(-1)
    log(f"  K3 against the chunked formula (speech only, (2, 2, 2048, 192), "
        f"fp32): {int(masked.sum())} fully masked query rows, max|diff| "
        f"{diff[masked].max().item():.3g} on them, "
        f"{diff[~masked].max().item():.3g} on the other rows")
    del q, k, v, kt, vt, spm, zt, out, chunked, masked, diff

    # K3's dropout keep-masks read back: q = k = 0 makes p uniform over the
    # valid keys; v one-hot on the key rows of the chunks of one residue mod 3
    # (a query chunk's three neighbours have three residues) and on a window
    # of 192 in-chunk positions gives out[r, j] = keep[r, col] / (n (1-rate))
    b, h, t, d, window, tt = 1, 2, 1024, 192, 512, 64
    c, nc, rate, seed = window // 2, t // (window // 2), 0.1, 987654321
    dev = torch.device("cuda")
    for dt in (torch.float32, torch.bfloat16):
        zeros = torch.zeros(b, h, t, d, device=dev, dtype=dt)
        zt = torch.zeros(b, h, tt, d, device=dev, dtype=dt)
        txm = torch.ones(b, tt, dtype=torch.int32, device=dev)
        spm = torch.ones(b, t, dtype=torch.int32, device=dev)
        got = torch.zeros(b, h, nc, c, 3 * c + tt, dtype=torch.bool, device=dev)
        rows = torch.arange(t, device=dev)
        for res in range(3):
            for w0 in range(0, c, d):
                n = min(d, c - w0)
                v = torch.zeros(b, h, t, d, device=dev, dtype=dt)
                sel = rows[((rows // c) % 3 == res) & (rows % c >= w0)
                           & (rows % c < w0 + n)]
                v[:, :, sel, sel % c - w0] = 1
                out, _ = ba.banded_attention_fwd(zeros, zeros, v, zt, zt, txm,
                                                 spm, window, seed, rate)
                out = out.view(b, h, nc, c, d)[..., :n] != 0
                for ci in range(nc):
                    nb = [ci + blk - 1 for blk in range(3)]
                    for blk in range(3):
                        if 0 <= nb[blk] < nc and nb[blk] % 3 == res:
                            got[:, :, ci, :, blk * c + w0:blk * c + w0 + n] = \
                                out[:, :, ci]
        for w0 in range(0, tt, d):
            n = min(d, tt - w0)
            vt = torch.zeros(b, h, tt, d, device=dev, dtype=dt)
            vt[:, :, w0 + torch.arange(n), torch.arange(n)] = 1
            out, _ = ba.banded_attention_fwd(zeros, zeros, zeros, zt, vt, txm,
                                             spm, window, seed, rate)
            got[..., 3 * c + w0:3 * c + w0 + n] = \
                out.view(b, h, nc, c, d)[..., :n] != 0
        want = torch.cat([ba.band_keep(b, h, nc, c, seed, rate, device=dev)
                          & ba.band_mask(spm, c)[:, None, :, None, :].bool(),
                          ba.text_keep(b, h, nc, c, tt, seed, rate,
                                       device=dev)], dim=-1)
        n_diff = int((got != want).sum())
        log(f"  K3 dropout keep-mask {str(dt)[6:]}: {n_diff} of {got.numel()} "
            f"bits differ, keep share {want.float().mean().item():.4f}")
        check(n_diff == 0, f"K3 dropout mask bits ({dt})")

    # two runs at the training shape give the same bits: no atomics (K4's
    # text gradients are per-CTA partials summed in a fixed order)
    (b, h, t, d), window, tt, lengths, _ = cases[0]
    c = window // 2
    for dt in (torch.float32, torch.bfloat16):
        for rate in (0.0, 0.2):
            q, k, v, kt, vt, go, txm, spm = _banded_inputs(
                torch, g, b, h, t, d, tt, dt, lengths)
            args = (q, k, v, kt, vt, txm, spm, window, 99, rate)
            out, lse = ba.banded_attention_fwd(*args)
            out2, lse2 = ba.banded_attention_fwd(*args)
            same3 = [torch.equal(out, out2), torch.equal(lse, lse2)]
            log(f"  K3 {(b, h, t, d)} {str(dt)[6:]} rate={rate}: two runs "
                f"equal bit for bit: out {same3[0]}, lse {same3[1]}")
            check(all(same3), f"K3 deterministic ({dt}, rate {rate})")
            del out2, lse2
            delta = (go.float() * out.float()).sum(-1)
            bwd = (99, rate, go, lse, delta)
            runs = [ba.banded_attention_bwd_dq(*args[:8], *bwd)
                    + ba.banded_attention_bwd_dkv(q, k, v, spm, window, *bwd)
                    for _ in range(2)]
            same = [torch.equal(x, y) for x, y in zip(*runs)]
            log(f"  K4/K5 {(b, h, t, d)} {str(dt)[6:]} rate={rate}: two runs "
                f"equal bit for bit: dq {same[0]}, dk_text {same[1]}, "
                f"dv_text {same[2]}, dk {same[3]}, dv {same[4]}")
            check(all(same), f"K4/K5 deterministic ({dt}, rate {rate})")
            del q, k, v, kt, vt, go, txm, spm, args, out, lse, delta, bwd
            del runs
    torch.cuda.empty_cache()

    # times at the training shape, rate 0, in bfloat16 (the slice's type) and
    # float32; the library yardstick is SDPA over [speech; text] keys with a
    # dense boolean band mask, forward, and its backward through autograd;
    # K4 and K5 also at the yaml's attention dropout, 0.2
    rows_out = {}
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for dt in (torch.bfloat16, torch.float32):
        name = str(dt)[6:]
        q, k, v, kt, vt, go, txm, spm = _banded_inputs(
            torch, g, b, h, t, d, tt, dt, lengths)
        args = (q, k, v, kt, vt, txm, spm, window, 0, 0.0)
        out, lse = ba.banded_attention_fwd(*args)
        delta = (go.float() * out.float()).sum(-1)
        bwd = (0, 0.0, go, lse, delta)
        ci = torch.arange(t, device=q.device) // c
        band = (ci[:, None] - ci[None, :]).abs() <= 1
        keys_ok = torch.cat([band[None] & (spm[:, None, :] > 0),
                             (txm[:, None, :] > 0).expand(b, t, tt)], dim=-1)
        mask = keys_ok[:, None]  # (B, 1, T, T + tt)
        ka, va = torch.cat([k, kt], 2), torch.cat([v, vt], 2)
        qs, ks, vs = (x.clone().requires_grad_() for x in (q, ka, va))
        lib_out = sdpa(qs, ks, vs, attn_mask=mask)
        fns = {
            "K3": (lambda: ba.banded_attention_fwd(*args),
                   lambda: ba.banded_attention_reference(*args),
                   banded_bound_ms(b, h, t, d, c, tt, name)),
            "K4": (lambda: ba.banded_attention_bwd_dq(*args[:8], *bwd),
                   lambda: ba.banded_attention_bwd_dq_reference(*args[:8],
                                                                *bwd),
                   banded_dq_bound_ms(b, h, t, d, c, tt, name)),
            "K5": (lambda: ba.banded_attention_bwd_dkv(q, k, v, spm, window,
                                                       *bwd),
                   lambda: ba.banded_attention_bwd_dkv_reference(
                       q, k, v, spm, window, *bwd),
                   banded_dkv_bound_ms(b, h, t, d, c, name)),
        }
        drop = (0, 0.2, go, lse, delta)
        dropped = {
            "K3": lambda: ba.banded_attention_fwd(*args[:8], 0, 0.2),
            "K4": lambda: ba.banded_attention_bwd_dq(*args[:8], *drop),
            "K5": lambda: ba.banded_attention_bwd_dkv(q, k, v, spm, window,
                                                      *drop)}
        t_lib_fwd = cuda_ms(lambda: sdpa(q, ka, va, attn_mask=mask), iters=5)
        t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(
            lib_out, (qs, ks, vs), go, retain_graph=True), iters=5)
        for kern, (kernel, plain, (bound, by)) in fns.items():
            # in turns: kernel, plain, kernel
            t_kernel = cuda_ms(kernel, iters=10)
            t_plain = cuda_ms(plain, iters=3, warmup=1)
            t_kernel2 = cuda_ms(kernel, iters=10)
            t_lib = t_lib_fwd if kern == "K3" else t_lib_bwd
            at_drop = (f"; at dropout 0.2 "
                       f"{cuda_ms(dropped[kern], iters=10):.4f} ms"
                       if kern in dropped else "")
            log(f"  {kern} times {(b, h, t, d)} c={c} tt={tt} {name}: kernel "
                f"{t_kernel:.4f} / {t_kernel2:.4f} ms, plain {t_plain:.4f} "
                f"ms, sdpa {'forward' if kern == 'K3' else 'backward'} "
                f"{t_lib:.4f} ms, bound {bound:.5f} ms ({by}){at_drop}")
            rows_out[(kern, name)] = dict(
                ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                bound_ms=bound, bound_by=by,
                max_abs_err=worst[(kern, b, h, t, d, name)])
        log(f"  SDPA with the dense band mask {name}: forward "
            f"{t_lib_fwd:.4f} ms, backward {t_lib_bwd:.4f} ms, forward + "
            f"backward {t_lib_fwd + t_lib_bwd:.4f} ms")
        del q, k, v, kt, vt, go, out, lse, delta, qs, ks, vs, lib_out, mask
        del keys_ok, band, ka, va, fns, args, bwd, drop, dropped
        torch.cuda.empty_cache()
    return {kern: rows_out[(kern, "bfloat16")] for kern in ("K3", "K4", "K5")}


def logmel_bound_ms(b, s, f, c):
    """(least ms, what bounds it, the same for the direct DFT) for one fused
    log-mel call (K6) on audio (b, s) giving f frames of config c.  Bytes:
    the audio read once and the features written once, b s 4 + b f n_mels 4
    (+ the lengths).  Operations, fp32 on the CUDA cores, counting only
    the work the function needs: per frame, a real FFT of n_fft points,
    5 (n_fft / 2) log2(n_fft) FLOP, and the window's win multiplies; then 4
    FLOP per bin up to the last bin with a non-zero mel weight (power,
    clamp, square root), 2 per non-zero entry of the filterbank, and one
    log per output.  The FFT count is the bound; the direct DFT that the
    TPU kernel computes (and the port's route for an n_fft that is not a
    power of two), 2 win 2 per bin over those bins, gives the third number,
    for reference."""
    from a3t_tpu_torch.dsp.mel import mel_filterbank

    melmat = mel_filterbank(c.fs, c.n_fft, c.n_mels, c.fmin, c.fmax)
    nnz = int((melmat != 0).sum())
    n_bins = int((melmat != 0).any(axis=0).nonzero()[0].max()) + 1
    nbytes = 4 * b * s + 4 * b * f * c.n_mels + 4 * b
    rest = 4.0 * n_bins + 2.0 * nnz + c.n_mels
    fft = 5.0 * (c.n_fft // 2) * math.log2(c.n_fft) + c.win_length
    dft = 2.0 * c.win_length * 2 * n_bins
    bound, by = _bound(nbytes, b * f * (fft + rest), "float32")
    return bound, by, _bound(nbytes, b * f * (dft + rest), "float32")[0]


def kernel_logmel_phase(torch, np, fl, cuda_ms, label):
    """K6 through its wrapper against its plain version on the card, with
    and without sample_lengths: max|kernel - plain| on the log10 features
    within TOL_F32, frames at or past the lengths exactly 0, the frame
    lengths equal, two runs equal bit for bit; then kernel, plain, library
    (the port's rfft front-end: cuFFT and one product) and matmul-DFT
    front-end (cuBLAS fp32) times beside the bound, at every shape.  The
    repo's configs take the FFT route; the fifth case, n_fft 400, the
    direct DFT."""
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.tasks.config import FRONTEND_16K, FRONTEND_24K

    dev = torch.device("cuda")
    rng = np.random.default_rng(7)
    bench = bench_batch(torch, np)
    lf_batch = _longformer_setup(torch, np, "cuda")[0]

    def noise(b, n, short):
        """bench_kernels.py's frontend audio; lengths down to ``short``."""
        audio = torch.tensor(rng.standard_normal((b, n)).astype(np.float32)
                             * 0.1, device=dev)
        lengths = torch.tensor(rng.integers(short, n + 1, b), device=dev)
        lengths[0] = n
        return audio, lengths

    small = LogMelConfig(fs=8000, n_fft=256, hop_length=80, win_length=240,
                         n_mels=20, fmin=20, fmax=4000)
    odd = LogMelConfig(fs=16000, n_fft=400, hop_length=160, win_length=400,
                       n_mels=80)
    cases = [
        # the JAX bench's batch (train, train-bf16, frontend)
        ("bench_b88_432", FRONTEND_24K, bench["audio"],
         bench["audio_lengths"]),
        # bench_kernels.py's frontend_b32_10s: 801 frames, no tile multiple
        ("frontend_b32_10s", FRONTEND_24K) + noise(32, 240000, 120000),
        # train-longformer's batch: 8192 frames at 16 kHz
        ("longformer_b4_8192", FRONTEND_16K, lf_batch["audio"],
         lf_batch["audio_lengths"]),
        # tests/test_ops.py's odd case: n_fft 256, 38 frames
        ("small_8k_b2_38", small) + noise(2, 80 * 37, 2000),
        # an n_fft that is not a power of two (the direct-DFT route): 8
        # utterances of 5 s at 16 kHz, 501 frames
        ("nfft400_b8_501", odd) + noise(8, 16000 * 5, 40000)]
    rows, worst = {}, 0.0
    for name, c, audio, lengths in cases:
        b, n = audio.shape
        f = c.num_frames(n)
        for sl in (None, lengths):
            out, flens = fl.fused_logmel(audio, c, sl)
            again, _ = fl.fused_logmel(audio, c, sl)
            ref, ref_flens = fl.fused_logmel_plain(audio, c, sl)
            torch.cuda.synchronize()
            err = (out - ref).abs().max().item()
            tail = torch.arange(f, device=dev)[None, :] >= flens[:, None]
            tail_ok = sl is None or not bool(out[tail].any())
            same = torch.equal(out, again)
            log(f"  K6 {name} ({fl.plan(c).route}) {tuple(audio.shape)} -> "
                f"{tuple(out.shape)} lengths={'no' if sl is None else 'yes'}:"
                f" max|kernel-plain| {err:.3g} (tol {TOL_F32:g}) on features "
                f"in [{ref.min().item():.3f}, {ref.max().item():.3f}], "
                f"{int(tail.sum()) if sl is not None else 0} tail frames "
                f"{'all 0' if tail_ok else 'NOT 0'}, frame lengths "
                f"{'equal' if torch.equal(flens, ref_flens) else 'DIFFER'}, "
                f"two runs {'equal' if same else 'DIFFER'} bit for bit")
            check(out.shape == (b, f, c.n_mels) and err <= TOL_F32
                  and tail_ok and torch.equal(flens, ref_flens) and same,
                  f"K6 {name} lengths={sl is not None}")
            del again
            worst = max(worst, err)
        fe = LogMelFrontend(c, device=dev)
        # in turns: kernel, plain, library, matmul DFT, kernel
        t_kernel = cuda_ms(lambda: fl.fused_logmel(audio, c, lengths))
        t_plain = cuda_ms(lambda: fl.fused_logmel_plain(audio, c, lengths),
                          iters=5)
        t_rfft = cuda_ms(lambda: fe(audio, lengths))
        t_fused = cuda_ms(lambda: fe.fused(audio, lengths))
        t_kernel2 = cuda_ms(lambda: fl.fused_logmel(audio, c, lengths))
        bound, by, dft_bound = logmel_bound_ms(b, n, f, c)
        log(f"  K6 times {name} (B={b}, F={f}): kernel {t_kernel:.4f} / "
            f"{t_kernel2:.4f} ms, plain {t_plain:.4f} ms, library (rfft "
            f"front-end) {t_rfft:.4f} ms, matmul-DFT front-end "
            f"{t_fused:.4f} ms, bound {bound:.4f} ms ({by}, FFT count; "
            f"{dft_bound:.4f} ms for the direct DFT over the bins below "
            f"fmax) [{label}]")
        rows[name] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_rfft,
                          bound_ms=bound, bound_by=by)
        del fe
    torch.cuda.empty_cache()
    return dict(rows["bench_b88_432"], max_abs_err=worst)


class _Utterances:
    """collect_stats's duck-typed dataset over a batch's utterances: uids,
    and [uid]["audio"] cut to its length."""

    def __init__(self, batch):
        audio = batch["audio"].cpu().numpy()
        lengths = batch["audio_lengths"].cpu().numpy()
        self.items = {f"utt{i:03d}": {"audio": audio[i, :lengths[i]]}
                      for i in range(len(audio))}
        self.uids = sorted(self.items)

    def __getitem__(self, uid):
        return self.items[uid]


def frontend_phase(torch, np, fl, label):
    """featurize(use_pallas=True), the one entry point to K6, against
    featurize() (the matmul-DFT front-end, the step's default) on the bench
    and longformer batches, with a GlobalMVN normalizer from collect_stats
    over the bench batch's utterances, and with int16 audio served through
    corpus + audio_offset against the same PCM passed as audio.  Every key
    must agree: speech within TOL_F32 (divided by the smallest std under
    the normalizer), masks and integer tensors bit for bit.  Returns K6's
    launches, one per call."""
    import tempfile

    from a3t_tpu_torch.dsp import GlobalMVN, LogMelFrontend, collect_stats
    from a3t_tpu_torch.tasks.config import FRONTEND_24K
    from a3t_tpu_torch.train import featurize

    dev = torch.device("cuda")
    bench = bench_batch(torch, np)
    lf_batch, fe16 = _longformer_setup(torch, np, "cuda")[:2]
    fe24 = LogMelFrontend(FRONTEND_24K, device=dev)

    def compare(what, got, want, tol):
        check(got.keys() == want.keys(), f"{what}: keys")
        err = (got["speech"] - want["speech"]).abs().max().item()
        same = [k for k in want if k != "speech"
                and got[k].dtype == want[k].dtype
                and torch.equal(got[k], want[k])]
        log(f"  {what}: speech {tuple(got['speech'].shape)} "
            f"max|K6-fused| {err:.3g} (tol {tol:.3g}); equal bit for bit: "
            f"{', '.join(sorted(same))}")
        check(err <= tol and len(same) == len(want) - 1, what)

    fl.reset_launches()
    calls = 0

    def pallas(fe, batch, **kw):
        nonlocal calls
        before = fl.LAUNCHES
        out = featurize(fe, batch, use_pallas=True, **kw)
        calls += 1
        check(fl.LAUNCHES - before == 1, "one K6 launch per featurize call")
        return out

    compare("featurize bench batch", pallas(fe24, bench),
            featurize(fe24, bench), TOL_F32)
    compare("featurize longformer batch", pallas(fe16, lf_batch),
            featurize(fe16, lf_batch), TOL_F32)

    with tempfile.TemporaryDirectory() as d:
        stats = collect_stats(fe24, _Utterances(bench), d)
        mvn = GlobalMVN.from_stats(f"{d}/feats_stats.npz")
    log(f"  collect_stats over the bench batch's {len(bench['audio'])} "
        f"utterances: {stats['count']} frames, std "
        f"{float(mvn.std.min()):.4f}..{float(mvn.std.max()):.4f}")
    compare("featurize bench batch, GlobalMVN",
            pallas(fe24, bench, normalizer=mvn),
            featurize(fe24, bench, normalizer=mvn),
            TOL_F32 / float(mvn.std.min()))

    # the same PCM as a flat int16 corpus (utterances in reverse order,
    # gaps between them) and as audio
    lengths = bench["audio_lengths"].long()
    b, n = bench["audio"].shape
    pos = torch.arange(n, device=dev)
    pcm = torch.round(bench["audio"] * 32767).to(torch.int16)
    pcm = torch.where(pos[None] < lengths[:, None], pcm, torch.zeros_like(pcm))
    corpus = torch.zeros(b * (n + 37), dtype=torch.int16, device=dev)
    offsets = torch.tensor([(b - 1 - i) * (n + 37) for i in range(b)],
                           device=dev)
    for i in range(b):
        corpus[offsets[i]:offsets[i] + n] = pcm[i]
    by_offset = {k: v for k, v in bench.items() if k != "audio"}
    by_offset["audio_offset"] = offsets
    compare("featurize int16 corpus + audio_offset vs the PCM as audio",
            pallas(fe24, by_offset, corpus=corpus),
            featurize(fe24, {**bench, "audio": pcm}), TOL_F32)
    launches = fl.LAUNCHES
    check(launches == calls, f"{launches} K6 launches for {calls} calls")
    log(f"  K6 launched {launches} times, once per featurize(use_pallas="
        f"True) call [{label}]")
    return launches


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
    # the same forward's device work: at batch 1 the host paces the forward,
    # so the events above read the host's launch rate; the profiler reads
    # what the device itself spends, K1 included
    from torch.profiler import ProfilerActivity, profile
    with torch.inference_mode(), profile(
            activities=[ProfilerActivity.CUDA]) as prof:
        model(**inputs)
        torch.cuda.synchronize()
    spans = [((e.time_range.end - e.time_range.start) / 1e3, e.name)
             for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    k1 = [ms for ms, name in spans if "fused_attention_fwd_" in name
          or "fused_attention_combine_" in name]
    if spans:
        log(f"  6 s request's model forward on the device (torch.profiler): "
            f"{sum(ms for ms, _ in spans):.3f} ms in {len(spans)} device "
            f"activities, K1 {sum(k1):.3f} ms in {len(k1)} launches [{label}]")
    else:
        log("  6 s request's model forward: the profiler saw no device "
            "activity; device time not measured")
    return launches


def bench_batch(torch, np, device="cuda"):
    """The JAX bench's batch (bench.py:79-124): 88 synthetic utterances of
    432 frames at 24 kHz, 64 phones, vocabulary 80,
    make_synthetic_batch(default_rng(0)), moved to the card once, as the
    JAX bench moves its batch before the loop."""
    from a3t_tpu_torch.data import make_synthetic_batch
    from a3t_tpu_torch.tasks.config import FRONTEND_24K

    hop = FRONTEND_24K.hop_length
    batch = make_synthetic_batch(
        np.random.default_rng(0), batch_size=88, n_samples=hop * 431,
        n_text=64, hop_length=hop, vocab_size=80)
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


def step_split(torch, state, fe, batch, gen, label, what):
    """Where a step's time goes: CUDA events around the front-end (the
    step's default, the matmul-DFT route), forward + loss, backward and the
    optimizer; returns the four times in ms."""
    from a3t_tpu_torch.models.mlm import mlm_loss
    from a3t_tpu_torch.train import featurize

    ev = [torch.cuda.Event(enable_timing=True) for _ in range(5)]
    m = state.model
    m.train()
    ev[0].record()
    mb = featurize(fe, batch)
    ev[1].record()
    before, after = m(**mb, generator=gen)
    loss = mlm_loss(before, after, mb["speech"], mb["masked_position"])
    ev[2].record()
    grads = torch.autograd.grad(loss, state.params)
    ev[3].record()
    state.apply_gradients(grads)
    ev[4].record()
    torch.cuda.synchronize()
    t = [ev[i].elapsed_time(ev[i + 1]) for i in range(4)]
    log(f"  {what} step breakdown (CUDA events): front-end {t[0]:.2f} ms, "
        f"forward + loss {t[1]:.2f} ms, backward {t[2]:.2f} ms, optimizer "
        f"{t[3]:.2f} ms [{label}]")
    return t


def device_busy(torch, prof):
    """(busy ms, window ms, {kernel name: ms}, activities) of a
    torch.profiler run: the union of the device's activities over the
    window from the first to the last of them; None when the profiler saw
    no device activity."""
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    if not spans:
        return None
    busy, end, by_name = 0.0, spans[0][0], {}
    for t0, t1, name in spans:
        busy += max(0.0, t1 - max(t0, end))
        end = max(end, t1)
        by_name[name] = by_name.get(name, 0.0) + (t1 - t0) / 1e3
    return busy / 1e3, (end - spans[0][0]) / 1e3, by_name, len(spans)


def profile_step(torch, step, state, batch, gen, label, what, top=10):
    """One more step under torch.profiler: the device's busy share over the
    step and the kernels that take its time.  Returns ({kernel name: ms},
    busy ms), or None when the profiler saw no device activity."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    busy = device_busy(torch, prof)
    if busy is None:
        log(f"  {what} step profile: the profiler saw no device activity; "
            "busy share not measured")
        return None
    busy_ms, window, by_name, n = busy
    log(f"  {what} step profile: device busy {busy_ms:.2f} ms of "
        f"{window:.2f} ms from first to last device activity "
        f"(busy share {busy_ms / window:.4f}), {n} device activities "
        f"[{label}]")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
        log(f"    {ms:9.3f} ms  {name[:100]}")
    return by_name, busy_ms


def train_phase(torch, np, fa, wall_time, label, compute_dtype="float32",
                device="cuda"):
    """make_train_step at full width on the JAX bench's batch, in float32
    (phase train) or bfloat16 (phase train-bf16, the JAX bench's own
    precision)."""
    import dataclasses

    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.tasks.config import (FRONTEND_24K, OPTIM_24K,
                                            a3t_conformer_24k)
    from a3t_tpu_torch.train import (create_train_state, featurize,
                                     make_optimizer, make_train_step)

    what = "train" if compute_dtype == "float32" else "train-bf16"
    # fp32: the kernels' summation order only; bf16: as the longformer step,
    # a value near a rounding boundary lands one bf16 ulp apart
    tol_loss, tol_gnorm, tol_stats = (
        (TOL_STEP_LOSS, TOL_STEP_GRAD_NORM, TOL_STEP_PARAMS)
        if compute_dtype == "float32"
        else (TOL_LF_LOSS, TOL_LF_GRAD_NORM, TOL_LF_STATS))
    batch = bench_batch(torch, np, device)
    b_size, n_frames = batch["masked_position"].shape
    fe = LogMelFrontend(FRONTEND_24K, device=device)
    cfg = a3t_conformer_24k(vocab_size=80, compute_dtype=compute_dtype)

    # one step at dropout 0: K1/K2 against the plain attention branch
    def no_dropout(e):
        return dataclasses.replace(e, dropout_rate=0.0,
                                   positional_dropout_rate=0.0,
                                   attention_dropout_rate=0.0)

    cfg0 = dataclasses.replace(cfg, encoder=no_dropout(cfg.encoder),
                               decoder=no_dropout(cfg.decoder))
    flash = build_model(cfg0, device=device, seed=0)
    flash.postnet.dropout.rate = 0.0
    plain = _plain_copy(flash)
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
    log(f"  {what} step at dropout 0, kernels vs plain attention: loss "
        f"{lk:.7g} vs {lp:.7g} (rel {abs(lk - lp) / abs(lp):.3g}, tol "
        f"{tol_loss:g}), grad_norm {gk:.7g} vs {gp:.7g} (rel "
        f"{abs(gk - gp) / gp:.3g}, tol {tol_gnorm:g}), "
        f"max|params| diff {dparam:.3g} (tol {TOL_STEP_PARAMS:g}), "
        f"max|BatchNorm stats| diff {dstats:.3g} (tol {tol_stats:g}); "
        f"launches K1/K2 {nk} vs {np_}")
    check(nk == (8, 8) and np_ == (0, 0), "launches of the compared steps")
    check(abs(lk - lp) <= tol_loss * abs(lp), "kernel vs plain loss")
    check(abs(gk - gp) <= tol_gnorm * gp, "kernel vs plain grad_norm")
    check(dparam <= TOL_STEP_PARAMS and dstats <= tol_stats,
          "kernel vs plain updated parameters")
    del flash, plain, model, state, stats
    # the gradients leaf by leaf, which the loss and grad_norm above see
    # only in sum: K1/K2 against the plain attention branch
    flash = build_model(cfg0, device=device, seed=0)
    flash.postnet.dropout.rate = 0.0
    grad_check(torch, flash, _plain_copy(flash), contextlib.nullcontext(),
               lambda: (fa.LAUNCHES, fa.LAUNCHES_BWD), (8, 8),
               featurize(fe, batch),
               TOL_GRADS_F32 if compute_dtype == "float32"
               else TOL_GRADS_BF16_24K, what)
    del flash
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
        log(f"  {what} step {i} ({'warm-up' if i < 2 else 'timed'}): "
            f"{dt * 1e3:.2f} ms wall, loss {loss:.6g}, grad_norm "
            f"{gnorm:.6g}, notfinite_count {skipped}, launches K1 {n[0]} "
            f"K2 {n[1]}")
        check(np.isfinite(loss) and np.isfinite(gnorm) and skipped == 0,
              f"{what} step {i}: finite loss and grad_norm, no skip")
        check(n == (8, 8), f"{what} step {i}: {n} launches, expected 8 and 8")
        if i >= 2:
            walls.append(dt)
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(walls))
    frames = b_size * n_frames
    log(f"  {what}: median {med * 1e3:.2f} ms per step (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}, n={REPEATS}), "
        f"{frames / med:.1f} mel-frames/s (B*F = {frames}), peak memory "
        f"{peak / 2**30:.2f} GiB [{label}]")

    step_split(torch, state, fe, batch, gen, label, what)
    prof = profile_step(torch, step, state, batch, gen, label, what)
    if prof is not None:
        k1, k2 = (sum(ms for name, ms in prof[0].items() if tag in name)
                  for tag in ("fused_attention_fwd_", "fused_attention_dkdv_"))
        # K1's key-range combine and K2's dq pass are launches of the same
        # wrapper calls
        k1 += sum(ms for name, ms in prof[0].items()
                  if "fused_attention_combine_" in name)
        k2 += sum(ms for name, ms in prof[0].items()
                  if "fused_attention_dq_" in name)
        log(f"  in the profiled {what} step: K1 {k1:.2f} ms, K2 {k2:.2f} ms")
    return launches, dict(step_ms=med * 1e3)


def _plain_copy(model):
    """A copy of the model with every rel-pos attention on the plain
    branch."""
    import copy

    from a3t_tpu_torch.models.attention import RelPositionMultiHeadedAttention

    plain = copy.deepcopy(model)
    for m in plain.modules():
        if isinstance(m, RelPositionMultiHeadedAttention):
            m.use_flash = False
    return plain


class PlainBanded:
    """Within this context the banded-attention wrappers take their plain
    versions on CUDA tensors too: the oracle step that the kernel step is
    held against.  The port itself has no such switch."""

    NAMES = ("banded_attention_fwd", "banded_attention_bwd_dq",
             "banded_attention_bwd_dkv")

    def __init__(self, ba):
        self.ba = ba

    def __enter__(self):
        ba = self.ba
        self.saved = [getattr(ba, n) for n in self.NAMES]
        ba.banded_attention_fwd = ba.banded_attention_reference
        ba.banded_attention_bwd_dq = \
            lambda *a, text_grads=True: ba.banded_attention_bwd_dq_reference(*a)
        ba.banded_attention_bwd_dkv = ba.banded_attention_bwd_dkv_reference

    def __exit__(self, *exc):
        for n, f in zip(self.NAMES, self.saved):
            setattr(self.ba, n, f)
        return False


def _banded_launches(ba):
    return (ba.LAUNCHES_BANDED_FWD, ba.LAUNCHES_BANDED_DQ,
            ba.LAUNCHES_BANDED_DKV)


def _longformer_setup(torch, np, device):
    """train-longformer's batch on the card (make_synthetic_batch(
    default_rng(0)), 4 utterances of up to 8192 frames at 16 kHz, 64 phones,
    vocabulary 80), its front-end, the yaml's config and that config with
    every dropout rate 0."""
    import dataclasses

    from a3t_tpu_torch.data import make_synthetic_batch
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.tasks.config import FRONTEND_16K, a3t_longformer_16k

    hop = FRONTEND_16K.hop_length
    batch = make_synthetic_batch(
        np.random.default_rng(0), batch_size=4, n_samples=hop * 8191,
        n_text=64, hop_length=hop, vocab_size=80, fs=FRONTEND_16K.fs)
    batch = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
    cfg = a3t_longformer_16k(vocab_size=80)
    cfg0 = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, dropout_rate=0.0, positional_dropout_rate=0.0,
        attention_dropout_rate=0.0))
    return batch, LogMelFrontend(FRONTEND_16K, device=device), cfg, cfg0


def _dropout0_model(cfg0, device):
    from a3t_tpu_torch.models import build_model

    model = build_model(cfg0, device=device, seed=0)
    model.postnet.dropout.rate = 0.0
    return model


ZERO_GRADIENT = ("linear_k.bias", "depthwise_conv.bias")


def grad_check(torch, kern, plain, plain_ctx, launches, expected, mb,
               tol: float, what: str, loss_fn=None) -> float:
    """One dropout-0 forward, loss and backward through a path's kernels
    (model ``kern``) against the same through their plain versions (the
    copy ``plain``, run within ``plain_ctx``): the loss, and the gradient
    leaf by leaf, max|kernel - plain| over max|plain| of each parameter,
    which must stay within ``tol``.  Two kinds of bias have a true gradient
    of zero, so theirs is rounding noise in both runs: the key projections'
    (softmax ignores a constant added to every score of a row) and the
    depthwise convolutions' (the BatchNorm after them subtracts the batch
    mean).  They are held to the largest gradient of all leaves instead.  ``launches()`` reads the
    kernels' counts, which must be ``expected`` for the kernel run and 0
    for the plain one.  ``loss_fn(model, mb, generator)`` replaces the
    masked L1 loss of the forward.  Returns the worst ratio."""
    from a3t_tpu_torch.models.mlm import mlm_loss

    def mlm(model, mb, gen):
        before, after = model(**mb, generator=gen)
        return mlm_loss(before, after, mb["speech"], mb["masked_position"])

    runs = []
    for model in (kern, plain):
        model.train()
        names, params = zip(*model.named_parameters())
        start = launches()
        with plain_ctx if model is plain else contextlib.nullcontext():
            loss = (loss_fn or mlm)(model, mb,
                                    torch.Generator().manual_seed(0))
            grads = torch.autograd.grad(loss, params)
        torch.cuda.synchronize()
        runs.append((float(loss.detach()), dict(zip(names, grads)),
                     tuple(n - n0 for n, n0 in zip(launches(), start))))
        del loss, grads
    (lk, gk, nk), (lp, gp, np_) = runs
    top = max(g.abs().max().item() for g in gp.values())
    ratio = {}
    for name, want in gp.items():
        ref = top if name.endswith(ZERO_GRADIENT) \
            else want.abs().max().item()
        ratio[name] = (gk[name] - want).abs().max().item() / max(ref, 1e-30)
    worst = sorted(ratio.items(), key=lambda kv: -kv[1])
    log(f"  gradients at dropout 0, kernels vs plain versions, {what}: loss "
        f"{lk:.7g} vs {lp:.7g} (rel {abs(lk - lp) / abs(lp):.3g}), "
        f"max|grad-plain|/max|plain| per leaf (tol {tol:g}): worst "
        + ", ".join(f"{n} {r:.3g}" for n, r in worst[:3])
        + f"; median leaf {worst[len(worst) // 2][1]:.3g} of {len(worst)}; "
        f"largest gradient {top:.4g}; launches {nk} vs {np_}")
    check(nk == expected and not any(np_),
          f"launches of the compared gradients ({what})")
    check(abs(lk - lp) <= TOL_LF_LOSS * abs(lp) and worst[0][1] <= tol,
          f"kernel vs plain gradients ({what})")
    del runs, gk, gp
    torch.cuda.empty_cache()
    return worst[0][1]


def longformer_grad_check(torch, ba, cfg0, fe, batch, tol: float,
                          what: str, device="cuda") -> float:
    """:func:`grad_check` of the longformer model through K3-K5."""
    import copy

    from a3t_tpu_torch.train import featurize

    n_blocks = cfg0.encoder.num_blocks + cfg0.encoder.pre_speech_layers
    kern = _dropout0_model(cfg0, device)
    worst = grad_check(torch, kern, copy.deepcopy(kern), PlainBanded(ba),
                       lambda: _banded_launches(ba), (n_blocks,) * 3,
                       featurize(fe, batch), tol, f"longformer {what}")
    del kern
    torch.cuda.empty_cache()
    return worst


def train_longformer_phase(torch, np, ba, wall_time, label, device="cuda"):
    """make_train_step of configs/a3t_longformer_16k.yaml at full width and
    depth, bf16, on the yaml's largest bucket: 4 utterances of 8192 frames
    (16 kHz, hop 200), 64 phones, vocabulary 80."""
    import copy
    import dataclasses

    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.tasks.config import OPTIM_24K
    from a3t_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step)

    batch, fe, cfg, cfg0 = _longformer_setup(torch, np, device)
    b_size, n_frames = batch["masked_position"].shape
    n_blocks = cfg.encoder.num_blocks + cfg.encoder.pre_speech_layers

    # one step at dropout 0: K3/K4/K5 against their plain versions
    kern = _dropout0_model(cfg0, device)
    plain = copy.deepcopy(kern)
    results = []
    for model in (kern, plain):
        state = create_train_state(model, make_optimizer(OPTIM_24K),
                                   device=device)
        step = make_train_step(model, fe, device=device)
        ba.reset_launches()
        if model is plain:
            with PlainBanded(ba):
                state, stats = step(state, batch, 0)
        else:
            state, stats = step(state, batch, 0)
        torch.cuda.synchronize()
        results.append((float(stats["loss"]), float(stats["grad_norm"]),
                        _banded_launches(ba)))
    (lk, gk, nk), (lp, gp, np_) = results
    dparam = max((a - b).abs().max().item() for a, b in
                 zip(kern.parameters(), plain.parameters()))
    dstats = max((a - b).abs().max().item() for a, b in
                 zip(kern.buffers(), plain.buffers()) if a.is_floating_point())
    log(f"  longformer step at dropout 0, kernels vs plain versions: loss "
        f"{lk:.7g} vs {lp:.7g} (rel {abs(lk - lp) / abs(lp):.3g}, tol "
        f"{TOL_LF_LOSS:g}), grad_norm {gk:.7g} vs {gp:.7g} (rel "
        f"{abs(gk - gp) / gp:.3g}, tol {TOL_LF_GRAD_NORM:g}), max|params| "
        f"diff {dparam:.3g} (tol {TOL_STEP_PARAMS:g}), max|BatchNorm stats| "
        f"diff {dstats:.3g} (tol {TOL_LF_STATS:g}); launches K3/K4/K5 {nk} "
        f"vs {np_}")
    check(nk == (n_blocks,) * 3 and np_ == (0, 0, 0),
          "launches of the compared longformer steps")
    check(abs(lk - lp) <= TOL_LF_LOSS * abs(lp), "kernel vs plain loss")
    check(abs(gk - gp) <= TOL_LF_GRAD_NORM * gp, "kernel vs plain grad_norm")
    check(dparam <= TOL_STEP_PARAMS and dstats <= TOL_LF_STATS,
          "kernel vs plain updated parameters")
    del kern, plain, model, state, stats, step
    torch.cuda.empty_cache()

    # the gradients themselves, leaf by leaf: on this batch, where the
    # pre-encoder's fully masked padded rows dominate them (the Pallas
    # semantics, kept), and on the same batch with every utterance at full
    # length, where no row is padding and every gradient is the true one, in
    # bf16 as the yaml trains and in float32
    full = dict(batch, audio_lengths=torch.full_like(
        batch["audio_lengths"], int(batch["audio"].shape[1])))
    cfg0_f32 = dataclasses.replace(cfg0, encoder=dataclasses.replace(
        cfg0.encoder, compute_dtype="float32"))
    longformer_grad_check(torch, ba, cfg0, fe, batch, TOL_GRADS_BF16,
                          "bf16, the batch")
    longformer_grad_check(torch, ba, cfg0, fe, full, TOL_GRADS_BF16,
                          "bf16, full-length utterances")
    longformer_grad_check(torch, ba, cfg0_f32, fe, full, TOL_GRADS_F32,
                          "float32, full-length utterances")

    # the yaml's dropout rates: 2 warm-up and 5 timed steps
    model = build_model(cfg, device=device, seed=0)
    state = create_train_state(model, make_optimizer(OPTIM_24K),
                               device=device)
    step = make_train_step(model, fe, device=device)
    gen = torch.Generator().manual_seed(0)
    walls = []
    ba.reset_launches()
    for i in range(2 + REPEATS):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        before = _banded_launches(ba)
        (state, stats), dt = wall_time(step, state, batch, gen)
        n = tuple(a - b for a, b in zip(_banded_launches(ba), before))
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        skipped = int(stats["notfinite_count"])
        log(f"  longformer step {i} ({'warm-up' if i < 2 else 'timed'}): "
            f"{dt * 1e3:.2f} ms wall, loss {loss:.6g}, grad_norm "
            f"{gnorm:.6g}, notfinite_count {skipped}, launches K3/K4/K5 {n}")
        check(np.isfinite(loss) and np.isfinite(gnorm) and skipped == 0,
              f"longformer step {i}: finite loss and grad_norm, no skip")
        check(n == (n_blocks,) * 3,
              f"longformer step {i}: launches {n}, expected {n_blocks} each")
        if i >= 2:
            walls.append(dt)
    launches = _banded_launches(ba)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(walls))
    frames = b_size * n_frames
    log(f"  train-longformer: median {med * 1e3:.2f} ms per step (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}, n={REPEATS}), "
        f"{frames / med:.1f} mel-frames/s (B*F = {frames}), peak memory "
        f"{peak / 2**30:.2f} GiB [{label}]")

    step_split(torch, state, fe, batch, gen, label, "longformer")
    prof = profile_step(torch, step, state, batch, gen, label, "longformer",
                        top=12)
    if prof is None:
        return launches, med * 1e3
    by_name, busy = prof
    k3, k4, k5 = (sum(ms for name, ms in by_name.items()
                      if any(tag in name for tag in tags))
                  for tags in (("banded_attention_fwd_",),
                               ("banded_attention_bwd_dq_",
                                "banded_text_grad_sum_kernel"),
                               ("banded_attention_bwd_dkv_",)))
    log(f"  in the profiled step: K3 {k3:.2f} ms, K4 {k4:.2f} ms, K5 "
        f"{k5:.2f} ms, together {(k3 + k4 + k5) / busy:.3f} of the "
        f"device's busy time")
    return launches, med * 1e3


# --- trainer: bin/train.main on a generated corpus ---------------------------

CONFIG_24K = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "a3t_conformer_24k.yaml")
# the generated corpus: 6 training shards of 100 utterances and one
# validation shard of 64, each written by its own process.  8-35 phones of
# 60-220 ms make 40-470 frames at 24 kHz (hop 300): about half fall in the
# yaml's 256-frame bucket (146 a batch) and half in its 512-frame bucket
# (73 a batch), none above.  The training split keeps two whole batches of
# each bucket (292 and 146 utterances, the first in uid order), so every
# step of the phase is a full batch, as in a corpus of thousands of batches.
TRAIN_SHARDS = 6
SHARD_UTTS = 100
VALID_UTTS = 64
PHONES = (8, 36)
HOP_24K = 300
MIN_FRAMES = 16  # BatcherConfig.min_frames: shorter utterances are dropped
TRAIN_FILL = ((256, 2 * 146), (512, 2 * 73))  # (bucket frames, utterances)
ITERS = 4  # steps per epoch of the runs held against each other: one pass


def _gen_shard(out_dir, n_utts, seed, fs=24000, phones=PHONES):
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus

    generate_speechlike_corpus(out_dir, n_utts=n_utts, n_speakers=8,
                               fs=fs, n_phones_range=phones, seed=seed,
                               speaker_seed=0)


def _n_frames(path, hop=HOP_24K):
    """The batcher's frame count of a wav, from its header."""
    import wave

    with wave.open(path) as w:
        return 1 + w.getnframes() // hop


def make_corpus(root, fs=24000, hop=HOP_24K, fill=TRAIN_FILL,
                shards=TRAIN_SHARDS, valid_utts=VALID_UTTS, seed=0,
                phones=PHONES, shard_utts=SHARD_UTTS):
    """(train_dir, valid_dir, seconds, bytes): the shards of ``shard_utts``
    utterances of ``phones`` phones (seeds ``seed``, ``seed + 1``, ...)
    generated in parallel processes, then merged into one data directory
    (uids prefixed by shard) that keeps ``fill``'s utterances of each
    bucket; with ``valid_utts`` 0 no validation split (valid_dir None)."""
    import multiprocessing

    from a3t_tpu_torch.data.fileio import (read_2column_text,
                                           write_2column_text)

    t0 = time.perf_counter()
    jobs = [(os.path.join(root, f"shard{k}"), shard_utts, seed + k, fs,
             phones) for k in range(shards)]
    valid = os.path.join(root, "valid") if valid_utts else None
    if valid:
        jobs.append((valid, valid_utts, 100, fs, phones))
    with multiprocessing.get_context("spawn").Pool(len(jobs)) as pool:
        pool.starmap(_gen_shard, jobs)
    merged = {name: {} for name in ("wav.scp", "text", "mfa_start",
                                    "mfa_end", "utt2spk")}
    for k, (shard, *_) in enumerate(jobs[:shards]):
        for name, table in merged.items():
            for uid, v in read_2column_text(os.path.join(shard, name)).items():
                table[f"s{k}_{uid}"] = v
    frames = {u: _n_frames(p, hop) for u, p in merged["wav.scp"].items()}
    keep, lo = [], MIN_FRAMES
    for hi, n in fill:
        members = sorted(u for u, f in frames.items() if lo < f <= hi)
        check(len(members) >= n, f"the generated corpus holds {n} "
              f"utterances of {lo + 1}-{hi} frames (it holds {len(members)})")
        keep += members[:n]
        lo = hi
    train = os.path.join(root, "train")
    for name, table in merged.items():
        write_2column_text(os.path.join(train, name),
                           {u: table[u] for u in sorted(keep)})
    seconds = time.perf_counter() - t0
    nbytes = sum(os.path.getsize(merged["wav.scp"][u]) for u in keep)
    if valid:
        nbytes += sum(os.path.getsize(os.path.join(d, f))
                      for d, _, names in os.walk(valid) for f in names)
    return train, valid, seconds, nbytes


def _train_argv(train, valid, exp, device, *sets):
    argv = ["--config", CONFIG_24K, "--device", device]
    for s in (f"train_data_dir={train}", f"valid_data_dir={valid}",
              f"exp_dir={exp}", "trainer.keep_nbest_models=2",
              "trainer.log_interval=4", *sets):
        argv += ["--set", s]
    return argv


def _snapshot(state):
    """The model's parameters and BatchNorm statistics and Adam's moments,
    copied to the host."""
    out = {k: v.detach().cpu().clone()
           for k, v in state.model.state_dict().items()}
    out["opt.mu"] = state.opt_state.mu.cpu().clone()
    out["opt.nu"] = state.opt_state.nu.cpu().clone()
    return out


def _compare(torch, got, want, what):
    """Check bit equality; on a difference print each differing tensor's
    largest |difference| before failing."""
    bad = [(k, (got[k].double() - want[k].double()).abs().max().item())
           for k in want if not torch.equal(got[k], want[k])]
    for k, d in bad[:20]:
        log(f"    {what}: {k} differs, max|diff| {d:.3g}")
    log(f"  {what}: {len(want) - len(bad)} of {len(want)} tensors "
        f"(parameters, BatchNorm statistics, Adam moments) equal bit for bit")
    check(not bad, f"{what}: the resumed run equals the uninterrupted run")


def _fill(batcher):
    """bucket frames -> the share of the bucket's frames that its
    utterances' own frames fill (the rest is padding to the bucket)."""
    return {spec.n_frames: sum(batcher._frames[u] for u in members)
            / (len(members) * spec.n_frames)
            for spec, members in zip(batcher.buckets, batcher.bucket_members)}


def _bucket_numbers(np, steps, label, what, fill=None):
    """Per bucket (per corpus and bucket in a multi-corpus run): median
    device ms per optimizer step (CUDA events around each step call; a
    chained call covers its ``steps`` sub-steps), mel-frames/s (B x F over
    it, and with ``fill`` the utterances' own frames), the median data wait
    (the reporter's iter time), the host's time in the step call (and per
    step of a chained call), and the device's idle time before the call
    (from the previous call's end event).  Every batch is full; the first
    call of each bucket is left out when it is not the only one."""
    out = {}
    for corpus, frames in sorted({(r.get("corpus", ""), r["frames"])
                                  for r in steps}):
        rows = [r for r in steps
                if (r.get("corpus", ""), r["frames"]) == (corpus, frames)]
        rows = rows[1:] or rows
        n = [r.get("steps", 1) for r in rows]
        per = [r["device_ms"] / k for r, k in zip(rows, n)]
        ms = float(np.median(per))
        wait = float(np.median([r["iter_wait_s"] for r in rows])) * 1e3
        host = float(np.median([r["host_s"] for r in rows])) * 1e3
        host_step = float(np.median([r["host_s"] / k
                                     for r, k in zip(rows, n)])) * 1e3
        gaps = [r["gap_ms"] for r in rows if "gap_ms" in r]
        gap = float(np.median(gaps)) if gaps else float("nan")
        b = rows[0]["batch"]
        out[(corpus, frames) if corpus else frames] = ms
        rate = b * frames / ms * 1e3
        own = (f", of them the utterances' own {rate * fill[frames]:.1f} "
               f"(fill {fill[frames]:.4f})" if fill else "")
        chain = (f" ({host_step:.2f} ms per step, calls of {n} steps)"
                 if max(n) > 1 else "")
        log(f"  {what} {corpus + ' ' if corpus else ''}bucket {frames} "
            f"frames x {b}: median {ms:.2f} ms per step on the device's "
            f"clock (n={len(rows)}, min {min(per):.2f}, max "
            f"{max(per):.2f}), {rate:.1f} mel-frames/s (B*F = {b * frames})"
            f"{own}, median data wait {wait:.2f} ms, host in the step call "
            f"{host:.2f} ms{chain}, device idle before the step {gap:.2f} ms"
            f" [{label}]")
    return out


def measure_trainer(torch, np, trainer, state, epoch, label, what):
    """On a built trainer: an epoch of 8 steps for the per-bucket step
    times and data waits, the device's busy share over an epoch of 3 steps
    (torch.profiler), the host's batch assembly and native decode per
    batch, and the same bucket's batch through the bare step."""
    from torch.profiler import ProfilerActivity, profile

    factory = trainer.train_iter_factory
    batcher = factory.batcher
    factory.num_iters = trainer.config.num_iters_per_epoch = 8
    n0 = len(trainer.step_log)
    t0 = time.perf_counter()
    state = trainer.train_one_epoch(state, epoch)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    steps = list(trainer.step_log)[n0:]
    check(all(np.isfinite(r["loss"]) for r in steps),
          f"{what}: every step's loss is finite")
    log(f"  {what}: an epoch of {len(steps)} steps in {wall:.2f} s wall "
        f"({wall / len(steps) * 1e3:.1f} ms per step, the epoch's set-up "
        f"included) [{label}]")
    medians = _bucket_numbers(np, steps, label, what, _fill(batcher))

    # device activities only: recording the host's ops as well slows each
    # launch, and the bf16 step's dispatch only just keeps pace with the
    # card (with them, its 3 steps read 226-257 ms against ~195 ms)
    factory.num_iters = trainer.config.num_iters_per_epoch = 3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = trainer.train_one_epoch(state, epoch + 1)
        torch.cuda.synchronize()
    busy = device_busy(torch, prof)
    if busy is None:
        log(f"  {what}: the profiler saw no device activity; busy share "
            "not measured")
    else:
        busy_ms, window, _, n = busy
        log(f"  {what}: over an epoch of 3 steps the device is busy "
            f"{busy_ms:.2f} ms of {window:.2f} ms from first to last device "
            f"activity (busy share {busy_ms / window:.4f}, idle "
            f"{1 - busy_ms / window:.4f}), {n} device activities [{label}]")
        # where the window goes: each step between its events, the gaps
        # between steps, and what lies outside them (the first batch's copy
        # before step 1, the statistics' copy after step 3)
        prof_steps = list(trainer.step_log)[-3:]
        inside = sum(r["device_ms"] + r.get("gap_ms", 0.0)
                     for r in prof_steps)
        log(f"  {what}: the 3 profiled steps on the device's clock "
            + ", ".join(f"{r['device_ms']:.2f} ms (gap before "
                        f"{r.get('gap_ms', float('nan')):.2f}, host "
                        f"{r['host_s'] * 1e3:.2f} ms, data wait "
                        f"{r['iter_wait_s'] * 1e3:.2f} ms)"
                        for r in prof_steps)
            + f"; outside the steps {window - inside:.2f} ms of the window")

    # the host's side of one batch of each bucket
    rng = np.random.default_rng(0)
    for bi, spec in enumerate(batcher.buckets):
        uids = batcher.bucket_members[bi][: spec.batch_size]
        idx = [batcher._uid_index[u] for u in uids]
        buf = np.zeros((len(uids), spec.n_samples), np.int16)
        dec, gen = [], []
        for _ in range(3):
            t0 = time.perf_counter()
            batcher._loader.load_batch_i16(idx, spec.n_samples, out=buf)
            dec.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            host = batcher.make_batch(bi, uids, rng)
            gen.append(time.perf_counter() - t0)
        log(f"  {what} bucket {spec.n_frames}: native decode of "
            f"{len(uids)} wavs {np.median(dec) * 1e3:.2f} ms, whole batch "
            f"assembly (decode, masking, positions) {np.median(gen) * 1e3:.2f}"
            f" ms per batch on the host")

    # the bare step on the 256-frame bucket's batch, already on the card
    bi = 0
    spec = batcher.buckets[bi]
    host = batcher.make_batch(bi, batcher.bucket_members[bi][
        : spec.batch_size], np.random.default_rng(1))
    batch = {k: torch.as_tensor(v, device=state.opt_state.mu.device)
             for k, v in host.items()}
    gen = torch.Generator().manual_seed(0)
    times = []
    for i in range(4):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        state, stats = trainer.train_step(state, batch, gen)
        ev[1].record()
        torch.cuda.synchronize()
        if i:
            times.append(ev[0].elapsed_time(ev[1]))
    bare = float(np.median(times))
    log(f"  {what}: the bare step on a {spec.n_frames}-frame batch of "
        f"{spec.batch_size}: median {bare:.2f} ms (n=3), the trainer's "
        f"{medians.get(spec.n_frames, float('nan')):.2f} ms for the same "
        f"bucket ({medians.get(spec.n_frames, float('nan')) / bare:.3f}x) "
        f"[{label}]")
    return state


def kernel_pair_check(torch, fa, mask, h, d, g, where, dtypes=None,
                      rates=(0.0, 0.2)):
    """K1 (out, lse) and K2 (dq, dk, dv, dbias) against their plain
    versions at the key mask ``mask`` (B, L) with ``h`` heads of width
    ``d``: random q, k, v, bias and output gradient from ``g``, float32 and
    bfloat16 (or ``dtypes``), at each of ``rates``.  Returns the largest
    |kernel - plain| of K1 and of K2 in float32."""
    b, l = mask.shape
    dev = mask.device
    worst = [0.0, 0.0]
    for dt, tol, tol_bwd in dtypes or (
            (torch.float32, TOL_F32, TOL_BWD_F32),
            (torch.bfloat16, TOL_BF16, TOL_BWD_BF16)):
        for rate in rates:
            q, k, v, go = (torch.randn(b, h, l, d, generator=g).to(
                dev, dt) for _ in range(4))
            bias = torch.randn(b, h, l, l, generator=g).to(dev, dt)
            out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 2468,
                                              rate)
            ref, ref_lse = fa.fused_attention_reference(
                q, k, v, bias, mask, 2468, rate)
            ins = [t.clone().requires_grad_() for t in (q, k, v, bias)]
            got = torch.autograd.grad(
                fa.fused_attention(*ins, mask, rate, 2468), ins, go)
            want = fa.fused_attention_bwd_reference(
                q, k, v, bias, mask, 2468, rate, out, lse, go)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            lerr = (lse - ref_lse).abs().max().item()
            errs = [_rel_err(a, w) for a, w in zip(got, want)]
            log(f"  K1/K2 at {where} {(b, h, l, d)} {str(dt)[6:]} "
                f"rate={rate}: K1 max|out-plain| {err:.3g}, max|lse-plain| "
                f"{lerr:.3g} (tol {tol:g}); K2 max|grad-plain|/max|plain| "
                f"dq {errs[0]:.3g}, dk {errs[1]:.3g}, dv {errs[2]:.3g}, "
                f"dbias {errs[3]:.3g} (tol {tol_bwd:g})")
            check(err <= tol and lerr <= tol,
                  f"K1 at {where} {(b, h, l, d)} {dt} rate={rate}")
            check(all(a.dtype == w.dtype for a, w in zip(got, want))
                  and max(errs) <= tol_bwd,
                  f"K2 at {where} {(b, h, l, d)} {dt} rate={rate}")
            if dt == torch.float32:
                worst[0] = max(worst[0], err)
                worst[1] = max(worst[1], max(
                    (a - w).abs().max().item() for a, w in zip(got, want)))
            del q, k, v, go, bias, out, lse, ref, ref_lse, ins, got, want
    return worst


def trainer_kernel_check(torch, np, fa, batcher, h, d, frontend):
    """K1 (out, lse) and K2 (dq, dk, dv, dbias) against their plain versions
    at each bucket's shape as the trainer's step hands it to them: B the
    bucket's batch size, L its frames plus its phone tokens, the key mask
    that of the bucket's first batch (its frames, then its phones, as
    featurize and the model build it); float32 and bfloat16, dropout 0 and
    0.2, random q, k, v, bias and output gradient.  Returns the largest
    |kernel - plain| of K1 and of K2 in float32."""
    from a3t_tpu_torch.train.train_step import featurize

    g = torch.Generator().manual_seed(5)
    worst = [0.0, 0.0]
    for bi, spec in enumerate(batcher.buckets):
        host = batcher.make_batch(bi, batcher.bucket_members[bi][
            : spec.batch_size], np.random.default_rng(bi))
        mb = featurize(frontend, host)
        mask = torch.cat([mb["speech_mask"], mb["text_mask"].bool()], 1)
        b, l = mask.shape
        check((b, l) == (spec.batch_size, spec.n_frames + spec.n_text),
              f"the {spec.n_frames}-frame bucket's attention is "
              f"{spec.batch_size} x {spec.n_frames + spec.n_text}")
        errs = kernel_pair_check(torch, fa, mask, h, d, g, "the trainer's")
        worst = [max(a, b) for a, b in zip(worst, errs)]
    return worst


def transfer_check(torch, np, trainer, epoch):
    """The trainer's batches as its step receives them, through the
    prefetch thread and DeviceTransfer, against the same batches assembled
    on the host, bit for bit.  Before it reads each batch the consumer
    queues ~50 ms of work on its stream, so the producer copies ahead and
    reuses its pinned buffers; it holds every other batch, and copies the
    others on its stream and drops them at once, so their memory goes back
    to the allocator while those copies still wait in the stream."""
    factory = trainer.train_iter_factory
    check(factory.transfer is not None, "the trainer's batches reach the "
          "card through DeviceTransfer")
    n = 2 * ITERS
    saved = factory.num_iters
    factory.num_iters = n
    try:
        want = list(factory._batches(epoch))
        it = factory(epoch)
        held, copies = {}, []
        try:
            for i, batch in enumerate(it):
                torch.cuda._sleep(100_000_000)
                copies.append({k: t.clone() for k, t in batch.items()})
                if i % 2 == 0:
                    held[i] = batch
                del batch
        finally:
            it.close()
    finally:
        factory.num_iters = saved
    torch.cuda.synchronize()
    check(len(copies) == n, f"the prefetch iterator gave {n} batches")
    bad = [(i, k, how) for how, got in
           (("read on the step's stream", dict(enumerate(copies))),
            ("held", held))
           for i, batch in got.items() for k, t in batch.items()
           if not np.array_equal(t.cpu().numpy(), want[i][k])]
    log(f"  DeviceTransfer: {n} batches ({len(want[0])} arrays each) read "
        f"on the step's stream after a queued wait, {len(held)} of them "
        f"held to the end: {len(bad)} arrays differ from the host's "
        f"batches {bad[:8]}")
    check(not bad, "the batches on the card equal the host's bit for bit")


@contextlib.contextmanager
def deterministic_mode(torch):
    """cuDNN's deterministic algorithms, PyTorch's deterministic
    implementations and CUBLAS_WORKSPACE_CONFIG, restored on exit."""
    cudnn = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    cublas = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = cudnn
        torch.use_deterministic_algorithms(False)
        if cublas is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG")
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = cublas


def trainer_phase(torch, np, fa, label, root, device="cuda"):
    """configs/a3t_conformer_24k.yaml, unedited, trained through
    bin/train.main on a 24 kHz corpus generated under ``root``; returns the
    K1/K2 launches of the uninterrupted fp32 run and the bf16 run, K1's and
    K2's largest float32 errors at the trainer's shapes, and run A's
    experiment directory and the validation split, which the serve-cli
    phase serves from."""
    import gc

    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.tasks.mlm import MLMTask
    from a3t_tpu_torch.train.checkpoint import CheckpointManager
    from a3t_tpu_torch.train.train_step import featurize

    train, valid, secs, nbytes = make_corpus(os.path.join(root, "data"))
    log(f"  corpus: {TRAIN_SHARDS * SHARD_UTTS} training and "
        f"{VALID_UTTS} validation utterances at 24 kHz generated in "
        f"{secs:.2f} s ({TRAIN_SHARDS + 1} processes), {nbytes / 1e6:.1f}"
        f" MB on disk")

    def run(name, *sets):
        exp = os.path.join(root, name)
        t0 = time.perf_counter()
        trainer, state = train_main(_train_argv(train, valid, exp, device,
                                                *sets))
        torch.cuda.synchronize()
        log(f"  run {name} ({' '.join(sets)}): "
            f"{len(trainer.step_log)} steps in "
            f"{time.perf_counter() - t0:.2f} s")
        return exp, trainer, state

    iters = f"trainer.num_iters_per_epoch={ITERS}"
    # Runs A, B and C in deterministic mode: cuDNN's deterministic
    # algorithms, and PyTorch's deterministic implementations, which
    # this step needs for nn.Embedding's backward (its CUDA kernel sums
    # with atomics, so two identical passes differ in the embeddings'
    # gradients without them).  Any op without a deterministic
    # implementation would raise here.
    with deterministic_mode(torch):
        # A: two epochs, uninterrupted
        fa.reset_launches()
        exp_a, trainer, state = run("A", "trainer.max_epoch=2", iters)
        launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
        want = _snapshot(state)
        batcher = trainer.train_iter_factory.batcher
        buckets = [(b.n_frames, b.batch_size) for b in batcher.buckets]
        members = [len(m) for m in batcher.bucket_members]
        log(f"  buckets (frames, batch): {buckets}, members {members}, "
            f"{batcher.n_dropped} dropped")
        check(buckets == [(256, 146), (512, 73)],
              "the yaml's first two buckets at its batch sizes")
        check(all(m == 2 * b for m, (_, b) in zip(members, buckets))
              and batcher.n_dropped == 0,
              "each bucket holds two whole batches, nothing dropped")
        steps = trainer.step_log
        check(len(steps) == 2 * ITERS and all(
            np.isfinite(r["loss"]) for r in steps),
            "every step of run A is finite")
        check(int(state.opt_state.total_notfinite) == 0,
              "no step of run A was skipped")
        n_eval = sum(len(trainer.valid_iter_factory.batcher.batch_plan(e))
                     for e in (1, 2))
        log(f"  run A: {len(steps)} train steps "
            f"{[(r['frames'], round(r['loss'], 3)) for r in steps]}, "
            f"{n_eval} eval steps; launches K1 {launches[0]} K2 "
            f"{launches[1]}; valid loss by epoch "
            f"{[round(h['valid']['loss'], 4) for h in trainer.reporter.history.values()]}")
        check(launches == (8 * (len(steps) + n_eval), 8 * len(steps)),
              "8 K1 launches per train and eval step, 8 K2 per train "
              "step")
        files = sorted(os.listdir(exp_a)) + sorted(
            os.listdir(os.path.join(exp_a, "checkpoints")))
        log(f"  run A wrote {files}")
        check({"config.yaml", "tokens.txt", "epoch_1.pt", "epoch_2.pt",
               "ave_2best.pt"} <= set(files),
              "config, tokens, epoch and average checkpoints written")

        model, cfg, conv = MLMTask.build_model_from_dir(exp_a,
                                                        device=device)
        vb = trainer.valid_iter_factory.batcher
        host = vb.make_batch(0, vb.bucket_members[0][
            : vb.buckets[0].batch_size], np.random.default_rng(0))
        fe = LogMelFrontend(cfg.frontend, device=device)
        with torch.no_grad():
            before, after = model(**featurize(fe, host))
        check(bool(torch.isfinite(after).all()) and tuple(after.shape)
              == (vb.buckets[0].batch_size, vb.buckets[0].n_frames, 80),
              "build_model_from_dir serves a finite forward")
        log(f"  build_model_from_dir(A): forward on a validation batch "
            f"{tuple(after.shape)}, finite")
        del model, before, after

        # B: stopped after epoch 1, started again
        exp_b, _, _ = run("B", "trainer.max_epoch=1", iters)
        _, tb, sb = run("B", "trainer.max_epoch=2", iters)
        check([r["epoch"] for r in tb.step_log] == [2] * ITERS,
              "run B resumed at epoch 2")
        _compare(torch, _snapshot(sb), want, "epoch resume (B vs A)")
        del tb, sb

        # C: stopped at a mid-epoch save in epoch 2, started again
        save = CheckpointManager.save_mid_epoch

        class Stop(Exception):
            pass

        def save_then_stop(self, epoch, iteration, *a, **kw):
            save(self, epoch, iteration, *a, **kw)
            if epoch == 2:
                raise Stop

        CheckpointManager.save_mid_epoch = save_then_stop
        try:
            run("C", "trainer.max_epoch=2", iters,
                "trainer.save_interval_steps=3")
            check(False, "run C stops at its mid-epoch save")
        except Stop:
            pass
        finally:
            CheckpointManager.save_mid_epoch = save
        mid = CheckpointManager(os.path.join(root, "C", "checkpoints")
                                ).latest_mid_epoch()
        check(mid == (2, 3), f"run C left a mid-epoch save at {mid}")
        _, tc, sc = run("C", "trainer.max_epoch=2", iters,
                        "trainer.save_interval_steps=3")
        check([(r["epoch"], r["iteration"]) for r in tc.step_log]
              == [(2, 3)], "run C resumed at epoch 2, iteration 3")
        _compare(torch, _snapshot(sc), want, "mid-epoch resume (C vs A)")
        del tc, sc
        _bucket_numbers(np, steps, label, "run A (deterministic mode)",
                        _fill(batcher))
    gc.collect()
    torch.cuda.empty_cache()

    att = next(m for m in state.model.modules() if hasattr(m, "d_k"))
    errs = trainer_kernel_check(torch, np, fa, batcher, att.h, att.d_k,
                                fe)
    transfer_check(torch, np, trainer, 5)

    # timing in fp32 (cuDNN's own choices again) on run A's trainer
    state = measure_trainer(torch, np, trainer, state, 3, label,
                            "trainer fp32")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    # one short epoch in bf16, the stashes' own precision
    fa.reset_launches()
    _, trainer, state = run(
        "bf16", "trainer.max_epoch=1", "trainer.num_iters_per_epoch=6",
        "model.encoder.compute_dtype=bfloat16",
        "model.decoder.compute_dtype=bfloat16")
    bf16 = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    steps = trainer.step_log
    n_eval = len(trainer.valid_iter_factory.batcher.batch_plan(1))
    check(all(np.isfinite(r["loss"]) for r in steps)
          and int(state.opt_state.total_notfinite) == 0,
          "every bf16 step is finite and not skipped")
    log(f"  run bf16: {len(steps)} train steps, {n_eval} eval steps; "
        f"launches K1 {bf16[0]} K2 {bf16[1]}")
    check(bf16 == (8 * (len(steps) + n_eval), 8 * len(steps)),
          "bf16: 8 K1 launches per train and eval step, 8 K2 per train "
          "step")
    _bucket_numbers(np, steps, label, "trainer bf16 epoch 1",
                    _fill(trainer.train_iter_factory.batcher))
    measure_trainer(torch, np, trainer, state, 2, label, "trainer bf16")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()
    return ((launches[0] + bf16[0], launches[1] + bf16[1]), errs, exp_a,
            valid)


TOL_GL_1 = 1e-4  # Griffin-Lim, card against CPU, one iteration
# 32 iterations: the phase recursion carries each iteration's rounding
# (cuFFT against pocketfft, ~1e-7 relative) into the next; the port on the
# CPU against JAX's reads 1.2e-6 over 32 (tests/test_torch_griffin_lim.py)
TOL_GL_32 = 1e-3
SERVE_LR = "5e-5,1"  # --dynamic-eval: lr and passes
SERVE_REPEATS = 3  # warm requests of each mode, each with its model load
MCD_UTTS = 4


def _pwg_pickle(torch, path):
    """A parallel_wavegan-layout pickle of the 24 kHz generator (model ->
    generator) with every conv weight split into weight_g and weight_v, from
    seeded tensors."""
    from a3t_tpu_torch.models import PWGConfig, build_vocoder

    g = torch.Generator().manual_seed(7)
    sd = {}
    for k, v in build_vocoder(PWGConfig(), device="cpu",
                              seed=1).state_dict().items():
        if k.endswith(".weight") and v.dim() >= 3:
            p = k[: -len(".weight")]
            sd[f"{p}.weight_v"] = torch.randn(v.shape, generator=g)
            sd[f"{p}.weight_g"] = 0.5 * torch.rand(
                (v.shape[0],) + (1,) * (v.dim() - 1), generator=g) + 0.25
        else:
            sd[k] = v
    torch.save({"model": {"generator": sd}, "steps": 1}, path)
    return path


def _wav_length_check(np, res, wav, hop, vocoded_frames, what):
    """The vocoded wav and the spliced wav have the lengths that the span
    boundaries imply, and both are finite."""
    n_f = res.mel_edited.shape[0]
    check(res.prediction.shape == ((n_f - 1 + vocoded_frames) * hop,),
          f"{what}: vocoded length {res.prediction.shape} for {n_f} frames")
    t_old = [hop * x for x in res.old_span_boundary]
    t_new = [hop * x for x in res.new_span_boundary]
    check(len(res.origin_replaced)
          == len(wav) - (t_old[1] - t_old[0]) + (t_new[1] - t_new[0]),
          f"{what}: spliced length {len(res.origin_replaced)}")
    check(bool(np.isfinite(res.prediction).all()
               and np.isfinite(res.origin_replaced).all()),
          f"{what}: finite wavs")


def serve_cli_phase(torch, np, fa, cuda_ms, label, exp_dir, valid, root,
                    device="cuda"):
    """The serving and scoring CLIs on run A's experiment and the
    validation split: bin.sedit's three modes with Griffin-Lim, an edit
    with a parallel_wavegan pickle, an edit with --dynamic-eval, and
    bin.mcd_gate --espnet-ckpt on the same weights written as an ESPnet
    experiment.  Returns the K1 and K2 launches of the CLIs' run."""
    from a3t_tpu_torch.bin import mcd_gate, sedit
    from a3t_tpu_torch.compat.espnet import save_espnet_a3t
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text, read_wav
    from a3t_tpu_torch.dsp import griffin_lim, istft, logmel_to_wav, stft
    from a3t_tpu_torch.dsp import mel_to_linear
    from a3t_tpu_torch.dsp.griffin_lim import initial_phase
    from a3t_tpu_torch.inference import FileAlignmentSource, baselines

    texts = read_2column_text(os.path.join(valid, "text"))
    # the request: the first validation utterance of at least 24 phones
    uid = next(u for u in sorted(texts) if len(texts[u].split()) >= 24)
    phones = texts[uid].split()
    n = len(phones)
    vocab = sorted({p for t in texts.values() for p in t.split()})
    k = n // 2 - 1
    news = {
        "reconstruct": mcd_gate.protocol_mask(texts[uid]),
        "edit": " ".join(phones[:k] + vocab[:5] + phones[k + 3:]),
        "prompt": " ".join(phones + [vocab[(3 * i) % len(vocab)]
                                     for i in range(8)]),
    }
    out = os.path.join(root, "serve")
    os.makedirs(out, exist_ok=True)
    pkl = _pwg_pickle(torch, os.path.join(out, "pwg.pkl"))

    # wrappers that time the loads and keep the editors, the MCD analysis
    # and dynamic evaluation for the checks after the counted run
    seen = {"editors": [], "load": [], "mcd": [], "dyn": []}
    build_sedit, build_gate = sedit.build_editor, mcd_gate.build_editor
    mcd_fn, dyn_fn = mcd_gate.mcd_between_waveforms, \
        baselines.dynamic_evaluation

    def timed_build(build):
        def wrapped(args):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            made = build(args)
            torch.cuda.synchronize()
            seen["load"].append(time.perf_counter() - t0)
            seen["editors"].append(made[0])
            return made
        return wrapped

    def timed_mcd(*a, **kw):
        t0 = time.perf_counter()
        value = mcd_fn(*a, **kw)
        seen["mcd"].append(time.perf_counter() - t0)
        return value

    def watched_dyn(editor, *a, **kw):
        before = {k: v.detach().clone()
                  for k, v in editor.model.state_dict().items()}
        l1, l2 = fa.LAUNCHES, fa.LAUNCHES_BWD
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        adapted = dyn_fn(editor, *a, **kw)
        torch.cuda.synchronize()
        seen["dyn"].append(dict(
            seconds=time.perf_counter() - t0, k1=fa.LAUNCHES - l1,
            k2=fa.LAUNCHES_BWD - l2, before=before, editor=editor,
            adapted=adapted))
        return adapted

    def request(mode, *extra):
        argv = [mode, "--exp-dir", exp_dir, "--data-dir", valid, "--uid",
                uid, "--new-text", news[mode], "--out",
                os.path.join(out, f"{mode}{len(seen['load'])}.wav"),
                "--device", device, *extra]
        l1 = fa.LAUNCHES
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = sedit.main(argv)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0 - seen["load"][-1]
        return res, wall, fa.LAUNCHES - l1, argv[argv.index("--out") + 1]

    sedit.build_editor = timed_build(build_sedit)
    mcd_gate.build_editor = timed_build(build_gate)
    mcd_gate.mcd_between_waveforms = timed_mcd
    baselines.dynamic_evaluation = watched_dyn
    try:
        fa.reset_launches()
        results = {}
        # the process's first request brings cuFFT plans and cuDNN's
        # algorithms in; it is reported apart
        results["reconstruct-cold"] = [request("reconstruct")]
        for mode in ("reconstruct", "edit", "prompt"):
            results[mode] = [request(mode) for _ in range(SERVE_REPEATS)]
        results["edit-pwg"] = [request("edit", "--vocoder", pkl)]
        results["edit-dyn"] = [request("edit", "--dynamic-eval", SERVE_LR)]
        esp = save_espnet_a3t(seen["editors"][0].model,
                              seen["editors"][0].fe.config,
                              seen["editors"][0].tokens.token_list,
                              os.path.join(out, "espnet"))
        mcd_uids = sorted(texts)[:MCD_UTTS]
        gate_out = os.path.join(out, "mcd")
        l1 = fa.LAUNCHES
        report = mcd_gate.main(["--espnet-ckpt", esp, "--data-dir", valid,
                                "--uids", ",".join(mcd_uids), "--out",
                                gate_out, "--device", device])
        gate_k1 = fa.LAUNCHES - l1
        launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    finally:
        sedit.build_editor, mcd_gate.build_editor = build_sedit, build_gate
        mcd_gate.mcd_between_waveforms = mcd_fn
        baselines.dynamic_evaluation = dyn_fn

    editor = seen["editors"][0]
    fe = editor.fe.config
    hop, fs = fe.hop_length, fe.fs
    wav = A3TDataset(valid)[uid]["audio"]
    align = FileAlignmentSource(valid)(uid)
    log(f"  request {uid}: {n} phones, {len(wav) / fs:.3f} s; model loads "
        f"(build_editor, checkpoint to card) "
        f"{[round(t, 3) for t in seen['load']]} s [{label}]")
    dyn = seen["dyn"][0]
    n_examples = max(n - 1, 1)
    for name, runs in results.items():
        for res, _, k1, path in runs:
            fs_out, written = read_wav(path)
            if name == "prompt":
                mel = res["mel"]
                n_f = mel.shape[0]
                check(len(res["full"]) == (n_f - 1) * hop
                      and len(res["new_wav"])
                      == (n_f - 1 - res["span_boundary"][0]) * hop
                      and bool(np.isfinite(res["full"]).all()),
                      f"{name}: wav lengths for {n_f} frames, span "
                      f"{res['span_boundary']}")
                out_wav, spans = res["full"], res["span_boundary"]
            else:
                _wav_length_check(np, res, wav, hop,
                                  1 if name == "edit-pwg" else 0, name)
                out_wav, mel = res.origin_replaced, res.mel_edited
                spans = (res.old_span_boundary, res.new_span_boundary)
            check(fs_out == fs and len(written) == len(out_wav),
                  f"{name}: the written wav")
            want = 8 * (1 + (n_examples if name == "edit-dyn" else 0))
            check(k1 == want, f"{name}: {k1} K1 launches, expected {want}")
        walls = [wall for _, wall, _, _ in runs]
        med = float(np.median(walls))
        log(f"  sedit {name}: median {med * 1e3:.1f} ms wall after the load "
            f"(min {min(walls) * 1e3:.1f}, max {max(walls) * 1e3:.1f}, n="
            f"{len(walls)}) for {len(out_wav) / fs:.3f} s of audio, RTF "
            f"{med * fs / len(out_wav):.4f}; mel {mel.shape}, spans {spans}"
            f", K1 launches {k1} per request [{label}]")

    # dynamic evaluation: launches, the adapted copy, the untouched original
    check(dyn["k1"] == 8 * n_examples and dyn["k2"] == 8 * n_examples,
          f"dynamic evaluation: K1 {dyn['k1']}, K2 {dyn['k2']} launches for "
          f"{n_examples} examples, expected 8 each per example")
    orig = dyn["editor"].model.state_dict()
    check(all(torch.equal(orig[k], v) for k, v in dyn["before"].items()),
          "dynamic evaluation leaves the editor's parameters and running "
          "statistics as they were, bit for bit")
    adapted = dyn["adapted"].model.state_dict()
    moved = [k for k, v in adapted.items()
             if "running_" not in k and "num_batches" not in k
             and not torch.equal(v, orig[k])]
    kept = all(torch.equal(adapted[k], orig[k]) for k in orig
               if "running_" in k)
    check(len(moved) > 0 and kept, "the adapted parameters differ from the "
          "original ones and the running statistics are the original's")
    n_params = sum(1 for k in adapted
                   if "running_" not in k and "num_batches" not in k)
    log(f"  dynamic evaluation ({SERVE_LR}): {n_examples} examples, "
        f"{dyn['seconds']:.3f} s per pass "
        f"({dyn['seconds'] / n_examples * 1e3:.1f} ms per example step), "
        f"K1 {dyn['k1']} K2 {dyn['k2']} launches, {len(moved)} of "
        f"{n_params} parameter tensors moved, running statistics kept "
        f"[{label}]")

    # the MCD gate
    with open(os.path.join(gate_out, "MCD.json")) as f:
        written = json.load(f)
    check(written["n"] == MCD_UTTS and math.isfinite(written["mean_mcd"])
          and math.isfinite(written["vocoder_ceiling_mcd"]),
          f"MCD.json: n {written['n']}, mean {written['mean_mcd']}, ceiling "
          f"{written['vocoder_ceiling_mcd']}")
    check(gate_k1 == 8 * MCD_UTTS, f"mcd_gate: {gate_k1} K1 launches")
    per_utt = sum(seen["mcd"]) / MCD_UTTS
    log(f"  mcd_gate --espnet-ckpt on {MCD_UTTS} utterances: mean MCD "
        f"{report['mean_mcd']:.3f} dB, vocoder ceiling "
        f"{report['vocoder_ceiling_mcd']:.3f} dB (random weights, "
        f"Griffin-Lim); MCD analysis {per_utt:.3f} s per utterance on the "
        f"host (two scores each) [{label}]")

    # --espnet-ckpt against --exp-dir, bit for bit
    ed_esp = seen["editors"][-1]
    got = ed_esp.reconstruct_masked_span(wav, align, texts[uid],
                                         news["reconstruct"])
    want = results["reconstruct"][0][0]
    check(np.array_equal(got.mel_edited, want.mel_edited),
          "--espnet-ckpt and --exp-dir give the same mel_edited bit for bit")
    log("  --espnet-ckpt and --exp-dir: mel_edited equal bit for bit")

    # K1/K2 against their plain versions at each request's own shape
    g = torch.Generator().manual_seed(11)
    att = next(m for m in editor.model.modules() if hasattr(m, "d_k"))
    for mode in ("reconstruct", "edit", "prompt"):
        tl = editor._new_timeline(wav, align, texts[uid], news[mode],
                                  mask_reconstruct=mode == "reconstruct")
        inputs = editor.build_inputs(tl[0], tl[1], tl[2], tl[3], tl[5])
        mask = torch.cat([inputs["speech_mask"], inputs["text_mask"]], 1)
        kernel_pair_check(torch, fa, mask, att.h, att.d_k, g,
                          f"the {mode} request's",
                          dtypes=((torch.float32, TOL_F32, TOL_BWD_F32),))

    # Griffin-Lim: the card against the CPU from one initial phase, and
    # against PWG on the same mel
    mel = torch.as_tensor(results["edit"][0][0].mel_edited[None])
    mag_cpu = mel_to_linear(mel, fe)
    phase = initial_phase(mag_cpu.shape, 0, "cpu")
    for iters, tol in ((1, TOL_GL_1), (32, TOL_GL_32)):
        want = griffin_lim(mag_cpu, fe, iters, phase=phase)
        got = griffin_lim(mag_cpu.to(device), fe, iters,
                          phase=phase.to(device)).cpu()
        err = ((got - want).abs().max() / want.abs().max()).item()
        log(f"  Griffin-Lim card vs CPU, {iters} iteration(s) from one "
            f"phase: max|diff|/max|cpu| {err:.3g} (tol {tol:g})")
        check(err <= tol, f"Griffin-Lim card vs CPU, {iters} iterations")
    mel_d = mel.to(device)
    vocoder = sedit.make_vocoder(pkl, fe, device)
    tl = editor._new_timeline(wav, align, texts[uid], news["edit"])
    inputs = editor.build_inputs(tl[0], tl[1], tl[2], tl[3], tl[5])
    with torch.inference_mode():
        gl_ms = cuda_ms(lambda: logmel_to_wav(mel_d, fe), iters=10)
        pwg_ms = cuda_ms(lambda: vocoder(mel_d), iters=10)
        fwd_ms = cuda_ms(lambda: editor.model(**inputs), iters=10)
    wall_ms = float(np.median([w for _, w, _, _ in results["edit"]])) * 1e3
    log(f"  vocoders on the edit's mel {tuple(mel.shape)}: Griffin-Lim (32 "
        f"iterations) {gl_ms:.3f} ms, PWG {pwg_ms:.3f} ms (CUDA events) "
        f"[{label}]")
    log(f"  the edit request's median {wall_ms:.1f} ms: model forward {fwd_ms:.3f} "
        f"ms, Griffin-Lim {gl_ms:.3f} ms (CUDA events, each paced by the "
        f"host's launches at batch 1), the rest {wall_ms - fwd_ms - gl_ms:.1f}"
        f" ms (timeline, front-end, padding, splice, wav write) [{label}]")

    # istft on the card, twice, bit for bit
    spec = stft(torch.as_tensor(wav[None], device=device), fe.n_fft, hop,
                fe.win_length)
    a, b = (istft(spec, fe.n_fft, hop, fe.win_length) for _ in range(2))
    check(torch.equal(a, b), "two runs of istft on the card agree bit for "
          "bit")
    log(f"  istft on the card: two runs equal bit for bit {tuple(a.shape)}")
    return launches


CONFIG_FS2 = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "fs2_conformer_24k.yaml")
FS2_STEPS = 8  # FastSpeech2 and speaker-conditioned A3T training steps
FS2_SETS: list = []  # extra FS2 config overrides (a CPU rehearsal's widths)
SPEMB_SETS: list = []  # the same for the speaker-conditioned A3T run
DECODE_UTTS = 4
# the context x-vector's reach around a frame: the TDNN's context, sum of
# (k - 1) / 2 * dilation = 2 + 2 + 3 frames, and the STFT's half-window
XV_CONTEXT = 7


def _median3(np, fn):
    """(median seconds of 3 host-clock runs after a warm-up, each ending
    synchronised, the last result)."""
    import torch

    out = fn()
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return float(np.median(times)), out


def seeded_xvector(torch, np, fe, train_ds, out_dir, device):
    """XVectorConfig() (512 channels, 192 dims) with seeded weights (the
    JAX initialisers), its log-mel MVN taken from the training corpus, in
    ``load_xvector``'s format; returns (seconds for the MVN, frames)."""
    from a3t_tpu_torch.models.mlm import init_parameters
    from a3t_tpu_torch.models.xvector import (XVectorConfig, XVectorNet,
                                              save_xvector)

    net = XVectorNet(XVectorConfig(n_mels=fe.config.n_mels))
    init_parameters(net, torch.Generator().manual_seed(17))
    t0 = time.perf_counter()
    total = sq = None
    n = 0
    with torch.inference_mode():
        for uid in train_ds.uids:
            feats = fe(train_ds[uid]["audio"][None])[0][0].double()
            total = feats.sum(0) if total is None else total + feats.sum(0)
            sq = (feats * feats).sum(0) if sq is None \
                else sq + (feats * feats).sum(0)
            n += feats.shape[0]
    mean = (total / n).cpu().numpy()
    std = np.sqrt(np.maximum((sq / n).cpu().numpy() - mean ** 2, 1e-10))
    save_xvector(net, (mean.astype(np.float32), std.astype(np.float32)),
                 out_dir)
    return time.perf_counter() - t0, n


def _fs2_masks(torch, np, batcher, eos_id, fs2_model, device):
    """The key masks K1 and K2 see in FastSpeech2's training step: the
    encoder's text mask (B x 64, the longest bucket's first batch) and the
    decoder's frame mask (B x max_feat_len) from that batch's durations."""
    from a3t_tpu_torch.models.fastspeech2 import length_regulate

    bi = len(batcher._buckets) - 1
    while not batcher._buckets[bi]:
        bi -= 1
    host = batcher.make_batch(bi, batcher._buckets[bi][
        : batcher.config.batch_size], eos_id)
    text_mask = torch.as_tensor(host["text_mask"], device=device)
    d = torch.as_tensor(host["durations"], device=device)
    _, frames = length_regulate(
        torch.zeros(*d.shape, 1, device=device), d,
        fs2_model.config.max_feat_len)
    return text_mask, frames


def speaker_fs2_phase(torch, np, fa, label, root, train, valid, device="cuda"):
    """Speaker conditioning and the FastSpeech2 path on the trainer
    phase's corpus (8 speakers): a seeded x-vector directory and its
    per-speaker and per-utterance x-vectors; configs/fs2_conformer_24k.yaml
    trained 8 steps through FS2Task.run (fp32, with the spk2xvector
    table); configs/a3t_conformer_24k.yaml with spemb_dim 192 trained 8
    steps through bin.train; then bin.sedit edit with --duration-model and
    --spk-xvector, an edit and a prompt TTS through SpeechEditor(spemb_fn=
    make_spemb_extractor(...)), bin.batch_decode --fs2-exp --spk-xvector
    and bin.mcd_gate --duration-model on 4 validation utterances, and the
    ESPnet .pth route of the duration model.  Returns the K1 and K2
    launches of the phase's main path and K1's and K2's largest float32
    errors at the FastSpeech2 shapes."""
    import gc

    from a3t_tpu_torch.bin import batch_decode, mcd_gate, sedit
    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.compat.fs2 import save_espnet_fs2
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text, read_wav
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.inference import (FS2Baselines, FileAlignmentSource,
                                         SpeechEditor, diff_phone_spans,
                                         resolve_mask_str)
    from a3t_tpu_torch.inference.durations import load_duration_fn
    from a3t_tpu_torch.models import xvector as xv
    from a3t_tpu_torch.tasks.fs2 import FS2Task, load_fs2_config
    from a3t_tpu_torch.tasks.mlm import MLMTask

    out = os.path.join(root, "speaker")
    os.makedirs(out, exist_ok=True)
    cfg24 = load_fs2_config(CONFIG_FS2).frontend
    fe = LogMelFrontend(cfg24, device=device)
    train_ds, valid_ds = A3TDataset(train), A3TDataset(valid)
    speakers = sorted(set(train_ds.utt2spk.values()))

    # 1. the x-vector directory, spk2xvector and utt2xvector
    xv_dir = os.path.join(out, "xvector")
    mvn_s, n_frames = seeded_xvector(torch, np, fe, train_ds, xv_dir, device)
    xnet, mvn = xv.load_xvector(xv_dir, device=device)
    spk_path = os.path.join(xv_dir, "spk2xvector.npz")
    t0 = time.perf_counter()
    spk2xv = xv.build_spk2xvector(xnet, fe, train_ds, spk_path, mel_mvn=mvn)
    spk_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for d, ds in ((train, train_ds), (valid, valid_ds)):
        utt2xv = xv.build_utt2xvector(
            xnet, fe, ds, os.path.join(d, "utt2xvector.npz"), mel_mvn=mvn)
        check(sorted(utt2xv) == list(ds.uids) and all(
            v.shape == (192,) and np.isfinite(v).all()
            for v in utt2xv.values()), f"utt2xvector of {d}")
    utt_s = time.perf_counter() - t0
    check(sorted(spk2xv) == speakers and all(
        v.shape == (192,) and np.isfinite(v).all() for v in spk2xv.values()),
        "spk2xvector: one finite 192-dim x-vector per speaker")
    log(f"  x-vectors: MVN over {n_frames} training frames in {mvn_s:.2f} s; "
        f"spk2xvector of {len(spk2xv)} speakers over {len(train_ds)} "
        f"utterances (one call each) in {spk_s:.2f} s; utt2xvector of "
        f"{len(train_ds)} + {len(valid_ds)} utterances (chunks of 32) in "
        f"{utt_s:.2f} s [{label}]")
    del xnet
    spk_npy = os.path.join(out, f"{speakers[0]}.npy")
    np.save(spk_npy, spk2xv[speakers[0]])

    # 2. FastSpeech2 training
    fs2_exp = os.path.join(out, "fs2")
    cfg = load_fs2_config(CONFIG_FS2, [
        f"train_data_dir={train}", f"valid_data_dir={valid}",
        f"exp_dir={fs2_exp}", f"spk_xvector={spk_path}",
        "trainer.max_epoch=1", f"trainer.num_iters_per_epoch={FS2_STEPS}",
        *FS2_SETS])
    fa.reset_launches()
    t0 = time.perf_counter()
    trainer, state = FS2Task.run(cfg, device=device)
    torch.cuda.synchronize()
    fs2_wall = time.perf_counter() - t0
    fs2_launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    steps = list(trainer.step_log)
    vplan = trainer.valid_iter_factory.batcher.batcher
    n_eval = sum(-(-len(m) // vplan.config.batch_size)
                 for m in vplan._buckets)
    n_blocks = cfg.model.encoder.num_blocks + cfg.model.decoder.num_blocks
    check(len(steps) == FS2_STEPS and all(
        np.isfinite(r["loss"]) for r in steps)
        and int(state.opt_state.total_notfinite) == 0,
        "every FastSpeech2 step is finite and not skipped")
    check(fs2_launches == (n_blocks * (len(steps) + n_eval),
                           n_blocks * len(steps)),
          f"FastSpeech2: {n_blocks} K1 launches per train and eval forward, "
          f"{n_blocks} K2 per train step (read K1 {fs2_launches[0]}, K2 "
          f"{fs2_launches[1]} for {len(steps)} + {n_eval} steps)")
    dev_ms = [r["device_ms"] for r in steps[1:]]
    wait = [r["iter_wait_s"] * 1e3 for r in steps[1:]]
    b, f = steps[0]["batch"], steps[0]["frames"]
    med = float(np.median(dev_ms))
    batcher = trainer.train_iter_factory.batcher
    host_s, _ = _median3(np, lambda: batcher.batcher.make_batch(
        0, batcher.batcher._buckets[0][: cfg.batcher.batch_size],
        batcher.eos_id))
    log(f"  FS2Task.run: {len(steps)} steps + {n_eval} eval steps in "
        f"{fs2_wall:.2f} s; losses {[round(r['loss'], 2) for r in steps]}; "
        f"K1 {fs2_launches[0]}, K2 {fs2_launches[1]} launches [{label}]")
    log(f"  FS2 step (B = {b}, {f} frames, text {sorted(cfg.batcher.text_buckets)}"
        f"): median {med:.2f} ms on the device's clock (n={len(dev_ms)}, "
        f"min {min(dev_ms):.2f}, max {max(dev_ms):.2f}), "
        f"{b * f / med * 1e3:.1f} mel-frames/s; data wait median "
        f"{float(np.median(wait)):.2f} ms per step (max {max(wait):.2f}); "
        f"host assembly of one batch (F0 and energy on the host) "
        f"{host_s * 1e3:.1f} ms (median of 3) [{label}]")
    host_ms = float(np.median([r["host_s"] for r in steps[1:]])) * 1e3
    # the same step on one assembled batch with no producer thread running
    # (2 warm-up + 5 timed steps, CUDA events), beside the trainer's
    host = batcher.batcher.make_batch(
        0, batcher.batcher._buckets[0][: cfg.batcher.batch_size],
        batcher.eos_id)
    bare = []
    for i in range(7):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        trainer.train_step(state, host, i)
        ev[1].record()
        torch.cuda.synchronize()
        if i >= 2:
            bare.append(ev[0].elapsed_time(ev[1]))
    bare_ms = float(np.median(bare))
    log(f"  FS2 step: host time in the trainer's step call median "
        f"{host_ms:.2f} ms; the bare step on one batch with no producer "
        f"thread running median {bare_ms:.2f} ms (n=5, min {min(bare):.2f},"
        f" max {max(bare):.2f}), {b * f / bare_ms * 1e3:.1f} mel-frames/s: "
        f"the trainer's step is {med / bare_ms:.2f}x the bare step while the "
        f"producer thread extracts F0 and energy in numpy [{label}]")
    text_mask, frame_mask = _fs2_masks(torch, np, batcher.batcher,
                                       batcher.eos_id, state.model, device)
    att = next(m for m in state.model.modules() if hasattr(m, "d_k"))
    g = torch.Generator().manual_seed(13)
    errs = [0.0, 0.0]
    for mask, where in ((text_mask, "FS2's encoder"),
                        (frame_mask, "FS2's decoder")):
        e = kernel_pair_check(torch, fa, mask, att.h, att.d_k, g, where)
        errs = [max(a, c) for a, c in zip(errs, e)]
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    # 3. speaker-conditioned A3T training
    fa.reset_launches()
    t0 = time.perf_counter()
    spemb_exp = os.path.join(out, "a3t_spemb")
    trainer, state = train_main(_train_argv(
        train, valid, spemb_exp, device, "model.spemb_dim=192",
        f"spemb_file={spk_path}", "trainer.max_epoch=2",
        f"trainer.num_iters_per_epoch={FS2_STEPS // 2}", *SPEMB_SETS))
    torch.cuda.synchronize()
    a3t_launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    steps = list(trainer.step_log)
    n_eval = sum(len(trainer.valid_iter_factory.batcher.batch_plan(e))
                 for e in (1, 2))
    check(len(steps) == FS2_STEPS and all(
        np.isfinite(r["loss"]) for r in steps)
        and int(state.opt_state.total_notfinite) == 0,
        "every speaker-conditioned A3T step is finite and not skipped")
    a3t_cfg = state.model.config
    a3t_blocks = a3t_cfg.encoder.num_blocks + a3t_cfg.decoder.num_blocks
    check(a3t_launches == (a3t_blocks * (len(steps) + n_eval),
                           a3t_blocks * len(steps)),
          f"speaker-conditioned A3T: {a3t_blocks} K1 launches per train and "
          f"eval step, {a3t_blocks} K2 per train step")
    moved = float(state.model.spemb_out.weight.detach().abs().max())
    log(f"  bin.train spemb_dim=192: {len(steps)} steps + {n_eval} eval "
        f"steps in {time.perf_counter() - t0:.2f} s; losses "
        f"{[round(r['loss'], 3) for r in steps]}; K1 {a3t_launches[0]}, K2 "
        f"{a3t_launches[1]}; max|spemb_out.weight| {moved:.3g} (zero at "
        f"init); step median "
        f"{float(np.median([r['device_ms'] for r in steps[1:]])):.2f} ms "
        f"on the device's clock [{label}]")
    check(moved > 0, "the zero-initialised speaker offset moved")
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    # 4. serving
    texts = read_2column_text(os.path.join(valid, "text"))
    uid = next(u for u in sorted(texts) if len(texts[u].split()) >= 24)
    phones = texts[uid].split()
    n = len(phones)
    vocab = sorted({p for t in texts.values() for p in t.split()})
    k = n // 2 - 1
    new_edit = " ".join(phones[:k] + vocab[:5] + phones[k + 3:])
    new_prompt = " ".join(phones + [vocab[(3 * i) % len(vocab)]
                                    for i in range(8)])
    wav = valid_ds[uid]["audio"]
    align = FileAlignmentSource(valid)(uid)
    hop, fs = fe.config.hop_length, fe.config.fs
    fa.reset_launches()
    serve = {"k1": 0, "k2": 0}

    def counted(fn):
        """Run ``fn`` with the launch counts read into the phase's total
        (the main path's serving part)."""
        l1, l2 = fa.LAUNCHES, fa.LAUNCHES_BWD
        res = fn()
        serve["k1"] += fa.LAUNCHES - l1
        serve["k2"] += fa.LAUNCHES_BWD - l2
        return res

    # 4a. bin.sedit edit --duration-model --spk-xvector
    argv = ["edit", "--exp-dir", spemb_exp, "--data-dir", valid, "--uid",
            uid, "--new-text", new_edit, "--out",
            os.path.join(out, "edit.wav"), "--duration-model", fs2_exp,
            "--spk-xvector", spk_npy, "--device", device]
    l1 = fa.LAUNCHES
    res = counted(lambda: sedit.main(argv))
    cli_k1 = fa.LAUNCHES - l1
    _wav_length_check(np, res, wav, hop, 0, "sedit --duration-model")
    enc_blocks = cfg.model.encoder.num_blocks
    check(cli_k1 == a3t_blocks + 2 * enc_blocks,
          f"sedit --duration-model: {cli_k1} K1 launches, expected "
          f"{a3t_blocks} (the A3T forward) + 2 x {enc_blocks} (the duration "
          "model's encoder on the old and the new phones)")
    log(f"  bin.sedit edit --duration-model --spk-xvector {speakers[0]}: "
        f"{n} phones, spans {res.old_span_boundary} -> "
        f"{res.new_span_boundary}, K1 launches {cli_k1} [{label}]")

    # 4b. loads, the duration function, the x-vector extractor
    load_a3t, (model, a3t_cfg, conv) = _median3(
        np, lambda: MLMTask.build_model_from_dir(spemb_exp, device=device))
    load_fs2, (fs2, fs2_cfg, fs2_conv) = _median3(
        np, lambda: FS2Task.build_model_from_dir(fs2_exp, device=device))
    load_xv, _ = _median3(np, lambda: xv.load_xvector(xv_dir, device))
    dur_fn = load_duration_fn(fs2_exp, spembs=spk2xv[speakers[0]],
                              device=device)
    l1 = fa.LAUNCHES
    d1 = counted(lambda: dur_fn(phones, wav))
    check(fa.LAUNCHES - l1 == enc_blocks, f"one duration prediction: "
          f"{fa.LAUNCHES - l1} K1 launches, expected {enc_blocks} (the "
          "encoder's blocks)")
    d2 = counted(lambda: dur_fn(phones, wav))
    check(d1 == d2 and len(d1) == n, "two runs of the duration function "
          "agree bit for bit")
    dur_s, _ = _median3(np, lambda: counted(lambda: dur_fn(phones, wav)))
    spemb_fn = xv.make_spemb_extractor(xv_dir, fe)
    tl = SpeechEditor(model, a3t_cfg.frontend, conv, device=device,
                      lexicon=sedit.phone_lexicon(texts))._new_timeline(
        wav, align, texts[uid], mcd_gate.protocol_mask(texts[uid]),
        mask_reconstruct=True)
    f_pad = -(-(1 + len(wav) // hop) // 64) * 64
    audio = np.zeros((f_pad - 1) * hop, np.float32)
    audio[: len(wav)] = wav
    s, e = tl[5]
    ctx = np.arange(f_pad) < 1 + len(wav) // hop
    ctx[s:e] = False
    xv_s, x_ctx = _median3(np, lambda: spemb_fn(audio, ctx))
    half = fe.config.n_fft // 2
    lo, hi = (s - 1 + XV_CONTEXT) * hop + half, (e - XV_CONTEXT) * hop - half
    check(hi - lo > 10 * hop, f"the masked span [{s}, {e}) has an interior "
          "that reaches no context frame")
    noise = np.random.default_rng(3).standard_normal(audio.size).astype(
        np.float32) * 0.3
    inner = audio.copy()
    inner[lo:hi] = noise[lo:hi]
    whole = audio.copy()
    whole[s * hop:e * hop] = noise[s * hop:e * hop]
    x_inner, x_whole = spemb_fn(inner, ctx), spemb_fn(whole, ctx)
    check(np.array_equal(x_inner, x_ctx), "the context x-vector is the same "
          "bit for bit with the masked span's interior replaced by noise")
    log(f"  context x-vector (frames [{s}, {e}) masked of {int(ctx.sum()) + e - s}"
        f"): equal bit for bit with samples [{lo}, {hi}) replaced by noise; "
        f"with the whole span replaced, max|diff| "
        f"{np.abs(x_whole - x_ctx).max():.3g} of max|x| "
        f"{np.abs(x_ctx).max():.3g} (the span's edges reach the context "
        f"through the STFT window and the TDNN) [{label}]")

    # 4c. an edit and a prompt TTS through SpeechEditor(spemb_fn=...)
    editor = SpeechEditor(model, a3t_cfg.frontend, conv, duration_fn=dur_fn,
                          lexicon=sedit.phone_lexicon(texts),
                          device=device, spemb_fn=spemb_fn)
    edit_s, res = _median3(np, lambda: counted(
        lambda: editor.edit(wav, align, texts[uid], new_edit)))
    _wav_length_check(np, res, wav, hop, 0, "edit with spemb_fn")
    prompt_s, pres = _median3(np, lambda: counted(
        lambda: editor.prompt_tts(wav, align, texts[uid], new_prompt)))
    check(len(pres["full"]) == (pres["mel"].shape[0] - 1) * hop
          and bool(np.isfinite(pres["full"]).all()),
          "prompt TTS with spemb_fn: finite, of the mel's length")
    log(f"  SpeechEditor(spemb_fn, FS2 durations): edit median "
        f"{edit_s * 1e3:.1f} ms (RTF {edit_s * fs / len(res.origin_replaced):.4f}), "
        f"prompt +8 phones {prompt_s * 1e3:.1f} ms (RTF "
        f"{prompt_s * fs / len(pres['full']):.4f}); x-vector extraction "
        f"{xv_s * 1e3:.2f} ms, the duration function {dur_s * 1e3:.2f} ms "
        f"per call (medians of 3 on the host clock) [{label}]")
    log(f"  model loads (median of 3): speaker-conditioned A3T "
        f"{load_a3t:.3f} s, FastSpeech2 {load_fs2:.3f} s, x-vector "
        f"{load_xv:.3f} s [{label}]")

    # 4d. the ESPnet .pth route of the duration model
    pth = save_espnet_fs2(fs2, fs2_conv.token_list, fs2_cfg.frontend,
                          os.path.join(out, "espnet_fs2"))
    by_pth = load_duration_fn(pth, spembs=spk2xv[speakers[0]], device=device)
    for u in sorted(texts)[:DECODE_UTTS]:
        ph = texts[u].split()
        w = valid_ds[u]["audio"]
        a, c = counted(lambda: dur_fn(ph, w)), counted(lambda: by_pth(ph, w))
        check(a == c, f"{u}: the ESPnet .pth and the experiment give the "
              "same durations bit for bit")
    log(f"  duration model through save_espnet_fs2 -> load_duration_fn(.pth)"
        f": durations equal bit for bit on {DECODE_UTTS} utterances")

    # 4e. the baselines, timed per utterance
    base = FS2Baselines(fs2, fs2_conv, fe)
    ali = align
    rs = resolve_mask_str(ali, texts[uid], new_edit, editor.lexicon)
    _, sp_add_ed = diff_phone_spans(ali, texts[uid], new_edit,
                                    editor.lexicon)[1:]
    target = " ".join(rs.split()[sp_add_ed[0]:sp_add_ed[1]])
    x0 = spk2xv[speakers[0]]
    b_s = [_median3(np, lambda: counted(lambda: base.baseline1(rs, wav, x0))),
           _median3(np, lambda: counted(lambda: base.baseline2(
               wav, ali, texts[uid], new_edit, target, editor.lexicon,
               editor.mel, x0))),
           _median3(np, lambda: counted(lambda: base.baseline3(
               wav, ali, texts[uid], new_edit, editor.lexicon, editor.mel,
               x0)))]
    check(all(np.isfinite(w).all() for _, w in b_s), "finite baselines")
    log(f"  baselines on {uid} ({len(wav) / fs:.3f} s): "
        + ", ".join(f"baseline{i + 1} {t * 1e3:.1f} ms ({len(w) / fs:.3f} s"
                    f" of audio)" for i, (t, w) in enumerate(b_s))
        + f" (medians of 3, Griffin-Lim) [{label}]")

    # 4f. bin.batch_decode --fs2-exp --spk-xvector
    uids = sorted(texts)[:DECODE_UTTS]
    task = os.path.join(out, "tasks.txt")
    with open(task, "w") as fh:
        for i, u in enumerate(uids):
            p = texts[u].split()
            fh.write(f"{u}|{' '.join(p[:3] + vocab[:3] + p[5:])}\n"
                     if i % 2 else f"{u}\n")
    seen = {"edit": [], "synth": [], "vocode": []}
    edit_fn, synth_fn, vocode_fn = (SpeechEditor.edit,
                                    FS2Baselines._synthesize,
                                    FS2Baselines._vocode)

    def rec(key, fn):
        def wrapped(self, *a, **kw):
            if key == "vocode":
                seen[key].append(a[0].shape[0])
            r = fn(self, *a, **kw)
            if key != "vocode":
                seen[key].append(r)
            return r
        return wrapped

    SpeechEditor.edit = rec("edit", edit_fn)
    FS2Baselines._synthesize = rec("synth", synth_fn)
    FS2Baselines._vocode = rec("vocode", vocode_fn)
    try:
        dec_out = os.path.join(out, "decode")
        got = counted(lambda: batch_decode.main([
            "--exp-dir", spemb_exp, "--data-dir", valid, "--task-file", task,
            "--out-dir", dec_out, "--fs2-exp", fs2_exp, "--spk-xvector",
            spk_path, "--device", device]))
    finally:
        SpeechEditor.edit, FS2Baselines._synthesize, FS2Baselines._vocode = \
            edit_fn, synth_fn, vocode_fn
    check(set(got) == set(uids) and len(seen["edit"]) == DECODE_UTTS
          and len(seen["synth"]) == len(seen["vocode"]) == 3 * DECODE_UTTS,
          "batch_decode: an edit and three baselines per utterance")
    lexicon = sedit.phone_lexicon(texts)
    for i, u in enumerate(uids):
        w = valid_ds[u]["audio"]
        r = seen["edit"][i]
        _wav_length_check(np, r, w, hop, 0, f"batch_decode {u}")
        s0, e0 = r.old_span_boundary
        a = FileAlignmentSource(valid)(u)
        new = (" ".join(texts[u].split()[:3] + vocab[:3]
                        + texts[u].split()[5:]) if i % 2
               else mcd_gate.protocol_mask(texts[u]))
        _, span_rep, span_add = diff_phone_spans(a, texts[u], new, lexicon)
        if "[MASK]" in new:
            span_add = list(span_rep)
        o0, o1 = base._old_span(a, span_rep)
        n_in = 1 + len(w) // hop
        (_, d1), (_, d2), (_, d3) = seen["synth"][3 * i: 3 * i + 3]
        want_frames = [int(d1.sum()),
                       o0 + int(d2.sum()) - int(d2[-1]) + n_in - o1,
                       o0 + int(d3[span_add[0]:span_add[1]].sum()) + n_in
                       - o1]
        check(seen["vocode"][3 * i: 3 * i + 3] == want_frames,
              f"batch_decode {u}: the baselines vocode {want_frames} frames "
              f"(read {seen['vocode'][3 * i: 3 * i + 3]})")
        for name, frames in zip(("baseline1", "baseline2", "baseline3"),
                                want_frames):
            fs_out, data = read_wav(os.path.join(dec_out, f"{u}_{name}.wav"))
            check(fs_out == fs and len(data) == (frames - 1) * hop
                  and np.isfinite(data).all(),
                  f"batch_decode {u} {name}: {len(data)} samples for "
                  f"{frames} frames of summed durations")
        for name, length in (("full", len(r.prediction)),
                             ("replaced", len(r.origin_replaced)),
                             ("gt_span", (e0 - s0) * hop)):
            fs_out, data = read_wav(os.path.join(dec_out, f"{u}_{name}.wav"))
            check(fs_out == fs and len(data) == length,
                  f"batch_decode {u} {name}: {len(data)} samples")
        log(f"  batch_decode {u} ({'edit' if i % 2 else '[MASK]'}): spans "
            f"{r.old_span_boundary} -> {r.new_span_boundary}; baselines "
            f"{want_frames} frames from the summed durations; six wavs of "
            f"the expected lengths, finite [{label}]")

    # 4g. bin.mcd_gate --duration-model
    report = counted(lambda: mcd_gate.main([
        "--exp-dir", spemb_exp, "--data-dir", valid, "--uids",
        ",".join(uids), "--out", os.path.join(out, "mcd"),
        "--duration-model", fs2_exp, "--spk-xvector", spk_npy,
        "--device", device]))
    check(report["n"] == DECODE_UTTS
          and math.isfinite(report["vocoder_ceiling_mcd"]),
          f"mcd_gate --duration-model: n {report['n']}, ceiling "
          f"{report['vocoder_ceiling_mcd']}")
    log(f"  mcd_gate --duration-model on {DECODE_UTTS} utterances: per "
        f"utterance {report['per_utt']}, vocoder ceiling "
        f"{report['vocoder_ceiling_mcd']:.3f} dB (random weights, "
        f"Griffin-Lim; a span that the predicted durations leave empty "
        f"scores NaN) [{label}]")
    del model, fs2, editor, base
    gc.collect()
    torch.cuda.empty_cache()
    launches = (fs2_launches[0] + a3t_launches[0] + serve["k1"],
                fs2_launches[1] + a3t_launches[1] + serve["k2"])
    log(f"  speaker-fs2 main path: K1 {launches[0]} (FS2 training "
        f"{fs2_launches[0]}, A3T training {a3t_launches[0]}, serving "
        f"{serve['k1']}), K2 {launches[1]} [{label}]")
    return launches, errs


SIDE_ITERS = 8  # TTS variant steps: two passes of the two buckets' plan
SIDE_SETS: list = []  # extra bin.train overrides (a CPU rehearsal's widths)
XV_STEPS = 30  # x-vector training steps
XV_SETS: dict = {}  # XVectorConfig fields (a CPU rehearsal's widths)
VOC_STEPS, VOC_STOP = 6, 3  # vocoder steps; the run stops after this save
VOC_ARGS: list = []  # extra bin.train_vocoder flags (a CPU rehearsal's)
MCD_VOC_UTTS = 2


class _Stop(Exception):
    pass


def _timed(torch, fn, times, key=None):
    """``fn`` with each call's CUDA-event pair appended to ``times``, with
    its result and ``key(*args)`` beside it."""
    def wrapped(*a, **kw):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = fn(*a, **kw)
        ev[1].record()
        times.append((ev, out, key(*a) if key else None))
        return out
    return wrapped


def _profiled(torch, fn, n, label, what, top=8):
    """``fn`` whose ``n``-th call (from 1) runs under torch.profiler,
    recording device activities only: its busy share and the kernels that
    take its time are logged."""
    from torch.profiler import ProfilerActivity, profile

    calls = [0]

    def wrapped(*a, **kw):
        calls[0] += 1
        if calls[0] != n:
            return fn(*a, **kw)
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = fn(*a, **kw)
            torch.cuda.synchronize()
        busy = device_busy(torch, prof)
        if busy is None:
            log(f"  {what} (call {n}) profile: the profiler saw no device "
                "activity; not measured")
            return out
        busy_ms, window, by_name, count = busy
        log(f"  {what} (call {n}) profile: device busy {busy_ms:.2f} ms of "
            f"{window:.2f} ms (busy share {busy_ms / window:.4f}), {count} "
            f"device activities; the kernels by device time [{label}]")
        for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]:
            log(f"    {ms:9.3f} ms  {name[:100]}")
        return out
    return wrapped


def _event_ms(torch, times):
    torch.cuda.synchronize()
    return [ev[0].elapsed_time(ev[1]) for ev, _, _ in times]


def side_train_phase(torch, np, fa, label, root, train, valid, device="cuda"):
    """The side trainers on the trainer phase's corpus (438 utterances, 8
    speakers), in fp32 at full width: (a) the duration-aware A3T variant,
    configs/a3t_conformer_24k.yaml with model.duration_predictor_layers=2
    through bin.train, K1/K2 against their plain versions at its reduced
    encoder masks and length-regulated decoder masks, one dropout-0 step's
    gradients through the kernels against the plain versions, then
    bin.sedit edit on the experiment; (b) train_xvector at XVectorConfig()
    feeding make_spemb_extractor; (c) bin.train_vocoder at its 24 kHz
    defaults, stopped after its save at step 3 and resumed to step 6,
    load_vocoder, and bin.mcd_gate --vocoder DIR.  Returns the K1 and K2
    launches of the main path (training and serving of (a), the gate of
    (c)) and K1's and K2's largest float32 errors at the variant's
    masks."""
    import dataclasses
    import gc

    from a3t_tpu_torch.bin import mcd_gate, sedit
    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.bin.train_vocoder import main as train_vocoder_main
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.models import xvector as xv
    from a3t_tpu_torch.models.layers import length_regulate
    from a3t_tpu_torch.tasks import mlm as task_mlm
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.train import vocoder
    from a3t_tpu_torch.train.train_step import featurize, tts_inputs, tts_loss

    out = os.path.join(root, "side")
    os.makedirs(out, exist_ok=True)
    texts = read_2column_text(os.path.join(valid, "text"))
    valid_ds = A3TDataset(valid)

    # (a) the duration-aware variant through bin.train
    tts_exp = os.path.join(out, "tts")
    make_step = task_mlm.make_tts_train_step
    task_mlm.make_tts_train_step = lambda *a, **kw: _profiled(
        torch, make_step(*a, **kw), SIDE_ITERS, label, "TTS variant step")
    fa.reset_launches()
    t0 = time.perf_counter()
    try:
        trainer, state = train_main(_train_argv(
            train, valid, tts_exp, device,
            "model.duration_predictor_layers=2", "trainer.max_epoch=1",
            f"trainer.num_iters_per_epoch={SIDE_ITERS}", *SIDE_SETS))
    finally:
        task_mlm.make_tts_train_step = make_step
    torch.cuda.synchronize()
    tts_s = time.perf_counter() - t0
    train_launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    steps = list(trainer.step_log)
    batcher = trainer.train_iter_factory.batcher
    n_eval = len(trainer.valid_iter_factory.batcher.batch_plan(1))
    cfg = state.model.config
    blocks = cfg.encoder.num_blocks + cfg.decoder.num_blocks
    buckets = [(b.n_frames, b.batch_size) for b in batcher.buckets]
    log(f"  bin.train duration_predictor_layers=2: {len(steps)} steps "
        f"{[(r['frames'], round(r['loss'], 3)) for r in steps]} + {n_eval} "
        f"eval steps in {tts_s:.2f} s; buckets {buckets}; train losses "
        f"{trainer.reporter.history[1]['train']}; K1 {train_launches[0]}, "
        f"K2 {train_launches[1]} [{label}]")
    check(batcher.config.duration_collect and cfg.duration_predictor_layers
          == 2, "the variant's batches collect durations")
    check(len(steps) == SIDE_ITERS and all(
        np.isfinite(r["loss"]) for r in steps)
        and int(state.opt_state.total_notfinite) == 0,
        "every TTS variant step is finite and not skipped")
    check(train_launches == (blocks * (len(steps) + n_eval),
                             blocks * len(steps)),
          f"TTS variant: {blocks} K1 launches per train and eval forward, "
          f"{blocks} K2 per train step")
    _bucket_numbers(np, steps, label, "side-train TTS fp32", _fill(batcher))

    fe = LogMelFrontend(load_config(os.path.join(tts_exp, "config.yaml")
                                    ).frontend, device=device)
    att = next(m for m in state.model.modules() if hasattr(m, "d_k"))
    g = torch.Generator().manual_seed(17)
    errs = [0.0, 0.0]
    first = None
    for bi, spec in enumerate(batcher.buckets):
        host = batcher.make_batch(bi, batcher.bucket_members[bi][
            : spec.batch_size], np.random.default_rng(bi))
        mb = featurize(fe, host)
        red = tts_inputs(mb, host)
        text_mask = red["text_mask"].bool()
        _, frames = length_regulate(
            torch.zeros(*red["durations"].shape, 1, device=mb["speech"].device),
            red["durations"] * red["speech_mask"], spec.n_frames)
        n_red = red["speech_mask"].sum(1).float()
        n_frm = mb["speech_mask"].sum(1).float()
        log(f"  TTS bucket {spec.n_frames} x {spec.batch_size}: reduced "
            f"speech keys per row mean {n_red.mean().item():.1f} (min "
            f"{int(n_red.min())}, max {int(n_red.max())}) of "
            f"{spec.n_frames}, valid frames mean {n_frm.mean().item():.1f}, "
            f"length-regulated frames mean "
            f"{frames.sum(1).float().mean().item():.1f}")
        for mask, where in (
                (torch.cat([red["speech_mask"], text_mask], 1),
                 f"the TTS encoder's reduced mask ({spec.n_frames})"),
                (torch.cat([frames, text_mask], 1),
                 f"the TTS decoder's length-regulated mask "
                 f"({spec.n_frames})")):
            e = kernel_pair_check(torch, fa, mask, att.h, att.d_k, g, where)
            errs = [max(a, c) for a, c in zip(errs, e)]
        first = first or (host, mb)
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    # one dropout-0 step's gradients, kernels against plain versions
    no_dropout = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    cfg0 = dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **no_dropout),
        decoder=dataclasses.replace(cfg.decoder, **no_dropout))
    kern = _dropout0_model(cfg0, device)
    for layer in kern.duration_predictor.conv:
        layer[3].rate = 0.0
    host, mb = first
    grad_check(torch, kern, _plain_copy(kern), contextlib.nullcontext(),
               lambda: (fa.LAUNCHES, fa.LAUNCHES_BWD), (blocks, blocks), mb,
               TOL_GRADS_F32, "the TTS variant's step",
               loss_fn=lambda m, mb, gen: tts_loss(m, mb, host, gen)[0])
    del kern, first, host, mb
    gc.collect()
    torch.cuda.empty_cache()

    # serving the experiment: the edit ignores the predictor
    uid = next(u for u in sorted(texts) if len(texts[u].split()) >= 24)
    phones = texts[uid].split()
    vocab = sorted({p for t in texts.values() for p in t.split()})
    k = len(phones) // 2 - 1
    new_edit = " ".join(phones[:k] + vocab[:5] + phones[k + 3:])
    l1 = fa.LAUNCHES
    res = sedit.main(["edit", "--exp-dir", tts_exp, "--data-dir", valid,
                      "--uid", uid, "--new-text", new_edit, "--out",
                      os.path.join(out, "edit.wav"), "--device", device])
    serve_k1 = fa.LAUNCHES - l1
    hop = fe.config.hop_length
    _wav_length_check(np, res, valid_ds[uid]["audio"], hop, 0,
                      "sedit on the TTS variant")
    check(serve_k1 == blocks, f"sedit on the TTS variant: {serve_k1} K1 "
          f"launches, expected {blocks}")
    log(f"  bin.sedit edit on the TTS variant's experiment: spans "
        f"{res.old_span_boundary} -> {res.new_span_boundary}, K1 launches "
        f"{serve_k1} [{label}]")

    # (b) x-vector training
    xv_dir = os.path.join(out, "xvector")
    xv_times = []
    step_fn = xv.xvector_step
    xv.xvector_step = _timed(
        torch, _profiled(torch, step_fn, XV_STEPS, label, "x-vector step"),
        xv_times, key=lambda model, tx, st, mel, sid: mel.shape[1])
    try:
        t0 = time.perf_counter()
        _, report = xv.train_xvector(
            train, fe, xv_dir, xv.XVectorConfig(**XV_SETS), batch_size=32,
            total_steps=XV_STEPS, eval_data_dir=valid,
            log_fn=lambda msg: None)
        torch.cuda.synchronize()
        xv_s = time.perf_counter() - t0
    finally:
        xv.xvector_step = step_fn
    ms = _event_ms(torch, xv_times)[:-1]  # the last call is profiled
    losses = [float(o[0]) for _, o, _ in xv_times]
    by_crop = {}
    for t, (_, _, crop) in zip(ms[3:], xv_times[3:]):
        by_crop.setdefault(crop, []).append(t)
    check(len(xv_times) == XV_STEPS and all(np.isfinite(losses)),
          "every x-vector step is finite")
    spemb_fn = xv.make_spemb_extractor(xv_dir, fe)
    audio = valid_ds[uid]["audio"]
    emb = spemb_fn(audio, np.ones(1 + len(audio) // hop, bool))
    check(emb.shape == (xv.XVectorConfig(**XV_SETS).embed_dim,)
          and np.isfinite(emb).all(), "make_spemb_extractor on the trained "
          "x-vector directory: a finite embedding")
    log(f"  train_xvector: {XV_STEPS} steps of 32 crops (256/512/1024 "
        f"frames) in {xv_s:.2f} s with the corpus log-mels; losses "
        f"{[round(x, 3) for x in losses[:2]]} ... "
        f"{[round(x, 3) for x in losses[-2:]]}; held-out accuracy "
        f"{report['eval_acc']} on {report['eval_n']} utterances of "
        f"{report['n_speakers']} speakers; step median "
        f"{float(np.median(ms[3:])):.2f} ms on the device's clock (n="
        f"{len(ms) - 3}, min {min(ms[3:]):.2f}, max {max(ms[3:]):.2f}); by "
        f"crop: " + ", ".join(
            f"{c} frames {float(np.median(v)):.2f} ms (n={len(v)})"
            for c, v in sorted(by_crop.items())) + f" [{label}]")

    # (c) vocoder training, stopped and resumed, then served
    vdir = os.path.join(out, "vocoder")
    argv = ["--wav-scp", os.path.join(train, "wav.scp"), "--out", vdir,
            "--steps", str(VOC_STEPS), "--disc-start", str(VOC_STOP),
            "--save-interval", str(VOC_STOP), "--corpus-cache",
            os.path.join(out, "vocoder_corpus.npz"), "--device", device,
            *VOC_ARGS]
    spec_t, adv_t = [], []
    fns = (vocoder.spectral_step, vocoder.adversarial_step,
           vocoder.save_checkpoint)

    def save_then_stop(out_dir, tree, history):
        fns[2](out_dir, tree, history)
        if tree["step"] == VOC_STOP:
            raise _Stop

    # each kind's first step carries cuDNN's set-up; its last is profiled
    vocoder.spectral_step = _timed(torch, _profiled(
        torch, fns[0], VOC_STOP, label, "spectral step"), spec_t)
    vocoder.adversarial_step = _timed(torch, _profiled(
        torch, fns[1], VOC_STEPS - VOC_STOP, label, "adversarial step"),
        adv_t)
    vocoder.save_checkpoint = save_then_stop
    try:
        t0 = time.perf_counter()
        try:
            train_vocoder_main(argv)
            check(False, f"the vocoder run stops at its save of step "
                  f"{VOC_STOP}")
        except _Stop:
            pass
        first_s = time.perf_counter() - t0
        with open(os.path.join(vdir, "vocoder.json")) as f:
            meta = json.load(f)
        n_first = (len(spec_t), len(adv_t))
        vocoder.save_checkpoint = fns[2]
        t0 = time.perf_counter()
        train_vocoder_main(argv)
        torch.cuda.synchronize()
        second_s = time.perf_counter() - t0
    finally:
        (vocoder.spectral_step, vocoder.adversarial_step,
         vocoder.save_checkpoint) = fns
    with open(os.path.join(vdir, "vocoder.json")) as f:
        meta2 = json.load(f)
    with open(os.path.join(vdir, "history.json")) as f:
        hist = json.load(f)
    tree = torch.load(os.path.join(vdir, "state.pt"), map_location="cpu",
                      weights_only=True)
    spec_ms, adv_ms = _event_ms(torch, spec_t), _event_ms(torch, adv_t)
    spec_l = [[float(x) for x in o] for _, o, _ in spec_t]
    adv_l = [[float(x) for x in o] for _, o, _ in adv_t]
    check(n_first == (VOC_STOP, 0) and len(spec_t) == VOC_STOP
          and len(adv_t) == VOC_STEPS - VOC_STOP and tree["step"] == VOC_STEPS
          and int(tree["opt_d"]["count"]) == VOC_STEPS - VOC_STOP,
          f"the vocoder ran {VOC_STOP} spectral steps, stopped, and resumed "
          f"at step {VOC_STOP} for {VOC_STEPS - VOC_STOP} adversarial steps")
    check(meta2["mel_mean"] == meta["mel_mean"]
          and meta2["mel_std"] == meta["mel_std"],
          "the resumed vocoder run reuses the stored mel MVN")
    check(all(np.isfinite(x) for v in spec_l + adv_l for x in v)
          and [h["step"] for h in hist] == [VOC_STEPS],
          "finite spectral and adversarial losses")
    log(f"  bin.train_vocoder (hop 300, 64 x 30 layers x 3 stacks, batch 8, "
        f"crop 96 frames): first run {first_s:.2f} s ({VOC_STOP} spectral "
        f"steps, corpus log-mels and cache), resumed run {second_s:.2f} s "
        f"({VOC_STEPS - VOC_STOP} adversarial steps); spectral (loss, sc, "
        f"mag) {[[round(x, 3) for x in v] for v in spec_l]}, adversarial "
        f"(g, sc, mag, adv, d) {[[round(x, 3) for x in v] for v in adv_l]}"
        f"; spectral step {spec_ms} ms, adversarial step {adv_ms} ms on "
        f"the device's clock (the first of each with cuDNN's set-up, the "
        f"last profiled) [{label}]")
    vocode = vocoder.load_vocoder(vdir, device)
    mel = fe(audio[None])[0]
    wav = vocode(mel)
    check(tuple(wav.shape) == (1, mel.shape[1] * hop)
          and bool(torch.isfinite(wav).all()),
          f"load_vocoder: {tuple(wav.shape)} samples for {mel.shape[1]} "
          f"frames, finite")
    uids = sorted(texts)[:MCD_VOC_UTTS]
    l1 = fa.LAUNCHES
    t0 = time.perf_counter()
    report = mcd_gate.main(["--exp-dir", tts_exp, "--data-dir", valid,
                            "--uids", ",".join(uids), "--vocoder", vdir,
                            "--out", os.path.join(out, "mcd"), "--device",
                            device])
    gate_s = time.perf_counter() - t0
    gate_k1 = fa.LAUNCHES - l1
    check(report["n"] == MCD_VOC_UTTS and os.path.exists(os.path.join(
        out, "mcd", "MCD.json")) and math.isfinite(
            report["vocoder_ceiling_mcd"]),
        f"mcd_gate --vocoder DIR: n {report['n']}, ceiling "
        f"{report['vocoder_ceiling_mcd']}")
    check(gate_k1 == blocks * MCD_VOC_UTTS, f"mcd_gate --vocoder DIR: "
          f"{gate_k1} K1 launches, expected {blocks} per utterance")
    log(f"  mcd_gate --vocoder DIR on {MCD_VOC_UTTS} utterances in "
        f"{gate_s:.2f} s: per utterance {report['per_utt']}, vocoder "
        f"ceiling {report['vocoder_ceiling_mcd']:.3f} dB (random weights, "
        f"{VOC_STEPS} vocoder steps) [{label}]")
    gc.collect()
    torch.cuda.empty_cache()
    launches = (train_launches[0] + serve_k1 + gate_k1, train_launches[1])
    log(f"  side-train main path: K1 {launches[0]} (TTS training "
        f"{train_launches[0]}, sedit {serve_k1}, mcd_gate {gate_k1}), K2 "
        f"{launches[1]} [{label}]")
    return launches, errs


OPT_ITERS = 12  # multi-corpus steps: 8 / 2 / 2 by the yaml's portions
SOAK_ITERS = 8  # record-shard steps at each steps_per_dispatch
SOAK_K = 4
ACCUM = (2, 4, 0.01)  # accum_grad, micro-steps, grad_noise_eta
FILL_16K = ((256, 146), (512, 73))  # whole batches of the yaml's buckets
SHARDS_16K = 3
OPT_SETS: list = []  # extra bin.train overrides (a CPU rehearsal's widths)
CONFIG_MULTI = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            "configs", "a3t_multi_corpus.yaml")
TOL_UPDATE = 1e-6  # the accumulated, noised update against the plain rule


def _profiled_epoch(torch, trainer, state, epoch, label, what):
    """One more epoch of the trainer under torch.profiler (device
    activities only): its busy share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        state = trainer.train_one_epoch(state, epoch)
        torch.cuda.synchronize()
    busy = device_busy(torch, prof)
    if busy is None:
        log(f"  {what}: the profiler saw no device activity; busy share "
            "not measured")
    else:
        busy_ms, window, _, n = busy
        log(f"  {what}: over an epoch of {trainer.config.num_iters_per_epoch}"
            f" steps the device is busy {busy_ms:.2f} ms of {window:.2f} ms "
            f"(busy share {busy_ms / window:.4f}, idle "
            f"{1 - busy_ms / window:.4f}), {n} device activities [{label}]")
    return state


def _noise_plain(torch, np, count, n, device):
    """The port's noise rule, written out: N(0, 1) from a generator on the
    device seeded from SeedSequence([0, count])."""
    s = np.random.SeedSequence([0, count]).generate_state(2)
    gen = torch.Generator(device=device).manual_seed(
        int(s[0]) << 32 | int(s[1]))
    return torch.randn(n, generator=gen, device=device, dtype=torch.float32)


def _update_plain(torch, np, g1, g2, mu, nu, count, oc, eta, device):
    """The applied update of an accumulation of two micro-steps, written
    out in float32 as optax computes it: the mean gradient (MultiSteps'
    running mean, g1 + (g2 - g1) / 2: Adam's eps amplifies an ulp of a
    mean that cancels to ~1e-8) plus the noise, clipped to the global
    norm, Adam bias-corrected at count + 1 and the Noam rate at count + 1."""
    t = torch.tensor(float(count + 1), dtype=torch.float32, device=device)
    x = g1 + (g2 - g1) / 2 + torch.sqrt(eta / t ** oc.grad_noise_gamma) * \
        _noise_plain(torch, np, count, g1.numel(), device)
    norm = torch.linalg.vector_norm(x)
    if norm >= oc.grad_clip:
        x = x / norm * oc.grad_clip
    mu = oc.adam_b1 * mu + (1 - oc.adam_b1) * x
    nu = oc.adam_b2 * nu + (1 - oc.adam_b2) * x * x
    step = (mu / (1 - oc.adam_b1 ** t)) / (
        torch.sqrt(nu / (1 - oc.adam_b2 ** t)) + oc.adam_eps)
    lr = oc.lr * oc.model_size ** -0.5 * torch.minimum(
        t ** -0.5, t * oc.warmup_steps ** -1.5)
    return -lr * step


def train_options_phase(torch, np, fa, label, root, train, valid,
                        device="cuda"):
    """The rest of single-device training on the trainer phase's 24 kHz
    corpus: (a) configs/a3t_multi_corpus.yaml (a copy with only its data
    directories and exp_dir changed) through bin.train for one epoch of
    OPT_ITERS steps, librispeech on a generated 16 kHz speech-only corpus;
    (b) the corpus packed by bin.pack_records and trained on with
    batcher.device_audio in bf16 at steps_per_dispatch 1 and SOAK_K, the
    audio gathered on the card, the chained step and the pre-featurized
    step held bit for bit; (c) an fp32 run with accumulation and gradient
    noise, its update held against a plain rule.  Returns the K1 and K2
    launches of the main path (the runs of (a), (b) and (c)) and K1's and
    K2's largest float32 errors at the speech-only masks."""
    import collections
    import copy
    import dataclasses
    import gc
    import subprocess

    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.data.batcher import BucketBatcher, stack_group
    from a3t_tpu_torch.data.records import RecordDataset
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.tasks import mlm as task_mlm
    from a3t_tpu_torch.tasks import yaml_subset
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.train import optim
    from a3t_tpu_torch.train.train_step import (create_train_state,
                                                featurize, gather_audio,
                                                make_chained_train_step,
                                                make_train_step)

    out = os.path.join(root, "options")
    os.makedirs(out, exist_ok=True)
    total = [0, 0]

    def run(argv, what):
        fa.reset_launches()
        t0 = time.perf_counter()
        trainer, state = train_main(argv)
        torch.cuda.synchronize()
        n = (fa.LAUNCHES, fa.LAUNCHES_BWD)
        steps = list(trainer.step_log)
        n_steps = sum(r.get("steps", 1) for r in steps)
        n_eval = len(trainer.valid_iter_factory.batcher.batch_plan(1))
        cfg = state.model.config
        blocks = cfg.encoder.num_blocks + cfg.decoder.num_blocks
        log(f"  {what}: {n_steps} steps in {len(steps)} calls and {n_eval} "
            f"eval steps in {time.perf_counter() - t0:.2f} s, losses "
            f"{[round(r['loss'], 3) for r in steps]}; K1 {n[0]}, K2 {n[1]} "
            f"[{label}]")
        check(all(np.isfinite(r["loss"]) for r in steps)
              and int(state.opt_state.total_notfinite) == 0,
              f"{what}: every step finite and not skipped")
        check(n == (blocks * (n_steps + n_eval), blocks * n_steps),
              f"{what}: {blocks} K1 launches per train and eval step, "
              f"{blocks} K2 per train step")
        total[0] += n[0]
        total[1] += n[1]
        return trainer, state, steps

    # (a) the multi-corpus yaml, librispeech speech-only at 16 kHz
    c16, _, secs, nbytes = make_corpus(
        os.path.join(out, "data16k"), fs=16000, hop=200, fill=FILL_16K,
        shards=SHARDS_16K, valid_utts=0, seed=200)
    log(f"  16 kHz corpus: {SHARDS_16K * SHARD_UTTS} utterances generated "
        f"in {secs:.2f} s, {sum(n for _, n in FILL_16K)} kept "
        f"({nbytes / 1e6:.1f} MB)")
    data = yaml_subset.load_file(CONFIG_MULTI)
    dirs = {"libritts": train, "librispeech": c16, "vctk": train}
    for entry in data["corpora"]:
        entry["data_dir"] = dirs[entry["name"]]
    changed = dict(train_data_dir=train, valid_data_dir=valid,
                   exp_dir=os.path.join(out, "multi"))
    data.update(changed)
    copy_path = os.path.join(out, "a3t_multi_corpus.yaml")
    with open(copy_path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dump(data))
    orig = yaml_subset.load_file(CONFIG_MULTI)
    again = yaml_subset.load_file(copy_path)
    for d in (orig, again):
        for k in changed:
            d.pop(k)
        for entry in d["corpora"]:
            entry.pop("data_dir")
    check(orig == again, "the yaml's copy differs only in its data "
          "directories and exp_dir")
    argv = ["--config", copy_path, "--device", device]
    for s in ("trainer.max_epoch=1",
              f"trainer.num_iters_per_epoch={OPT_ITERS}",
              "trainer.log_interval=4", *OPT_SETS):
        argv += ["--set", s]
    trainer, state, steps = run(argv, "multi-corpus epoch")
    counts = collections.Counter(r["corpus"] for r in steps)
    corpora = trainer.train_iter_factory.corpora
    log(f"  multi-corpus: steps by corpus {dict(counts)}; buckets "
        + "; ".join(
        f"{s.name} ({s.batcher.fe.fs} Hz"
        f"{', speech only' if s.speech_only else ''}) "
        f"{[(b.n_frames, b.batch_size) for b in s.batcher.buckets]}"
        for s in corpora))
    check(dict(counts) == {"libritts": 8, "librispeech": 2, "vctk": 2},
          "the yaml's portions give 8 / 2 / 2 steps of 12")
    _bucket_numbers(np, steps, label, "multi-corpus fp32")
    so = next(s for s in corpora if s.speech_only)
    check(so.batcher.fe.fs == 16000 and so.batcher.fe.hop_length == 200
          and [(b.n_frames, len(m)) for b, m in zip(
              so.batcher.buckets, so.batcher.bucket_members)]
          == list(FILL_16K), "librispeech: 16 kHz, hop 200, the kept "
          "utterances in the yaml's first two buckets")
    att = next(m for m in state.model.modules() if hasattr(m, "d_k"))
    host = so.batcher.make_batch(0, so.batcher.bucket_members[0][
        : so.batcher.buckets[0].batch_size], np.random.default_rng(0))
    keys = host["text_mask"][host["audio_lengths"] > 0].sum(1)
    check((keys == 1).all(), "a speech-only batch holds one valid text key "
          "per utterance")
    errs = trainer_kernel_check(torch, np, fa, so.batcher, att.h, att.d_k,
                                LogMelFrontend(so.batcher.fe, device=device))
    del trainer, state, steps
    gc.collect()
    torch.cuda.empty_cache()

    # (b) record shards, the corpus on the card, chained dispatch
    rec = os.path.join(out, "records")
    t0 = time.perf_counter()
    subprocess.run([sys.executable, "-m", "a3t_tpu_torch.bin.pack_records",
                    "--data-dir", train, "--out", rec], check=True,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    mb = sum(os.path.getsize(os.path.join(rec, f))
             for f in os.listdir(rec)) / 1e6
    log(f"  bin.pack_records: {len(RecordDataset(rec))} utterances in "
        f"{time.perf_counter() - t0:.2f} s (with the interpreter's start), "
        f"{mb:.1f} MB")
    captured = {}
    makers = (task_mlm.make_train_step, task_mlm.make_chained_train_step)

    def capture(make):
        def wrapped(*a, **kw):
            captured["corpus"] = kw.get("corpus")
            return make(*a, **kw)
        return wrapped

    task_mlm.make_train_step, task_mlm.make_chained_train_step = map(
        capture, makers)
    try:
        for k in (1, SOAK_K):
            trainer, state, steps = run(_train_argv(
                rec, valid, os.path.join(out, f"soak{k}"), device,
                f"token_list={os.path.join(rec, 'tokens.txt')}",
                "trainer.max_epoch=1",
                f"trainer.num_iters_per_epoch={SOAK_ITERS}",
                "batcher.device_audio=true",
                "model.encoder.compute_dtype=bfloat16",
                "model.decoder.compute_dtype=bfloat16",
                f"trainer.steps_per_dispatch={k}", *OPT_SETS),
                f"records bf16 steps_per_dispatch={k}")
            batcher = trainer.train_iter_factory.batcher
            check(trainer.config.steps_per_dispatch == k
                  and isinstance(batcher.dataset, RecordDataset)
                  and captured["corpus"] is not None
                  and captured["corpus"].device.type == torch.device(
                      device).type, f"steps_per_dispatch={k}: record "
                  "shards, the corpus on the device")
            _bucket_numbers(np, steps, label, f"records bf16 k={k}")
            state = _profiled_epoch(torch, trainer, state, 2, label,
                                    f"records bf16 k={k}")
            _bucket_numbers(np, list(trainer.step_log)[len(steps):], label,
                           f"records bf16 k={k} epoch 2 (profiled)")
            if k == 1:
                del trainer, state, steps
                gc.collect()
                torch.cuda.empty_cache()
    finally:
        task_mlm.make_train_step, task_mlm.make_chained_train_step = makers
    corpus = captured["corpus"]
    log(f"  the corpus on the device: {corpus.numel()} int16 samples "
        f"({corpus.numel() * 2 / 1e6:.1f} MB)")

    # audio gathered on the card against the host's batch, per bucket
    host_b = BucketBatcher(batcher.dataset, batcher.fe, dataclasses.replace(
        batcher.config, device_audio=False))
    hop = batcher.fe.hop_length
    for bi, spec in enumerate(batcher.buckets):
        uids = batcher.bucket_members[bi][: spec.batch_size]
        x_d = batcher.make_batch(bi, uids, np.random.default_rng(bi))
        x_h = host_b.make_batch(bi, uids, np.random.default_rng(bi))
        check("audio" not in x_d and "audio_offset" in x_d,
              "device_audio batches carry offsets, no audio")
        got = gather_audio(corpus, {k: torch.as_tensor(v, device=device)
                                    for k, v in x_d.items()}, hop).cpu()
        same = got.dtype == torch.int16 and torch.equal(
            got, torch.from_numpy(x_h["audio"]))
        log(f"  bucket {spec.n_frames}: audio gathered on the card "
            f"{tuple(got.shape)} {got.dtype} equals the host-assembled "
            f"batch bit for bit: {same}")
        check(same, f"the card's audio of the {spec.n_frames}-frame bucket")

    # the chained step and the pre-featurized step, bit for bit
    cfg = load_config(os.path.join(out, f"soak{SOAK_K}", "config.yaml"))
    no_dropout = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                      attention_dropout_rate=0.0)
    cfg0 = dataclasses.replace(
        state.model.config,
        encoder=dataclasses.replace(state.model.config.encoder,
                                    **no_dropout),
        decoder=dataclasses.replace(state.model.config.decoder,
                                    **no_dropout))
    fe = LogMelFrontend(cfg.frontend, device=device)
    del trainer, state, steps
    gc.collect()
    torch.cuda.empty_cache()
    spec = batcher.buckets[0]
    members = batcher.bucket_members[0]
    chunks = [members[:spec.batch_size], members[spec.batch_size:]
              [:spec.batch_size], members[:spec.batch_size]]
    _, stacked, valid_k, _ = stack_group(
        [batcher.make_batch(0, c, np.random.default_rng(10 + i))
         for i, c in enumerate(chunks)], SOAK_K)
    stacked = {k: torch.as_tensor(v, device=device)
               for k, v in stacked.items()}
    check(list(valid_k) == [True] * 3 + [False] * (SOAK_K - 3),
          "the group holds 3 sub-steps and a padded one")
    base = _dropout0_model(cfg0, device)
    tx = optim.make_optimizer(cfg.optim)

    def fresh():
        model = copy.deepcopy(base)
        return model, create_train_state(model, tx, device)

    with deterministic_mode(torch):
        model, state = fresh()
        step = make_chained_train_step(model, fe, SOAK_K, device=device,
                                       corpus=corpus)
        t0 = time.perf_counter()
        state, stats = step(state, stacked, list(range(SOAK_K)), valid_k)
        torch.cuda.synchronize()
        chained_s = time.perf_counter() - t0
        want = _snapshot(state)
        got_loss = stats["loss"].cpu()
        del model, state, step
        model, state = fresh()
        step = make_train_step(model, fe, device=device, corpus=corpus)
        losses = []
        for i in range(3):
            state, s = step(state, {k: v[i] for k, v in stacked.items()}, i)
            losses.append(float(s["loss"]))
        log(f"  chained step (k={SOAK_K}, 3 valid) in {chained_s:.2f} s: "
            f"losses {got_loss.tolist()}; sequential {losses}")
        check(got_loss[:3].tolist() == losses and float(got_loss[3]) == 0,
              "the chained step's losses equal the sequential steps'")
        _compare(torch, _snapshot(state), want,
                 "the chained step against 3 sequential steps")
        del model, state, step
        # the pre-featurized step against the featurizing step
        first = {k: v[0] for k, v in stacked.items()}
        snaps = []
        for pre in (False, True):
            model, state = fresh()
            if pre:
                step = make_train_step(model, None, device=device)
                batch = featurize(fe, first, corpus=corpus)
            else:
                step = make_train_step(model, fe, device=device,
                                       corpus=corpus)
                batch = first
            state, _ = step(state, batch, 7)
            snaps.append(_snapshot(state))
            del model, state, step
        _compare(torch, snaps[1], snaps[0],
                 "make_train_step(model, None) on featurized batches "
                 "against the featurizing step")
    del base, snaps, stacked
    gc.collect()
    torch.cuda.empty_cache()

    # (c) accumulation and gradient noise, fp32
    k_acc, n_micro, eta = ACCUM
    records = []
    apply0, add0 = optim.Optimizer.apply, optim._add_

    def add_hook(params, u):
        records[-1]["u"] = u.clone()
        add0(params, u)

    def apply_hook(self, params, grads, state):
        params = list(params)
        rec = {"g": optim._flat(grads).clone(), "mu": state.mu.clone(),
               "nu": state.nu.clone(), "count": int(state.count),
               "mini": int(state.mini_step)}
        before = optim._flat(params)
        records.append(rec)
        out = apply0(self, params, grads, state)
        rec["same"] = torch.equal(optim._flat(params), before)
        return out

    optim.Optimizer.apply, optim._add_ = apply_hook, add_hook
    try:
        trainer, state, _ = run(_train_argv(
            train, valid, os.path.join(out, "accum"), device,
            "trainer.max_epoch=1", f"trainer.num_iters_per_epoch={n_micro}",
            f"optim.accum_grad={k_acc}", f"optim.grad_noise_eta={eta}",
            *OPT_SETS), f"accum_grad={k_acc} grad_noise_eta={eta} fp32")
    finally:
        optim.Optimizer.apply, optim._add_ = apply0, add0
    os_ = state.opt_state
    oc = load_config(os.path.join(out, "accum", "config.yaml")).optim
    log(f"  accumulation: parameters unchanged after micro-steps "
        f"{[i + 1 for i, r in enumerate(records) if r['same']]}; Noam's "
        f"count {int(os_.count)}, gradient_step {int(os_.gradient_step)}, "
        f"mini_step {int(os_.mini_step)}, step {state.step}")
    check(len(records) == n_micro and [r["same"] for r in records]
          == [i % k_acc != k_acc - 1 for i in range(n_micro)],
          "the parameters stay bit for bit at the micro-steps that emit no "
          "update and move at the others")
    check(int(os_.count) == n_micro // k_acc == int(os_.gradient_step)
          and state.step == n_micro, f"Noam's count is {n_micro // k_acc} "
          f"after {n_micro} micro-steps")
    for i in range(k_acc - 1, n_micro, k_acc):
        r0, r1 = records[i - 1], records[i]
        plain = _update_plain(torch, np, r0["g"], r1["g"], r1["mu"],
                              r1["nu"], r1["count"], oc, eta, device)
        rel = ((r1["u"] - plain).abs().max() / plain.abs().max()).item()
        log(f"  micro-step {i + 1}: the applied update against the plain "
            f"rule (mean of 2 gradients + noise at count {r1['count']}, "
            f"clip, Adam, Noam; float32): max|diff|/max|plain| {rel:.3g} "
            f"(tol {TOL_UPDATE:g}) [{label}]")
        check(rel <= TOL_UPDATE, f"the update of micro-step {i + 1} "
              "follows the plain rule")
    del trainer, state, records
    gc.collect()
    torch.cuda.empty_cache()
    log(f"  train-options main path: K1 {total[0]}, K2 {total[1]} [{label}]")
    return tuple(total), errs


PREP_UTTS = (12, 4)  # training and validation utterances of the sources
PREP_ITERS = 4  # full-width training steps on the chain's data
PREP_ALIGN_ITERS = 8  # the aligner's EM iterations (the recipe's)
PREP_PINS = ["--add-symbol", "<blank>:0", "--add-symbol", "<unk>:1",
             "--add-symbol", "<sos/eos>:-1"]
PREP_SETS: list = []  # extra bin.train overrides (a CPU rehearsal's widths)
PREP_RECIPE = ["--epochs", "1"]


def _prep_run(torch, np, fa, train_main, argv, what, label):
    """bin.train on the chain's data: every step finite and not skipped, 8
    K1 launches per train and eval step and 8 K2 per train step (per block
    of a narrower rehearsal).  Returns (trainer, state, (K1, K2))."""
    l1, l2 = fa.LAUNCHES, fa.LAUNCHES_BWD
    t0 = time.perf_counter()
    trainer, state = train_main(argv)
    torch.cuda.synchronize()
    n = (fa.LAUNCHES - l1, fa.LAUNCHES_BWD - l2)
    steps = list(trainer.step_log)
    n_steps = len(steps)
    n_eval = len(trainer.valid_iter_factory.batcher.batch_plan(1))
    cfg = state.model.config
    blocks = cfg.encoder.num_blocks + cfg.decoder.num_blocks
    dev = [r["device_ms"] for r in steps if "device_ms" in r]
    log(f"  {what}: {n_steps} steps of {[(r['batch'], r['frames']) for r in steps]}"
        f" and {n_eval} eval steps in {time.perf_counter() - t0:.2f} s, "
        f"losses {[round(r['loss'], 3) for r in steps]}, device ms per step "
        f"{[round(x, 2) for x in dev]}; K1 {n[0]}, K2 {n[1]} [{label}]")
    check(all(np.isfinite(r["loss"]) for r in steps)
          and int(state.opt_state.total_notfinite) == 0,
          f"{what}: every step finite and not skipped")
    check(n == (blocks * (n_steps + n_eval), blocks * n_steps),
          f"{what}: {blocks} K1 launches per train and eval step, "
          f"{blocks} K2 per train step")
    return trainer, state, n


def prep_chain_phase(torch, np, fa, label, root, device="cuda"):
    """The data-preparation chain on a 48 kHz mini corpus (PREP_UTTS
    utterances, one source rewritten as a stereo FLAC), each stage through
    its CLI's main(argv): format_data (24 kHz FLAC), align, tokenize_text,
    collect_stats, then bin.train at the yaml's full width on what they
    wrote, export_params and a warm-started bin.train, bin.sedit
    reconstruct and bin.mcd_gate on the experiment, and the mini recipe.
    Returns the K1 and K2 launches of the main path (the training runs, the
    CLIs and the recipe) and K1's and K2's largest float32 errors at the
    chain's masks."""
    import gc

    from a3t_tpu_torch.bin import (align, collect_stats, export_params,
                                   format_data, mcd_gate, sedit,
                                   tokenize_text)
    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.data import native_loader
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import (load_num_sequence_text,
                                           read_2column_text, read_wav,
                                           write_2column_text)
    from a3t_tpu_torch.data.flac import read_flac, write_flac
    from a3t_tpu_torch.data.format_wav import validate_data_dir_fs
    from a3t_tpu_torch.data.miniature import generate_mini_corpus
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.recipes import mini
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.text import TokenIDConverter
    from a3t_tpu_torch.train import trainer as trainer_mod
    from a3t_tpu_torch.train.checkpoint import load_params

    out = os.path.join(root, "prep")
    seconds = {}

    def stage(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        result = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return result

    # the sources: 48 kHz, the oracle alignments dropped, one stereo FLAC
    raw = os.path.join(out, "raw")
    n_train, n_valid = PREP_UTTS
    stage("sources", generate_mini_corpus, raw, n_train + n_valid, 48000)
    for name in ("mfa_start", "mfa_end"):
        os.remove(os.path.join(raw, name))
    scp = read_2column_text(os.path.join(raw, "wav.scp"))
    uids = sorted(scp)
    fs, pcm = read_wav(scp[uids[1]], always_float=False)
    scp[uids[1]] = os.path.join(raw, f"{uids[1]}_stereo.flac")
    write_flac(scp[uids[1]], fs, np.stack([pcm, pcm // 2], axis=1))
    write_2column_text(os.path.join(raw, "wav.scp"), scp)

    fmt = os.path.join(out, "fmt")
    report = stage("format_data", format_data.main, [
        "--data-dir", raw, "--out", fmt, "--fs", "24000", "--audio-format",
        "flac", "--expected-source-fs", "48000", "--device", device])
    check(report == {"n_utts": len(uids), "target_fs": 24000,
                     "source_fs_counts": {48000: len(uids)}},
          f"format_data's report {report}")
    formatted = read_2column_text(os.path.join(fmt, "wav.scp"))
    for uid, path in formatted.items():
        fs_n, native = native_loader.read_file(path)
        fs_p, ints, bps = read_flac(path)
        check(fs_n == fs_p == 24000 and ints.ndim == 1 and np.array_equal(
            native, ints.astype(np.float32) / float(1 << (bps - 1))),
            f"{uid}: the native decoder and read_flac give the same 24 kHz "
            "mono samples")
    validate_data_dir_fs(fmt, 24000)

    model_path = os.path.join(out, "aligner.bin")
    stage("align", align.main, [
        "--data-dir", fmt, "--sample-rate", "24000", "--iters",
        str(PREP_ALIGN_ITERS), "--save-model", model_path,
        "--device", device])
    os.replace(os.path.join(fmt, "mfa_text"), os.path.join(fmt, "text"))
    texts = read_2column_text(os.path.join(fmt, "text"))
    starts = load_num_sequence_text(os.path.join(fmt, "mfa_start"))
    ends = load_num_sequence_text(os.path.join(fmt, "mfa_end"))
    for uid in uids:
        s, e = starts.get(uid), ends.get(uid)
        n_ph = len(texts.get(uid, "").split())
        check(s is not None and e is not None and n_ph == len(s) == len(e)
              > 0 and bool((np.diff(s) >= 0).all() and (e >= s).all()),
              f"{uid}: one span per phone, starts monotone, end >= start")

    tokens = os.path.join(out, "tokens.txt")
    stage("tokenize_text", tokenize_text.main, [
        "-i", os.path.join(fmt, "text"), "-o", tokens, "--field", "2-",
        "--write-vocabulary", *PREP_PINS, "--device", device])
    conv = TokenIDConverter(tokens)
    phones = sorted({p for t in texts.values() for p in t.split()})
    check(conv.token_list[:2] == ["<blank>", "<unk>"]
          and conv.token_list[-1] == "<sos/eos>"
          and sorted(conv.token_list[2:-1]) == phones,
          "the vocabulary: blank, unk, the phones, sos/eos")

    # the training and validation splits of the formatted, aligned data
    splits = {"train": uids[:n_train], "valid": uids[n_train:]}
    for split, members in splits.items():
        for name in ("wav.scp", "text", "mfa_start", "mfa_end", "utt2spk"):
            table = read_2column_text(os.path.join(fmt, name))
            write_2column_text(os.path.join(out, split, name),
                               {u: table[u] for u in members})
    train, valid = (os.path.join(out, s) for s in ("train", "valid"))

    stats = os.path.join(out, "stats")
    info = stage("collect_stats", collect_stats.main, [
        "--config", CONFIG_24K, "--data-dir", train, "--out", stats,
        "--device", device])
    shapes = read_2column_text(os.path.join(stats, "speech_shape"))
    z = np.load(os.path.join(stats, "feats_stats.npz"))
    check(int(z["count"]) == info["count"] == sum(
        int(v.split(",")[0]) for v in shapes.values())
        and len(shapes) == n_train
        and bool(np.isfinite(z["sum"]).all() and np.isfinite(z["sqsum"]).all()),
        f"the statistics' count {int(z['count'])} is the sum of speech_shape's "
        f"frames over {n_train} utterances, sums finite")
    log(f"  chain: {len(uids)} sources ({n_train} train, {n_valid} valid), "
        f"{len(phones)} phones, {int(z['count'])} training frames; host "
        f"seconds per stage {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
        f" [{label}]")

    sets = (f"token_list={tokens}", "normalize=global_mvn",
            f"stats_file={os.path.join(stats, 'feats_stats.npz')}",
            "trainer.max_epoch=1", "trainer.keep_nbest_models=1", *PREP_SETS)
    fa.reset_launches()
    exp = os.path.join(out, "exp")
    t0 = time.perf_counter()
    trainer, state, _ = _prep_run(
        torch, np, fa, train_main,
        _train_argv(train, valid, exp, device, *sets,
                    f"trainer.num_iters_per_epoch={PREP_ITERS}"),
        "bin.train on the chain's data", label)
    seconds["train"] = time.perf_counter() - t0
    cfg = load_config(os.path.join(exp, "config.yaml"))
    enc, dec = state.model.config.encoder, state.model.config.decoder
    n_params = sum(p.numel() for p in state.model.parameters())
    log(f"  model: d={enc.attention_dim}, {enc.num_blocks} + "
        f"{dec.num_blocks} blocks, postnet {state.model.config.postnet_layers}"
        f" x {state.model.config.postnet_chans}, {n_params / 1e6:.2f}M "
        f"parameters, fp32; normalize {cfg.normalize}")
    with open(os.path.join(exp, "tokens.txt"), "rb") as f, \
            open(tokens, "rb") as g:
        check(f.read() == g.read() and cfg.normalize == "global_mvn",
              "bin.train took the chain's token list and statistics")
    check(len(trainer.step_log) == PREP_ITERS, f"{PREP_ITERS} steps")
    final = {k: v.detach().cpu().clone()
             for k, v in state.model.named_parameters()}
    batcher = trainer.train_iter_factory.batcher
    att = next(m for m in state.model.modules() if hasattr(m, "d_k"))
    h, d_k = att.h, att.d_k
    del trainer, state
    gc.collect()
    torch.cuda.empty_cache()

    stash = os.path.join(out, "stash")
    stage("export_params", export_params.main, [
        "--exp", exp, "--out", stash, "--dtype", "float32",
        "--device", device])
    exported = load_params(stash)
    check(sorted(exported) == sorted(final) and all(
        torch.equal(exported[k], v) for k, v in final.items()),
        "the float32 export holds the trained parameters bit for bit")
    seen = {}
    warm_start = trainer_mod.warm_start_params

    def watched(model, path, **kw):
        model = warm_start(model, path, **kw)
        seen.update({k: v.detach().cpu().clone()
                     for k, v in model.named_parameters()})
        return model

    trainer_mod.warm_start_params = watched
    try:
        t0 = time.perf_counter()
        trainer, state, _ = _prep_run(
            torch, np, fa, train_main,
            _train_argv(train, valid, os.path.join(out, "warm"), device,
                        *sets, "trainer.num_iters_per_epoch=1",
                        f"trainer.init_params_dir={stash}"),
            "bin.train warm-started from the export", label)
        seconds["train_warm"] = time.perf_counter() - t0
    finally:
        trainer_mod.warm_start_params = warm_start
    bad = [k for k in exported if not torch.equal(seen.get(k), exported[k])]
    log(f"  warm start: {len(exported) - len(bad)} of {len(exported)} "
        "parameters equal the export's bit for bit before the first step")
    check(sorted(seen) == sorted(exported) and not bad,
          "the warm start equals the export bit for bit")
    del trainer, state, final, exported, seen
    gc.collect()
    torch.cuda.empty_cache()

    vtexts = read_2column_text(os.path.join(valid, "text"))
    uid = max(sorted(vtexts), key=lambda u: len(vtexts[u].split()))
    l1 = fa.LAUNCHES
    res = stage("sedit", sedit.main, [
        "reconstruct", "--exp-dir", exp, "--data-dir", valid, "--uid", uid,
        "--new-text", mcd_gate.protocol_mask(vtexts[uid]), "--out",
        os.path.join(out, "reconstruct.wav"), "--device", device])
    blocks = enc.num_blocks + dec.num_blocks
    check(fa.LAUNCHES - l1 == blocks,
          f"sedit reconstruct: {fa.LAUNCHES - l1} K1 launches, {blocks} "
          "expected")
    _wav_length_check(np, res, A3TDataset(valid)[uid]["audio"],
                      cfg.frontend.hop_length, 0, "sedit reconstruct")
    l1 = fa.LAUNCHES
    report = stage("mcd_gate", mcd_gate.main, [
        "--exp-dir", exp, "--data-dir", valid, "--out",
        os.path.join(out, "mcd"), "--device", device])
    log(f"  sedit reconstruct {uid} ({len(vtexts[uid].split())} phones): "
        f"spans {res.old_span_boundary} -> {res.new_span_boundary}; "
        f"mcd_gate n={report['n']} mean MCD {report['mean_mcd']:.3f} dB "
        f"(per utterance {json.dumps(report['per_utt'])})")
    check(report["n"] == n_valid and np.isfinite(report["mean_mcd"])
          and fa.LAUNCHES - l1 == blocks * n_valid,
          f"mcd_gate: {n_valid} utterances, a finite MCD, {blocks} K1 "
          "launches each")

    result = stage("recipe", mini.main, [
        "--workdir", os.path.join(out, "mini"), "--device", device,
        *PREP_RECIPE])
    check(np.isfinite(result["mean_mcd"]) and result["n"] > 0,
          f"the mini recipe's MCD {result['mean_mcd']:.3f} over "
          f"{result['n']} utterances is finite")
    launches = (fa.LAUNCHES, fa.LAUNCHES_BWD)
    log(f"  host seconds per stage {json.dumps({k: round(v, 3) for k, v in seconds.items()})}"
        f"; the main path's launches K1 {launches[0]}, K2 {launches[1]} "
        f"[{label}]")

    fe = LogMelFrontend(cfg.frontend, device=device)
    errs = trainer_kernel_check(torch, np, fa, batcher, h, d_k, fe)
    return launches, errs


# --- model-options: the last single-device options ----------------------------

CONFIG_16K = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "configs", "a3t_longformer_16k.yaml")
DILATION = 2
# the dilated bin.train corpus at 16 kHz: the yaml's 1024- and 2048-frame
# buckets hold 36 and 18 utterances a batch (batch_bins 3,000,000 over 80 mel
# bins); two whole batches of each, from 8 shards of 30 utterances of
# 40-160 phones (450-1800 frames at hop 200)
LF_FILL = ((1024, 2 * 36), (2048, 2 * 18))
LF_PHONES = (40, 160)
LF_SHARDS = 8
LF_SHARD_UTTS = 30
LF_ITERS = 4
# the full-width longformer step at dropout 0 through JAX's chunked formula,
# read in PR 6 (PERF.md): the grad_norm the port's chunked path is read beside
CHUNKED_GRAD_NORM_PR6 = 669.2003
# the trained vocoder's wav on the card against JAX's on the CPU (check.npz),
# relative to the wav's peak: fp32 through 30 dilated layers, cuDNN summing
# its convolutions in its own order (the CPU test holds the port to 1e-4)
TOL_VOCODER = 1e-4
PLOT_EXAMPLES = 2
PLOT_ITERS = 2
# a CPU rehearsal's widths: extra overrides of the dilated and the plot
# bin.train runs, and EncoderConfig fields of the knobs' steps
LF_SETS: list = []
PLOT_SETS: list = []
OPTION_STACK: dict = {}


def _stack_cfg(cfg, **kw):
    """``cfg`` with ``kw`` set on its encoder and decoder stacks."""
    import dataclasses

    return dataclasses.replace(
        cfg, encoder=dataclasses.replace(cfg.encoder, **kw),
        decoder=None if cfg.decoder is None
        else dataclasses.replace(cfg.decoder, **kw))


def dilated_kernel_rows(torch, ba, cuda_ms, lengths, window, label):
    """K3, K4 and K5 at the dilated encoder's shape: each utterance's two
    phases as two rows (B * 2, 2, T / 2, 192) with ``lengths`` valid frames,
    64 text keys, bf16, dropout 0: against their plain versions (out and dq
    on the rows that see a key, dk and dv on the valid keys, each against
    its own largest value), then times in turns beside SDPA over a dense band
    mask and the bounds.  Returns {kernel: row}."""
    g = torch.Generator().manual_seed(3)
    b, h, t, d, tt = len(lengths), 2, max(lengths), 192, 64
    c, name = window // 2, "bfloat16"
    q, k, v, kt, vt, go, txm, spm = _banded_inputs(
        torch, g, b, h, t, d, tt, torch.bfloat16, lengths)
    args = (q, k, v, kt, vt, txm, spm, window, 0, 0.0)
    out, lse = ba.banded_attention_fwd(*args)
    ref, _ = ba.banded_attention_reference(*args)
    delta = (go.float() * out.float()).sum(-1)
    bwd = (0, 0.0, go, lse, delta)
    got = ba.banded_attention_bwd_dq(*args[:8], *bwd) \
        + ba.banded_attention_bwd_dkv(q, k, v, spm, window, *bwd)
    want = ba.banded_attention_bwd_dq_reference(*args[:8], *bwd) \
        + ba.banded_attention_bwd_dkv_reference(q, k, v, spm, window, *bwd)
    rows = _masked_rows(torch, ba, txm, spm, c)
    keys = spm > 0
    errs = {"K3": _split_rel_err(torch, out, ref, ~rows)[0],
            "K4": max(_split_rel_err(torch, got[0], want[0], ~rows)[0],
                      _rel_err(got[1], want[1]), _rel_err(got[2], want[2])),
            "K5": max(_split_rel_err(torch, got[3], want[3], keys)[0],
                      _split_rel_err(torch, got[4], want[4], keys)[0])}
    log(f"  K3/K4/K5 at the dilated shape {(b, h, t, d)} c={c} tt={tt} bf16:"
        f" max|kernel-plain|/max|plain| " + ", ".join(
            f"{k_} {e:.3g}" for k_, e in errs.items())
        + f" (tol {TOL_BWD_BF16:g})")
    check(all(e <= TOL_BWD_BF16 for e in errs.values()),
          "K3/K4/K5 against their plain versions at the dilated shape")
    abs_err = {"K3": (out.float() - ref.float()).abs().max().item(),
               "K4": max((a.float() - w.float()).abs().max().item()
                         for a, w in zip(got[:3], want[:3])),
               "K5": max((a.float() - w.float()).abs().max().item()
                         for a, w in zip(got[3:], want[3:]))}
    del ref, got, want
    ci = torch.arange(t, device=q.device) // c
    band = (ci[:, None] - ci[None, :]).abs() <= 1
    mask = torch.cat([band[None] & (spm[:, None, :] > 0),
                      (txm[:, None, :] > 0).expand(b, t, tt)], dim=-1)[:, None]
    ka, va = torch.cat([k, kt], 2), torch.cat([v, vt], 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qs, ks, vs = (x.clone().requires_grad_() for x in (q, ka, va))
    lib_out = sdpa(qs, ks, vs, attn_mask=mask)
    t_lib_fwd = cuda_ms(lambda: sdpa(q, ka, va, attn_mask=mask), iters=5)
    t_lib_bwd = cuda_ms(lambda: torch.autograd.grad(
        lib_out, (qs, ks, vs), go, retain_graph=True), iters=5)
    fns = {"K3": (lambda: ba.banded_attention_fwd(*args),
                  lambda: ba.banded_attention_reference(*args),
                  banded_bound_ms(b, h, t, d, c, tt, name), t_lib_fwd),
           "K4": (lambda: ba.banded_attention_bwd_dq(*args[:8], *bwd),
                  lambda: ba.banded_attention_bwd_dq_reference(*args[:8],
                                                               *bwd),
                  banded_dq_bound_ms(b, h, t, d, c, tt, name), t_lib_bwd),
           "K5": (lambda: ba.banded_attention_bwd_dkv(q, k, v, spm, window,
                                                      *bwd),
                  lambda: ba.banded_attention_bwd_dkv_reference(
                      q, k, v, spm, window, *bwd),
                  banded_dkv_bound_ms(b, h, t, d, c, name), t_lib_bwd)}
    rows_out = {}
    for kern, (kernel, plain, (bound, by), t_lib) in fns.items():
        t_kernel = cuda_ms(kernel, iters=10)
        t_plain = cuda_ms(plain, iters=3, warmup=1)
        t_kernel2 = cuda_ms(kernel, iters=10)
        log(f"  {kern} times at the dilated shape {(b, h, t, d)}: kernel "
            f"{t_kernel:.4f} / {t_kernel2:.4f} ms, plain {t_plain:.4f} ms, "
            f"sdpa {'forward' if kern == 'K3' else 'backward'} {t_lib:.4f} "
            f"ms, bound {bound:.5f} ms ({by}) [{label}]")
        rows_out[kern] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                              bound_ms=bound, bound_by=by,
                              max_abs_err=abs_err[kern])
    del q, k, v, kt, vt, go, out, lse, delta, qs, ks, vs, lib_out, mask
    del band, ka, va, fns, args, bwd
    torch.cuda.empty_cache()
    return rows_out


def dilation_part(torch, np, ba, cuda_ms, wall_time, label, root,
                  device="cuda"):
    """configs/a3t_longformer_16k.yaml with attention_dilation 2 at full
    width (bf16, its 2 speech-only pre-encoder blocks dilated too, with no
    text keys) on train-longformer's batch: a dropout-0 step's gradients
    through K3-K5 against their plain versions, 2 warm-up and 5 timed steps
    at the yaml's dropout (6 launches of each kernel a step), K3-K5 at the
    dilated shape, then bin.train with the dilation for LF_ITERS steps on a
    generated 16 kHz corpus of whole 1024- and 2048-frame batches.  Returns
    the K3-K5 launches of the timed steps and the run, and the kernels'
    rows at the dilated shape."""
    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.tasks.config import OPTIM_24K
    from a3t_tpu_torch.train import (create_train_state, featurize,
                                     make_optimizer, make_train_step)

    batch, fe, cfg, cfg0 = _longformer_setup(torch, np, device)
    cfg, cfg0 = (_stack_cfg(x, attention_dilation=DILATION)
                 for x in (cfg, cfg0))
    b_size, n_frames = batch["masked_position"].shape
    n_blocks = cfg.encoder.num_blocks + cfg.encoder.pre_speech_layers
    longformer_grad_check(torch, ba, cfg0, fe, batch, TOL_GRADS_BF16,
                          f"dilation {DILATION}, bf16, the batch", device)

    model = build_model(cfg, device=device, seed=0)
    state = create_train_state(model, make_optimizer(OPTIM_24K),
                               device=device)
    step = make_train_step(model, fe, device=device)
    gen = torch.Generator().manual_seed(0)
    walls = []
    ba.reset_launches()
    for i in range(2 + REPEATS):
        if i == 2:
            torch.cuda.reset_peak_memory_stats()
        before = _banded_launches(ba)
        (state, stats), dt = wall_time(step, state, batch, gen)
        n = tuple(a - b for a, b in zip(_banded_launches(ba), before))
        loss, gnorm = float(stats["loss"]), float(stats["grad_norm"])
        check(np.isfinite(loss) and np.isfinite(gnorm)
              and int(stats["notfinite_count"]) == 0,
              f"dilated step {i}: finite loss and grad_norm, no skip")
        check(n == (n_blocks,) * 3,
              f"dilated step {i}: launches {n}, expected {n_blocks} each")
        if i >= 2:
            walls.append(dt)
    launches = _banded_launches(ba)
    peak = torch.cuda.max_memory_allocated()
    med = float(np.median(walls))
    log(f"  dilation {DILATION} step: median {med * 1e3:.2f} ms (min "
        f"{min(walls) * 1e3:.2f}, max {max(walls) * 1e3:.2f}, n={REPEATS}), "
        f"{b_size * n_frames / med:.1f} mel-frames/s, peak memory "
        f"{peak / 2**30:.2f} GiB, last loss {loss:.6g}, grad_norm "
        f"{gnorm:.6g}; K3/K4/K5 launches {launches} [{label}]")
    flens = featurize(fe, batch)["speech_mask"].sum(1).tolist()
    del model, state, step, stats
    torch.cuda.empty_cache()
    lengths = [max(0, -(-(f - r) // DILATION)) for f in flens
               for r in range(DILATION)]
    rows = dilated_kernel_rows(torch, ba, cuda_ms, lengths,
                               cfg.encoder.attention_window, label)

    # bin.train with the dilation on whole 1024- and 2048-frame batches
    work = os.path.join(root, "dilated")
    train, _, secs, _ = make_corpus(
        work, fs=16000, hop=200, fill=LF_FILL, shards=LF_SHARDS,
        valid_utts=0, seed=40, phones=LF_PHONES, shard_utts=LF_SHARD_UTTS)
    argv = ["--config", CONFIG_16K, "--device", device]
    for s in (f"train_data_dir={train}", "valid_data_dir=",
              f"exp_dir={os.path.join(work, 'exp')}",
              f"model.encoder.attention_dilation={DILATION}",
              "trainer.max_epoch=1", f"trainer.num_iters_per_epoch={LF_ITERS}",
              "trainer.keep_nbest_models=1", *LF_SETS):
        argv += ["--set", s]
    before = _banded_launches(ba)
    t0 = time.perf_counter()
    trainer, state = train_main(argv)
    torch.cuda.synchronize()
    n = tuple(a - b for a, b in zip(_banded_launches(ba), before))
    steps = list(trainer.step_log)
    enc = state.model.config.encoder
    log(f"  bin.train dilation {enc.attention_dilation}: corpus made in "
        f"{secs:.2f} s; {len(steps)} steps of "
        f"{[(r['batch'], r['frames']) for r in steps]} in "
        f"{time.perf_counter() - t0:.2f} s, losses "
        f"{[round(r['loss'], 3) for r in steps]}, device ms per step "
        f"{[round(r.get('device_ms', 0.0), 2) for r in steps]}; K3/K4/K5 {n}"
        f" [{label}]")
    blocks = enc.num_blocks + enc.pre_speech_layers
    check(enc.attention_dilation == DILATION and len(steps) == LF_ITERS
          and sorted({r["frames"] for r in steps}) == [1024, 2048]
          and all(np.isfinite(r["loss"]) for r in steps)
          and int(state.opt_state.total_notfinite) == 0,
          "bin.train with the dilation: every step finite, both buckets")
    check(n == (blocks * LF_ITERS,) * 3,
          f"bin.train with the dilation: {blocks} launches of each of K3, "
          "K4 and K5 a step")
    del trainer, state
    torch.cuda.empty_cache()
    return tuple(a + b for a, b in zip(launches, n)), rows


def chunked_part(torch, np, ba, wall_time, label, device="cuda"):
    """The chunked-einsum path (use_pallas_attention: false) at full width:
    a dropout-0 step at dilation 1 and 2 (no K3-K5 launch), at dilation 1
    beside the same first step with chunked_attention in place of the
    banded call (the measurement PR 6 made, its reading printed beside), and
    the module's speech attention against chunked_attention on the same
    q/k/v."""
    import a3t_tpu_torch.models.windowed_attention as wa
    from a3t_tpu_torch.models.windowed_attention import WindowedSelfAttention
    from a3t_tpu_torch.tasks.config import OPTIM_24K
    from a3t_tpu_torch.train import (create_train_state, make_optimizer,
                                     make_train_step)

    def formula(q, k, v, kt, vt, text_mask, window, speech_mask,
                dropout_rate, seed):
        return chunked_attention(torch, q, k, v, kt, vt, text_mask.int(),
                                 speech_mask.int(), window)[0].to(q.dtype)

    batch, fe, _, cfg0 = _longformer_setup(torch, np, device)
    firsts = {}
    for dl, chunked in ((1, True), (DILATION, True), (1, False)):
        model = _dropout0_model(_stack_cfg(
            cfg0, attention_dilation=dl, use_pallas_attention=not chunked),
            device)
        state = create_train_state(model, make_optimizer(OPTIM_24K),
                                   device=device)
        step = make_train_step(model, fe, device=device)
        wa.banded_attention, banded = formula, wa.banded_attention
        try:
            _, st = step(state, batch, 0)
            firsts[(dl, chunked)] = (float(st["loss"]),
                                     float(st["grad_norm"]))
            if chunked:
                torch.cuda.reset_peak_memory_stats()
                before = _banded_launches(ba)
                (_, st), dt = wall_time(step, state, batch, 0)
                n = tuple(a - b for a, b in zip(_banded_launches(ba), before))
        finally:
            wa.banded_attention = banded
        if not chunked:
            continue
        loss, gnorm = firsts[(dl, chunked)]
        log(f"  chunked path, dilation {dl}, dropout 0, first step: loss "
            f"{loss:.7g}, grad_norm {gnorm:.7g}; the second step "
            f"{dt * 1e3:.2f} ms, peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; K3/K4/K5 "
            f"launches {n} [{label}]")
        check(np.isfinite(loss) and np.isfinite(gnorm) and n == (0, 0, 0),
              f"chunked path, dilation {dl}: finite, no banded kernel")
        del model, state, step, st
        torch.cuda.empty_cache()
    (lc, gc), (lf, gf) = firsts[(1, True)], firsts[(1, False)]
    log(f"  the first step through chunked_attention in place of the banded "
        f"call: loss {lf:.7g}, grad_norm {gf:.7g} (PR 6 read "
        f"{CHUNKED_GRAD_NORM_PR6}); the port's chunked path: rel "
        f"{abs(lc - lf) / abs(lf):.3g} and {abs(gc - gf) / gf:.3g} (tol "
        f"{TOL_LF_LOSS:g} and {TOL_LF_GRAD_NORM:g})")
    check(abs(lc - lf) <= TOL_LF_LOSS * abs(lf)
          and abs(gc - gf) <= TOL_LF_GRAD_NORM * gf,
          "the chunked path's step equals chunked_attention's")

    g = torch.Generator().manual_seed(4)
    q, k, v, kt, vt, _, txm, spm = _banded_inputs(
        torch, g, 4, 2, 8192, 192, 64, torch.float32, (8192, 5444, 5133, 6229))
    mod = WindowedSelfAttention(384, 2, 512, use_banded=False).to(q.device)
    got = mod.eval()._chunked(q, k, v, spm > 0, kt, vt, txm > 0, None)
    want, masked = chunked_attention(torch, q, k, v, kt, vt, txm, spm, 512)
    err = _rel_err(got, want)
    log(f"  the module's chunked path against chunked_attention, (4, 2, "
        f"8192, 192), 64 text keys, fp32, {int(masked.sum())} fully masked "
        f"rows: max|diff|/max|ref| {err:.3g} (tol {TOL_F32:g})")
    check(err <= TOL_F32, "the chunked path equals chunked_attention")
    del q, k, v, kt, vt, txm, spm, got, want, masked
    torch.cuda.empty_cache()


def _knob_grads(torch, model, mb):
    """(loss, {name: gradient}, {name: buffer}, generator state) of one
    forward and backward in train mode at the model's dropout."""
    from a3t_tpu_torch.models.mlm import mlm_loss

    model.train()
    gen = torch.Generator().manual_seed(0)
    before, after = model(**mb, generator=gen)
    loss = mlm_loss(before, after, mb["speech"], mb["masked_position"])
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    torch.cuda.synchronize()
    return (float(loss.detach()), dict(zip(names, grads)),
            {n: b.clone() for n, b in model.named_buffers()}, gen.get_state())


def knobs_part(torch, np, fa, label, device="cuda"):
    """The encoder knobs on the 24 kHz bf16 step (bench_batch, 88 x (432 +
    64)) with the yaml's dropout: remat and remat_attention against the
    plain step (loss, gradients, BatchNorm statistics and the generator's
    state bit for bit in deterministic mode, within TOL_GRADS_BF16_24K of
    each leaf's largest gradient otherwise), their step times and peak
    memory; one step each of cnn_module_bn_compute_dtype,
    normalize_before false, conv1d_shifted and cnn_module_shifted, the
    shifted ones' eval outputs bit for bit those of conv1d.  Returns the K1
    and K2 launches of the steps."""
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.models import build_model
    from a3t_tpu_torch.tasks.config import (FRONTEND_24K, OPTIM_24K,
                                            a3t_conformer_24k)
    from a3t_tpu_torch.train import (create_train_state, featurize,
                                     make_optimizer, make_train_step)

    batch = bench_batch(torch, np, device)
    fe = LogMelFrontend(FRONTEND_24K, device=device)
    mb = featurize(fe, batch)
    base = _stack_cfg(a3t_conformer_24k(compute_dtype="bfloat16"),
                      **OPTION_STACK)
    variants = {"plain": {}, "remat": {"remat": True},
                "remat_attention": {"remat_attention": True}}
    models = {name: build_model(_stack_cfg(base, **kw), device=device, seed=0)
              for name, kw in variants.items()}
    models["plain"].eval()
    with torch.no_grad(), deterministic_mode(torch):
        plain_eval = models["plain"](**mb)
    with deterministic_mode(torch):
        runs = {name: _knob_grads(torch, m, mb) for name, m in models.items()}
    for name in ("remat", "remat_attention"):
        got, want = runs[name], runs["plain"]
        same = (got[0] == want[0]
                and all(torch.equal(got[1][n], g) for n, g in want[1].items())
                and all(torch.equal(got[2][n], b) for n, b in want[2].items())
                and torch.equal(got[3], want[3]))
        log(f"  {name} against the plain step, deterministic mode, dropout "
            f"0.2: loss {got[0]:.7g} vs {want[0]:.7g}; gradients, BatchNorm "
            f"statistics and the generator's state bit for bit: {same}")
        check(same, f"{name} changes nothing in deterministic mode")
    runs = {name: _knob_grads(torch, m, mb) for name, m in models.items()}
    top = max(g.abs().max().item() for g in runs["plain"][1].values())
    for name in ("remat", "remat_attention"):
        got, want = runs[name], runs["plain"]
        worst = max((got[1][n] - g).abs().max().item() / max(
            top if n.endswith(ZERO_GRADIENT) else g.abs().max().item(),
            1e-30) for n, g in want[1].items())
        stats = max((got[2][n].float() - b.float()).abs().max().item()
                    for n, b in want[2].items() if b.is_floating_point())
        log(f"  {name} against the plain step, default algorithms: loss "
            f"{got[0]:.7g} vs {want[0]:.7g}, worst leaf max|diff|/max|plain|"
            f" {worst:.3g} (tol {TOL_GRADS_BF16_24K:g}), BatchNorm statistics"
            f" max|diff| {stats:.3g} (tol {TOL_LF_STATS:g}), generator state "
            f"equal {torch.equal(got[3], want[3])}")
        check(worst <= TOL_GRADS_BF16_24K and stats <= TOL_LF_STATS
              and torch.equal(got[3], want[3])
              and abs(got[0] - want[0]) <= TOL_LF_LOSS * abs(want[0]),
              f"{name} against the plain step")
    del runs

    l1, l2 = fa.LAUNCHES, fa.LAUNCHES_BWD
    blocks = base.encoder.num_blocks + base.decoder.num_blocks
    for name, model in models.items():
        state = create_train_state(model, make_optimizer(OPTIM_24K),
                                   device=device)
        step = make_train_step(model, fe, device=device)
        gen = torch.Generator().manual_seed(1)
        step(state, batch, gen)
        torch.cuda.synchronize()
        base_mem = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        walls = []
        for _ in range(3):
            k1, k2 = fa.LAUNCHES, fa.LAUNCHES_BWD
            t0 = time.perf_counter()
            _, st = step(state, batch, gen)
            loss = float(st["loss"])
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            n = (fa.LAUNCHES - k1, fa.LAUNCHES_BWD - k2)
            check(np.isfinite(loss) and n == (
                blocks * (1 if name == "plain" else 2), blocks),
                f"{name} step: finite, launches K1/K2 {n}")
        peak = torch.cuda.max_memory_allocated()
        log(f"  {name} bf16 step: median {np.median(walls) * 1e3:.2f} ms "
            f"(n=3), peak memory {peak / 2**30:.3f} GiB, of it above the "
            f"resident state {(peak - base_mem) / 2**30:.3f} GiB; K1/K2 per "
            f"step {n} [{label}]")
        del state, step
    del models
    torch.cuda.empty_cache()

    for name, kw in (("cnn_module_bn_compute_dtype",
                      {"cnn_module_bn_compute_dtype": True}),
                     ("normalize_before false", {"normalize_before": False}),
                     ("conv1d_shifted",
                      {"positionwise_layer_type": "conv1d_shifted"}),
                     ("cnn_module_shifted", {"cnn_module_shifted": True})):
        model = build_model(_stack_cfg(base, **kw), device=device, seed=0)
        note = ""
        if "shifted" in name:
            model.eval()
            with torch.no_grad(), deterministic_mode(torch):
                outs = model(**mb)
            same = all(torch.equal(a, b) for a, b in zip(outs, plain_eval))
            note = f", eval outputs bit for bit those of conv1d: {same}"
            check(same, f"{name}: the outputs of conv1d")
        state = create_train_state(model, make_optimizer(OPTIM_24K),
                                   device=device)
        _, st = make_train_step(model, fe, device=device)(
            state, batch, torch.Generator().manual_seed(1))
        loss = float(st["loss"])
        log(f"  {name}: one bf16 step, loss {loss:.6g}, grad_norm "
            f"{float(st['grad_norm']):.6g}{note}")
        check(np.isfinite(loss) and int(st["notfinite_count"]) == 0,
              f"{name}: a finite step")
        del model, state, st
        torch.cuda.empty_cache()
    return fa.LAUNCHES - l1, fa.LAUNCHES_BWD - l2


def plots_part(torch, np, fa, label, root, train, valid, device="cuda"):
    """bin.train on the trainer's 24 kHz corpus for one epoch of PLOT_ITERS
    steps with num_plot_examples=PLOT_EXAMPLES: the plot arrays computed on
    the card (shapes; each attention row sums to 1), rendered where
    matplotlib imports.  Returns the K1 and K2 launches of the run."""
    from a3t_tpu_torch.bin.train import main as train_main
    from a3t_tpu_torch.train import plots

    captured = {}
    real = (plots.mel_plot_arrays, plots.attention_plot_arrays)

    def record(key, fn):
        def wrapped(*a):
            captured[key] = fn(*a)
            return captured[key]
        return wrapped

    plots.mel_plot_arrays = record("mel", real[0])
    plots.attention_plot_arrays = record("attention", real[1])
    exp = os.path.join(root, "plots_exp")
    l1, l2 = fa.LAUNCHES, fa.LAUNCHES_BWD
    try:
        trainer, state = train_main(_train_argv(
            train, valid, exp, device, "trainer.max_epoch=1",
            f"trainer.num_iters_per_epoch={PLOT_ITERS}",
            f"num_plot_examples={PLOT_EXAMPLES}", *PLOT_SETS))
    finally:
        plots.mel_plot_arrays, plots.attention_plot_arrays = real
    torch.cuda.synchronize()
    n = (fa.LAUNCHES - l1, fa.LAUNCHES_BWD - l2)
    target, pred, masked, valid_frames = captured["mel"]
    entries = captured["attention"]
    cfg = state.model.config
    blocks = cfg.encoder.num_blocks + cfg.decoder.num_blocks
    n_eval = len(trainer.valid_iter_factory.batcher.batch_plan(1))
    b, f, odim = target.shape
    on_card = all(a.device.type == torch.device(device).type
                  for a in (target, pred, masked, valid_frames,
                            *(a for _, a in entries)))
    sums = max((a.sum(-1) - 1).abs().max().item() for _, a in entries)
    log(f"  plots: mel arrays {tuple(target.shape)} / {tuple(pred.shape)} / "
        f"{tuple(masked.shape)} / {tuple(valid_frames.shape)} on the card "
        f"{on_card}; {len(entries)} attention maps of "
        f"{tuple(entries[0][1].shape)}, rows sum to 1 within {sums:.3g}; K1 "
        f"{n[0]}, K2 {n[1]} ({PLOT_ITERS} steps, {n_eval} eval steps, one "
        f"mel-plot forward)")
    check(on_card and odim == cfg.odim and b >= PLOT_EXAMPLES
          and pred.shape == target.shape and masked.shape == (b, f)
          and valid_frames.shape == (b, f) and len(entries) == blocks
          and all(a.shape[:2] == (PLOT_EXAMPLES, 2)
                  and a.shape[2] == a.shape[3] for _, a in entries)
          and sums <= 1e-5, "the plot arrays")
    check(n == (blocks * (PLOT_ITERS + n_eval + 1), blocks * PLOT_ITERS),
          "the plot run's launches: the mel plot through K1, the attention "
          "plot through the plain attention")
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        log("  matplotlib is not installed here: the plot arrays were "
            "computed on the card and nothing was rendered")
    else:
        files = sorted(os.listdir(os.path.join(exp, "plots")))
        log(f"  matplotlib rendered {files}")
        check(files == sorted(f"{p}epoch1_utt{i}.png" for p in ("", "att_")
                              for i in range(PLOT_EXAMPLES)),
              "the plots were written")
    del trainer, state, captured, entries
    torch.cuda.empty_cache()
    return n


def vocoder_part(torch, np, cuda_ms, label, device="cuda"):
    """The trained 16 kHz vocoder (weights/vocoder_16k, converted from the
    JAX package's artifacts/vocoder) on check.npz's mel with JAX's noise,
    against JAX's wav; ms per call and the real-time factor."""
    from a3t_tpu_torch.train.vocoder import TRAINED_16K, load_vocoder

    data = np.load(os.path.join(TRAINED_16K, "check.npz"))
    t0 = time.perf_counter()
    vocode = load_vocoder(TRAINED_16K, device=device)
    load_s = time.perf_counter() - t0
    mel = torch.as_tensor(data["mel"], device=device)
    z = torch.as_tensor(data["z"], device=device)
    wav = vocode(mel, z=z).cpu().numpy()
    want = data["wav"]
    peak = float(np.abs(want).max())
    err = float(np.abs(wav - want).max()) / peak
    ms = cuda_ms(lambda: vocode(mel, z=z), iters=10, warmup=2)
    secs = want.shape[1] / 16000
    log(f"  trained vocoder: load {load_s:.2f} s; {tuple(mel.shape)} mel -> "
        f"{wav.shape[1]} samples ({secs:.3f} s); max|card - JAX|/peak "
        f"{err:.3g} (tol {TOL_VOCODER:g}, peak {peak:.4f}); {ms:.3f} ms per "
        f"call, RTF {ms / 1e3 / secs:.5f} [{label}]")
    check(wav.shape == want.shape and err <= TOL_VOCODER,
          "the trained vocoder's wav equals JAX's")


def _buzz(np, rng, fs, n_words):
    """Speech-ish buzz of ``n_words`` 0.6 s words: a pulse train with a
    4 Hz envelope and noise (tests/test_prepare_recipes.py's)."""
    t = np.arange(int(0.6 * fs)) / fs
    parts = []
    for _ in range(n_words):
        f0 = rng.uniform(100, 220)
        w = 0.2 * np.sign(np.sin(2 * np.pi * f0 * t)) \
            * np.sin(2 * np.pi * 4 * t) ** 2
        parts.append(w + 0.02 * rng.standard_normal(len(t)))
    return np.concatenate(parts).astype(np.float32)


def recipes_part(torch, np, label, root, device="cuda"):
    """The LJSpeech and VCTK recipes on tiny corpora in the sources' layouts
    (LJSpeech's metadata.csv + wavs/ at 22.05 kHz to 16 kHz, VCTK's txt/ +
    wav48/ at 48 kHz to 24 kHz with one held-out speaker): every split at
    the target rate and one monotone span per phone."""
    import csv

    from a3t_tpu_torch.data.fileio import (load_num_sequence_text,
                                           read_2column_text, write_wav)
    from a3t_tpu_torch.data.format_wav import validate_data_dir_fs
    from a3t_tpu_torch.recipes import ljspeech, vctk

    rng = np.random.default_rng(0)
    base = os.path.join(root, "recipes")
    lj = os.path.join(base, "LJSpeech-1.1")
    os.makedirs(os.path.join(lj, "wavs"))
    texts = ["CALL STELLA NOW", "Ask her, please!", "bring these things",
             "with her from the store", "six spoons", "of fresh snow peas"]
    with open(os.path.join(lj, "metadata.csv"), "w", newline="") as f:
        w = csv.writer(f, delimiter="|")
        for i, text in enumerate(texts):
            uid = f"LJ001-{i:04d}"
            write_wav(os.path.join(lj, "wavs", f"{uid}.wav"), 22050,
                      _buzz(np, rng, 22050, 2))
            w.writerow([uid, "text", text])
    vc = os.path.join(base, "VCTK-Corpus")
    words = ["PLEASE", "CALL", "STELLA", "ASK", "HER"]
    for spk in ("p225", "p226", "p227"):
        os.makedirs(os.path.join(vc, "wav48", spk))
        os.makedirs(os.path.join(vc, "txt", spk))
        for i in range(3):
            uid = f"{spk}_{i:03d}"
            write_wav(os.path.join(vc, "wav48", spk, f"{uid}.wav"), 48000,
                      _buzz(np, rng, 48000, 2))
            with open(os.path.join(vc, "txt", spk, f"{uid}.txt"), "w") as f:
                f.write(" ".join(words[i:i + 2]) + "\n")
    runs = (("ljspeech", ljspeech, lj, ["--dev-utts", "1", "--eval-utts", "1",
                                        "--fs", "16000"], 16000,
             ("tr_no_dev", "dev", "eval1")),
            ("vctk", vctk, vc, ["--unseen-speakers", "p227",
                                "--dev-per-spk", "1", "--target-fs",
                                "24000"], 24000,
             ("tr_no_dev", "dev", "eval_unseen")))
    for name, module, corpus, argv, fs, splits in runs:
        out = os.path.join(base, f"{name}_out")
        t0 = time.perf_counter()
        module.main(["--corpus", corpus, "--out", out, *argv,
                     "--device", device])
        secs = time.perf_counter() - t0
        counts = []
        for split in splits:
            d = os.path.join(out, split)
            validate_data_dir_fs(d, fs)
            scp = read_2column_text(os.path.join(d, "wav.scp"))
            phones = read_2column_text(os.path.join(d, "mfa_text"))
            starts = load_num_sequence_text(os.path.join(d, "mfa_start"))
            ends = load_num_sequence_text(os.path.join(d, "mfa_end"))
            for uid in scp:
                s, e = starts.get(uid), ends.get(uid)
                n_ph = len(phones.get(uid, "").split())
                check(s is not None and e is not None
                      and n_ph == len(s) == len(e) > 0
                      and bool((np.diff(s) >= 0).all() and (e >= s).all()),
                      f"{name} {split} {uid}: one span per phone, starts "
                      "monotone")
            counts.append((split, len(scp)))
        log(f"  recipe {name}: {secs:.2f} s, splits {counts} at {fs} Hz, "
            f"every phone aligned")


def model_options_phase(torch, np, fa, ba, cuda_ms, wall_time, label, root,
                        train, valid, device="cuda"):
    """Dilation through K3-K5 (and bin.train with it), the chunked path, the
    encoder knobs, the plots, the trained vocoder and the recipes, each
    part's seconds printed.  Returns the K1-K5 launches of the phase's main
    path (the dilated steps and run, the knobs' steps and the plot run)."""
    seconds = {}

    def part(name, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn(*args)
        torch.cuda.synchronize()
        seconds[name] = time.perf_counter() - t0
        return out

    banded, rows = part("dilation", dilation_part, torch, np, ba, cuda_ms,
                        wall_time, label, root, device)
    part("chunked", chunked_part, torch, np, ba, wall_time, label, device)
    knobs = part("knobs", knobs_part, torch, np, fa, label, device)
    plotted = part("plots", plots_part, torch, np, fa, label, root, train,
                   valid, device)
    part("vocoder", vocoder_part, torch, np, cuda_ms, label, device)
    part("recipes", recipes_part, torch, np, label, root, device)
    launches = (knobs[0] + plotted[0], knobs[1] + plotted[1], *banded)
    log(f"  model-options seconds per part "
        f"{json.dumps({k: round(v, 2) for k, v in seconds.items()})}; "
        f"launches K1-K5 {launches} [{label}]")
    return launches, rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from a3t_tpu_torch.data import native_loader
    from a3t_tpu_torch.device import card_label, cuda_ms, wall_time
    from a3t_tpu_torch.ops import banded_attention as ba
    from a3t_tpu_torch.ops import fused_attention as fa
    from a3t_tpu_torch.ops import fused_logmel as fl
    from a3t_tpu_torch.ops import native

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    with Phase("device"):
        kind = torch.cuda.get_device_name(0)
        label = card_label()
        log(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, "
            f"{torch.cuda.device_count()} device(s): {kind}; nvidia-smi: {label}")

    with Phase("build"):
        # the trainer's native WAV loader (host C++) builds beside nvcc
        loader_build = {}

        def build_loader():
            t0 = time.perf_counter()
            try:
                loader_build["path"] = native_loader.build()
            except Exception as e:  # re-raised below, in this thread
                loader_build["error"] = e
            loader_build["seconds"] = time.perf_counter() - t0

        loader_thread = threading.Thread(target=build_loader)
        loader_thread.start()
        libraries = {**fa.LIBRARIES, **ba.LIBRARIES, **fl.LIBRARIES}
        paths = native.build_all(libraries)
        loader_thread.join()
        if "error" in loader_build:
            raise loader_build["error"]
        log(f"  native/loader built in {loader_build['seconds']:.2f} s: "
            f"{os.path.relpath(loader_build['path'])}")
        fa._entry()
        fa._entry_bwd()
        fl._entry("fft")
        fl._entry("dft")
        for name in ba.LIBRARIES:
            ba._entry(name)
        for name in libraries:
            for line in native.build_logs.get(name, "").splitlines():
                if "Compiling entry" in line or "registers" in line \
                        or "spill" in line:
                    log(f"  ptxas {name}: {line.strip()}")
        check_tensor_cores(native, paths)

    if sys.argv[1:] == ["--model-options"]:
        # the model-options phase alone, on a trainer corpus of its own
        with tempfile.TemporaryDirectory(prefix="a3t_options_") as root:
            with Phase("corpus"):
                train, valid, _, _ = make_corpus(os.path.join(root, "data"))
            with Phase("model-options"):
                model_options_phase(torch, np, fa, ba, cuda_ms, wall_time,
                                    label, root, train, valid)
        return 0

    with Phase("kernel"):
        f32, f32_train, _ = kernel_phase(torch, fa, cuda_ms)

    with Phase("kernel-bwd"):
        bwd = kernel_bwd_phase(torch, fa, cuda_ms)

    with Phase("kernel-banded"):
        banded = kernel_banded_phase(torch, ba, cuda_ms)

    with Phase("kernel-logmel"):
        logmel = kernel_logmel_phase(torch, np, fl, cuda_ms, label)

    with Phase("slice"):
        serve_launches = slice_phase(torch, np, fa, cuda_ms, wall_time, label)

    with Phase("frontend"):
        logmel_launches = frontend_phase(torch, np, fl, label)

    with Phase("train"):
        (train_fwd, train_bwd), split = train_phase(
            torch, np, fa, wall_time, label)
    log(f"  K1 alone at the training shape {f32_train['ms']:.4f} ms x 8 = "
        f"{8 * f32_train['ms']:.2f} ms, K2 {bwd['ms']:.4f} ms x 8 = "
        f"{8 * bwd['ms']:.2f} ms, per step of {split['step_ms']:.2f} ms "
        f"[{label}]")

    with Phase("train-bf16"):
        (bf16_fwd, bf16_bwd), _ = train_phase(
            torch, np, fa, wall_time, label, compute_dtype="bfloat16")

    with Phase("train-longformer"):
        lf_launches, lf_step_ms = train_longformer_phase(
            torch, np, ba, wall_time, label)
    per_step = sum(banded[k]["ms"] for k in ("K3", "K4", "K5"))
    log(f"  K3 + K4 + K5 alone at the training shape {per_step:.4f} ms x 6 = "
        f"{6 * per_step:.2f} ms, per longformer step of {lf_step_ms:.2f} ms "
        f"[{label}]")

    # the trainer's corpus and experiments stay until serve-cli is done
    with tempfile.TemporaryDirectory(prefix="a3t_trainer_") as root:
        with Phase("trainer"):
            (trainer_fwd, trainer_bwd), trainer_errs, exp_a, valid = \
                trainer_phase(torch, np, fa, label, root)

        with Phase("serve-cli"):
            cli_fwd, cli_bwd = serve_cli_phase(torch, np, fa, cuda_ms, label,
                                               exp_a, valid, root)

        with Phase("speaker-fs2"):
            (sp_fwd, sp_bwd), fs2_errs = speaker_fs2_phase(
                torch, np, fa, label, root,
                os.path.join(root, "data", "train"), valid)

        with Phase("side-train"):
            (side_fwd, side_bwd), side_errs = side_train_phase(
                torch, np, fa, label, root,
                os.path.join(root, "data", "train"), valid)

        with Phase("train-options"):
            (opt_fwd, opt_bwd), opt_errs = train_options_phase(
                torch, np, fa, label, root,
                os.path.join(root, "data", "train"), valid)

        with Phase("prep-chain"):
            (prep_fwd, prep_bwd), prep_errs = prep_chain_phase(
                torch, np, fa, label, root)

        with Phase("model-options"):
            mo_launches, dilated_rows = model_options_phase(
                torch, np, fa, ba, cuda_ms, wall_time, label, root,
                os.path.join(root, "data", "train"), valid)

    kernels = [{
        "name": "fused_attention_fwd",
        "route": "cuda",
        "source": "a3t_tpu_torch/csrc/fused_attention_fwd.cu",
        "replaces": "a3t_tpu/ops/fused_attention.py:92",
        "note": "redesigned PR 8",
        "launches": serve_launches + train_fwd + bf16_fwd + trainer_fwd
        + cli_fwd + sp_fwd + side_fwd + opt_fwd + prep_fwd + mo_launches[0],
        "launches_serve_cli": cli_fwd,
        "launches_speaker_fs2": sp_fwd,
        "launches_side_train": side_fwd,
        "launches_train_options": opt_fwd,
        "launches_prep_chain": prep_fwd,
        "launches_model_options": mo_launches[0],
        "max_abs_err": f32["max_abs_err"],
        "max_abs_err_trainer_shapes": trainer_errs[0],
        "max_abs_err_fs2_shapes": fs2_errs[0],
        "max_abs_err_tts_shapes": side_errs[0],
        "max_abs_err_speech_only_shapes": opt_errs[0],
        "max_abs_err_prep_chain_shapes": prep_errs[0],
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
        "note": "redesigned PR 8",
        "launches": train_bwd + bf16_bwd + trainer_bwd + cli_bwd + sp_bwd
        + side_bwd + opt_bwd + prep_bwd + mo_launches[1],
        "launches_serve_cli": cli_bwd,
        "launches_speaker_fs2": sp_bwd,
        "launches_side_train": side_bwd,
        "launches_train_options": opt_bwd,
        "launches_prep_chain": prep_bwd,
        "launches_model_options": mo_launches[1],
        "max_abs_err": bwd["max_abs_err"],
        "max_abs_err_trainer_shapes": trainer_errs[1],
        "max_abs_err_fs2_shapes": fs2_errs[1],
        "max_abs_err_tts_shapes": side_errs[1],
        "max_abs_err_speech_only_shapes": opt_errs[1],
        "max_abs_err_prep_chain_shapes": prep_errs[1],
        "ms": bwd["ms"],
        "plain_ms": bwd["plain_ms"],
        "bound_ms": bwd["bound_ms"],
        "bound_by": bwd["bound_by"],
        "library_ms": bwd["library_ms"],
    }]
    for i, (kern, name, line, n, note) in enumerate((
            ("K3", "banded_attention_fwd", 90, lf_launches[0],
             {"note": "redesigned: bf16 on wgmma"}),
            ("K4", "banded_attention_bwd_dq", 172, lf_launches[1],
             {"note": "redesigned PR 9"}),
            ("K5", "banded_attention_bwd_dkv", 286, lf_launches[2],
             {"note": "redesigned PR 9"}))):
        row, dil = banded[kern], dilated_rows[kern]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"a3t_tpu_torch/csrc/{name}.cu",
            "replaces": f"a3t_tpu/ops/banded_attention.py:{line}", **note,
            "launches": n + mo_launches[2 + i],
            "launches_model_options": mo_launches[2 + i],
            **{k: row[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")},
            **{f"{k}_dilated": dil[k] for k in (
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms")}})
    kernels.append({
        "name": "fused_logmel", "route": "cuda",
        "source": "a3t_tpu_torch/csrc/fused_logmel.cu",
        "replaces": "a3t_tpu/ops/fused_logmel.py:93",
        "note": "redesigned: an fp32 FFT in shared memory",
        "launches": logmel_launches, "launches_model_options": 0,
        **{k: logmel[k] for k in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")}})
    log(f"done in {time.perf_counter() - T0:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(label, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
