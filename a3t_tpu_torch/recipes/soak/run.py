"""Quality-soak recipe: hours-long training on a formant-synthesized corpus
(the port of ``recipes/soak/run.py``).

A multi-speaker speech-like corpus (``data/miniature.py::
generate_speechlike_corpus``) large enough to train the production-size
model for hours, through the full production pipeline: native C++ forced
alignment (evaluated against the oracle boundaries the synthesizer knows),
packed record shards, bf16 training through the fused-attention kernels
with step-keyed checkpoints, and the reference MCD protocol (middle-third
mask, teacher-forced, replaced-span MCD) on held-out utterances.

Stages (reference run.sh / mlm.sh analogue):
  1  synthesize corpus (train + held-out eval split)
  2  native forced alignment + boundary-error eval vs oracle
  3  pack record shards
  4  train (resumable; bound wall-clock with --epochs)
  5  eval: middle-third MCD protocol on held-out utterances
  6  train the FastSpeech2 duration model on the same corpus
  7  text-replacement edit + prompt-TTS demos with FS2-predicted durations

Run:  python -m a3t_tpu_torch.recipes.soak.run [--workdir DIR] \\
          [--stage 1 --stop-stage 5] [--n-utts 4000] [--epochs 200] \\
          [--device cpu]

The flags, the defaults and the work directory's layout are the JAX
recipe's.  The models train and serve on ``--device``, the CUDA card unless
``--device cpu`` is given; stages 1-3 are host work, and the recipe refuses
to start without a card unless given ``--device cpu``.  Each stage's host
seconds are printed as it ends.  The work directory defaults to
``a3t_soak`` under the temporary directory (``DEFAULT_WORKDIR``), which
``curve_eval`` and the report assemblers default to as well.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

FS = 16000
N_EVAL = 48
DEFAULT_WORKDIR = os.path.join(tempfile.gettempdir(), "a3t_soak")


def frontend_config():
    """The reference 16 kHz front-end (tasks/mlm.py:544-548)."""
    from a3t_tpu_torch.dsp import LogMelConfig

    return LogMelConfig(fs=FS, n_fft=1024, hop_length=200, win_length=800,
                        n_mels=80, fmin=80.0, fmax=7600.0)


def stage1_data(args, train_dir, eval_seen_dir, eval_unseen_dir):
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus

    print("== stage 1: corpus synthesis ==", flush=True)
    t0 = time.time()
    generate_speechlike_corpus(
        train_dir, n_utts=args.n_utts, n_speakers=args.n_speakers, fs=FS,
        seed=0, speaker_seed=0)
    # fresh oracle boundaries: invalidate any backup from a previous run
    for f in ("mfa_start.oracle", "mfa_end.oracle"):
        stale = os.path.join(train_dir, f)
        if os.path.exists(stale):
            os.remove(stale)
    # the reference MCD protocol evaluates seen AND unseen speakers
    # (sedit_mcd.py:58-75): held-out utterances from the training speaker
    # pool (same speaker_seed), and utterances from brand-new speakers
    generate_eval_splits(args.n_speakers, eval_seen_dir, eval_unseen_dir)
    print(f"   synthesized {args.n_utts}+{N_EVAL}+{N_EVAL} utts "
          f"in {time.time() - t0:.0f}s", flush=True)


def generate_eval_splits(n_speakers, eval_seen_dir, eval_unseen_dir):
    """The two held-out splits of stage 1: seen speakers (seed 1, the
    training speaker_seed 0) and unseen ones (seed 2, speaker_seed 99)."""
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus

    generate_speechlike_corpus(
        eval_seen_dir, n_utts=N_EVAL, n_speakers=n_speakers, fs=FS,
        seed=1, speaker_seed=0)
    generate_speechlike_corpus(
        eval_unseen_dir, n_utts=N_EVAL, n_speakers=n_speakers, fs=FS,
        seed=2, speaker_seed=99)


def _oracle_backup(data_dir):
    for f in ("mfa_start", "mfa_end"):
        src = os.path.join(data_dir, f)
        dst = src + ".oracle"
        if not os.path.exists(dst):
            os.replace(src, dst)


def stage2_align(args, train_dir, workdir):
    """Train the native aligner on a corpus subsample, align everything,
    and score phone-boundary error against the synthesizer's oracle."""
    import numpy as np

    from a3t_tpu_torch.align.native import NativeAligner
    from a3t_tpu_torch.data.fileio import (
        SoundScpReader, load_num_sequence_text, read_2column_text,
        write_num_sequence_text)

    print("== stage 2: native forced alignment ==", flush=True)
    _oracle_backup(train_dir)
    wav = SoundScpReader(os.path.join(train_dir, "wav.scp"))
    text = read_2column_text(os.path.join(train_dir, "text"))
    uids = [u for u in wav.keys() if u in text]

    phone_set = sorted({p for t in text.values() for p in t.split()})
    aligner = NativeAligner(phone_set, FS)

    rng = np.random.default_rng(0)
    sub = list(rng.permutation(uids)[: args.align_utts])
    t0 = time.time()
    utts = [(wav[u][1], text[u].split()) for u in sub]
    lls = aligner.train(utts, n_iterations=8, n_mixtures=args.align_mixtures)
    print(f"   EM on {len(sub)} utts: ll/frame {lls[0]:.2f} -> {lls[-1]:.2f} "
          f"({aligner.n_mixtures} mix, {time.time() - t0:.0f}s)", flush=True)
    aligner.save(os.path.join(workdir, "aligner.bin"))

    starts, ends = {}, {}
    t0 = time.time()
    for u in uids:
        s, e = aligner.align(wav[u][1], text[u].split())
        starts[u], ends[u] = s, e
    write_num_sequence_text(os.path.join(train_dir, "mfa_start"), starts)
    write_num_sequence_text(os.path.join(train_dir, "mfa_end"), ends)
    print(f"   aligned {len(uids)} utts in {time.time() - t0:.0f}s",
          flush=True)

    # boundary error vs oracle: interior boundaries (end of phone i ==
    # start of phone i+1), the standard forced-alignment metric
    o_start = load_num_sequence_text(os.path.join(train_dir,
                                                  "mfa_start.oracle"))
    errs = []
    for u in uids:
        a = np.asarray(starts[u][1:], np.float64)
        b = np.asarray(o_start[u][1:], np.float64)
        if len(a) == len(b) and len(a):
            errs.append(np.abs(a - b))
    if not errs:
        stats = {"n_boundaries": 0,
                 "error": "no utterance had matching aligner/oracle phone "
                          "counts — aligner output is unusable"}
        with open(os.path.join(workdir, "aligner_eval.json"), "w") as f:
            json.dump(stats, f, indent=1)
        raise RuntimeError(stats["error"])
    errs = np.concatenate(errs) * 1000.0
    stats = {
        "n_boundaries": int(errs.size),
        "median_ms": float(np.median(errs)),
        "mean_ms": float(errs.mean()),
        "p90_ms": float(np.percentile(errs, 90)),
        "within_20ms_pct": float((errs <= 20.0).mean() * 100.0),
        "em_train_utts": len(sub),
        "n_mixtures": int(aligner.n_mixtures),
    }
    print(f"   boundary error vs oracle: median {stats['median_ms']:.1f} ms, "
          f"p90 {stats['p90_ms']:.1f} ms, "
          f"<=20ms {stats['within_20ms_pct']:.1f}%", flush=True)
    with open(os.path.join(workdir, "aligner_eval.json"), "w") as f:
        json.dump(stats, f, indent=1)


def stage3_pack(args, train_dir, records_dir):
    from a3t_tpu_torch.bin.pack_records import main as pack_main

    print("== stage 3: pack record shards ==", flush=True)
    pack_main(["--data-dir", train_dir, "--out", records_dir])


def ensure_xvector(args, train_dir, eval_seen_dir, workdir):
    """Train the x-vector speaker model + spk2xvector dict if absent, on
    ``args.device``.

    Shared by stage 4 (--spemb acoustic conditioning) and stage 6
    (FS2 duration conditioning).  Returns the spk2xvector.npz path.
    """
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.dsp import LogMelFrontend
    from a3t_tpu_torch.models.xvector import (
        build_spk2xvector, build_utt2xvector, load_xvector, train_xvector)
    from a3t_tpu_torch.text import TokenIDConverter, build_token_list

    xv_dir = os.path.join(workdir, "exp_xvector")
    spk2xv_path = os.path.join(xv_dir, "spk2xvector.npz")
    fe = LogMelFrontend(frontend_config(), device=args.device)
    if not os.path.exists(spk2xv_path):
        print("== x-vector speaker model (shared stage) ==", flush=True)
        train_xvector(train_dir, fe, xv_dir, total_steps=args.xvector_steps,
                      eval_data_dir=eval_seen_dir, max_utts=4000)
        model, mel_mvn = load_xvector(xv_dir, device=args.device)
        texts = read_2column_text(os.path.join(train_dir, "text"))
        conv = TokenIDConverter(build_token_list(texts.values()))
        build_spk2xvector(model, fe, A3TDataset(train_dir, conv),
                          out_path=spk2xv_path, mel_mvn=mel_mvn,
                          max_utts_per_speaker=64)
    # per-utterance embeddings, dir-local (training conditions on the
    # same kind of utterance-level signal the context-masked inference
    # extractor observes)
    model, mel_mvn = load_xvector(xv_dir, device=args.device)
    texts = read_2column_text(os.path.join(train_dir, "text"))
    conv = TokenIDConverter(build_token_list(texts.values()))
    for d in (train_dir, eval_seen_dir):
        out = os.path.join(d, "utt2xvector.npz")
        if not os.path.exists(out):
            print(f"   utt2xvector for {d}", flush=True)
            build_utt2xvector(model, fe, A3TDataset(d, conv), out_path=out,
                              mel_mvn=mel_mvn)
    return spk2xv_path


def launch_config(args, records_dir, eval_dir, exp):
    """Stage 4's production launch config (before --spemb's additions)."""
    return {
        "train_data_dir": records_dir,
        "valid_data_dir": eval_dir,
        "token_list": os.path.join(records_dir, "tokens.txt"),
        "exp_dir": exp,
        # reference 16 kHz front-end settings (tasks/mlm.py:544-548)
        "frontend": {"fs": FS, "n_fft": 1024, "hop_length": 200,
                     "win_length": 800, "n_mels": 80, "fmin": 80.0,
                     "fmax": 7600.0},
        # production-size model (fsp2_conformer.yaml), bf16 + the fused
        # attention kernels
        "model": {
            "encoder": {"cnn_module_kernel": 7,
                        "compute_dtype": "bfloat16"},
            "decoder": {"cnn_module_kernel": 31,
                        "compute_dtype": "bfloat16"},
            "mlm_prob": 0.8, "mean_phn_span": 8,
        },
        "optim": {"lr": 1.0, "model_size": 384,
                  "warmup_steps": args.warmup_steps, "grad_clip": 1.0},
        "batcher": {"batch_bins": args.batch_bins,
                    "bucket_frames": [192, 256, 320, 448],
                    "mlm_prob": 0.8, "mean_phn_span": 8.0,
                    "mlm_prob_factor": args.mlm_prob_factor,
                    # the corpus resident on the device: the host ships
                    # offsets, the step gathers audio on the device
                    "device_audio": not args.no_device_audio},
        "trainer": {"max_epoch": args.epochs,
                    "num_iters_per_epoch": args.iters_per_epoch,
                    "keep_nbest_models": 5, "log_interval": 50,
                    "resume": True,
                    # one call per k steps (trainer.steps_per_dispatch)
                    "steps_per_dispatch": args.steps_per_dispatch,
                    # a stash kept outside the workdir (bin.export_params,
                    # or the JAX package's orbax stash): warm-start when
                    # the workdir was wiped and no resume ckpt exists;
                    # absent stash (very first run) falls through to
                    # random init so the recipe line is the same either way
                    "init_params_dir": (args.init_params
                                        if args.init_params
                                        and os.path.isdir(args.init_params)
                                        else None)},
    }


def stage4_train(args, records_dir, eval_dir, workdir, exp,
                 train_dir=None):
    from a3t_tpu_torch.tasks import yaml_subset

    print("== stage 4: training ==", flush=True)
    conf = launch_config(args, records_dir, eval_dir, exp)
    if args.spemb:
        # speaker-conditioned training: per-utterance x-vectors (dir-local
        # utt2xvector.npz; spk2xvector as the by-speaker fallback),
        # projected into the modality embeddings and the decoder input.
        # allow_missing lets --init-params warm-start from an
        # unconditioned stash (the spemb projections keep fresh init).
        import shutil

        spk2xv = ensure_xvector(args, train_dir or records_dir,
                                eval_dir, workdir)
        if train_dir and train_dir != records_dir:
            src = os.path.join(train_dir, "utt2xvector.npz")
            if os.path.exists(src):
                shutil.copy(src, os.path.join(records_dir,
                                              "utt2xvector.npz"))
        conf["model"]["spemb_dim"] = 192
        conf["spemb_file"] = spk2xv
        conf["trainer"]["init_params_allow_missing"] = True
    conf_path = os.path.join(
        workdir, f"{os.path.basename(exp)}_launch.yaml")
    with open(conf_path, "w", encoding="utf-8") as f:
        f.write(yaml_subset.dump(conf))

    from a3t_tpu_torch.bin.train import main as train_main

    train_main(["--config", conf_path, "--device", str(args.device)])


def stage5_eval(args, eval_dirs, workdir, exp):
    from a3t_tpu_torch.bin.mcd_gate import run_gate
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text, write_wav
    from a3t_tpu_torch.eval.mcd import MCDConfig
    from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
    from a3t_tpu_torch.tasks.mlm import MLMTask

    print("== stage 5: evaluation ==", flush=True)
    model, cfg, conv = MLMTask.build_model_from_dir(
        exp, which=args.eval_checkpoint, device=args.device)
    # hop 200 @ 16 kHz = 12.5 ms frame shift
    mcd_cfg = MCDConfig(shiftms=1000.0 * cfg.frontend.hop_length
                        / cfg.frontend.fs)

    vocoder = None
    if args.vocoder:
        from a3t_tpu_torch.train.vocoder import load_vocoder

        vocoder = load_vocoder(args.vocoder, device=args.device)
        print(f"   using trained vocoder {args.vocoder}", flush=True)

    spemb_fn = None
    if getattr(cfg.model, "spemb_dim", 0) > 0:
        from a3t_tpu_torch.dsp import LogMelFrontend
        from a3t_tpu_torch.models.xvector import make_spemb_extractor

        spemb_fn = make_spemb_extractor(
            os.path.join(workdir, "exp_xvector"),
            LogMelFrontend(cfg.frontend, device=args.device))
        print("   speaker-conditioned model: context-only x-vector "
              "extraction", flush=True)

    report = {"checkpoint": args.eval_checkpoint,
              "vocoder": args.vocoder or "griffin-lim"}
    for split, split_dir in eval_dirs.items():
        texts = read_2column_text(os.path.join(split_dir, "text"))
        lexicon = {p.upper(): [p] for t in texts.values()
                   for p in t.split()}
        editor = SpeechEditor(model, cfg.frontend, conv, lexicon=lexicon,
                              vocoder=vocoder, spemb_fn=spemb_fn,
                              device=args.device)
        ds = A3TDataset(split_dir, conv)
        aligner = FileAlignmentSource(split_dir)
        out_dir = os.path.join(workdir, "mcd_out", split)
        uids = ds.uids[: args.eval_utts] if args.eval_utts else ds.uids
        result = run_gate(editor, texts, ds, aligner, uids, out_dir,
                          mcd_config=mcd_cfg)
        report[split] = result
        print(f"   MCD [{split}] over {result['n']} utts: "
              f"{result['mean_mcd']:.2f} dB "
              f"(vocoder ceiling {result['vocoder_ceiling_mcd']:.2f} dB)",
              flush=True)
    out_json = os.path.join(workdir, args.mcd_out or "soak_mcd.json")
    with open(out_json, "w") as f:
        json.dump(report, f, indent=1)

    # edit demo on the first seen-split utterance
    split_dir = next(iter(eval_dirs.values()))
    texts = read_2column_text(os.path.join(split_dir, "text"))
    ds = A3TDataset(split_dir, conv)
    aligner = FileAlignmentSource(split_dir)
    editor = SpeechEditor(
        model, cfg.frontend, conv,
        lexicon={p.upper(): [p] for t in texts.values() for p in t.split()},
        device=args.device)
    uid = ds.uids[0]
    wav, words = ds[uid]["audio"], texts[uid].split()
    masked = " ".join(words[:2] + ["[MASK]"] + words[5:])
    res = editor.reconstruct_masked_span(wav, aligner(uid), texts[uid],
                                         masked)
    write_wav(os.path.join(workdir, f"{uid}_edited.wav"), FS,
              res.origin_replaced)
    print(f"   edit demo: {uid}_edited.wav "
          f"(span frames {res.old_span_boundary})", flush=True)


def stage6_fs2(args, train_dir, eval_seen_dir, workdir):
    """Speaker model + FastSpeech2 duration predictor on the soak corpus.

    (a) Train the x-vector TDNN speaker classifier (the reference's
        pretrained Kaldi 0008_sitw_v2_1a role, tts.sh:332-370), score it on
        held-out utterances of the training speakers, and build the
        per-speaker spk2xvector dict (generate_spk2xv.py analogue).
    (b) Train FastSpeech2 *conditioned on those embeddings* (the
        reference's duration path integrates x-vectors,
        sedit_inference.py:405-420).
    """
    from a3t_tpu_torch.models.fastspeech2 import (
        FastSpeech2Config, transformer_stack_config)
    from a3t_tpu_torch.tasks.fs2 import (FS2BatcherConfig, FS2Task,
                                         FS2TaskConfig)
    from a3t_tpu_torch.train import OptimConfig, TrainerConfig

    print("== stage 6a: x-vector speaker model ==", flush=True)
    spk2xv_path = ensure_xvector(args, train_dir, eval_seen_dir, workdir)

    print("== stage 6b: FastSpeech2 duration-model training ==", flush=True)
    stack = transformer_stack_config(adim=256, aheads=2, layers=4,
                                     units=1024, dropout=0.2)
    cfg = FS2TaskConfig(
        train_data_dir=train_dir,
        exp_dir=os.path.join(workdir, "exp_fs2"),
        spk_xvector=spk2xv_path,
        frontend=frontend_config(),
        model=FastSpeech2Config(adim=256, encoder=stack, decoder=stack,
                                postnet_layers=2, max_feat_len=448,
                                spk_embed_dim=192),
        batcher=FS2BatcherConfig(batch_size=32, max_feat_len=448),
        optim=OptimConfig(model_size=256, warmup_steps=1000),
        trainer=TrainerConfig(
            max_epoch=args.fs2_epochs, num_iters_per_epoch=50,
            keep_nbest_models=2, log_interval=50,
            best_model_criterion=("train", "loss", "min"), resume=True),
    )
    FS2Task.run(cfg, args.device)


def prompt_xvector(xv_dir, frontend, wav):
    """The x-vector of ``wav`` itself (whole frames of the hop, no mask),
    for a speaker the spk2xvector table lacks."""
    import torch

    from a3t_tpu_torch.models.xvector import load_xvector

    xv_model, mel_mvn = load_xvector(xv_dir, device=frontend.device)
    hop = frontend.config.hop_length
    n = (len(wav) // hop) * hop
    with torch.inference_mode():
        feats, _ = frontend(wav[None, :n])
        mean, std = (torch.as_tensor(a, device=feats.device)
                     for a in mel_mvn)
        emb, _ = xv_model((feats - mean) / std)
    return emb[0].cpu().numpy()


def stage7_edit_demo(args, eval_dir, workdir, exp):
    """Text-replacement editing + prompt TTS with FS2-*predicted* durations
    (the published editing-quality path) on the trained soak models."""
    from a3t_tpu_torch.data.dataset import A3TDataset
    from a3t_tpu_torch.data.fileio import read_2column_text, write_wav
    from a3t_tpu_torch.inference import FileAlignmentSource, SpeechEditor
    from a3t_tpu_torch.inference.durations import load_duration_fn
    from a3t_tpu_torch.tasks.mlm import MLMTask

    print("== stage 7: trained-duration edit + prompt demos ==", flush=True)
    model, cfg, conv = MLMTask.build_model_from_dir(exp, device=args.device)
    texts = read_2column_text(os.path.join(eval_dir, "text"))
    lexicon = {p.upper(): [p] for t in texts.values() for p in t.split()}
    ds = A3TDataset(eval_dir, conv)
    aligner = FileAlignmentSource(eval_dir)
    out_dir = os.path.join(workdir, "demo")
    os.makedirs(out_dir, exist_ok=True)

    uid = ds.uids[0]
    # condition duration prediction on the edited speaker's trained
    # x-vector (reference: spk2xvector dicts fed to duration_predict,
    # sedit_inference.py:405-420, 713-715)
    from a3t_tpu_torch.models.xvector import load_spk2xvector

    xv_dir = os.path.join(workdir, "exp_xvector")
    spk2xv_path = os.path.join(xv_dir, "spk2xvector.npz")
    spemb = None
    if os.path.exists(spk2xv_path):
        spk2xv = load_spk2xvector(spk2xv_path)
        spk = ds[uid].get("speaker")
        spemb = spk2xv.get(spk)
        if spemb is None:
            # unseen speaker: extract the x-vector from the prompt audio
            # itself (what the pretrained-extractor path would do), with
            # the front-end on the device
            from a3t_tpu_torch.dsp import LogMelFrontend

            spemb = prompt_xvector(
                xv_dir, LogMelFrontend(cfg.frontend, device=args.device),
                ds[uid]["audio"])
    duration_fn = load_duration_fn(os.path.join(workdir, "exp_fs2"),
                                   spembs=spemb, device=args.device)
    editor = SpeechEditor(model, cfg.frontend, conv, lexicon=lexicon,
                          duration_fn=duration_fn, device=args.device)
    wav, words = ds[uid]["audio"], texts[uid].split()
    # replace two middle phones with three different ones
    mid = len(words) // 2
    repl = ["AA", "S", "OW"]
    new_text = " ".join(words[: mid] + repl + words[mid + 2:])
    res = editor.edit(wav, aligner(uid), texts[uid], new_text)
    write_wav(os.path.join(out_dir, f"{uid}_replaced.wav"), FS,
              res.origin_replaced)
    rep = {"uid": uid, "old": texts[uid], "new": new_text,
           "spemb_used": spemb is not None,
           "old_span_frames": [int(x) for x in res.old_span_boundary],
           "new_span_frames": [int(x) for x in res.new_span_boundary]}
    print(f"   edit: {rep}", flush=True)

    prompt_words = words[: max(3, len(words) // 3)]
    full = " ".join(prompt_words + ["IY", "M", "AO", "S", "EH"])
    out = editor.prompt_tts(wav, aligner(uid), " ".join(prompt_words), full)
    write_wav(os.path.join(out_dir, f"{uid}_prompt.wav"), FS, out["full"])
    rep["prompt_out_sec"] = round(len(out["full"]) / FS, 2)
    print(f"   prompt-TTS: {rep['prompt_out_sec']} s", flush=True)
    with open(os.path.join(out_dir, "demo.json"), "w") as f:
        json.dump(rep, f, indent=1)


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workdir", default=DEFAULT_WORKDIR)
    ap.add_argument("--exp-name", default="exp",
                    help="experiment dir name under the workdir (separate "
                         "names keep e.g. conditioned and unconditioned "
                         "runs side by side)")
    ap.add_argument("--stage", type=int, default=1)
    ap.add_argument("--stop-stage", type=int, default=5)
    ap.add_argument("--fs2-epochs", type=int, default=40)
    ap.add_argument("--xvector-steps", type=int, default=2000)
    ap.add_argument("--n-utts", type=int, default=4000)
    ap.add_argument("--n-speakers", type=int, default=8)
    ap.add_argument("--align-utts", type=int, default=600)
    ap.add_argument("--align-mixtures", type=int, default=2)
    ap.add_argument("--epochs", type=int, default=200)
    ap.add_argument("--iters-per-epoch", type=int, default=100)
    ap.add_argument("--warmup-steps", type=int, default=2000)
    ap.add_argument("--init-params", default="",
                    help="params-only stash (bin.export_params, or the JAX "
                         "package's orbax stash) to warm-start from when no "
                         "resume ckpt exists")
    ap.add_argument("--batch-bins", type=int, default=3000000)
    ap.add_argument("--mlm-prob-factor", type=float, default=0.8,
                    help="training-time multiplier on mlm_prob (1.0 = the "
                         "reference's full 0.8 masking; scarcer context "
                         "strengthens the speaker-conditioning gradient)")
    ap.add_argument("--steps-per-dispatch", type=int, default=1)
    ap.add_argument("--spemb", action="store_true",
                    help="condition the MLM on per-speaker x-vectors "
                         "(trains the x-vector model first if absent); "
                         "eval extracts leak-free context-only x-vectors")
    ap.add_argument("--no-device-audio", action="store_true",
                    help="ship per-step PCM from host instead of the "
                         "device-resident corpus gather")
    ap.add_argument("--vocoder", default="",
                    help="trained vocoder dir (a3t_tpu_torch.bin."
                         "train_vocoder, or the JAX package's) for stage 5; "
                         "empty = Griffin-Lim fallback")
    ap.add_argument("--eval-checkpoint", default="ave",
                    help="which checkpoint stage 5 evaluates "
                         "('ave' | 'latest' | epoch number)")
    ap.add_argument("--mcd-out", default="",
                    help="stage-5 report filename (default soak_mcd.json; "
                         "override for steps-vs-MCD curve points)")
    ap.add_argument("--eval-utts", type=int, default=24,
                    help="cap stage-5 MCD utterances (0 = all; the MCD "
                         "extraction is CPU-bound)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train and serve on (default cuda)")
    return ap


def main(argv=None) -> dict:
    """Run the stages from --stage to --stop-stage; returns each run
    stage's host seconds by stage number."""
    args = parser().parse_args(argv)

    from a3t_tpu_torch.device import resolve_device

    args.device = resolve_device(args.device)
    os.makedirs(args.workdir, exist_ok=True)
    train_dir = os.path.join(args.workdir, "data", "train")
    eval_seen = os.path.join(args.workdir, "data", "eval_seen")
    eval_unseen = os.path.join(args.workdir, "data", "eval_unseen")
    records_dir = os.path.join(args.workdir, "records")
    exp = os.path.join(args.workdir, args.exp_name)

    stages = {
        1: lambda: stage1_data(args, train_dir, eval_seen, eval_unseen),
        2: lambda: stage2_align(args, train_dir, args.workdir),
        3: lambda: stage3_pack(args, train_dir, records_dir),
        4: lambda: stage4_train(args, records_dir, eval_seen, args.workdir,
                                exp, train_dir=train_dir),
        5: lambda: stage5_eval(args, {"seen": eval_seen,
                                      "unseen": eval_unseen},
                               args.workdir, exp),
        6: lambda: stage6_fs2(args, train_dir, eval_seen, args.workdir),
        7: lambda: stage7_edit_demo(args, eval_seen, args.workdir, exp),
    }
    seconds = {}
    for n, stage in stages.items():
        if args.stage <= n <= args.stop_stage:
            t0 = time.perf_counter()
            stage()
            seconds[n] = time.perf_counter() - t0
            print(f"   stage {n} done in {seconds[n]:.2f} s (host clock)",
                  flush=True)
    return seconds


if __name__ == "__main__":
    main()
