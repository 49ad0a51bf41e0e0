"""The JAX package's soak recipe (recipes/soak/) for
tests/test_torch_soak_recipe.py, and the inputs both packages read, run in
processes of their own so that they overlap the port's run in the test's
process.

    python tests/torch_soak_jax.py BASE JOB [JOB ...]

Jobs (each writes under BASE, in the layout the test reads):
  prepare_ev     the inputs of stage 5 and curve_eval (``prepare_ev``)
  prepare7       the inputs of stage 7 (``prepare7``)
  stages123      stages 1-3 on the test's small corpus in BASE/s123/jax
  stage5         stage 5 in BASE/ev/jax_stage5
  curve:SOURCE   curve_eval --spemb-source SOURCE in BASE/ev/jax_SOURCE
  stage7:CASE    stage 7 in BASE/s7_CASE/jax

A prepare job ends by writing BASE/<job>.done; the jobs that read its
inputs, here or in the test's process, wait for that file.  The x-vectors
that reach each gate are recorded (``record_spembs``) into the job's
directory as ``spembs.npz``.  JAX's persistent compilation cache lives in
BASE/jax_cache, so that jobs that compile the same programs compile them
once.  Each job prints its seconds.
"""

import os
import shutil
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STASH = os.path.join(ROOT, "artifacts", "spemb_params")
XV_DIR = os.path.join(ROOT, "artifacts", "xvector")
VOCODER = os.path.join(ROOT, "artifacts", "vocoder")
SOURCES = ("context", "speaker", "zero", "shuffle")

# stages 1-3 at the size of tests/test_soak_recipe.py:71-100
SMALL = dict(n_utts=30, n_speakers=2, align_utts=24, align_mixtures=1)
STAGE5_UTTS = 1
# utterances a split: two (of two speakers in the seen split) for the
# rotation of shuffle, one for the rest
CURVE_UTTS = {"context": 1, "speaker": 1, "zero": 1, "shuffle": 2}


def record_spembs(xvector_module, gate_module, record: dict):
    """Wrap ``make_spemb_extractor`` and ``run_gate`` of a package so that
    every context x-vector (in call order) and every explicit one (by
    split and uid) lands in ``record``."""
    real_make = xvector_module.make_spemb_extractor
    real_gate = gate_module.run_gate

    def make(*args, **kwargs):
        fn = real_make(*args, **kwargs)

        def recorded(audio, frame_mask):
            out = fn(audio, frame_mask)
            record[f"context_{len(record)}"] = np.asarray(out, np.float32)
            return out
        return recorded

    def gate(editor, texts, dataset, alignments, uids, out, **kwargs):
        for uid, vec in (kwargs.get("spembs") or {}).items():
            record[f"explicit_{os.path.basename(out)}_{uid}"] = np.asarray(
                vec, np.float32)
        return real_gate(editor, texts, dataset, alignments, uids, out,
                         **kwargs)

    xvector_module.make_spemb_extractor = make
    gate_module.run_gate = gate


def link(target, name):
    os.makedirs(os.path.dirname(name), exist_ok=True)
    os.symlink(target, name)


def spemb_experiment(shared):
    """exp_spemb: the stash's config in fp32 and its tokens, and
    checkpoints/epoch_16 (orbax) holding its bfloat16 parameters (both
    models widen them exactly) with the BatchNorm statistics a fresh model
    starts from; the eval splits of stage 1's seeds at 4 utterances of 7-9
    phones."""
    import jax
    import orbax.checkpoint as ocp

    from a3t_tpu.tasks.config import load_config
    from a3t_tpu.tasks.mlm import MLMTask
    from a3t_tpu.train.checkpoint import restore_portable
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
    from test_torch_trained import _dummy

    for split, seed, spk in (("eval_seen", 1, 0), ("eval_unseen", 2, 99)):
        generate_speechlike_corpus(
            os.path.join(shared, "data", split), n_utts=4, n_speakers=2,
            fs=16000, seed=seed, speaker_seed=spk, n_phones_range=(7, 9))
    exp = os.path.join(shared, "exp_spemb")
    os.makedirs(os.path.join(exp, "checkpoints"))
    shutil.copy(os.path.join(STASH, "tokens.txt"), exp)
    with open(os.path.join(STASH, "config.yaml")) as f:
        text = f.read()
    assert text.count("compute_dtype: bfloat16") == 2
    with open(os.path.join(exp, "config.yaml"), "w") as f:
        f.write(text.replace("compute_dtype: bfloat16",
                             "compute_dtype: float32"))
    cfg = load_config(os.path.join(exp, "config.yaml"))
    with open(os.path.join(exp, "tokens.txt")) as f:
        n_tokens = len(f.read().split())
    model = MLMTask.build_model(cfg, n_tokens)
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0),
                            **_dummy())["batch_stats"]
    stats = jax.tree_util.tree_map_with_path(
        lambda p, s: (np.ones if p[-1].key == "var" else np.zeros)(
            s.shape, np.float32), shapes)
    params = restore_portable(STASH)["params"]
    saver = ocp.StandardCheckpointer()
    saver.save(os.path.join(exp, "checkpoints", "epoch_16"),
               {"params": params, "batch_stats": stats})
    saver.wait_until_finished()


def prepare_ev(base):
    """One work directory per package and job, each linking the shared
    data, experiment and x-vector model, its curve snapshot already
    holding epoch_16 (so no job copies the checkpoint)."""
    shared = os.path.join(base, "ev", "shared")
    spemb_experiment(shared)
    for pkg in ("jax", "port"):
        for job in ("stage5",) + SOURCES:
            w = os.path.join(base, "ev", f"{pkg}_{job}")
            link(os.path.join(shared, "data"), os.path.join(w, "data"))
            link(os.path.join(shared, "exp_spemb"),
                 os.path.join(w, "exp_spemb"))
            link(XV_DIR, os.path.join(w, "exp_xvector"))
            link(os.path.join(shared, "exp_spemb", "checkpoints",
                              "epoch_16"),
                 os.path.join(w, "curve_ckpts_exp_spemb", "checkpoints",
                              "epoch_16"))


def prepare7(base):
    """Tiny JAX MLM and FS2 experiments (16 kHz, 80 mels, the stash's
    tokens; FS2 conditioned on 192-dim x-vectors), an eval dir of 6
    utterances (whose texts hold every phone the demo's edits write, the
    stage's lexicon), and per case an exp_xvector whose spk2xvector table holds
    the first utterance's speaker ("seen") or not ("unseen")."""
    import jax
    import jax.numpy as jnp
    import orbax.checkpoint as ocp

    from a3t_tpu.tasks import config as jax_task_config
    from a3t_tpu.tasks import fs2 as jax_fs2_task
    from a3t_tpu.tasks.config import load_config as jax_load_config
    from a3t_tpu.tasks.mlm import MLMTask as JaxMLMTask
    from a3t_tpu_torch.data.fileio import read_2column_text
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus
    from a3t_tpu_torch.tasks.config import load_config, save_config
    from a3t_tpu_torch.tasks.fs2 import load_fs2_config
    from test_torch_trained import TINY, _dummy, _with_stats

    shared = os.path.join(base, "s7_shared")
    eval_dir = generate_speechlike_corpus(
        os.path.join(shared, "eval"), n_utts=6, n_speakers=2, fs=16000,
        seed=5, speaker_seed=0, n_phones_range=(12, 16))
    with open(os.path.join(STASH, "tokens.txt")) as f:
        tokens = f.read().split()
    fe = [f"frontend.{k}={v}" for k, v in (
        ("fs", 16000), ("n_fft", 1024), ("hop_length", 200),
        ("win_length", 800), ("n_mels", 80), ("fmin", 80.0),
        ("fmax", 7600.0))]

    def experiment(name, cfg, jax_cfg_of, build, inputs,
                   tweak=lambda v: v):
        exp = os.path.join(shared, name)
        os.makedirs(exp)
        shutil.copy(os.path.join(STASH, "tokens.txt"), exp)
        save_config(cfg, os.path.join(exp, "config.yaml"))
        jm = build(jax_cfg_of(os.path.join(exp, "config.yaml")),
                   len(tokens))
        v = tweak(_with_stats(jax.jit(jm.init)(jax.random.PRNGKey(0),
                                               **inputs), 0))
        # checkpoints/epoch_1 (orbax) and LATEST: "ave" takes the latest
        ckpt = os.path.join(exp, "checkpoints")
        saver = ocp.StandardCheckpointer()
        saver.save(os.path.join(ckpt, "epoch_1"), {
            "step": np.int32(1), "params": v["params"],
            "batch_stats": v["batch_stats"]})
        saver.wait_until_finished()
        with open(os.path.join(ckpt, "LATEST"), "w") as f:
            f.write("1")

    def durations_of_4_frames(v):
        # the duration predictor's log(d + 1) output near log(5), so that
        # the edit's new phones take frames
        v["params"]["duration_predictor"]["Dense_0"]["bias"] = np.full(
            (1,), np.log(5.0), np.float32)
        return v

    experiment("exp", load_config(
        os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml"),
        TINY + fe + ["model.postnet_layers=1", "model.postnet_chans=8"]),
        jax_load_config, JaxMLMTask.build_model, _dummy(odim=80))
    sets = TINY + fe + [
        "model.adim=16", "model.postnet_layers=1", "model.postnet_chans=8",
        "model.gst_heads=2", "model.gst_conv_chans_list=[4,4,8]",
        "model.gst_gru_units=8", "model.spk_embed_dim=192",
        "model.max_feat_len=512"]
    sets += [f"model.{n}_predictor_chans=8"
             for n in ("duration", "pitch", "energy")]
    rng = np.random.default_rng(0)
    experiment("exp_fs2", load_fs2_config(
        os.path.join(ROOT, "configs", "fs2_conformer_24k.yaml"), sets),
        lambda p: jax_task_config._build(
            jax_fs2_task.FS2TaskConfig, jax_task_config.load_yaml_dict(p)),
        jax_fs2_task.FS2Task.build_model, dict(
            text=jnp.asarray(rng.integers(1, len(tokens), (1, 6)),
                             jnp.int32),
            text_mask=jnp.ones((1, 6), bool),
            speech=jnp.asarray(rng.standard_normal((1, 32, 80)),
                               jnp.float32),
            spembs=jnp.asarray(rng.standard_normal((1, 192)), jnp.float32),
            durations=jnp.full((1, 6), 2, jnp.int32),
            pitch=jnp.zeros((1, 6, 1)), energy=jnp.zeros((1, 6, 1))),
        durations_of_4_frames)

    first = sorted(read_2column_text(os.path.join(eval_dir, "utt2spk")))[0]
    speaker = read_2column_text(os.path.join(eval_dir, "utt2spk"))[first]
    with np.load(os.path.join(XV_DIR, "spk2xvector.npz")) as f:
        table = {k: f[k] for k in f.files}
    assert speaker in table
    for case in ("seen", "unseen"):
        xv = os.path.join(shared, f"xvector_{case}")
        os.makedirs(xv)
        for name in ("xvector.npz", "xvector.json"):
            os.symlink(os.path.join(XV_DIR, name), os.path.join(xv, name))
        np.savez(os.path.join(xv, "spk2xvector.npz"), **{
            k: v for k, v in table.items()
            if case == "seen" or k != speaker})
        for pkg in ("jax", "port"):
            w = os.path.join(base, f"s7_{case}", pkg)
            for name, target in (("exp", "exp"), ("exp_fs2", "exp_fs2"),
                                 ("eval", "eval"),
                                 ("exp_xvector", f"xvector_{case}")):
                link(os.path.join(shared, target), os.path.join(w, name))


def wait_for(base: str, job: str, procs=(), timeout: float = 600.0):
    """Wait until prepare job ``job`` has written its marker; raise if it
    takes over ``timeout`` s or one of ``procs`` (Popen) failed first."""
    marker = os.path.join(base, f"{job}.done")
    t0 = time.perf_counter()
    while not os.path.exists(marker):
        for p in procs:
            if p.poll():
                raise RuntimeError(f"a JAX job process failed ({p.args})")
        if time.perf_counter() - t0 > timeout:
            raise TimeoutError(f"no {marker} after {timeout} s")
        time.sleep(0.2)


NEEDS = {"stage5": "prepare_ev", "curve": "prepare_ev",
         "stage7": "prepare7"}


def private_aligner(base: str):
    """JAX's aligner built by its own ``make`` in a private copy of
    native/aligner, so that no other process's build races it."""
    from a3t_tpu.align import native as jax_align

    dst = os.path.join(base, "jax_aligner")
    os.makedirs(dst, exist_ok=True)
    for name in ("aligner.cc", "Makefile"):
        shutil.copy(os.path.join(ROOT, "native", "aligner", name), dst)
    jax_align._NATIVE_DIR = dst
    jax_align._LIB_PATH = os.path.join(dst, "liba3t_aligner.so")
    jax_align._lib = None


def main(base: str, jobs: list) -> None:
    sys.path.insert(0, ROOT)
    import jax

    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(base, "jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

    import a3t_tpu.bin.mcd_gate as gate_module
    import a3t_tpu.models.xvector as xvector_module
    import recipes.soak.curve_eval as curve_eval
    import recipes.soak.run as soak

    import a3t_tpu.train.vocoder as vocoder_module

    # one vocoder a process: its jitted generator (params closed over) is
    # traced and compiled once a shape, not once a job; the same for the
    # editors' forward below.  Both only spare JAX's tracing: what each
    # computes is unchanged
    real_load, vocoders = vocoder_module.load_vocoder, {}

    def load_vocoder(path):
        if path not in vocoders:
            vocoders[path] = real_load(path)
        return vocoders[path]

    vocoder_module.load_vocoder = load_vocoder
    # one jitted forward a model definition (flax modules compare by their
    # config): each job's editors reuse its traces, not re-trace the model
    import a3t_tpu.inference.sedit as sedit_module

    real_init, forwards = sedit_module.SpeechEditor.__init__, {}

    def init(self, *args, **kwargs):
        real_init(self, *args, **kwargs)
        self._jit_forward = forwards.setdefault(self.model,
                                                self._jit_forward)

    sedit_module.SpeechEditor.__init__ = init
    record: dict = {}
    record_spembs(xvector_module, gate_module, record)
    for job in jobs:
        t0 = time.perf_counter()
        record.clear()
        kind, _, what = job.partition(":")
        if kind in ("prepare_ev", "prepare7"):
            (prepare_ev if kind == "prepare_ev" else prepare7)(base)
            with open(os.path.join(base, f"{kind}.done"), "w"):
                pass
            print(f"job {job}: {time.perf_counter() - t0:.1f} s", flush=True)
            continue
        if kind in NEEDS:
            wait_for(base, NEEDS[kind])
        if kind == "stages123":
            private_aligner(base)
            w = os.path.join(base, "s123", "jax")
            args = types.SimpleNamespace(**SMALL)
            train = os.path.join(w, "data", "train")
            soak.stage1_data(args, train, os.path.join(w, "data", "eval_seen"),
                             os.path.join(w, "data", "eval_unseen"))
            soak.stage2_align(args, train, w)
            soak.stage3_pack(args, train, os.path.join(w, "records"))
            print(f"job {job}: {time.perf_counter() - t0:.1f} s", flush=True)
            continue
        if kind == "stage5":
            w = os.path.join(base, "ev", "jax_stage5")
            args = types.SimpleNamespace(eval_checkpoint="16",
                                         vocoder=VOCODER, mcd_out="",
                                         eval_utts=STAGE5_UTTS)
            soak.stage5_eval(args, {
                "seen": os.path.join(w, "data", "eval_seen"),
                "unseen": os.path.join(w, "data", "eval_unseen")},
                w, os.path.join(w, "exp_spemb"))
        elif kind == "curve":
            w = os.path.join(base, "ev", f"jax_{what}")
            sys.argv = ["curve_eval", "--workdir", w, "--exp-name",
                        "exp_spemb", "--epoch", "16", "--vocoder", VOCODER,
                        "--eval-utts", str(CURVE_UTTS[what]), "--spemb-source",
                        what, "--device", ""]  # JAX_PLATFORMS is cpu
            curve_eval.main()
        elif kind == "stage7":
            w = os.path.join(base, f"s7_{what}", "jax")
            soak.stage7_edit_demo(None, os.path.join(w, "eval"), w,
                                  os.path.join(w, "exp"))
        else:
            raise ValueError(f"unknown job {job!r}")
        np.savez(os.path.join(w, "spembs.npz"), **record)
        print(f"job {job}: {time.perf_counter() - t0:.1f} s", flush=True)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2:])
