"""The port's soak recipe (a3t_tpu_torch/recipes/soak/) against the JAX
package's (recipes/soak/, imported as tests/test_soak_recipe.py imports
it), on the CPU.  The JAX side, and the preparation of the inputs both
sides read, run in three processes of their own (tests/torch_soak_jax.py)
beside the port's run in this one.

* Stages 1-3 on a 30-utterance, 2-speaker corpus: every file equal byte for
  byte (the wavs, text, utt2spk, mfa_* and mfa_*.oracle, aligner.bin and
  its phone list, aligner_eval.json, the record shards and meta.json;
  wav.scp with each package's own directory in its paths; index.npz's
  arrays bit for bit, since a zip member's time is when it was written).
* Stage 4's launch config, with and without --spemb: the port's file
  through the port's loader gives the task config that JAX's yaml gives
  through a3t_tpu/tasks/config.py, and the port's task takes it.
* Stage 5 and curve_eval for each --spemb-source on the trained
  conditioned stash artifacts/spemb_params (its parameters in an
  experiment's epoch_16 with fresh BatchNorm statistics, run in fp32 on
  both sides) with artifacts/xvector and the trained vocoder
  artifacts/vocoder (the port's vocoder given JAX's own noise): the
  x-vectors that reach the gate within XV_TOL (1e-5) of JAX's, each
  utterance's MCD and vocoder ceiling within MCD_TOL (0.01 dB); stage 5's
  demo wav (Griffin-Lim from JAX's initial phase) clipped at the same
  samples and within WAV_TOL (1e-3) of its largest sample elsewhere.
* Stage 7 on tiny JAX MLM and FS2 experiment directories written here, a
  speaker in the spk2xvector table and one not in it (the x-vector then
  comes from the prompt audio): demo.json equal (the span frames), the
  edited and prompt waveforms within WAV_TOL of their largest sample.
* The two report assemblers: the same JSON, byte for byte, on a fixture
  work directory.
"""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3t_tpu_torch.data.fileio import read_2column_text, read_wav
from a3t_tpu_torch.recipes.soak import assemble_mcd_r05 as port_r05
from a3t_tpu_torch.recipes.soak import assemble_mcd_report as port_report
from a3t_tpu_torch.recipes.soak import curve_eval as port_curve
from a3t_tpu_torch.recipes.soak import run as port_run
from torch_soak_jax import (CURVE_UTTS, SMALL, SOURCES, STAGE5_UTTS,
                            VOCODER, XV_DIR, record_spembs, wait_for)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import recipes.soak.assemble_mcd_r05 as jax_r05  # noqa: E402
import recipes.soak.assemble_mcd_report as jax_report  # noqa: E402
import recipes.soak.run as jax_run  # noqa: E402

HELPER = os.path.join(ROOT, "tests", "torch_soak_jax.py")
XV_TOL = 1e-5
MCD_TOL = 0.01  # dB
WAV_TOL = 1e-3  # of the largest sample
CLIPPED = 0.999  # a PCM16 sample at full scale
# three processes of about a minute each on an idle 8-core host
JAX_JOBS = (["prepare_ev", "stage5", "curve:context"],
            ["stages123", "prepare7", "curve:speaker", "stage7:seen",
             "stage7:unseen"],
            ["curve:zero", "curve:shuffle"])


def _jax_noise(n_frames, hop):
    """JAX's vocoder noise (a3t_tpu/train/vocoder.py:410-414) for a mel of
    ``n_frames`` frames."""
    n_pad = -(-n_frames // 64) * 64
    return np.array(jax.random.normal(
        jax.random.PRNGKey(0), (1, n_pad * hop, 1)))[..., 0]


def _jax_phase(shape, seed=0, device=None):
    """JAX's Griffin-Lim initial phase (a3t_tpu/dsp/griffin_lim.py:46-48)."""
    return torch.from_numpy(np.array(jax.random.uniform(
        jax.random.PRNGKey(seed), tuple(shape), jnp.float32, -np.pi,
        np.pi))).to(device)


def _run_port(base, mp, procs):
    """The port's side of every job, on the CPU, with JAX's vocoder noise
    and Griffin-Lim phase, each job once its inputs are ready."""
    import importlib

    import a3t_tpu_torch.bin.mcd_gate as gate_module
    import a3t_tpu_torch.models.xvector as xvector_module
    import a3t_tpu_torch.train.vocoder as vocoder_module

    # the module (the package exports its function of the same name)
    griffin_lim = importlib.import_module("a3t_tpu_torch.dsp.griffin_lim")
    real_load = vocoder_module.load_vocoder

    def load_vocoder(path, device=None):
        vocode = real_load(path, device=device)
        with open(os.path.join(path, "vocoder.json")) as f:
            hop = int(np.prod(json.load(f)["pwg"]["upsample_scales"]))
        return lambda mel: vocode(mel, z=_jax_noise(mel.shape[-2], hop))

    mp.setattr(vocoder_module, "load_vocoder", load_vocoder)
    mp.setattr(griffin_lim, "initial_phase", _jax_phase)
    # undone by ``mp`` when the fixture ends
    mp.setattr(xvector_module, "make_spemb_extractor",
               xvector_module.make_spemb_extractor)
    mp.setattr(gate_module, "run_gate", gate_module.run_gate)
    record: dict = {}
    record_spembs(xvector_module, gate_module, record)

    w = os.path.join(base, "s123", "port")
    args = types.SimpleNamespace(**SMALL)
    train = os.path.join(w, "data", "train")
    port_run.stage1_data(args, train, os.path.join(w, "data", "eval_seen"),
                         os.path.join(w, "data", "eval_unseen"))
    port_run.stage2_align(args, train, w)
    port_run.stage3_pack(args, train, os.path.join(w, "records"))

    wait_for(base, "prepare_ev", procs)
    for job in ("stage5",) + SOURCES:
        record.clear()
        w = os.path.join(base, "ev", f"port_{job}")
        if job == "stage5":
            args = types.SimpleNamespace(eval_checkpoint="16",
                                         vocoder=VOCODER, mcd_out="",
                                         eval_utts=STAGE5_UTTS, device="cpu")
            port_run.stage5_eval(args, {
                "seen": os.path.join(w, "data", "eval_seen"),
                "unseen": os.path.join(w, "data", "eval_unseen")},
                w, os.path.join(w, "exp_spemb"))
        else:
            port_curve.main([
                "--workdir", w, "--exp-name", "exp_spemb", "--epoch", "16",
                "--vocoder", VOCODER, "--eval-utts", str(CURVE_UTTS[job]),
                "--spemb-source", job, "--device", "cpu"])
        np.savez(os.path.join(w, "spembs.npz"), **record)

    wait_for(base, "prepare7", procs)
    args = types.SimpleNamespace(device="cpu")
    for case in ("seen", "unseen"):
        w = os.path.join(base, f"s7_{case}", "port")
        port_run.stage7_edit_demo(args, os.path.join(w, "eval"), w,
                                  os.path.join(w, "exp"))


@pytest.fixture(scope="module")
def soak(tmp_path_factory):
    """Start the JAX jobs (the inputs first), run the port's side here,
    then wait for JAX's; returns the base directory."""
    base = str(tmp_path_factory.mktemp("soak"))
    logs = [open(os.path.join(base, f"jax_{i}.log"), "w")
            for i in range(len(JAX_JOBS))]
    procs = [subprocess.Popen([sys.executable, HELPER, base, *jobs],
                              stdout=log, stderr=subprocess.STDOUT, cwd=ROOT)
             for jobs, log in zip(JAX_JOBS, logs)]
    threads = torch.get_num_threads()
    try:
        torch.set_num_threads(4)
        with pytest.MonkeyPatch.context() as mp:
            _run_port(base, mp, procs)
        for p in procs:
            p.wait(timeout=900)
    finally:
        torch.set_num_threads(threads)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    for i, p in enumerate(procs):
        if p.returncode:
            with open(os.path.join(base, f"jax_{i}.log")) as f:
                tail = f.read()[-4000:]
            raise AssertionError(f"JAX jobs {JAX_JOBS[i]} failed:\n{tail}")
    return base


# -- stages 1-3 ---------------------------------------------------------------


def test_stages_1_to_3_equal_jax(soak):
    port = os.path.join(soak, "s123", "port")
    jax_dir = os.path.join(soak, "s123", "jax")
    names = []
    for dirpath, _, files in os.walk(jax_dir):
        names += [os.path.relpath(os.path.join(dirpath, f), jax_dir)
                  for f in files]
    got = []
    for dirpath, _, files in os.walk(port):
        got += [os.path.relpath(os.path.join(dirpath, f), port)
                for f in files]
    assert sorted(got) == sorted(names)
    for must in ("aligner.bin", "aligner.bin.phones", "aligner_eval.json",
                 "records/index.npz", "records/meta.json",
                 "data/train/mfa_start.oracle", "data/train/mfa_end.oracle",
                 "data/eval_unseen/wav/utt00047.wav"):
        assert must in names, must
    assert "records/shard_00000.bin" in names
    for name in names:
        a, b = os.path.join(port, name), os.path.join(jax_dir, name)
        if name.endswith("wav.scp"):
            pa = read_2column_text(a)
            pb = read_2column_text(b)
            assert {u: os.path.relpath(p, port) for u, p in pa.items()} \
                == {u: os.path.relpath(p, jax_dir) for u, p in pb.items()}
        elif name.endswith(".npz"):
            with np.load(a) as x, np.load(b) as y:
                assert x.files == y.files, name
                for k in x.files:
                    assert x[k].dtype == y[k].dtype, (name, k)
                    np.testing.assert_array_equal(x[k], y[k],
                                                  err_msg=f"{name}:{k}")
        else:
            assert filecmp.cmp(a, b, shallow=False), name
    stats = json.load(open(os.path.join(port, "aligner_eval.json")))
    assert stats["n_boundaries"] > 50 and stats["em_train_utts"] == 24


# -- stage 4's launch config --------------------------------------------------


@pytest.mark.parametrize("spemb", [False, True])
def test_stage4_launch_config_equals_jax(tmp_path, monkeypatch, spemb):
    """Both stage 4s write their launch file (their trainers replaced by a
    recorder, ensure_xvector by a fixed table); the files parse into the
    same task config, with the production keys, and the port's task takes
    it."""
    import a3t_tpu.bin.train as jax_train
    import a3t_tpu_torch.bin.train as port_train
    from a3t_tpu.tasks.config import load_config as jax_load_config
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.tasks.mlm import check_supported

    calls = {}
    monkeypatch.setattr(jax_train, "main",
                        lambda argv: calls.setdefault("jax", argv))
    monkeypatch.setattr(port_train, "main",
                        lambda argv: calls.setdefault("port", argv))
    table = str(tmp_path / "spk2xvector.npz")
    for mod in (jax_run, port_run):
        monkeypatch.setattr(mod, "ensure_xvector", lambda *a: table)
    stash = os.path.join(ROOT, "artifacts", "soak12k_params")
    argv = ["--spemb"] if spemb else []
    argv += ["--init-params", stash, "--steps-per-dispatch", "8",
             "--epochs", "3", "--iters-per-epoch", "40",
             "--warmup-steps", "1000", "--mlm-prob-factor", "1.0"]
    for pkg, mod in (("jax", jax_run), ("port", port_run)):
        w = str(tmp_path / pkg)
        os.makedirs(w)
        # the two recipes' flags are the same; JAX's ignores --device
        args = port_run.parser().parse_args(["--workdir", w, *argv,
                                             "--device", "cpu"])
        mod.stage4_train(args, os.path.join(w, "records"),
                         os.path.join(w, "eval"), w, os.path.join(w, "exp"),
                         train_dir=os.path.join(w, "train"))
    assert calls["port"][-2:] == ["--device", "cpu"]
    port_cfg = load_config(calls["port"][1])
    jax_cfg = jax_load_config(calls["jax"][1])

    def plain(x):
        if isinstance(x, dict):
            return {k: plain(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return [plain(v) for v in x]
        return x

    got = plain(dataclasses.asdict(port_cfg))
    want = plain(dataclasses.asdict(jax_cfg))
    want = json.loads(json.dumps(want).replace(
        str(tmp_path / "jax"), str(tmp_path / "port")))
    assert got == want
    assert port_cfg.batcher.device_audio is True
    assert tuple(port_cfg.batcher.bucket_frames) == (192, 256, 320, 448)
    assert port_cfg.batcher.batch_bins == 3000000
    assert port_cfg.trainer.steps_per_dispatch == 8
    assert port_cfg.trainer.init_params_dir == stash
    assert port_cfg.model.encoder.attention_dim == 384
    assert port_cfg.model.encoder.compute_dtype == "bfloat16"
    assert port_cfg.model.spemb_dim == (192 if spemb else 0)
    assert port_cfg.trainer.init_params_allow_missing is spemb
    assert port_cfg.spemb_file == (table if spemb else "")
    assert check_supported(port_cfg) == 1


# -- stage 5 and curve_eval on the trained conditioned stash ------------------


def _check_gate(port, want, label):
    assert port["n"] == want["n"] > 0, label
    assert sorted(port["per_utt"]) == sorted(want["per_utt"]), label
    for key in ("per_utt", "per_utt_vocoder"):
        for uid, v in want[key].items():
            assert np.isfinite(v), (label, key, uid)
            assert abs(port[key][uid] - v) <= MCD_TOL, (
                label, key, uid, port[key][uid], v)
    for key in ("mean_mcd", "vocoder_ceiling_mcd"):
        assert abs(port[key] - want[key]) <= MCD_TOL, (label, key)


def _check_spembs(soak, job, expect_context, expect_explicit):
    with np.load(os.path.join(soak, "ev", f"port_{job}", "spembs.npz")) \
            as a, np.load(os.path.join(soak, "ev", f"jax_{job}",
                                       "spembs.npz")) as b:
        assert a.files == b.files, job
        assert sum(k.startswith("context_") for k in a.files) \
            == expect_context, job
        assert sum(k.startswith("explicit_") for k in a.files) \
            == expect_explicit, job
        for k in a.files:
            assert a[k].shape == (192,), (job, k)
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=XV_TOL,
                                       err_msg=f"{job}:{k}")
            assert np.abs(b[k]).max() > 0.1 or job == "zero", (job, k)


def test_stage5_equals_jax(soak):
    w = {p: os.path.join(soak, "ev", f"{p}_stage5") for p in ("port", "jax")}
    got, want = (json.load(open(os.path.join(w[p], "soak_mcd.json")))
                 for p in ("port", "jax"))
    assert got["checkpoint"] == want["checkpoint"] == "16"
    for split in ("seen", "unseen"):
        _check_gate(got[split], want[split], split)
        assert got[split]["n"] == STAGE5_UTTS
    _check_spembs(soak, "stage5", 2 * STAGE5_UTTS, 0)
    demo = sorted(f for f in os.listdir(w["jax"]) if f.endswith("_edited.wav"))
    assert demo and demo == sorted(
        f for f in os.listdir(w["port"]) if f.endswith("_edited.wav"))
    # Griffin-Lim's span reaches far past full scale here, and write_wav
    # clips it: the clipped samples' places agree (a clipped sample's sign
    # may not), the others within WAV_TOL of their largest
    a = read_wav(os.path.join(w["port"], demo[0]))[1]
    b = read_wav(os.path.join(w["jax"], demo[0]))[1]
    assert a.shape == b.shape
    clipped = np.abs(b) >= CLIPPED
    np.testing.assert_array_equal(np.abs(a) >= CLIPPED, clipped)
    assert (~clipped).sum() > len(b) // 2
    assert np.abs(a - b)[~clipped].max() <= WAV_TOL * np.abs(b[~clipped]).max()


@pytest.mark.parametrize("source", SOURCES)
def test_curve_eval_equals_jax(soak, source):
    got = json.load(open(os.path.join(
        soak, "ev", f"port_{source}", "exp_spemb_curve_e16.json")))
    want = json.load(open(os.path.join(
        soak, "ev", f"jax_{source}", "exp_spemb_curve_e16.json")))
    assert {k: got[k] for k in ("checkpoint", "spemb_source")} == {
        "checkpoint": "epoch_16", "spemb_source": source} == {
        k: want[k] for k in ("checkpoint", "spemb_source")}
    for split in ("seen", "unseen"):
        _check_gate(got[split], want[split], f"{source} {split}")
        assert got[split]["n"] == CURVE_UTTS[source]
    # explicit x-vectors: the speaker averages (the unseen split's from
    # build_utt2xvector), rotated for shuffle, zeros for zero
    n = 2 * CURVE_UTTS[source]
    explicit = 0 if source == "context" else n
    _check_spembs(soak, source, n - explicit, explicit)
    if source == "shuffle":
        # the seen split's two utterances are of two speakers and trade
        # their training averages; the unseen split's are of one speaker
        # and keep their own (utt00000's as in the speaker run)
        shared = os.path.join(soak, "ev", "shared", "data")
        utt2spk = read_2column_text(os.path.join(shared, "eval_seen",
                                                 "utt2spk"))
        with np.load(os.path.join(soak, "ev", "port_shuffle",
                                  "spembs.npz")) as a, \
                np.load(os.path.join(soak, "ev", "port_speaker",
                                     "spembs.npz")) as b, \
                np.load(os.path.join(XV_DIR, "spk2xvector.npz")) as table:
            seen = sorted(k for k in a.files if "_eval_seen_" in k)
            u0, u1 = (k.rsplit("_", 1)[1] for k in seen)
            assert utt2spk[u0] != utt2spk[u1]
            np.testing.assert_array_equal(a[seen[0]], table[utt2spk[u1]])
            np.testing.assert_array_equal(a[seen[1]], table[utt2spk[u0]])
            key = "explicit_eval_unseen_utt00000"
            np.testing.assert_array_equal(a[key], b[key])


# -- stage 7 --------------------------------------------------------------------


@pytest.mark.parametrize("case", ["seen", "unseen"])
def test_stage7_equals_jax(soak, case):
    w = {p: os.path.join(soak, f"s7_{case}", p, "demo")
         for p in ("port", "jax")}
    got = json.load(open(os.path.join(w["port"], "demo.json")))
    want = json.load(open(os.path.join(w["jax"], "demo.json")))
    assert got == want
    assert want["spemb_used"] is True
    old, new = want["old_span_frames"], want["new_span_frames"]
    assert new[1] - new[0] > 4 and old[1] > old[0]
    assert want["prompt_out_sec"] > 1.0
    for kind in ("replaced", "prompt"):
        a = read_wav(os.path.join(w["port"], f"{got['uid']}_{kind}.wav"))[1]
        b = read_wav(os.path.join(w["jax"], f"{got['uid']}_{kind}.wav"))[1]
        assert a.shape == b.shape and np.abs(b).max() > 0.01, kind
        assert np.abs(a - b).max() <= WAV_TOL * np.abs(b).max(), kind


def test_prompt_xvector_equals_jax(soak):
    """The unseen-speaker x-vector of stage 7 (from the prompt audio, the
    whole frames of the hop, no mask) against JAX's run.py:432-441, within
    XV_TOL of its largest magnitude."""
    from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
    from a3t_tpu.models.xvector import load_xvector as jax_load_xvector
    from a3t_tpu_torch.dsp import LogMelFrontend

    eval_dir = os.path.join(soak, "s7_shared", "eval")
    scp = read_2column_text(os.path.join(eval_dir, "wav.scp"))
    wav = read_wav(scp[sorted(scp)[0]])[1]
    cfg = port_run.frontend_config()
    got = port_run.prompt_xvector(XV_DIR, LogMelFrontend(cfg, device="cpu"),
                                  wav)
    from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig

    fe = JaxLogMelFrontend(JaxLogMelConfig(**dataclasses.asdict(cfg)))
    xv_model, xv_vars, mvn = jax_load_xvector(XV_DIR)
    n = (len(wav) // cfg.hop_length) * cfg.hop_length
    feats, _ = jax.jit(fe)(wav[None, :n])
    want = np.asarray(xv_model.embed(xv_vars, (feats - mvn[0]) / mvn[1]))[0]
    assert got.shape == want.shape == (192,)
    # one float32 ulp of the largest element is ~2e-6 here: the TDNN's
    # convolutions and the pooling sum in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=XV_TOL * np.abs(want).max())


# -- the report assemblers ----------------------------------------------------


def _gate(rng, n):
    per = {f"utt{i:05d}": float(rng.uniform(5, 15)) for i in range(n)}
    voc = {u: float(rng.uniform(5, 7)) for u in per}
    return {"n": n, "mean_mcd": float(np.mean(list(per.values()))),
            "vocoder_ceiling_mcd": float(np.mean(list(voc.values()))),
            "per_utt": per, "per_utt_vocoder": voc}


def _report(rng, **extra):
    return {"checkpoint": f"epoch_{int(rng.integers(1, 200))}",
            "vocoder": "artifacts/vocoder", **extra,
            "seen": _gate(rng, 3), "unseen": _gate(rng, 2)}


@pytest.fixture(scope="module")
def report_dir(tmp_path_factory):
    """A soak work directory holding every file the two assemblers read."""
    w = str(tmp_path_factory.mktemp("reports"))
    rng = np.random.default_rng(3)
    names = ["curve_e8", "curve_e16", "curve_e112", "soak_mcd_gl",
             "soak_mcd_pwg", "sweep_epoch_2_pwg", "sweep_epoch_10_gl",
             "sweep_ave_pwg", "exp_spemb_curve_e8", "exp_spemb_curve_e16",
             "uncond_stash_eval", "exp_spemb_e16_spkavg",
             "exp_spemb_e16_zero", "exp_spemb_e16_shuffle",
             "ctrl_short_uncond", "ctrl_short_spemb_ctx",
             "ctrl_short_spemb_spk", "ctrl_long_eval", "ctrl_long_spemb",
             "sweep_spemb_e8", "sweep_spemb_e16_spkavg",
             "sweep_spemb_ave5_speaker"]
    for name in names:
        with open(os.path.join(w, f"{name}.json"), "w") as f:
            json.dump(_report(rng, spemb_source="speaker"), f)
    for sub, name, body in (
            ("vocoder", "history.json", [{"step": 1000 * i, "loss": 1.0 / i}
                                         for i in range(1, 4)]),
            ("exp_xvector", "xvector.json", {"n_speakers": 16, "eval_n": 48,
                                             "eval_acc": 0.9583,
                                             "config": {}}),
            ("demo", "demo.json", {"uid": "utt00000", "spemb_used": True}),
            ("", "aligner_eval.json", {"n_boundaries": 10,
                                       "median_ms": 12.5})):
        os.makedirs(os.path.join(w, sub), exist_ok=True)
        with open(os.path.join(w, sub, name), "w") as f:
            json.dump(body, f)
    return w


@pytest.mark.parametrize("which", ["report", "r05"])
def test_assemblers_equal_jax(report_dir, tmp_path, monkeypatch, which):
    port, jax_mod = {"report": (port_report, jax_report),
                     "r05": (port_r05, jax_r05)}[which]
    monkeypatch.setattr(sys, "argv", [
        "x", "--workdir", report_dir, "--out", str(tmp_path / "jax.json")])
    jax_mod.main()
    port.main(["--workdir", report_dir, "--out", str(tmp_path / "port.json"),
               "--device", "cpu"])
    with open(tmp_path / "jax.json", "rb") as f, \
            open(tmp_path / "port.json", "rb") as g:
        want, got = f.read(), g.read()
    assert got == want
    report = json.loads(got)
    if which == "report":
        assert len(report["steps_vs_mcd_curve"]) == 3
        # numeric epoch order: epoch_2 before epoch_10
        sweep = list(report["checkpoint_sweep"])
        assert sweep.index("epoch_2_pwg") < sweep.index("epoch_10_gl")
    else:
        assert report["headline"]["seen_mcd"] > 0
        assert len(report["conditioned_curve_r5"]) == 2


# -- the entry points need a card unless asked for the CPU ----------------------


@pytest.mark.parametrize("main,argv", [
    (port_run.main, []),
    (port_curve.main, ["--epoch", "1"]),
    (port_report.main, ["--out", "out.json"]),
    (port_r05.main, ["--out", "out.json"]),
], ids=["run", "curve_eval", "assemble_mcd_report", "assemble_mcd_r05"])
def test_entry_points_need_cuda(monkeypatch, tmp_path, main, argv):
    """Each raises without a card, with --device left out or cuda, before
    it writes anything."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    w = str(tmp_path / "w")
    for extra in ([], ["--device", "cuda"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--workdir", w, *argv, *extra])
    assert os.listdir(tmp_path) == []


# a stand-in for python on PATH: it records its arguments and writes the
# json that curve_eval would write (the heredoc call prints an epoch)
PYTHON_STUB = """#!/bin/sh
printf '%s\\n' "$*" >> "$STUB_LOG"
if [ "$1" = "-" ]; then cat > /dev/null; echo 16; exit 0; fi
w= e= x= o=
while [ $# -gt 0 ]; do
  case $1 in
    --workdir) w=$2;; --epoch) e=$2;; --exp-name) x=$2;; --out) o=$2;;
  esac
  shift
done
[ -n "$o" ] || o="$w/${x}_curve_e$e.json"
echo '{}' > "$o"
"""


@pytest.mark.parametrize("device", [None, "cpu"], ids=["default", "cpu"])
@pytest.mark.parametrize("launcher", ["post_train", "spemb_watch"])
def test_launchers_evaluate_on_cuda_unless_asked(tmp_path, launcher, device):
    """post_train.sh and spemb_watch.sh hand curve_eval (and post_train.sh
    the r05 assembler) --device cuda, or cpu when the caller passes it."""
    stub_dir = tmp_path / "bin"
    stub_dir.mkdir()
    (stub_dir / "python").write_text(PYTHON_STUB)
    (stub_dir / "python").chmod(0o755)
    w = tmp_path / "w"
    (w / "exp_spemb" / "checkpoints").mkdir(parents=True)
    (w / "exp_spemb" / "checkpoints" / "epoch_8.pt").write_bytes(b"")
    (w / "exp_spemb" / "DONE").touch()
    more = {"post_train": [], "spemb_watch": ["exp_spemb", "8", "voc"]}
    log = tmp_path / "calls.txt"
    env = {**os.environ, "STUB_LOG": str(log),
           "PATH": f"{stub_dir}{os.pathsep}{os.environ['PATH']}"}
    subprocess.run(["bash", os.path.join(ROOT, "a3t_tpu_torch", "recipes",
                                         "soak", f"{launcher}.sh"), str(w),
                    *more[launcher], *([device] if device else [])],
                   env=env, check=True, timeout=60, capture_output=True)
    calls = [c.split() for c in log.read_text().splitlines()
             if c.startswith("-m ")]
    soak = "a3t_tpu_torch.recipes.soak."
    assert {c[1] for c in calls} == (
        {soak + "curve_eval", soak + "assemble_mcd_r05"}
        if launcher == "post_train" else {soak + "curve_eval"})
    # post_train.sh: the sweep at epoch 8 (best - 8), five controls, the
    # assembler
    assert len(calls) == (7 if launcher == "post_train" else 1)
    for c in calls:
        assert c[c.index("--device") + 1] == (device or "cuda")
