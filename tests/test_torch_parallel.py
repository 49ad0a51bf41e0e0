"""The port's data axis (a3t_tpu_torch/parallel/, the ZeRO-1 optimizer, the
rank-aware step, batcher, trainer and checkpoints) on the CPU: W ranks are
spawned processes in a gloo group, one intra-op thread each
(tests/torch_parallel_ranks.py), held against one process on the same
global batch and against the JAX package's 2-way data mesh.

Tolerances, as JAX's own cross-mesh test (tests/test_train.py:169-237)
holds its meshes: losses within rtol 1e-5; parameters by that test's rule
(every element within 2.5 Adam updates, fewer than 0.2% of the elements
past 1e-5 and 2e-4 of their value: a parameter whose true gradient is 0,
such as the key bias, takes a full +-lr first Adam step of the sign of its
rounding noise); BatchNorm running statistics within 1e-6.  The models
run with every dropout rate 0, the postnet's fixed rate too.

The gathered moments equal one process's within rtol 1e-6 of each
tensor's largest magnitude at a step that is not clipped.  At a clipped
step they differ by the clip factor's rounding alone: one process takes the
gradient's norm with ``torch.linalg.vector_norm``, which on the CPU in
float32 reads 3.7e-6 below the float64 norm of this gradient, where the
ranks reduce the slices' sums of squares (within 1e-8); the test holds the
moments times each run's ``grad_norm / grad_clip`` to the same rtol.
"""

import copy
import functools
import os
import pickle
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig, EncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.parallel import MeshConfig, make_mesh, shard_opt_state
from a3t_tpu.parallel import shard_variables
from a3t_tpu.parallel.mesh import batch_sharding
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import create_train_state as jax_create_train_state
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train import noam_schedule
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.data.iterator import EpochIterFactory
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from a3t_tpu_torch.data.records import RecordDataset, pack_records
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.parallel import flat_slice, row_block, shard_flat
from a3t_tpu_torch.tasks.config import config_from_dict
from a3t_tpu_torch.tasks.mlm import MLMTask
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from test_torch_mlm import port_config
import torch_parallel_ranks as ranks

HOP = 64
W = 2
NO_DROPOUT = dict(dropout_rate=0.0, positional_dropout_rate=0.0,
                  attention_dropout_rate=0.0)
# JAX's tiny_model / tiny_frontend / tiny_batch (tests/test_train.py:29-51)
ENC = EncoderConfig(attention_dim=32, attention_heads=2, linear_units=64,
                    num_blocks=1, cnn_module_kernel=7, **NO_DROPOUT)
DEC = EncoderConfig(attention_dim=32, attention_heads=2, linear_units=64,
                    num_blocks=1, **NO_DROPOUT)
CFG = A3TModelConfig(odim=20, vocab_size=30, encoder=ENC, decoder=DEC,
                     postnet_layers=2, postnet_chans=16)
FRONTEND = dict(fs=8000, n_fft=256, hop_length=HOP, win_length=256,
                n_mels=20, fmin=20, fmax=4000)
OPTIM = dict(model_size=32, warmup_steps=20)
# the task runs: 24 kHz mini corpora at a toy width, buckets of 4 rows at
# batch_multiple 2 (the 10 training utterances make 4 + 4 + 2 rows: a short
# last batch, whose empty rows are all of rank 1's)
FE24 = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200,
            n_mels=20, fmin=80.0, fmax=7600.0)
FE16 = dict(fs=16000, n_fft=1024, hop_length=200, win_length=800,
            n_mels=20, fmin=80.0, fmax=7600.0)
STACK = dict(attention_dim=32, attention_heads=2, linear_units=32,
             num_blocks=1)
TASK_OPTIM = dict(lr=1.0, model_size=32, warmup_steps=100, grad_clip=1.0,
                  adam_eps=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_dp2():
    """JAX's one step on a 2-way data mesh (sharded Adam moments): the
    initial variables, the batch, the loss, and the parameters and
    BatchNorm statistics after the step."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch_np = make_synthetic_batch(
            np.random.default_rng(0), batch_size=8, n_samples=HOP * 40,
            n_text=8, hop_length=HOP, vocab_size=30, fs=8000)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, {k: v[:2] for k, v in batch.items()},
                          use_fused=False))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        mesh = make_mesh(MeshConfig(data_parallel=W),
                         devices=jax.devices()[:W])
        state = state.replace(params=shard_variables(mesh, state.params),
                              opt_state=shard_opt_state(mesh,
                                                        state.opt_state))
        step = jax_make_train_step(model, fe, mesh=mesh, donate=False)
        state, stats = step(state, jax.device_put(batch,
                                                  batch_sharding(mesh)),
                            jax.random.PRNGKey(0))
        after = mlm_state(jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats}))
    finally:
        jax_mlm.Postnet = postnet
    return dict(init=init, batch=batch_np, loss=float(stats["loss"]),
                grad_norm=float(stats["grad_norm"]), after=after)


def _config(corpus, exp, **over) -> dict:
    data = dict(
        train_data_dir=corpus["c24"], valid_data_dir=corpus["v24"],
        exp_dir=exp, frontend=FE24, num_workers_prefetch=0,
        model=dict(encoder=STACK, decoder=STACK, postnet_layers=2,
                   postnet_chans=16),
        batcher=dict(batch_bins=20 * 256 * 4, bucket_frames=[128, 256],
                     batch_multiple=W),
        optim=TASK_OPTIM,
        trainer=dict(max_epoch=2, num_iters_per_epoch=3, log_interval=2,
                     keep_nbest_models=2, save_interval_steps=2))
    for key, value in over.items():
        if isinstance(value, dict) and isinstance(data.get(key), dict):
            data[key] = {**data[key], **value}
        else:
            data[key] = value
    return data


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("dp_corpus")
    return dict(c24=generate_mini_corpus(str(d / "c24"), n_utts=10,
                                         fs=24000, seed=0),
                v24=generate_mini_corpus(str(d / "v24"), n_utts=4,
                                         fs=24000, seed=1),
                c16=generate_mini_corpus(str(d / "c16"), n_utts=6,
                                         fs=16000, seed=2))


def _tts(corpus, exp):
    return _config(corpus, exp, model={"duration_predictor_layers": 2},
                   trainer={"max_epoch": 1})


def _multi(corpus, exp):
    corpora = [dict(name="a", data_dir=corpus["c24"], portion=0.6),
               dict(name="b", data_dir=corpus["c16"], portion=0.4,
                    speech_only=True, frontend=FE16)]
    return _config(corpus, exp, corpora=corpora, trainer={
        "max_epoch": 1, "save_interval_steps": None})


@pytest.fixture(scope="module")
def runs(jax_dp2, corpus, tmp_path_factory):
    """Every scenario at W = 2 (spawned gloo ranks), at W = 1 in this
    process without a group, and (iii) at W = 1 under a group of one;
    returns the work directory, whose files hold the results."""
    d = str(tmp_path_factory.mktemp("dp_runs"))
    model = build_model(port_config(CFG), device="cpu")
    ranks.set_dropout(model, 0.0)
    load_state(model, mlm_state(jax_dp2["init"]))
    torch.save(model.state_dict(), os.path.join(d, "init.pt"))
    with open(os.path.join(d, "setup.pkl"), "wb") as f:
        pickle.dump(dict(model=port_config(CFG), optim=OPTIM,
                         frontend=FRONTEND), f)
    np.savez(os.path.join(d, "batch.npz"), **jax_dp2["batch"])
    # rank 1's rows a copy of rank 0's
    half = {k: v[:4] for k, v in jax_dp2["batch"].items()}
    np.savez(os.path.join(d, "twin.npz"),
             **{k: np.concatenate([v, v]) for k, v in half.items()})

    def exp(name):
        return os.path.join(d, name)

    def task(tag, config, **kw):
        return ("task_run", dict(workdir=d, tag=tag, config=config,
                                 dropout=0.0, **kw))

    base = {"U": _config(corpus, exp("U2")), "I": _config(corpus, exp("I2"))}
    first = [
        ("tiny_step", dict(workdir=d, tag="step")),
        ("tiny_step", dict(workdir=d, tag="noclip",
                           optim={"grad_clip": 1e9})),
        ("dropout_masks", dict(workdir=d, batch_file="twin.npz")),
        ("checkpoint_views", dict(workdir=d)),
        task("tts", _tts(corpus, exp("tts2"))),
        task("multi", _multi(corpus, exp("multi2"))),
        task("U", base["U"]),
        task("I", base["I"], stop_at=(2, 2)),
    ]
    ranks.spawn(W, first, d)
    # the one-process references
    ranks.tiny_step(d, tag="step")
    ranks.tiny_step(d, tag="noclip", optim={"grad_clip": 1e9})
    ranks.dropout_masks(d, "twin.npz")
    for tag, config, kw in (
            ("tts", _tts(corpus, exp("tts1")), {}),
            ("multi", _multi(corpus, exp("multi1")), {}),
            ("U", _config(corpus, exp("U1")), {}),
            ("I", _config(corpus, exp("I1")), {"stop_at": (2, 2)})):
        ranks.task_run(d, tag, config, dropout=0.0, **kw)
    # resumes across world sizes, each from a copy of the interrupted
    # run's experiment
    for src, dst in (("I2", "R21"), ("I2", "R22"), ("I1", "R11"),
                     ("I1", "R12")):
        shutil.copytree(exp(src), exp(dst))
    ranks.task_run(d, "R21", _config(corpus, exp("R21")), dropout=0.0)
    ranks.task_run(d, "R11", _config(corpus, exp("R11")), dropout=0.0)
    ranks.spawn(W, [task("R22", _config(corpus, exp("R22"))),
                    task("R12", _config(corpus, exp("R12")))], d)
    # (iii): one rank under a group
    ranks.spawn(1, [("tiny_step", dict(workdir=d, tag="g1_step")),
                    task("g1_U", _config(corpus, exp("g1_U")))], d)
    return d


def _load(d, tag):
    return torch.load(os.path.join(d, f"{tag}.pt"), weights_only=False)


def _jax_rule(base: dict, other: dict, max_update: float):
    """tests/test_train.py:225-237 over every parameter (BatchNorm
    statistics apart)."""
    n_bad = n_total = 0
    for name, a in base.items():
        if "running_" in name or name.endswith("num_batches_tracked"):
            continue
        a = np.asarray(a, np.float64)
        d = np.abs(a - np.asarray(other[name], np.float64))
        assert d.max() < max_update, (name, d.max())
        n_bad += int(((d > 1e-5) & (d > 2e-4 * np.abs(a))).sum())
        n_total += a.size
    assert n_bad / n_total < 2e-3, (n_bad, n_total)


def _bn(state: dict) -> dict:
    return {k: v for k, v in state.items() if "running_" in k}


# --- (i) one step at W = 2 against JAX's 2-way mesh and the port at W = 1

def test_step_equals_jax_mesh_and_one_process(runs, jax_dp2):
    w1 = _load(runs, "step_w1")
    r0, r1 = _load(runs, "step_r0"), _load(runs, "step_r1")
    # every rank reports the global batch's statistics
    for key in ("loss", "loss_mlm", "masked_frames", "grad_norm"):
        assert torch.equal(r1["stats"][key], r0["stats"][key])
    loss = float(r0["stats"]["loss"])
    assert loss == pytest.approx(float(w1["stats"]["loss"]), rel=1e-5)
    assert loss == pytest.approx(jax_dp2["loss"], rel=1e-5)
    # the global norm the clip and the log use (Adam's step alone is nearly
    # blind to the gradient's scale)
    norm = float(r0["stats"]["grad_norm"])
    assert norm == pytest.approx(float(w1["stats"]["grad_norm"]), rel=1e-5)
    assert norm == pytest.approx(jax_dp2["grad_norm"], rel=1e-5)
    assert int(r0["stats"]["masked_frames"]) == \
        int(w1["stats"]["masked_frames"])
    max_update = 2.5 * float(noam_schedule(32, 20, 1.0)(0))
    for want in (w1["model"], jax_dp2["after"]):
        want = {k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}
        _jax_rule(want, r0["model"], max_update)
        for name, v in _bn(want).items():
            np.testing.assert_allclose(r0["model"][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
    # the ranks hold one model: parameters and BatchNorm statistics equal
    # bit for bit
    for name, v in r0["model"].items():
        assert torch.equal(v, r1["model"][name]), name


# --- (ii) ZeRO-1: each rank's moments are ceil(n / W) long; gathered, they
# equal one process's

def test_gathered_moments_equal_one_process(runs):
    n = sum(p.numel() for p in build_model(port_config(CFG),
                                           device="cpu").parameters())
    for tag in ("noclip", "step"):
        w1 = _load(runs, f"{tag}_w1")
        r0, r1 = _load(runs, f"{tag}_r0"), _load(runs, f"{tag}_r1")
        assert w1["local_mu"] == n
        assert r0["local_mu"] == r1["local_mu"] == -(-n // W)
        # the moments scaled back by each run's clip factor (1 unclipped)
        clip = {"noclip": 1e9, "step": 1.0}[tag]

        def unclipped(run):
            f = max(float(run["stats"]["grad_norm"]) / clip, 1.0)
            return {"mu": run["opt"]["mu"].double() * f,
                    "nu": run["opt"]["nu"].double() * f * f}

        got, want = unclipped(r0), unclipped(w1)
        for key in ("mu", "nu"):
            assert got[key].shape == (n,)
            assert torch.equal(r0["opt"][key], r1["opt"][key])
            np.testing.assert_allclose(
                got[key].numpy(), want[key].numpy(), rtol=1e-6,
                atol=1e-6 * float(want[key].abs().max()), err_msg=tag)
        for key in ("count", "notfinite_count", "total_notfinite"):
            assert torch.equal(r0["opt"][key], w1["opt"][key])


def test_flat_slices_cover_the_vector():
    x = torch.arange(11, dtype=torch.float32)
    parts = [shard_flat(x, r, 4) for r in range(4)]
    assert [p.numel() for p in parts] == [3, 3, 3, 3]
    assert torch.equal(torch.cat(parts)[:11], x)
    assert torch.equal(torch.cat(parts)[11:], torch.zeros(1))
    assert flat_slice(11, 3, 4) == slice(9, 12)
    assert shard_flat(x, 0, 1) is x
    assert row_block(8, 1, 2) == slice(4, 8)
    with pytest.raises(ValueError, match="split"):
        row_block(6, 0, 4)


# --- (iii) W = 1 under a group is today's path bit for bit

def test_one_rank_under_a_group_is_bit_for_bit(runs):
    for group, alone in (("g1_step_w1", "step_w1"), ("g1_U_w1", "U_w1")):
        got, want = _load(runs, group), _load(runs, alone)
        for name, v in want["model"].items():
            assert torch.equal(got["model"][name], v), (group, name)
        for name, v in want["opt"].items():
            assert torch.equal(got["opt"][name], v), (group, name)
    got, want = _load(runs, "g1_U_w1"), _load(runs, "U_w1")
    assert got["steps"] == want["steps"]

    def values(history):  # the statistics, not the host's timings
        return {e: {p: {k: v for k, v in stats.items() if "time" not in k}
                    for p, stats in h.items()} for e, h in history.items()}

    assert values(got["history"]) == values(want["history"])


# --- (v) dropout: the ranks draw different masks for identical rows

def test_ranks_draw_their_own_dropout_masks(runs):
    r0, r1 = _load(runs, "dropout_r0"), _load(runs, "dropout_r1")
    w1 = _load(runs, "dropout_w1")
    # without the rank in the seed both ranks would draw one mask
    assert torch.equal(r0["unfolded"], r1["unfolded"])
    assert not torch.equal(r0["folded"], r1["folded"])
    frac = float((r0["folded"] != r1["folded"]).float().mean())
    assert frac > 0.5, frac
    # one process keeps the trainer's seeds of (seed, epoch, iteration)
    assert torch.equal(w1["folded"], w1["unfolded"])


# --- (vi) the duration-aware variant and a two-corpus mixture at W = 2

@pytest.mark.parametrize("tag", ["tts", "multi", "U"])
def test_task_runs_equal_one_process(runs, tag):
    w1 = _load(runs, f"{tag}_w1")
    r0, r1 = _load(runs, f"{tag}_r0"), _load(runs, f"{tag}_r1")
    assert r0["buckets"] == w1["buckets"]
    assert [s[:2] for s in r0["steps"]] == [s[:2] for s in w1["steps"]]
    # each rank's batches are half the global batch's rows
    assert [s[3] for s in r0["steps"]] == [s[3] // W for s in w1["steps"]]
    for a, b, c in zip(r0["steps"], r1["steps"], w1["steps"]):
        assert a[2] == b[2]
        assert a[2] == pytest.approx(c[2], rel=1e-5)
    for epoch, h in w1["history"].items():
        for phase, stats in h.items():
            for key, value in stats.items():
                if key == "loss" or key.startswith("loss_"):
                    assert r0["history"][epoch][phase][key] == \
                        pytest.approx(value, rel=1e-5), (epoch, phase, key)
    n_steps = len(w1["steps"])
    max_update = 2.5 * n_steps * float(noam_schedule(32, 100, 1.0)(n_steps))
    _jax_rule(w1["model"], r0["model"], max_update)
    for name, v in _bn(w1["model"]).items():
        np.testing.assert_allclose(r0["model"][name].numpy(), v.numpy(),
                                   rtol=0, atol=1e-6, err_msg=name)
    for name, v in r0["model"].items():
        assert torch.equal(v, r1["model"][name]), name


# --- (vii) checkpoints resume across world sizes

def test_checkpoints_resume_across_world_sizes(runs):
    u1, u2 = _load(runs, "U_w1"), _load(runs, "U_r0")
    # a resume at the same world size equals the uninterrupted run bit for
    # bit
    for got, want in ((_load(runs, "R22_r0"), u2),
                      (_load(runs, "R11_w1"), u1)):
        assert got["steps"] == [s for s in want["steps"]
                                if (s[0], s[1]) >= (2, 2)]
        for name, v in want["model"].items():
            assert torch.equal(got["model"][name], v), name
        for name, v in want["opt"].items():
            assert torch.equal(got["opt"][name], v), name
    # across world sizes: the resumed steps' losses and the final state
    # within the W = 2 / W = 1 tolerances of the run written at the other
    for got, want in ((_load(runs, "R21_w1"), u2),
                      (_load(runs, "R12_r0"), u1)):
        tail = [s for s in want["steps"] if (s[0], s[1]) >= (2, 2)]
        assert [s[:2] for s in got["steps"]] == [s[:2] for s in tail]
        for a, b in zip(got["steps"], tail):
            assert a[2] == pytest.approx(b[2], rel=1e-5)
        max_update = 2.5 * 6 * float(noam_schedule(32, 100, 1.0)(6))
        _jax_rule(want["model"], got["model"], max_update)
        for key in ("mu", "nu"):
            np.testing.assert_allclose(
                got["opt"][key].numpy(), want["opt"][key].numpy(),
                rtol=1e-5, atol=1e-5 * float(want["opt"][key].abs().max()))


def test_checkpoint_decisions_are_rank_zeros(runs):
    """Where to resume and what to average are rank 0's decisions, and a
    rank that cannot see rank 0's directory stops every rank, not only
    itself (a rank left alone in a collective would wait for ever)."""
    r0, r1 = _load(runs, "views_r0"), _load(runs, "views_r1")
    assert r0["latest"] == r1["latest"] == 3
    for r in (r0, r1):
        assert r["own"].startswith("rank(s) [1] do not see rank 0's"), r
    assert r0["average"] == "no ranked epochs available to average"
    assert r1["average"] == (None, None)
    assert r0["shared_files"] == r1["shared_files"] == []


def test_checkpoint_files_do_not_depend_on_world_size(runs):
    trees = {}
    for exp, tag in (("I1", "I_w1"), ("I2", "I_r0")):
        ckpt = os.path.join(runs, exp, "checkpoints")
        assert sorted(os.listdir(ckpt)) == [
            "LATEST", "epoch_1.pt", "meta.json", "meta_step.json",
            "step_e2_i2.pt"]
        tree = trees[exp] = torch.load(os.path.join(ckpt, "step_e2_i2.pt"),
                                       weights_only=True)
        run = _load(runs, tag)
        assert run["stopped"]
        for key, v in run["opt"].items():
            assert torch.equal(tree["opt_state"][key], v), key
    # one layout: the same entries, each of one shape and dtype
    for part in ("model", "opt_state"):
        a, b = trees["I1"][part], trees["I2"][part]
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                   for k in a)


# --- (iv) each rank's rows equal the one-process batch's block

@pytest.fixture(scope="module")
def records(corpus, tmp_path_factory):
    tokens = build_token_list(read_2column_text(
        os.path.join(corpus["c24"], "text")).values())
    d = tmp_path_factory.mktemp("dp_records")
    return pack_records(A3TDataset(corpus["c24"], TokenIDConverter(tokens)),
                        str(d / "rec"), shard_mb=0), tokens


def _batchers(corpus, records):
    rec_dir, tokens = records
    conv = TokenIDConverter(tokens)
    fe = LogMelConfig(**FE24)
    bc = dict(batch_bins=20 * 256 * 4, bucket_frames=(128, 256),
              batch_multiple=4)
    return {
        "native": BucketBatcher(A3TDataset(corpus["c24"], conv), fe,
                                BatcherConfig(**bc)),
        "decoded": BucketBatcher(A3TDataset(corpus["c24"], conv), fe,
                                 BatcherConfig(**bc,
                                               use_native_loader=False)),
        "float": BucketBatcher(A3TDataset(corpus["c24"], conv), fe,
                               BatcherConfig(**bc, use_native_loader=False,
                                             audio_int16=False)),
        "records": BucketBatcher(RecordDataset(rec_dir), fe,
                                 BatcherConfig(**bc, device_audio=True)),
        "records_pcm": BucketBatcher(RecordDataset(rec_dir), fe,
                                     BatcherConfig(**bc)),
        "tts": BucketBatcher(A3TDataset(corpus["c24"], conv), fe,
                             BatcherConfig(**bc, duration_collect=True)),
    }


@pytest.mark.parametrize("kind", ["native", "decoded", "float", "records",
                                  "records_pcm", "tts"])
def test_rank_rows_equal_the_global_batch_block(corpus, records, kind,
                                                monkeypatch):
    batcher = _batchers(corpus, records)[kind]
    read = []  # the uids whose audio was read or decoded

    def spy(orig):
        def wrapped(self, uid):
            read.append(uid)
            return orig(self, uid)
        return wrapped

    def spy_load(orig):
        def wrapped(idx, *a, **kw):
            read.extend(batcher.dataset.uids[i] for i in idx)
            return orig(idx, *a, **kw)
        return wrapped

    ds = type(batcher.dataset)
    for name in ("get_pcm16",) if hasattr(ds, "get_pcm16") else (
            "__getitem__",):
        monkeypatch.setattr(ds, name, spy(getattr(ds, name)))
    if batcher._loader is not None:
        for name in ("load_batch", "load_batch_i16"):
            monkeypatch.setattr(batcher._loader, name,
                                spy_load(getattr(batcher._loader, name)))
    short = 0
    for epoch in (1, 2):
        plan = batcher.batch_plan(epoch)
        short += sum(len(u) < batcher.buckets[bi].batch_size
                     for bi, u in plan)
        for w in (2, 4):
            rngs = [np.random.default_rng(epoch) for _ in range(w + 1)]
            for bi, uids in plan:
                full = batcher.make_batch(bi, uids, rngs[w])
                b = batcher.buckets[bi].batch_size
                for r in range(w):
                    read.clear()
                    got = batcher.make_batch(bi, uids, rngs[r], rows=(r, w))
                    block = row_block(b, r, w)
                    assert list(got) == list(full)
                    for key, v in full.items():
                        assert np.array_equal(got[key], v[block]), (r, key)
                        assert got[key].dtype == v.dtype
                    if kind != "records":  # device_audio reads no audio
                        assert sorted(read) == sorted(uids[block]), (r,
                                                                     read)
                    else:
                        assert read == []
    assert short > 0  # a short last batch was among them


def test_epoch_factory_rows_follow_the_unsharded_plan(corpus, records):
    batcher = _batchers(corpus, records)["native"]
    whole = list(EpochIterFactory(batcher, 5, prefetch=0)(1))
    parts = [list(EpochIterFactory(batcher, 5, prefetch=0, rows=(r, 2))(1))
             for r in range(2)]
    assert len(whole) == len(parts[0]) == len(parts[1]) == 5
    for i, full in enumerate(whole):
        b = len(full["audio_lengths"])
        for r in range(2):
            for key, v in full.items():
                assert np.array_equal(parts[r][i][key],
                                      v[row_block(b, r, 2)])
    with pytest.raises(NotImplementedError):
        EpochIterFactory(batcher, 5, chain=2, rows=(0, 2))


# --- (ix) what stays refused

def test_refusals(corpus, tmp_path):
    base = _config(corpus, str(tmp_path / "exp"))
    # the longformer on the seq axis: JAX's rules alone, its buckets
    # multiples of half-window x dilation, checked before the mesh is laid
    # out; a rank's block of part of a chunk (128 frames / 8 ranks = 16
    # against c = 32) goes through to the mesh, which one process does not
    # cover
    lf = copy.deepcopy(base)
    lf["model"]["encoder"] = {**STACK, "selfattention_layer_type":
                              "longformer", "attention_window": 64}
    with pytest.raises(ValueError, match="sequence_parallel=8"):
        MLMTask.build(config_from_dict({**lf, "mesh": {
            "sequence_parallel": 8}}), device="cpu")
    lf["model"]["encoder"]["attention_window"] = 512
    with pytest.raises(ValueError, match=r"bucket_frames \[128\] not "
                       "multiples of half-window x dilation 256"):
        MLMTask.build(config_from_dict({**lf, "mesh": {
            "sequence_parallel": 8}}), device="cpu")
    # one process covers no mesh of two
    for mesh, match in (({"data_parallel": 2}, "data_parallel=2"),
                        ({"sequence_parallel": 2}, "sequence_parallel=2"),
                        ({"tensor_parallel": 2}, "tensor_parallel=2")):
        with pytest.raises(ValueError, match=match):
            MLMTask.build(config_from_dict({**copy.deepcopy(base),
                                            "mesh": mesh}), device="cpu")
    for flags in (["--prng", "threefry2x32"], ["--coordinator", "h:1"],
                  ["--num-hosts", "2", "--host-id", "0"]):
        with pytest.raises(SystemExit):
            train_main(["--config", "c.yaml", *flags])
