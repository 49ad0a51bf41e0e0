"""The port's seq axis (context parallelism: ``a3t_tpu_torch/parallel/
sequence.py``, the three-axis mesh of ``parallel/mesh.py``, K1/K2's query
blocks) on the CPU: ranks are spawned processes in a gloo group, one
intra-op thread each (``tests/torch_sp_ranks.py``), on JAX's tiny model
(tests/test_train.py:29-51: d = 32, 2 heads, 64 units, 1 + 1 blocks, conv
kernels 7 and 31) at 40 frames, held against one process on the same
global batch and against JAX's ``MeshConfig(data_parallel=1,
sequence_parallel=2)`` and ``(2, 2, 2)`` meshes.  The port's 1 x 2 x 2
mesh is held to JAX's 2 x 2 x 2 (the three-axis mesh of JAX's own
cross-mesh test, tests/test_train.py:206), not to its 1 x 2 x 2: on the
CPU, GSPMD computes that one mesh's loss 2.6-2.7% above JAX's one device
(76.9518 against 75.0108 on this batch, 78.5097 against 76.4625 on
another), where one device, (1, 2, 1), (1, 1, 2), (2, 2, 1), (2, 2, 2),
(1, 4, 1) and (1, 4, 2) agree within 2e-7; the port's 1 x 2 x 2 reads
75.0108.  JAX's 2 x 2 x 2 parameters after the step in turn miss JAX's own
rule against its one device on this batch (292 of 89,552 elements past it,
0.33%, most in the feed-forwards' convolution kernels), so every mesh's
parameters are held to JAX's (1, 2) seq mesh (95 past, 0.11%) and to the
port's one process, and the 1 x 2 x 2 loss and BatchNorm statistics to
JAX's 2 x 2 x 2.

Tolerances: against JAX, JAX's own cross-mesh rule
(tests/test_train.py:216-237): losses within rtol 1e-5, every parameter
element within 2.5 Adam updates and fewer than 0.2% of them past 1e-5 and
2e-4 of their value, BatchNorm statistics within 1e-6, every dropout rate
0 (the postnet's and the duration predictor's fixed rates too).  Against
one process with dropout 0.2 everywhere, losses within 1e-5 relative and
every keep-mask a rank draws equal to the matching rows of one process's,
bit for bit.  The pieces (the convolutions' halos, the relative shift's
rows, the plain K1/K2 on a block of query rows) run in this process: the
halos with the ranks as threads whose collectives meet on a barrier.
"""

import concurrent.futures
import dataclasses
import functools
import os
import pickle
import shutil
import threading

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.data import make_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.parallel import MeshConfig, make_mesh, shard_opt_state
from a3t_tpu.parallel import shard_variables
from a3t_tpu.parallel.mesh import batch_sharding
from a3t_tpu.train import OptimConfig as JaxOptimConfig
from a3t_tpu.train import make_optimizer as jax_make_optimizer
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train import noam_schedule
from a3t_tpu.train.train_step import TrainState as JaxTrainState
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu.train.train_step import make_tts_train_step as jax_tts_step
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.data.batcher import BatcherConfig, BucketBatcher
from a3t_tpu_torch.data.dataset import A3TDataset
from a3t_tpu_torch.data.fileio import read_2column_text
from a3t_tpu_torch.dsp import LogMelConfig
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models import layers
from a3t_tpu_torch.models.attention import (latest_rel_shift,
                                            latest_rel_shift_rows,
                                            legacy_rel_shift,
                                            legacy_rel_shift_rows)
from a3t_tpu_torch.ops import fused_attention as fa
from a3t_tpu_torch.parallel import sequence
from a3t_tpu_torch.parallel.sequence import SeqLayout
from a3t_tpu_torch.text import TokenIDConverter, build_token_list
from test_torch_mlm import make_batch, port_config
from test_torch_parallel import (CFG, FRONTEND, OPTIM, _bn, _config,
                                 _jax_rule, _multi, _tts)
from test_torch_parallel import corpus  # noqa: F401  (a fixture)
import torch_parallel_ranks as ranks
import torch_sp_ranks as sp_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
FS2_CONFIG = os.path.join(HERE, "..", "configs", "fs2_conformer_24k.yaml")
HOP = 64
SP2 = {"mesh": {"sequence_parallel": 2}}
SP2TP2 = {"mesh": {"sequence_parallel": 2, "tensor_parallel": 2}}
PLOT = {"num_plot_examples": 1}
# the duration-aware variant against JAX's seq mesh (tests/test_variants.py
# :96): 24 kHz speech-like utterances in buckets of 128 frames
FE24 = dict(fs=24000, n_fft=2048, hop_length=300, win_length=1200,
            n_mels=20, fmin=80.0, fmax=7600.0)
TTS_STACK = dict(attention_dim=32, attention_heads=2, linear_units=32,
                 num_blocks=1, dropout_rate=0.0, positional_dropout_rate=0.0,
                 attention_dropout_rate=0.0)
TTS_OPTIM = dict(lr=1.0, model_size=32, warmup_steps=100, grad_clip=1.0,
                 adam_eps=1e-3)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tts_config(vocab: int) -> JaxA3TModelConfig:
    enc = JaxEncoderConfig(**TTS_STACK, cnn_module_kernel=7)
    return JaxA3TModelConfig(odim=20, vocab_size=vocab, encoder=enc,
                             decoder=enc, postnet_layers=2, postnet_chans=16,
                             duration_predictor_layers=2)


def _jax_state(model, optim: dict, sample: dict) -> JaxTrainState:
    """JAX's ``create_train_state`` with its init jitted (flax's eager
    init takes ~18 s of the tiny model here)."""
    tx = jax_make_optimizer(JaxOptimConfig(**optim))
    v = jax.jit(lambda b: model.init(jax.random.PRNGKey(0), **b,
                                     train=False))(sample)
    return JaxTrainState(step=jnp.zeros((), jnp.int32), params=v["params"],
                         batch_stats=v.get("batch_stats", {}),
                         opt_state=tx.init(v["params"]), tx=tx)


@pytest.fixture(scope="module")
def tts_batch(tmp_path_factory):
    """A duration-collected batch of the port's batcher at 128 frames and
    its vocabulary."""
    from a3t_tpu_torch.data.miniature import generate_speechlike_corpus

    d = tmp_path_factory.mktemp("sp_tts")
    train = generate_speechlike_corpus(str(d / "train"), n_utts=6, seed=5,
                                       n_speakers=2, fs=24000,
                                       n_phones_range=(4, 12))
    tokens = build_token_list(read_2column_text(
        os.path.join(train, "text")).values())
    batcher = BucketBatcher(
        A3TDataset(train, TokenIDConverter(tokens)), LogMelConfig(**FE24),
        BatcherConfig(batch_bins=20 * 128 * 4, bucket_frames=(128,),
                      min_frames=16, duration_collect=True))
    return next(batcher.epoch_iterator(1)), len(tokens)


@pytest.fixture(scope="module")
def jax_sp(tts_batch):
    """JAX's one step on the (1, 2) and (2, 2, 2) seq meshes from one init,
    and its duration-aware step on the (1, 2) seq mesh: the variables, the
    batches, each mesh's loss and parameters after the step."""
    saved = jax_mlm.Postnet, jax_mlm.DurationPredictor
    jax_mlm.Postnet = functools.partial(saved[0], dropout_rate=0.0)
    jax_mlm.DurationPredictor = functools.partial(saved[1], dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        # 40 frames, a multiple of the seq axis (JAX's test's batch_sp)
        batch_np = make_synthetic_batch(
            np.random.default_rng(7), batch_size=8, n_samples=HOP * 39,
            n_text=8, hop_length=HOP, vocab_size=30, fs=8000)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state0 = _jax_state(model, OPTIM, jax_featurize(
            fe, {k: v[:2] for k, v in batch.items()}, use_fused=False))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state0.params, "batch_stats": state0.batch_stats})
        out = dict(init=init, batch=batch_np)

        def one_step(mesh, make, state, batch):
            state = state.replace(
                params=shard_variables(mesh, state.params),
                opt_state=shard_opt_state(mesh, state.opt_state))
            state, stats = make(mesh)(state, jax.device_put(
                batch, batch_sharding(mesh)), jax.random.PRNGKey(0))
            return dict(loss=float(stats["loss"]), after=mlm_state(
                jax.tree_util.tree_map(np.asarray, {
                    "params": state.params,
                    "batch_stats": state.batch_stats})))

        for dp, sp, tp in ((1, 2, 1), (2, 2, 2)):
            mesh = make_mesh(MeshConfig(data_parallel=dp, sequence_parallel=sp,
                                        tensor_parallel=tp),
                             devices=jax.devices()[:dp * sp * tp])
            out[(dp, sp, tp)] = one_step(mesh, lambda m: jax_make_train_step(
                model, fe, mesh=m, donate=False), state0, batch)
        # the duration-aware step on the (1, 2) seq mesh
        host, vocab = tts_batch
        tts_model = jax_mlm.A3TMLMModel(_tts_config(vocab))
        tts_fe = JaxLogMelFrontend(JaxLogMelConfig(**FE24))
        dev = {k: jnp.asarray(v) for k, v in host.items()}
        tts_state = _jax_state(tts_model, TTS_OPTIM, jax_featurize(
            tts_fe, {k: v[:2] for k, v in dev.items()}))
        out["tts_init"] = jax.tree_util.tree_map(np.asarray, {
            "params": tts_state.params,
            "batch_stats": tts_state.batch_stats})
        mesh = make_mesh(MeshConfig(data_parallel=1, sequence_parallel=2),
                         devices=jax.devices()[:2])
        out["tts"] = one_step(mesh, lambda m: jax_tts_step(
            tts_model, tts_fe, mesh=m, donate=False), tts_state, dev)
    finally:
        jax_mlm.Postnet, jax_mlm.DurationPredictor = saved
    return out


@pytest.fixture(scope="module")
def runs(jax_sp, tts_batch, corpus, tmp_path_factory):
    """Every scenario on 2 ranks (sp = 2) and 4 ranks (sp = 2 x tp = 2),
    and its one-process reference in this process; returns the work
    directory, whose files hold the results."""
    d = str(tmp_path_factory.mktemp("sp_runs"))
    model = build_model(port_config(CFG), device="cpu")
    ranks.set_dropout(model, 0.0)
    load_state(model, mlm_state(jax_sp["init"]))
    torch.save(model.state_dict(), os.path.join(d, "init.pt"))
    host, vocab = tts_batch
    tts_cfg = port_config(_tts_config(vocab))
    tts_model = build_model(tts_cfg, device="cpu")
    ranks.set_dropout(tts_model, 0.0)
    load_state(tts_model, mlm_state(jax_sp["tts_init"]))
    torch.save(tts_model.state_dict(), os.path.join(d, "tts_init.pt"))
    with open(os.path.join(d, "setup.pkl"), "wb") as f:
        pickle.dump(dict(model=port_config(CFG), optim=OPTIM,
                         frontend=FRONTEND, fs2_config=FS2_CONFIG,
                         task=_config(corpus, os.path.join(d, "lf")),
                         tts_model=tts_cfg, tts_optim=TTS_OPTIM,
                         tts_frontend=FE24), f)
    np.savez(os.path.join(d, "batch.npz"), **jax_sp["batch"])
    np.savez(os.path.join(d, "tts_batch.npz"), **host)
    np.savez(os.path.join(d, "odd_batch.npz"), **make_synthetic_batch(
        np.random.default_rng(8), batch_size=2, n_samples=HOP * 40,
        n_text=8, hop_length=HOP, vocab_size=30, fs=8000))

    def exp(name):
        return os.path.join(d, name)

    def step(tag, **kw):
        return ("torch_sp_ranks:sp_step", dict(workdir=d, tag=tag, **kw))

    def task(tag, config, **kw):
        return ("task_run", dict(workdir=d, tag=tag, config=config, **kw))

    def sp2(config):
        return {**config, **SP2}

    drop = dict(dropout=0.2)
    # the two ranks run beside the one-process references below
    pool = concurrent.futures.ThreadPoolExecutor(1)
    two = pool.submit(ranks.spawn, 2, [
        step("s", sp=2),
        step("d", sp=2, masks=True, **drop),
        step("remat", sp=2, model={"remat_attention": True}, **drop),
        step("tts", sp=2, tts=True),
        task("ttsrun", {**sp2(_tts(corpus, exp("tts2"))), **PLOT}, **drop),
        task("multi", sp2(_multi(corpus, exp("multi2"))), **drop),
        task("I", sp2(_config(corpus, exp("I2"))), dropout=0.0,
             stop_at=(2, 2)),
        ("torch_sp_ranks:refusals", dict(workdir=d)),
    ], d)
    pool.shutdown(wait=False)
    # the one-process references
    sp_ranks.sp_step(d, "s")
    sp_ranks.sp_step(d, "d", masks=True, **drop)
    sp_ranks.sp_step(d, "remat", model={"remat_attention": True}, **drop)
    sp_ranks.sp_step(d, "tts", tts=True)
    ranks.task_run(d, "ttsrun", {**_tts(corpus, exp("tts1")), **PLOT},
                   **drop)
    ranks.task_run(d, "multi", _multi(corpus, exp("multi1")), **drop)
    ranks.task_run(d, "U", _config(corpus, exp("U1")), dropout=0.0)
    ranks.task_run(d, "I", _config(corpus, exp("I1")), dropout=0.0,
                   stop_at=(2, 2))
    two.result()
    # resumes across layouts, each from a copy of an interrupted run
    shutil.copytree(exp("I2"), exp("R21"))
    shutil.copytree(exp("I1"), exp("R14"))
    ranks.task_run(d, "R21", _config(corpus, exp("R21")), dropout=0.0)
    ranks.spawn(4, [
        step("s4", sp=2, tp=2),
        task("R14", {**_config(corpus, exp("R14")), **SP2TP2}, dropout=0.0),
    ], d)
    return d


def _load(d, tag):
    return torch.load(os.path.join(d, f"{tag}.pt"), weights_only=False)


def _max_update(steps: int = 1, warmup: int = 20) -> float:
    return 2.5 * sum(float(noam_schedule(32, warmup, 1.0)(k))
                     for k in range(steps))


# --- (1) one step at sp = 2 and sp = 2 x tp = 2 against JAX's seq meshes
# and one process, dropout 0

@pytest.mark.parametrize("tag,world,mesh", [("s", 2, (1, 2, 1)),
                                            ("s4", 4, (2, 2, 2))])
def test_step_equals_jax_seq_mesh_and_one_process(runs, jax_sp, tag, world,
                                                  mesh):
    got = [_load(runs, f"{tag}_r{r}") for r in range(world)]
    w1 = _load(runs, "s_w1")
    tp = mesh[2]
    # rank r is seq rank (r // tp) % sp, as JAX's reshape(dp, sp, tp)
    assert [x["seq"] for x in got] == [((r // tp) % 2, 2)
                                       for r in range(world)]
    for key in ("loss", "loss_mlm", "masked_frames", "grad_norm"):
        assert all(torch.equal(x["stats"][0][key], got[0]["stats"][0][key])
                   for x in got), key
    loss = float(got[0]["stats"][0]["loss"])
    assert loss == pytest.approx(float(w1["stats"][0]["loss"]), rel=1e-5)
    assert loss == pytest.approx(jax_sp[mesh]["loss"], rel=1e-5)
    assert int(got[0]["stats"][0]["masked_frames"]) == \
        int(w1["stats"][0]["masked_frames"])
    assert float(got[0]["stats"][0]["grad_norm"]) == pytest.approx(
        float(w1["stats"][0]["grad_norm"]), rel=1e-5)
    for src in (w1["model"], jax_sp[(1, 2, 1)]["after"],
                jax_sp[mesh]["after"]):
        want = {k: torch.as_tensor(np.asarray(v)) for k, v in src.items()}
        if src is not jax_sp[(2, 2, 2)]["after"]:  # module docstring
            _jax_rule(want, got[0]["model"], _max_update())
        for name, v in _bn(want).items():
            np.testing.assert_allclose(got[0]["model"][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
    # every rank ends on one model and one optimizer state
    for x in got:
        for name, v in got[0]["model"].items():
            assert torch.equal(x["model"][name], v), name
        for key, v in got[0]["opt"].items():
            assert torch.equal(x["opt"][key], v), key


# --- (2) sp = 2 against one process with dropout on: every rank's masks
# are its rows of one process's

def _rank_rows(full: torch.Tensor, part: torch.Tensor, s: int,
               frames: int = 40, sp: int = 2) -> torch.Tensor:
    """Seq rank s's rows of one process's mask ``full`` (its frame block,
    then the rows after the frames), along the one dimension where the
    shapes differ; ``full`` where they do not (a whole table's mask)."""
    if full.shape == part.shape:
        return full
    dims = [i for i, (a, b) in enumerate(zip(full.shape, part.shape))
            if a != b]
    assert len(dims) == 1, (full.shape, part.shape)
    fb = frames // sp
    rows = torch.cat([torch.arange(s * fb, (s + 1) * fb),
                      torch.arange(frames, full.shape[dims[0]])])
    return full.index_select(dims[0], rows)


def test_dropout_masks_are_one_process_rows(runs):
    w1 = _load(runs, "d_w1")
    kinds = {s for s, _ in w1["masks"]}
    assert kinds == {"byte", "attention"}
    for s in range(2):
        got = _load(runs, f"d_r{s}")
        rel = abs(float(got["stats"][0]["loss"])
                  / float(w1["stats"][0]["loss"]) - 1)
        assert rel <= 1e-5, rel
        assert [k for k, _ in got["masks"]] == [k for k, _ in w1["masks"]]
        split = set()
        for i, ((site, want), (_, have)) in enumerate(zip(w1["masks"],
                                                          got["masks"])):
            assert torch.equal(_rank_rows(want, have, s), have), (s, i, site)
            if want.shape != have.shape:
                split.add((site, want.dim()))
        # rows of the attention (K1's plain rule), the feed-forwards'
        # hidden units, the blocks' outputs and positional encodings
        # (B, L, d) and the postnet (B, C, F)
        assert {("attention", 4), ("byte", 3)} <= split, split
    _jax_rule(w1["model"], _load(runs, "d_r0")["model"], _max_update())


# --- (3) the other steps at sp = 2 against one process

def test_remat_and_eval_equal_one_process(runs):
    for tag in ("remat", "s"):
        w1, r0, r1 = (_load(runs, f"{tag}_{x}") for x in ("w1", "r0", "r1"))
        for key in ("loss", "grad_norm"):
            assert torch.equal(r0["stats"][0][key], r1["stats"][0][key])
            assert float(r0["stats"][0][key]) == pytest.approx(
                float(w1["stats"][0][key]), rel=1e-5)
        # the eval step after the update: one process's loss within
        # JAX's rule's reach (parameters of zero gradient take a +-lr
        # first step of their rounding noise's sign)
        assert torch.equal(r0["eval"], r1["eval"])
        assert float(r0["eval"]) == pytest.approx(float(w1["eval"]),
                                                  rel=1e-4)
        _jax_rule(w1["model"], r0["model"], _max_update())


def test_tts_step_equals_jax_seq_mesh(runs, jax_sp):
    w1, r0, r1 = (_load(runs, f"tts_{x}") for x in ("w1", "r0", "r1"))
    loss = float(r0["stats"][0]["loss"])
    assert torch.equal(r0["stats"][0]["loss"], r1["stats"][0]["loss"])
    assert loss == pytest.approx(float(w1["stats"][0]["loss"]), rel=1e-5)
    assert loss == pytest.approx(jax_sp["tts"]["loss"], rel=1e-5)
    assert float(r0["stats"][0]["loss_duration"]) == pytest.approx(
        float(w1["stats"][0]["loss_duration"]), rel=1e-5)
    for want in (w1["model"], jax_sp["tts"]["after"]):
        want = {k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}
        _jax_rule(want, r0["model"], _max_update(1, 100))
        for name, v in _bn(want).items():
            np.testing.assert_allclose(r0["model"][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)


@pytest.mark.parametrize("tag", ["ttsrun", "multi"])
def test_task_runs_equal_one_process(runs, tag):
    w1, r0, r1 = (_load(runs, f"{tag}_{s}") for s in ("w1", "r0", "r1"))
    assert r0["buckets"] == w1["buckets"]
    # the seq axis's ranks step on the whole rows of each batch
    assert [s[:2] + s[3:] for s in r0["steps"]] == \
        [s[:2] + s[3:] for s in w1["steps"]]
    for a, b, c in zip(r0["steps"], r1["steps"], w1["steps"]):
        assert a[2] == b[2]
        assert a[2] == pytest.approx(c[2], rel=1e-5)
    # the eval step's validation losses
    for epoch, h in w1["history"].items():
        if "valid" in h:
            got = r0["history"][epoch]["valid"]["loss"]
            assert got == pytest.approx(h["valid"]["loss"], rel=1e-4)
    _jax_rule(w1["model"], r0["model"], _max_update(len(w1["steps"]), 100))
    for name, v in r0["model"].items():
        assert torch.equal(v, r1["model"][name]), name
    if tag == "ttsrun":  # rank 0 rendered the plots
        for exp in ("tts1", "tts2"):
            assert sorted(os.listdir(os.path.join(runs, exp, "plots"))) == [
                "att_epoch1_utt0.png", "epoch1_utt0.png"], exp


# --- (4) checkpoints and weights

def test_checkpoints_resume_across_layouts(runs):
    u1 = _load(runs, "U_w1")
    tail = [s for s in u1["steps"] if (s[0], s[1]) >= (2, 2)]
    for got in (_load(runs, "R21_w1"), _load(runs, "R14_r0")):
        assert [s[:2] for s in got["steps"]] == [s[:2] for s in tail]
        for a, b in zip(got["steps"], tail):
            assert a[2] == pytest.approx(b[2], rel=1e-5)
        _jax_rule(u1["model"], got["model"], _max_update(6, 100))
    r = [_load(runs, f"R14_r{i}") for i in range(4)]
    for x in r[1:]:
        for name, v in r[0]["model"].items():
            assert torch.equal(x["model"][name], v), name


def test_checkpoint_files_do_not_depend_on_layout(runs):
    trees = {}
    for exp in ("I1", "I2"):
        ckpt = os.path.join(runs, exp, "checkpoints")
        assert sorted(os.listdir(ckpt)) == [
            "LATEST", "epoch_1.pt", "meta.json", "meta_step.json",
            "step_e2_i2.pt"]
        trees[exp] = torch.load(os.path.join(ckpt, "step_e2_i2.pt"),
                                weights_only=True)
    for part in ("model", "opt_state"):
        a, b = trees["I1"][part], trees["I2"][part]
        assert list(a) == list(b)
        assert all(a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
                   for k in a)
    run = _load(runs, "I_r0")
    for key, v in run["opt"].items():
        assert torch.equal(trees["I2"]["opt_state"][key], v), key
    _jax_rule(trees["I1"]["model"], trees["I2"]["model"],
              _max_update(5, 100))


# --- (5) refusals

def test_refusals(runs):
    got = _load(runs, "refusals_r0")
    assert got == _load(runs, "refusals_r1")
    # JAX's message, word for word (a3t_tpu/train/train_step.py:162-171)
    assert got["bucket"] == (
        "ValueError: sequence parallelism needs the frame bucket (41) to be "
        "a multiple of the seq axis (2); adjust BatcherConfig.bucket_frames")
    assert "mesh.data_parallel=2 x mesh.sequence_parallel=2 x " \
        "mesh.tensor_parallel=1 does not cover" in got["dp x sp x tp"]
    assert "sequence_parallel=3 x mesh.tensor_parallel=1 does not divide" \
        in got["sp 3"]
    # the longformer builds on both axes, also where a rank's block is
    # part of a chunk; its buckets must be multiples of the half-window x
    # dilation (JAX's message, a3t_tpu/tasks/mlm.py:343-347)
    for case in ("longformer sequence_parallel",
                 "longformer tensor_parallel", "longformer block"):
        assert got[case] is None, got[case]
    assert got["longformer bucket"] == (
        "ValueError: bucket_frames [128] not multiples of half-window x "
        "dilation 256 (required by longformer attention)")
    assert got["fs2"].startswith("NotImplementedError") and \
        "one device" in got["fs2"]
    assert got["chained"].startswith("NotImplementedError")


# --- the pieces, in this process

class _ThreadRanks:
    """sp seq ranks as threads of this process: ``parallel/sequence.py``'s
    all-gather and reduce-scatter meet on a barrier."""

    def __init__(self, sp: int):
        self.sp = sp
        self.bar = threading.Barrier(sp)
        self.slots = [None] * sp
        self.local = threading.local()

    def _meet(self, x):
        r = self.local.rank
        self.slots[r] = x
        self.bar.wait()
        got = list(self.slots)
        self.bar.wait()
        return r, got

    def gather(self, x, sp):
        return torch.cat(self._meet(x.contiguous())[1], 0)

    def scatter_sum(self, x, sp):
        r, got = self._meet(x.contiguous())
        total = functools.reduce(torch.add, got)
        n = x.shape[0] // sp
        return total[r * n:(r + 1) * n].clone()

    def run(self, fn):
        out, errs = [None] * self.sp, []

        def work(r):
            self.local.rank = r
            try:
                out[r] = fn(r)
            except BaseException as e:  # re-raised below
                errs.append(e)
                self.bar.abort()

        threads = [threading.Thread(target=work, args=(r,))
                   for r in range(self.sp)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errs:
            raise errs[0]
        return out


def _conv_modules():
    torch.manual_seed(0)
    return {
        "conv7": (layers.ConvolutionModule(16, 7), 6),
        "conv31": (layers.ConvolutionModule(16, 31), 6),
        "conv1d3": (layers.MultiLayeredConv1d(16, 24, 3), 6),
        "postnet": (layers.Postnet(16, 3, 12, 5), 0),
        "duration": (layers.DurationPredictor(16, n_chans=12), 0),
    }


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("name", ["conv7", "conv31", "conv1d3", "postnet",
                                  "duration"])
def test_convolution_halos_equal_the_whole(monkeypatch, name, sp):
    """Each time-wise convolution over sp blocks (and the text after them)
    with its halo equals the whole sequence's, rows and gradients: the
    ranks' losses (each its block's rows, the text's on rank 0 alone) sum
    to the whole one, so their parameter gradients sum to its gradient."""
    module, tail = _conv_modules()[name]
    module.eval()  # BatchNorm from running statistics (no group here)
    frames, b = 24, 2
    g = torch.Generator().manual_seed(1)
    x = torch.randn(b, frames + tail, 16, generator=g)
    w = torch.randn(b, frames + tail, 16 if name != "duration" else 1,
                    generator=g)
    group = _ThreadRanks(sp)
    monkeypatch.setattr(sequence, "_gather", group.gather)
    monkeypatch.setattr(sequence, "_scatter_sum", group.scatter_sum)

    def call(inp, seq):
        if name == "duration":
            return module(inp, None, None, seq)[..., None]
        if name.startswith("conv1d") or name == "postnet":
            return module(inp, None, seq)
        return module(inp, seq)

    params = list(module.parameters())
    whole = call(x, None)
    want = torch.autograd.grad((whole * w).sum(), params)

    def rank(r):
        seq = SeqLayout(frames, tail, r, sp)
        rows = seq.rows()
        y = call(x[:, rows].clone().requires_grad_(), seq)
        mine = torch.ones(len(rows), dtype=torch.bool)
        mine[seq.block:] = r == 0
        loss = (y * w[:, rows] * mine[None, :, None]).sum()
        return y.detach(), rows, torch.autograd.grad(loss, params)

    outs = group.run(rank)
    for y, rows, _ in outs:
        torch.testing.assert_close(y, whole.detach()[:, rows], rtol=1e-5,
                                   atol=1e-5)
    for i, p in enumerate(params):
        got = functools.reduce(torch.add, [o[2][i] for o in outs])
        torch.testing.assert_close(got, want[i], rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,flash", [
    ("legacy_rel_selfattn", True), ("legacy_rel_selfattn", False),
    ("rel_selfattn", True), ("selfattn", False)])
def test_model_forward_on_seq_ranks_equals_the_whole(monkeypatch, kind,
                                                     flash):
    """The tiny model's eval forward on 2 seq ranks (threads) equals the
    whole forward's rows, for each attention kind and both branches of the
    rel-pos attention (K1's plain version with the rank's query rows; the
    plain branch on an (Lq, Lk) score block)."""
    cfg = port_config(CFG, flash=flash)
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, selfattention_layer_type=kind),
        decoder=dataclasses.replace(cfg.decoder,
                                    selfattention_layer_type=kind))
    model = build_model(cfg, device="cpu", seed=3)
    batch = {k: torch.as_tensor(v) for k, v in
             make_batch(np.random.default_rng(4), 2, 24, 6, 20, 30).items()}
    with torch.no_grad():
        whole = model(**batch)
    group = _ThreadRanks(2)
    monkeypatch.setattr(sequence, "_gather", group.gather)
    monkeypatch.setattr(sequence, "_scatter_sum", group.scatter_sum)

    def rank(r):
        seq = SeqLayout(24, 0, r, 2)
        with torch.no_grad():
            return model(**{k: sequence.frame_block(v, seq) if k in (
                "speech", "masked_position", "speech_mask",
                "speech_segment_pos") else v for k, v in batch.items()},
                seq=seq)

    outs = group.run(rank)
    for want, got in zip(whole, zip(*outs)):
        torch.testing.assert_close(torch.cat(got, 1), want, rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("sp", [2, 4])
def test_rel_shift_rows_equal_the_full_shift(sp):
    g = torch.Generator().manual_seed(2)
    frames, tail = 24, 5
    length = frames + tail
    x = torch.randn(2, 3, length, length, generator=g)
    # the latest shift's table: 2L - 1 positions, or 2L - 2 where the
    # encoder puts the speech's and the text's tables side by side
    x2 = torch.randn(2, 3, length, 2 * length - 1 - (sp == 4),
                     generator=g)
    full, full2 = legacy_rel_shift(x), latest_rel_shift(x2)
    for r in range(sp):
        seq = SeqLayout(frames, tail, r, sp)
        n, off = seq.block, seq.offset
        speech = legacy_rel_shift_rows(x[:, :, off:off + n],
                                       x[:, :, off + n:off + n + 1], off)
        text = legacy_rel_shift_rows(x[:, :, frames:],
                                     torch.zeros(2, 3, 1, length), frames)
        assert torch.equal(torch.cat([speech, text], 2),
                           full[:, :, seq.rows()])
        got2 = torch.cat([latest_rel_shift_rows(x2[:, :, off:off + n], off),
                          latest_rel_shift_rows(x2[:, :, frames:], frames)],
                         2)
        assert torch.equal(got2, full2[:, :, seq.rows()])


@pytest.mark.parametrize("rate", [0.0, 0.2])
def test_plain_k1_k2_on_query_blocks_equal_square_rows(rate):
    """The plain K1/K2 on a seq rank's query rows (its frame block, then
    the text) equal those rows of the square call: out, lse, dq, dbias and
    the keep bits; the ranks' dk and dv, each text row's output gradient
    given to rank 0 alone, sum to the square call's."""
    b, h, frames, tail, d, sp = 3, 2, 24, 8, 16, 2
    length = frames + tail
    g = torch.Generator().manual_seed(3)
    q, k, v, go = (torch.randn(b, h, length, d, generator=g)
                   for _ in range(4))
    bias = torch.randn(b, h, length, length, generator=g)
    mask = torch.ones(b, length, dtype=torch.bool)
    mask[-1, frames - 6:frames] = False
    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 77, rate)
    want = fa.fused_attention_bwd(q, k, v, bias, mask, 77, rate, out, lse,
                                  go)
    keep = fa.keep_mask(b, h, length, 77, 0.2)
    dk = dv = 0
    for r in range(sp):
        seq = SeqLayout(frames, tail, r, sp)
        rows = seq.rows()
        assert torch.equal(fa.global_rows(len(rows), length, seq.q_rows()),
                           rows)
        assert torch.equal(fa.keep_mask(b, h, length, 77, 0.2, rows=rows),
                           keep[:, :, rows])
        qb, bb = q[:, :, rows].contiguous(), bias[:, :, rows].contiguous()
        gb = go[:, :, rows].clone()
        if r > 0:
            gb[:, :, seq.block:] = 0
        ob, lb = fa.fused_attention_fwd(qb, k, v, bb, mask, 77, rate,
                                        q_rows=seq.q_rows())
        torch.testing.assert_close(ob, out[:, :, rows], rtol=0, atol=1e-6)
        torch.testing.assert_close(lb, lse[..., rows], rtol=0, atol=1e-6)
        dq, dkb, dvb, dbias = fa.fused_attention_bwd(
            qb, k, v, bb, mask, 77, rate, ob, lb, gb, q_rows=seq.q_rows())
        own = slice(None) if r == 0 else slice(0, seq.block)
        torch.testing.assert_close(dq[:, :, own], want[0][:, :, rows][:, :, own],
                                   rtol=0, atol=1e-5)
        torch.testing.assert_close(dbias[:, :, own],
                                   want[3][:, :, rows][:, :, own],
                                   rtol=0, atol=1e-6)
        dk, dv = dk + dkb, dv + dvb
    torch.testing.assert_close(dk, want[1], rtol=0, atol=1e-5)
    torch.testing.assert_close(dv, want[2], rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="q_rows"):
        fa.fused_attention_fwd(q[:, :, :20].contiguous(), k, v,
                               bias[:, :, :20].contiguous(), mask)
