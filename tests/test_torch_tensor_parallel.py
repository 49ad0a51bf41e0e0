"""The port's model axis (Megatron tensor parallelism: ``a3t_tpu_torch/
parallel/tensor.py``, the split projections of ``parallel/sharding.py``,
K1/K2's ``head0``) on the CPU: ranks are spawned processes in a gloo
group, one intra-op thread each (``tests/torch_tp_ranks.py``), on JAX's
tiny model (tests/test_train.py:29-51: d = 32, 2 heads, 64 units, 1 + 1
blocks), held against one process on the same global batch and against
JAX's ``MeshConfig(data_parallel=1, tensor_parallel=2)`` and ``(2, 2)``
meshes.

Tolerances: against JAX, JAX's own cross-mesh rule
(tests/test_train.py:224-237): losses within rtol 1e-5, every parameter
element within 2.5 Adam updates and fewer than 0.2% of them past 1e-5 and
2e-4 of their value, BatchNorm statistics within 1e-6, every dropout rate
0 (the postnet's too).  Against one process with dropout 0.2 everywhere,
losses within 1e-5 relative and every keep-mask a rank draws equal to the
matching slice of one process's, bit for bit.
"""

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
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models.conformer import ConformerBlock, EncoderConfig
from a3t_tpu_torch.parallel import (FlatLayout, ModelShard, gather_state,
                                    param_partition_spec, shard_state)
from test_torch_mlm import make_batch, port_config
from test_torch_parallel import (CFG, FRONTEND, OPTIM, _bn, _config,
                                 _jax_rule, _multi, _tts)
from test_torch_parallel import corpus  # noqa: F401  (a fixture)
import torch_parallel_ranks as ranks
import torch_tp_ranks as tp_ranks

HERE = os.path.dirname(os.path.abspath(__file__))
FS2_CONFIG = os.path.join(HERE, "..", "configs", "fs2_conformer_24k.yaml")
ACCUM = {"accum_grad": 2, "grad_noise_eta": 0.01}
TP2 = {"mesh": {"tensor_parallel": 2}}
PLOT = {"num_plot_examples": 1}  # the plots' forward on the model axis


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jax_tp():
    """JAX's one step on the (1, 2) and (2, 2) meshes from one init, and
    its eval forward of that init: the variables, the batch, each mesh's
    loss and parameters after the step, the forward's batch and outputs."""
    postnet = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(postnet, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(CFG)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch_np = make_synthetic_batch(
            np.random.default_rng(0), batch_size=8, n_samples=64 * 40,
            n_text=8, hop_length=64, vocab_size=30, fs=8000)
        batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
        state0 = jax_create_train_state(
            model, jax_make_optimizer(JaxOptimConfig(**OPTIM)),
            jax_featurize(fe, {k: v[:2] for k, v in batch.items()},
                          use_fused=False))
        init = jax.tree_util.tree_map(np.asarray, {
            "params": state0.params, "batch_stats": state0.batch_stats})
        out = dict(init=init, batch=batch_np)
        for dp, tp in ((1, 2), (2, 2)):
            mesh = make_mesh(MeshConfig(data_parallel=dp, tensor_parallel=tp),
                             devices=jax.devices()[:dp * tp])
            state = state0.replace(
                params=shard_variables(mesh, state0.params),
                opt_state=shard_opt_state(mesh, state0.opt_state))
            step = jax_make_train_step(model, fe, mesh=mesh, donate=False)
            state, stats = step(state, jax.device_put(batch,
                                                      batch_sharding(mesh)),
                                jax.random.PRNGKey(0))
            out[(dp, tp)] = dict(loss=float(stats["loss"]), after=mlm_state(
                jax.tree_util.tree_map(np.asarray, {
                    "params": state.params,
                    "batch_stats": state.batch_stats})))
        fwd = make_batch(np.random.default_rng(3), 2, 24, 5, 20, 30)
        jb, ja, _ = model.apply(init, **{k: jnp.asarray(a)
                                         for k, a in fwd.items()})
        out["forward"] = dict(batch=fwd, before=np.asarray(jb),
                              after=np.asarray(ja))
    finally:
        jax_mlm.Postnet = postnet
    return out


@pytest.fixture(scope="module")
def runs(jax_tp, corpus, tmp_path_factory):
    """Every scenario on 2 ranks (tp = 2) and 4 ranks (dp = 2 x tp = 2),
    and its one-process reference in this process; returns the work
    directory, whose files hold the results."""
    d = str(tmp_path_factory.mktemp("tp_runs"))
    model = build_model(port_config(CFG), device="cpu")
    ranks.set_dropout(model, 0.0)
    load_state(model, mlm_state(jax_tp["init"]))
    torch.save(model.state_dict(), os.path.join(d, "init.pt"))
    torch.save({k: torch.as_tensor(v) for k, v in
                mlm_state(jax_tp["init"]).items()},
               os.path.join(d, "jax_state.pt"))
    with open(os.path.join(d, "setup.pkl"), "wb") as f:
        pickle.dump(dict(model=port_config(CFG), optim=OPTIM,
                         frontend=FRONTEND, fs2_config=FS2_CONFIG,
                         task=_config(corpus, os.path.join(d, "lf"))), f)
    np.savez(os.path.join(d, "batch.npz"), **jax_tp["batch"])
    np.savez(os.path.join(d, "forward.npz"), **jax_tp["forward"]["batch"])

    def exp(name):
        return os.path.join(d, name)

    def step(tag, **kw):
        return ("torch_tp_ranks:tp_step", dict(workdir=d, tag=tag, **kw))

    def task(tag, config, **kw):
        return ("task_run", dict(workdir=d, tag=tag, config=config, **kw))

    def tp2(config):
        return {**config, **TP2}

    remat = dict(model={"remat_attention": True}, dropout=0.2)
    ranks.spawn(2, [
        step("s", tp=2),
        step("d", tp=2, dropout=0.2, masks=True),
        step("acc", tp=2, optim=ACCUM, steps=2),
        step("remat", tp=2, **remat),
        ("torch_tp_ranks:jax_forward", dict(workdir=d, tp=2)),
        task("tts", {**tp2(_tts(corpus, exp("tts2"))), **PLOT},
             dropout=0.2),
        task("multi", tp2(_multi(corpus, exp("multi2"))), dropout=0.2),
        task("I", tp2(_config(corpus, exp("I2"))), dropout=0.0,
             stop_at=(2, 2)),
        ("torch_tp_ranks:refusals", dict(workdir=d)),
    ], d)
    # the one-process references
    tp_ranks.tp_step(d, "s")
    tp_ranks.tp_step(d, "d", dropout=0.2, masks=True)
    tp_ranks.tp_step(d, "acc", optim=ACCUM, steps=2)
    tp_ranks.tp_step(d, "remat", **remat)
    tp_ranks.jax_forward(d)
    ranks.task_run(d, "tts", {**_tts(corpus, exp("tts1")), **PLOT},
                   dropout=0.2)
    ranks.task_run(d, "multi", _multi(corpus, exp("multi1")), dropout=0.2)
    ranks.task_run(d, "U", _config(corpus, exp("U1")), dropout=0.0)
    ranks.task_run(d, "I", _config(corpus, exp("I1")), dropout=0.0,
                   stop_at=(2, 2))
    # resumes across layouts, each from a copy of an interrupted run
    shutil.copytree(exp("I2"), exp("R21"))
    shutil.copytree(exp("I1"), exp("R14"))
    ranks.task_run(d, "R21", _config(corpus, exp("R21")), dropout=0.0)
    ranks.spawn(4, [
        step("s4", tp=2),
        task("R14", tp2(_config(corpus, exp("R14"))), dropout=0.0),
    ], d)
    return d


def _load(d, tag):
    return torch.load(os.path.join(d, f"{tag}.pt"), weights_only=False)


def _max_update(steps: int = 1, warmup: int = 20) -> float:
    return 2.5 * sum(float(noam_schedule(32, warmup, 1.0)(k))
                     for k in range(steps))


# --- (1) one step at tp = 2 and dp = 2 x tp = 2 against JAX's meshes and
# one process, dropout 0

@pytest.mark.parametrize("tag,world,mesh", [("s", 2, (1, 2)),
                                            ("s4", 4, (2, 2))])
def test_step_equals_jax_mesh_and_one_process(runs, jax_tp, tag, world,
                                              mesh):
    got = [_load(runs, f"{tag}_r{r}") for r in range(world)]
    w1 = _load(runs, "s_w1")
    for key in ("loss", "loss_mlm", "masked_frames", "grad_norm"):
        assert all(torch.equal(x["stats"][0][key], got[0]["stats"][0][key])
                   for x in got), key
    loss = float(got[0]["stats"][0]["loss"])
    assert loss == pytest.approx(float(w1["stats"][0]["loss"]), rel=1e-5)
    assert loss == pytest.approx(jax_tp[mesh]["loss"], rel=1e-5)
    assert float(got[0]["stats"][0]["grad_norm"]) == pytest.approx(
        float(w1["stats"][0]["grad_norm"]), rel=1e-5)
    for want in (w1["model"], jax_tp[mesh]["after"]):
        want = {k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}
        _jax_rule(want, got[0]["model"], _max_update())
        for name, v in _bn(want).items():
            np.testing.assert_allclose(got[0]["model"][name].numpy(),
                                       v.numpy(), rtol=0, atol=1e-6,
                                       err_msg=name)
    # every rank holds one model, gathered
    for x in got:
        for name, v in got[0]["model"].items():
            assert torch.equal(x["model"][name], v), name
    # each rank holds its slice: the split projections halve
    n = w1["n_params"]
    split = sum(v.numel() for k, v in w1["model"].items()
                if param_partition_spec(k) is not None)
    assert got[0]["n_params"] == got[1]["n_params"] == n - split // 2


# --- (2) tp = 2 against one process with dropout on: the masks are the
# slices of one process's

def _matches(full: torch.Tensor, part: torch.Tensor, t: int) -> bool:
    if full.shape == part.shape:
        return torch.equal(full, part)
    dims = [i for i, (a, b) in enumerate(zip(full.shape, part.shape))
            if a != b]
    assert len(dims) == 1 and full.shape[dims[0]] == 2 * part.shape[dims[0]]
    n = part.shape[dims[0]]
    return torch.equal(full.narrow(dims[0], t * n, n), part)


def test_dropout_masks_are_one_process_slices(runs):
    w1 = _load(runs, "d_w1")
    kinds = {s for s, _ in w1["masks"]}
    assert kinds == {"byte", "attention"}
    for t in range(2):
        got = _load(runs, f"d_r{t}")
        rel = abs(float(got["stats"][0]["loss"])
                  / float(w1["stats"][0]["loss"]) - 1)
        assert rel <= 1e-5, rel
        assert [s for s, _ in got["masks"]] == [s for s, _ in w1["masks"]]
        split = 0
        for i, ((site, want), (_, have)) in enumerate(zip(w1["masks"],
                                                          got["masks"])):
            assert _matches(want, have, t), (t, i, site)
            split += want.shape != have.shape
        # the attention's heads and both feed-forwards' hidden units, in
        # the forward and again in the backward
        assert split >= 2 * 3 * 2, split
    _jax_rule(w1["model"], _load(runs, "d_r0")["model"], _max_update())


# --- (3) the other steps at tp = 2 against one process

@pytest.mark.parametrize("tag", ["acc", "remat"])
def test_steps_equal_one_process(runs, tag):
    w1, r0, r1 = (_load(runs, f"{tag}_{s}") for s in ("w1", "r0", "r1"))
    assert len(r0["stats"]) == len(w1["stats"])
    for a, b, c in zip(r0["stats"], r1["stats"], w1["stats"]):
        for key in ("loss", "grad_norm"):
            assert torch.equal(a[key], b[key])
            assert float(a[key]) == pytest.approx(float(c[key]), rel=1e-5)
    _jax_rule(w1["model"], r0["model"], _max_update(len(w1["stats"])))
    for key in ("mu", "nu"):
        np.testing.assert_allclose(
            r0["opt"][key].numpy(), w1["opt"][key].numpy(), rtol=1e-5,
            atol=1e-5 * float(w1["opt"][key].abs().max()))
    for key in ("count", "mini_step", "gradient_step"):
        assert torch.equal(r0["opt"][key], w1["opt"][key]), key


@pytest.mark.parametrize("tag", ["tts", "multi"])
def test_task_runs_equal_one_process(runs, tag):
    w1, r0, r1 = (_load(runs, f"{tag}_{s}") for s in ("w1", "r0", "r1"))
    assert r0["buckets"] == w1["buckets"]
    # the model axis's ranks step on the whole batches
    assert [s[:2] + s[3:] for s in r0["steps"]] == \
        [s[:2] + s[3:] for s in w1["steps"]]
    for a, b, c in zip(r0["steps"], r1["steps"], w1["steps"]):
        assert a[2] == b[2]
        assert a[2] == pytest.approx(c[2], rel=1e-5)
    n_steps = len(w1["steps"])
    _jax_rule(w1["model"], r0["model"], _max_update(n_steps, 100))
    for name, v in r0["model"].items():
        assert torch.equal(v, r1["model"][name]), name
    if tag == "tts":  # rank 0 rendered the plots, every head's attention
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
    # the four ranks end on one state
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
    # the step's state is the layout's within JAX's rule: the written
    # gathered state is the ranks' state
    run = _load(runs, "I_r0")
    for key, v in run["opt"].items():
        assert torch.equal(trees["I2"]["opt_state"][key], v), key
    _jax_rule(trees["I1"]["model"], trees["I2"]["model"],
              _max_update(5, 100))


def test_shard_then_gather_is_the_identity():
    cfg = port_config(CFG)
    state = build_model(cfg, device="cpu", seed=4).state_dict()
    parts = [shard_state(state, t, 2) for t in range(2)]
    back = gather_state(parts)
    assert list(back) == list(state)
    for k, v in state.items():
        assert torch.equal(back[k], v), k
    # the rank's model takes exactly its slices
    for t in range(2):
        net = build_model(cfg, device="cpu", seed=4, shard=ModelShard(t, 2))
        own = net.state_dict()
        assert list(own) == list(parts[t])
        for k, v in own.items():
            assert torch.equal(v, parts[t][k]), k
    assert shard_state(state, 0, 1) is state
    # the flat layout's slices put the full vector back together
    full = torch.cat([v.reshape(-1) for k, v in
                      build_model(cfg, device="cpu", seed=4)
                      .named_parameters()])
    nets = [build_model(cfg, device="cpu", seed=4, shard=ModelShard(t, 2))
            for t in range(2)]
    layouts = [FlatLayout.of(n) for n in nets]
    locs = [torch.cat([p.reshape(-1) for p in n.parameters()])
            for n in nets]
    for t in range(2):
        assert torch.equal(layouts[t].local_of(full), locs[t])
    assert torch.equal(layouts[0].full_of(locs), full)


def test_jax_parameters_on_each_rank_give_the_jax_forward(runs, jax_tp):
    want = jax_tp["forward"]
    for tag in ("forward_w1", "forward_r0", "forward_r1"):
        got = _load(runs, tag)
        np.testing.assert_allclose(got["before"].numpy(), want["before"],
                                   atol=1e-4, err_msg=tag)
        np.testing.assert_allclose(got["after"].numpy(), want["after"],
                                   atol=1e-4, err_msg=tag)


# --- (5) refusals

def test_refusals(runs):
    got = _load(runs, "refusals_r0")
    assert got == _load(runs, "refusals_r1")
    assert "mesh.data_parallel=2 x mesh.tensor_parallel=2" in got["dp x tp"]
    assert "tensor_parallel=3 does not divide" in got["tp 3"]
    assert got["heads"].startswith("ValueError") and \
        "attention_heads=3" in got["heads"]
    assert got["longformer"] is None  # the longformer builds at tp = 2
    assert got["fs2"].startswith("NotImplementedError") and \
        "one device" in got["fs2"]
    assert got["chained"].startswith("NotImplementedError")
    # the same checks without a group: a tp that does not divide the
    # heads raises for every kind, and the longformer splits its heads
    for kind in ("longformer", "legacy_rel_selfattn"):
        enc = EncoderConfig(attention_dim=32, attention_heads=2,
                            linear_units=64, selfattention_layer_type=kind,
                            attention_window=8)
        with pytest.raises(ValueError):
            enc.check_supported(3)
        with pytest.raises(ValueError):
            ConformerBlock(enc, ModelShard(0, 3))
        enc.check_supported(2)
        block = ConformerBlock(enc, ModelShard(1, 2))
        assert (block.self_attn.h, block.self_attn.head0) == (1, 1)
        assert tuple(block.self_attn.linear_q.weight.shape) == (16, 32)


# --- K1/K2's head0 on the CPU (their plain versions) and K1's grid on one
# head

def test_head0_selects_the_global_heads_lanes():
    from a3t_tpu_torch.ops import fused_attention as fa

    b, l, d = 3, 40, 16
    g = torch.Generator().manual_seed(5)
    both = fa.keep_mask(b, 2, l, 99, 0.2)
    assert torch.equal(fa.keep_mask(b, 1, l, 99, 0.2, head0=1), both[:, 1:])
    assert torch.equal(fa.keep_mask(b, 1, l, 99, 0.2), both[:, :1])
    q, k, v, go = (torch.randn(b, 2, l, d, generator=g) for _ in range(4))
    bias = torch.randn(b, 2, l, l, generator=g)
    mask = torch.ones(b, l, dtype=torch.bool)
    mask[-1, 30:] = False
    out, lse = fa.fused_attention_fwd(q, k, v, bias, mask, 99, 0.2)
    grads = fa.fused_attention_bwd(q, k, v, bias, mask, 99, 0.2, out, lse,
                                   go)
    one = [x[:, 1:].contiguous() for x in (q, k, v, bias)]
    out1, lse1 = fa.fused_attention_fwd(*one, mask, 99, 0.2, head0=1)
    assert torch.equal(out1, out[:, 1:]) and torch.equal(lse1, lse[:, 1:])
    grads1 = fa.fused_attention_bwd(*one, mask, 99, 0.2, out1, lse1,
                                    go[:, 1:].contiguous(), head0=1)
    for a, w in zip(grads1, grads):
        assert torch.equal(a, w[:, 1:])
    with pytest.raises(ValueError, match="head0"):
        fa.fused_attention_fwd(*one, mask, 99, 0.2, head0=4096)


@pytest.mark.parametrize("b,l", [(16, 264), (8, 520), (73, 264), (88, 496)])
def test_k1_grid_fills_the_card_on_one_head(b, l):
    """A model-axis rank calls K1 on one head: where the row tiles do not
    fill the 132 multiprocessors, the keys split until they do."""
    from a3t_tpu_torch.ops import fused_attention as fa

    for rows in (fa.ROW_TILE, fa.ROW_TILE_BF16):
        splits, kps = fa._fwd_plan(b, 1, l, 132, rows)
        assert b * -(-l // rows) * splits >= 132, (rows, splits, kps)
        assert splits == 1 or (kps % fa.SPLIT_UNIT == 0
                               and (splits - 1) * kps < l)
