"""The longformer on the port's seq and model axes (``models/
windowed_attention.py`` with a ``seq`` layout and a ``ModelShard``, the
banded kernels' place: ``head0``, ``heads`` and ``chunks`` with halo
chunks, ``ops/banded_attention.py``) on the CPU.  Ranks are spawned
processes in a gloo group, one intra-op thread each
(``tests/torch_sp_ranks.py``), on JAX's tiny longformer
(tests/test_train.py:240-290: d = 32, 2 heads, window 16, 1 + 1 blocks)
at 128 frames and 8 phones, and at 96 frames with window 64 (c = 32: a
rank's block of 48 frames at sp = 2 straddles a chunk edge, one of 24 at
sp = 4 is smaller than a chunk) and with window 32 and dilation 2 (c x d
= 32, 24 frames a rank at sp = 4).

* The chunked path (``use_pallas_attention: false``, the path JAX takes
  off the TPU) at 1 x 4 x 1, 2 x 2 x 1 and 1 x 1 x 2, and at 96 frames at
  1 x 2 x 1 and 1 x 4 x 1 (window 64) and 1 x 4 x 1 (window 32, dilation
  2), against JAX's ``MeshConfig`` meshes of the same shape, JAX's one
  device and the port's one process, every dropout rate 0: losses within
  rtol 1e-5, the parameters after the step by JAX's cross-mesh rule
  (tests/test_train.py:216-237).
* The banded path (the plain K3-K5) at 1 x 4 x 1 and 1 x 2 x 2 and with
  dilation 2 at 1 x 4 x 1, and at those 96-frame layouts, every dropout
  site at 0.2, against the port's one process: losses within 1e-5
  relative, every keep-mask a rank draws equal to its rows (and heads, and
  its covering chunks) of one process's, bit for bit.
* ROADMAP C1: a batch whose second row is padding past frame 50, so that
  the blocks of seq ranks 2 and 3 of 4 hold padding alone there (the
  pre-encoder has no text, so their query rows see no valid key, while
  rank 2's first chunk reads rank 1's real keys through its halo), also at
  96 frames with window 64 (24-frame blocks in chunks of 32): the loss,
  grad_norm and parameters of both paths as one process's.
* In this process: the plain K3/K4/K5 on the chunks that cover a rank's
  block (whole chunks, blocks that straddle a chunk edge, blocks smaller
  than a chunk) with halos and on one head equal the whole call's rows,
  the ranks' K5 halo rows summed back to their owners equal the whole
  call's dk and dv; the band halo equals the whole tensor's neighbours
  (also past the nearest block) and returns its gradient to them; JAX's
  two rules' messages; the windowed module on thread ranks at blocks that
  are not whole chunks or not multiples of the dilation; the windowed
  module's slices on the model axis; the pre-encoder and the joint
  encoder on seq ranks (threads).
"""

import concurrent.futures
import dataclasses
import functools
import os
import pickle

import numpy as np
import pytest
import torch
import jax

from a3t_tpu.data import make_synthetic_batch
from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.models import A3TModelConfig as JaxA3TModelConfig
from a3t_tpu.models import EncoderConfig as JaxEncoderConfig
from a3t_tpu.models import mlm as jax_mlm
from a3t_tpu.parallel import MeshConfig, make_mesh, shard_opt_state
from a3t_tpu.parallel import shard_variables
from a3t_tpu.parallel.mesh import batch_sharding
from a3t_tpu.train import make_train_step as jax_make_train_step
from a3t_tpu.train.train_step import featurize as jax_featurize
from a3t_tpu_torch.compat.from_jax import load_state, mlm_state
from a3t_tpu_torch.models import build_model
from a3t_tpu_torch.models.windowed_attention import WindowedSelfAttention
from a3t_tpu_torch.ops import banded_attention as ba
from a3t_tpu_torch.parallel import sequence
from a3t_tpu_torch.parallel.sequence import SeqLayout
from test_torch_mlm import port_config
from test_torch_parallel import FRONTEND, OPTIM, _jax_rule
from test_torch_seq_parallel import _ThreadRanks, _jax_state, _load
from test_torch_seq_parallel import _max_update
import torch_parallel_ranks as ranks
import torch_sp_ranks as sp_ranks

HOP = 64
FRAMES = 128
# JAX's tiny longformer (tests/test_train.py:250-262), every dropout rate 0
STACK = dict(attention_dim=32, attention_heads=2, linear_units=64,
             num_blocks=1, selfattention_layer_type="longformer",
             attention_window=16, dropout_rate=0.0,
             positional_dropout_rate=0.0, attention_dropout_rate=0.0)
LF = JaxA3TModelConfig(odim=20, vocab_size=30,
                       encoder=JaxEncoderConfig(**STACK, cnn_module_kernel=7),
                       decoder=JaxEncoderConfig(**STACK), postnet_layers=2,
                       postnet_chans=16)
CHUNKED = {"use_pallas_attention": False}
BANDED = {"use_pallas_attention": True}
MESHES = ((1, 4, 1), (2, 2, 1), (1, 1, 2))
# 96 frames: blocks that are not whole chunks of half-window x dilation
# (frames, the fields over STACK, JAX's meshes)
FRAMES96 = 96
WIDE = {"w64": (dict(attention_window=64), ((1, 2, 1), (1, 4, 1))),
        "w32": (dict(attention_window=32, attention_dilation=2),
                ((1, 4, 1),))}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _c1_batch(batch: dict) -> dict:
    """``batch`` with its second row cut to 50 frames: padding fills the
    blocks of seq ranks 2 and 3 of 4 there (of 128 frames; of 96, rank 3's
    and all but 2 frames of rank 2's)."""
    out = {k: v.copy() for k, v in batch.items()}
    out["audio_lengths"][1] = HOP * 49
    out["masked_position"][1, 50:] = False
    out["speech_segment_pos"][1, 50:] = 0
    return out


@pytest.fixture(scope="module")
def jax_init():
    """JAX's tiny longformer (its postnet's dropout 0 for the module's
    life) from one init: the front-end, the initial state, its variables
    and the batches of FRAMES and FRAMES96 frames."""
    saved = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(saved, dropout_rate=0.0)
    try:
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batches = {n: make_synthetic_batch(
            np.random.default_rng(11), batch_size=2, n_samples=HOP * (n - 1),
            n_text=8, hop_length=HOP, vocab_size=30, fs=8000)
            for n in (FRAMES, FRAMES96)}
        state0 = _jax_state(jax_mlm.A3TMLMModel(LF), OPTIM, jax_featurize(
            fe, {k: jax.numpy.asarray(v) for k, v in batches[FRAMES].items()},
            use_fused=False))
        yield dict(fe=fe, state0=state0, batches=batches,
                   init=jax.tree_util.tree_map(np.asarray, {
                       "params": state0.params,
                       "batch_stats": state0.batch_stats}))
    finally:
        jax_mlm.Postnet = saved


@pytest.fixture(scope="module")
def started(jax_init, tmp_path_factory):
    """Every scenario on 4 ranks (and on 2), and the one-process
    references in a thread of this process, started in the background from
    JAX's init (so that JAX's steps, :func:`jax_lf`, run meanwhile): the
    work directory, whose files hold the results, and the futures."""
    d = str(tmp_path_factory.mktemp("lf_runs"))
    model = build_model(port_config(LF), device="cpu")
    ranks.set_dropout(model, 0.0)
    load_state(model, mlm_state(jax_init["init"]))
    torch.save(model.state_dict(), os.path.join(d, "init.pt"))
    with open(os.path.join(d, "setup.pkl"), "wb") as f:
        pickle.dump(dict(model=port_config(LF), optim=OPTIM,
                         frontend=FRONTEND), f)
    batch, batch96 = (jax_init["batches"][n] for n in (FRAMES, FRAMES96))
    np.savez(os.path.join(d, "batch.npz"), **batch)
    np.savez(os.path.join(d, "c1.npz"), **_c1_batch(batch))
    np.savez(os.path.join(d, "b96.npz"), **batch96)
    np.savez(os.path.join(d, "c1_96.npz"), **_c1_batch(batch96))

    def step(tag, **kw):
        return ("torch_sp_ranks:sp_step", dict(workdir=d, tag=tag, **kw))

    drop = dict(dropout=0.2)
    dil = {**BANDED, "attention_dilation": 2}
    # the 96-frame models through each path: tag, model fields, options
    wide = [(f"{name}{kind}", {**path, **WIDE[name][0]},
             dict(batch="b96.npz", **(dict(masks=True, **drop)
                                      if kind == "b" else {})))
            for name in WIDE for kind, path in (("c", CHUNKED),
                                                ("b", BANDED))]
    w64 = {tag: (m, kw) for tag, m, kw in wide if tag.startswith("w64")}
    c1_96 = dict(batch="c1_96.npz", **drop)

    def one_process():
        sp_ranks.sp_step(d, "c", model=CHUNKED)
        sp_ranks.sp_step(d, "b", model=BANDED, masks=True, **drop)
        sp_ranks.sp_step(d, "dil", model=dil, masks=True, **drop)
        sp_ranks.sp_step(d, "pb", model=BANDED, batch="c1.npz", **drop)
        sp_ranks.sp_step(d, "pc", model=CHUNKED, batch="c1.npz", **drop)
        for tag, m, kw in wide:
            sp_ranks.sp_step(d, tag, model=m, **kw)
        for kind in "bc":
            sp_ranks.sp_step(d, f"w64p{kind}", model=w64[f"w64{kind}"][0],
                             **c1_96)

    pool = concurrent.futures.ThreadPoolExecutor(3)
    futures = [pool.submit(ranks.spawn, 4, [
        step("c4", sp=4, model=CHUNKED),
        step("c22", sp=2, model=CHUNKED),
        step("b4", sp=4, model=BANDED, masks=True, **drop),
        step("b22", sp=2, tp=2, model=BANDED, masks=True, **drop),
        step("dil", sp=4, model=dil, masks=True, **drop),
        step("pb", sp=4, model=BANDED, batch="c1.npz", **drop),
        step("pc", sp=4, model=CHUNKED, batch="c1.npz", **drop),
        *[step(f"{tag}4", sp=4, model=m, **kw) for tag, m, kw in wide],
        *[step(f"w64p{kind}", sp=4, model=w64[f"w64{kind}"][0], **c1_96)
          for kind in "bc"],
    ], d), pool.submit(ranks.spawn, 2, [
        step("c12", tp=2, model=CHUNKED),
        *[step(f"{tag}2", sp=2, model=m, **kw)
          for tag, (m, kw) in w64.items()],
    ], d), pool.submit(one_process)]
    pool.shutdown(wait=False)
    return d, futures


@pytest.fixture(scope="module")
def jax_lf(jax_init, started):
    """JAX's one step of the tiny longformer (the chunked einsums, as JAX
    runs it off the TPU) on one device and on each of MESHES, from one
    init, by mesh: the loss and the parameters after the step; and, from
    the same variables (the window and the dilation shape no parameter),
    each of WIDE's models at FRAMES96 frames on one device and on its
    meshes, under (name, dp, sp, tp).  It runs while the port's scenarios
    (``started``) do."""
    fe, state0 = jax_init["fe"], jax_init["state0"]
    cases = [(None, LF, FRAMES, m) for m in ((1, 1, 1),) + MESHES]
    for name, (over, meshes) in WIDE.items():
        cfg = dataclasses.replace(
            LF, encoder=dataclasses.replace(LF.encoder, **over),
            decoder=dataclasses.replace(LF.decoder, **over))
        cases += [(name, cfg, FRAMES96, m) for m in ((1, 1, 1),) + meshes]

    def one(case):
        name, cfg, frames, (dp, sp, tp) = case
        batch = {k: jax.numpy.asarray(v)
                 for k, v in jax_init["batches"][frames].items()}
        mesh = make_mesh(MeshConfig(data_parallel=dp, sequence_parallel=sp,
                                    tensor_parallel=tp),
                         devices=jax.devices()[:dp * sp * tp])
        state = state0.replace(
            params=shard_variables(mesh, state0.params),
            opt_state=shard_opt_state(mesh, state0.opt_state))
        state, stats = jax_make_train_step(
            jax_mlm.A3TMLMModel(cfg), fe, mesh=mesh, donate=False)(
            state, jax.device_put(batch, batch_sharding(mesh)),
            jax.random.PRNGKey(0))
        key = (dp, sp, tp) if name is None else (name, dp, sp, tp)
        return key, dict(loss=float(stats["loss"]), after=mlm_state(
            jax.tree_util.tree_map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats})))

    # three compiles at a time: XLA compiles outside the interpreter's lock
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        return dict(pool.map(one, cases))


@pytest.fixture(scope="module")
def runs(started, jax_lf):
    """The work directory of ``started``, once every scenario is done."""
    d, futures = started
    for f in futures:
        f.result()
    return d


# --- (1) the chunked path against JAX's meshes and one process, dropout 0

@pytest.mark.parametrize("tag,mesh", [("c4", (1, 4, 1)), ("c22", (2, 2, 1)),
                                      ("c12", (1, 1, 2)),
                                      ("w64c2", (1, 2, 1)),
                                      ("w64c4", (1, 4, 1)),
                                      ("w32c4", (1, 4, 1))])
def test_chunked_step_equals_jax_mesh(runs, jax_lf, tag, mesh):
    """The 96-frame tags (w64c*, w32c*) hold JAX's model of their own
    window and dilation on their mesh and on one device."""
    dp, sp, tp = mesh
    got = [_load(runs, f"{tag}_r{r}") for r in range(dp * sp * tp)]
    name = tag[:3] if tag[:3] in WIDE else None
    w1 = _load(runs, f"{name}c_w1" if name else "c_w1")
    if name:
        jax_lf = {m: jax_lf[(name, *m)] for m in ((1, 1, 1), mesh)}
    # rank r is seq rank (r // tp) % sp, model rank r % tp
    assert [(x["seq"], x["model_axis"]) for x in got] == [
        (((r // tp) % sp, sp), (r % tp, tp)) for r in range(dp * sp * tp)]
    for key in ("loss", "loss_mlm", "masked_frames", "grad_norm"):
        assert all(torch.equal(x["stats"][0][key], got[0]["stats"][0][key])
                   for x in got), key
    loss = float(got[0]["stats"][0]["loss"])
    assert loss == pytest.approx(jax_lf[mesh]["loss"], rel=1e-5)
    assert loss == pytest.approx(jax_lf[(1, 1, 1)]["loss"], rel=1e-5)
    assert loss == pytest.approx(float(w1["stats"][0]["loss"]), rel=1e-5)
    for want in (jax_lf[mesh]["after"], w1["model"]):
        want = {k: torch.as_tensor(np.asarray(v)) for k, v in want.items()}
        _jax_rule(want, got[0]["model"], _max_update())
    for x in got:
        for name, v in got[0]["model"].items():
            assert torch.equal(x["model"][name], v), name


# --- (2) the banded path against one process with dropout on: every
# keep-mask a rank draws is its rows (and heads) of one process's

def _model_dim(n: int) -> bool:
    """Whether the model axis splits a mask's dimension of ``n``: the
    heads' (2) and the feed-forwards' hidden units' (64); every other
    dimension that differs is the seq axis's (frames, [frames ; text],
    query chunks)."""
    return n in (STACK["attention_heads"], STACK["linear_units"])


def _rank_part(full, part, s: int, sp: int, t: int, tp: int, frames: int):
    """Seq rank s and model rank t's part of one process's mask ``full``:
    along a split of the model axis the t-th of tp slices; along the seq
    axis, on a dimension of ``frames`` or frames and text, the rank's block
    and the rows after the frames, and on one of n query chunks (of frames
    / n each, over every phase) the chunks that cover the rank's block."""
    out = full
    block = frames // sp
    for dim, (n, m) in enumerate(zip(full.shape, part.shape)):
        if n == m:
            continue
        if tp > 1 and _model_dim(n):
            out = out.narrow(dim, t * m, m)
        elif n >= frames:
            rows = torch.cat([torch.arange(s * block, (s + 1) * block),
                              torch.arange(frames, n)])
            out = out.index_select(dim, rows)
        else:
            unit = frames // n
            lo, hi = s * block // unit, -(-(s + 1) * block // unit)
            out = out.narrow(dim, lo, hi - lo)
    return out


@pytest.mark.parametrize("tag,ref,world", [("b4", "b", 4), ("b22", "b", 4),
                                           ("dil", "dil", 4),
                                           ("w64b2", "w64b", 2),
                                           ("w64b4", "w64b", 4),
                                           ("w32b4", "w32b", 4)])
def test_banded_masks_are_one_process_rows(runs, tag, ref, world):
    frames = FRAMES96 if tag[:3] in WIDE else FRAMES
    w1 = _load(runs, f"{ref}_w1")
    assert {s for s, _ in w1["masks"]} == {"byte", "banded"}
    for r in range(world):
        got = _load(runs, f"{tag}_r{r}")
        (s, sp), (t, tp) = got["seq"], got["model_axis"]
        rel = abs(float(got["stats"][0]["loss"])
                  / float(w1["stats"][0]["loss"]) - 1)
        assert rel <= 1e-5, rel
        assert [k for k, _ in got["masks"]] == [k for k, _ in w1["masks"]]
        split = set()
        for i, ((site, want), (_, have)) in enumerate(zip(w1["masks"],
                                                          got["masks"])):
            assert torch.equal(_rank_part(want, have, s, sp, t, tp,
                                          frames), have), (r, i, site)
            if want.shape != have.shape:
                split.add(site)
        # K3/K4's band and text draws and the byte masks are split
        assert split == {"byte", "banded"}, split
    _jax_rule(w1["model"], _load(runs, f"{tag}_r0")["model"], _max_update())


# --- (3) ROADMAP C1: a rank whose block holds padding alone on a row

@pytest.mark.parametrize("tag", ["pb", "pc", "w64pb", "w64pc"])
def test_padded_block_equals_one_process(runs, tag):
    w1 = _load(runs, f"{tag}_w1")
    got = [_load(runs, f"{tag}_r{r}") for r in range(4)]
    for key in ("loss", "grad_norm"):
        assert all(torch.equal(x["stats"][0][key], got[0]["stats"][0][key])
                   for x in got), key
        assert float(got[0]["stats"][0][key]) == pytest.approx(
            float(w1["stats"][0][key]), rel=1e-5), key
    assert bool(torch.isfinite(got[0]["stats"][0]["grad_norm"]))
    _jax_rule(w1["model"], got[0]["model"], _max_update())


# --- (4) the pieces, in this process

def _band_case(seed: int = 0, tt: int = 6, t: int = 32):
    g = torch.Generator().manual_seed(seed)
    b, h, d = 2, 2, 8
    q, k, v, go = (torch.randn(b, h, t, d, generator=g) for _ in range(4))
    kt, vt = (torch.randn(b, h, tt, d, generator=g) for _ in range(2))
    txm = torch.ones(b, tt, dtype=torch.int32)
    txm[1, -2:] = 0
    if tt and seed:  # no valid text: rows 12.. of row 0 see no key
        txm[:] = 0
    spm = torch.ones(b, t, dtype=torch.int32)
    spm[0, 12:] = 0
    return q, k, v, kt, vt, go, txm, spm


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("sp", [2, 4, 8, 12, 16])
def test_plain_banded_on_blocks_equal_whole_rows(sp, rate, seed):
    """The plain K3/K4/K5 on the chunks that cover seq rank s's block of
    48 rows in chunks of 4 (whole chunks at sp = 2, 4 and 12; at sp = 8 a
    block of 6 straddles a chunk edge, at sp = 16 one of 3 is smaller than
    a chunk, so two ranks compute one chunk), with one halo chunk on each
    side (a phantom at a global edge), and on head 1 alone (head0 = 1 of
    2), equal the whole call's rows on the rank's own rows: out, lse, dq
    within 1e-6 (dq also 1e-6 relative), with the output gradient zero on
    the cover's other rows, whose dq is then zero; the ranks' dk and dv,
    each halo row added to its owner's, and their text gradients summed,
    the whole call's; phantom halo rows get zeros.  Seed 1 has no valid
    text, so its padded rows see no key at all."""
    window, c = 8, 4
    q, k, v, kt, vt, go, txm, spm = _band_case(seed, t=48)
    b, h, t, d = q.shape
    nc = t // c
    fwd = (window, 7, rate)
    out, lse = ba.banded_attention_reference(q, k, v, kt, vt, txm, spm, *fwd)
    delta = (go * out).sum(-1)
    bwd = (7, rate, go, lse, delta)
    dq, dkt, dvt = ba.banded_attention_bwd_dq_reference(
        q, k, v, kt, vt, txm, spm, window, *bwd)
    dk, dv = ba.banded_attention_bwd_dkv_reference(q, k, v, spm, window,
                                                   *bwd)
    # K, V and the mask with a phantom chunk of zeros past each edge
    kp, vp = (torch.nn.functional.pad(x, (0, 0, c, c)) for x in (k, v))
    mp = torch.nn.functional.pad(spm, (c, c))
    blk = t // sp
    sums = [torch.zeros(b, h, t + 2 * c, d) for _ in range(4)]
    for s in range(sp):
        lo, hi = s * blk // c * c, -(-(s + 1) * blk // c) * c
        own = slice(s * blk - lo, s * blk - lo + blk)
        rows = slice(s * blk, (s + 1) * blk)
        for h0 in range(h):
            hh = slice(h0, h0 + 1)
            a = (q[:, hh, lo:hi], kp[:, hh, lo:hi + 2 * c],
                 vp[:, hh, lo:hi + 2 * c], kt[:, hh], vt[:, hh], txm,
                 mp[:, lo:hi + 2 * c])
            at = dict(head0=h0, heads=h, chunks=(lo // c, nc))
            o, lo_ = ba.banded_attention_reference(*a, *fwd, **at)
            torch.testing.assert_close(o[:, :, own], out[:, hh, rows],
                                       rtol=0, atol=1e-6)
            torch.testing.assert_close(lo_[:, :, own], lse[:, hh, rows],
                                       rtol=0, atol=1e-6)
            g1 = torch.zeros_like(o)
            g1[:, :, own] = go[:, hh, rows]
            bw = (7, rate, g1, lo_, (g1 * o).sum(-1))
            dq1, dkt1, dvt1 = ba.banded_attention_bwd_dq_reference(
                *a, window, *bw, **at)
            torch.testing.assert_close(dq1[:, :, own], dq[:, hh, rows],
                                       rtol=1e-6, atol=1e-6)
            assert not dq1[:, :, :own.start].any()
            assert not dq1[:, :, own.stop:].any()
            dk1, dv1 = ba.banded_attention_bwd_dkv_reference(
                a[0], a[1], a[2], a[6], window, *bw, **at)
            sums[0][:, hh, lo:hi + 2 * c] += dk1
            sums[1][:, hh, lo:hi + 2 * c] += dv1
            sums[2][:, hh, :kt.shape[2]] += dkt1
            sums[3][:, hh, :kt.shape[2]] += dvt1
    for x in sums[:2]:
        assert not x[:, :, :c].any() and not x[:, :, -c:].any()
    torch.testing.assert_close(sums[0][:, :, c:-c], dk, rtol=0, atol=1e-5)
    torch.testing.assert_close(sums[1][:, :, c:-c], dv, rtol=0, atol=1e-5)
    torch.testing.assert_close(sums[2][:, :, :kt.shape[2]], dkt, rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(sums[3][:, :, :kt.shape[2]], dvt, rtol=0,
                               atol=1e-5)


def test_banded_lanes_and_place_checks():
    """band_keep at a place draws one process's bits for those heads and
    chunks; a place outside the whole call raises."""
    b, h, nc, c = 2, 2, 8, 4
    whole = ba.band_keep(b, h, nc, c, 99, 0.2)
    text = ba.text_keep(b, h, nc, c, 5, 99, 0.2)
    for h0, c0, n in ((1, 2, 3), (0, 0, 4), (1, 5, 3)):
        pl = ba.Place(h0, h, c0, nc)
        assert torch.equal(ba.band_keep(b, 1, n, c, 99, 0.2, place=pl),
                           whole[:, h0:h0 + 1, c0:c0 + n])
        assert torch.equal(ba.text_keep(b, 1, n, c, 5, 99, 0.2, place=pl),
                           text[:, h0:h0 + 1, c0:c0 + n])
    q = torch.zeros(1, 1, 8, 4)
    k = torch.zeros(1, 1, 16, 4)
    kt = torch.zeros(1, 1, 2, 4)
    txm = torch.ones(1, 2, dtype=torch.bool)
    with pytest.raises(ValueError, match="head0"):
        ba.banded_attention(q, k, k, kt, kt, txm, 8, head0=2, heads=2,
                            chunks=(0, 4))
    with pytest.raises(ValueError, match="chunks"):
        ba.banded_attention(q, k, k, kt, kt, txm, 8, chunks=(3, 4))
    with pytest.raises(ValueError, match="rows"):
        ba.banded_attention(q, q, q, kt, kt, txm, 8, chunks=(0, 4))


@pytest.mark.parametrize("sp", [2, 4, 16])
def test_band_halo_equals_whole_neighbours(monkeypatch, sp):
    """The band halo (``halo_pad`` over the frames alone, as the windowed
    module takes it) on sp ranks (threads) gives each block with c rows of
    its neighbours, zeros past the global edges (at sp = 16 blocks of 2
    rows, so that c = 4 rows reach past the nearest block), and its
    backward returns each halo row's gradient to its owner: the ranks'
    input gradients are the whole padded tensor's gradient folded back."""
    frames, c = 32, 4
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, frames, 3, generator=g)
    w = torch.randn(2, frames + 2 * c, 3, generator=g)
    padded = torch.nn.functional.pad(x, (0, 0, c, c))
    group = _ThreadRanks(sp)
    monkeypatch.setattr(sequence, "_gather", group.gather)
    monkeypatch.setattr(sequence, "_scatter_sum", group.scatter_sum)

    def rank(r):
        seq = SeqLayout(frames, 0, r, sp)
        xb = x[:, seq.offset:seq.offset + seq.block].clone().requires_grad_()
        y = sequence.halo_pad(xb, c, seq.speech(), 1)
        wb = w[:, seq.offset:seq.offset + seq.block + 2 * c]
        (gx,) = torch.autograd.grad((y * wb).sum(), xb)
        return y.detach(), gx

    outs = group.run(rank)
    blk = frames // sp
    for r, (y, _) in enumerate(outs):
        assert torch.equal(y, padded[:, r * blk:r * blk + blk + 2 * c])
    # each rank's loss weighs its view; the whole gradient folds the
    # overlapping views' weights onto every frame
    want = torch.zeros(2, frames + 2 * c, 3)
    for r in range(sp):
        want[:, r * blk:r * blk + blk + 2 * c] += w[:, r * blk:
                                                    r * blk + blk + 2 * c]
    got = torch.cat([gx for _, gx in outs], 1)
    torch.testing.assert_close(got, want[:, c:-c], rtol=0, atol=1e-6)


def test_block_rule_message(monkeypatch):
    """The seq axis asks JAX's two rules alone: the whole sequence's frames
    a multiple of half-window x dilation (the module's message, JAX's
    windowed_attention.py:100-103, before any collective; the task's
    bucket message, JAX's tasks/mlm.py:343-347) and of the seq axis
    (seq_layout, JAX's train_step.py:162-171).  A rank's block is free:
    the yaml's 1024-frame bucket at sp = 8 (128 frames against c = 256)
    and at sp = 4 with dilation 2 (256 against c x d = 512) builds, each
    rank on the chunks that cover its block, with one halo for every
    rank."""
    from a3t_tpu_torch.models.windowed_attention import cover
    from a3t_tpu_torch.tasks.config import load_config
    from a3t_tpu_torch.tasks.mlm import check_supported

    attn = WindowedSelfAttention(8, 2, 16, dilation=2)
    with pytest.raises(ValueError) as e:
        attn(torch.zeros(1, 28, 8), 20, torch.ones(1, 48, dtype=torch.bool),
             seq=SeqLayout(40, 8, 0, 2))
    assert str(e.value) == ("n_frames 40 must be a multiple of half-window "
                            "8 x dilation 2")
    monkeypatch.setattr(sequence, "seq_world", lambda: 8)
    monkeypatch.setattr(sequence, "seq_rank", lambda: 3)
    with pytest.raises(ValueError) as e:
        sequence.seq_layout(1020, 64)
    assert str(e.value) == (
        "sequence parallelism needs the frame bucket (1020) to be a multiple "
        "of the seq axis (8); adjust BatcherConfig.bucket_frames")
    assert sequence.seq_layout(1024, 64) == SeqLayout(1024, 64, 3, 8)
    # the task: the bucket rule, then the mesh, which one process does
    # not cover (the layouts themselves build on their groups:
    # tests/test_torch_seq_parallel.py, chip_smoke.py's longformer-mesh)
    path = os.path.join(os.path.dirname(__file__), os.pardir, "configs",
                        "a3t_longformer_16k.yaml")
    for sp, dl in ((8, 1), (4, 2)):
        cfg = load_config(path, [f"mesh.sequence_parallel={sp}",
                                 f"model.encoder.attention_dilation={dl}",
                                 "batcher.bucket_frames=[1024, 2048]"])
        with pytest.raises(ValueError, match=f"sequence_parallel={sp}"):
            check_supported(cfg)
        covers = [cover(SeqLayout(1024, 0, s, sp), 256 * dl)
                  for s in range(sp)]
        assert [(lo, hi) for lo, hi, _ in covers] == [
            (s * 1024 // sp // (256 * dl) * 256 * dl,
             -(-(s + 1) * 1024 // sp // (256 * dl)) * 256 * dl)
            for s in range(sp)]
        assert {h for _, _, h in covers} == {256 * dl + 1024 // sp}
    with pytest.raises(ValueError) as e:
        check_supported(load_config(path, [
            "model.encoder.attention_dilation=2",
            "batcher.bucket_frames=[768, 1024]"]))
    assert str(e.value) == ("bucket_frames [768] not multiples of "
                            "half-window x dilation 512 (required by "
                            "longformer attention)")


@pytest.mark.parametrize("banded", [True, False])
@pytest.mark.parametrize("frames,sp,window,dilation", [
    (24, 4, 8, 1), (24, 8, 8, 1), (32, 8, 16, 1), (40, 8, 4, 2),
    (48, 8, 8, 3)])
def test_windowed_attention_on_any_block(monkeypatch, frames, sp, window,
                                         dilation, banded):
    """WindowedSelfAttention on sp seq ranks (threads) at blocks that
    straddle a chunk edge of c x d frames (24 / 4 at c = 4), are smaller
    than a chunk (3 of c = 4; 4 of c = 8, whose halo reaches over two
    blocks), are not multiples of the dilation (5 frames at d = 2) or
    hold half a dilated chunk (6 of 12 at d = 3), training mode at dropout
    0.2 with padded speech and text keys: each rank's rows of the speech
    and text outputs are the whole forward's, and the ranks' gradients
    (each of its own rows' loss and 1 / sp of the text rows') give the
    whole one's: the frames' by rank, the text's and the parameters'
    summed (``linear_k.bias`` left out: the softmax ignores a key bias, so
    its gradient is rounding noise)."""
    tt, b = 5, 2
    torch.manual_seed(0)
    attn = WindowedSelfAttention(8, 2, window, dropout_rate=0.2,
                                 dilation=dilation, use_banded=banded)
    attn.train()
    g = torch.Generator().manual_seed(1)
    x, w = (torch.randn(b, frames + tt, 8, generator=g) for _ in range(2))
    mask = torch.ones(b, frames + tt, dtype=torch.bool)
    mask[1, frames - frames // 3:frames] = False
    mask[1, -2:] = False
    params = list(attn.parameters())
    xw = x.clone().requires_grad_()
    whole = attn(xw, frames, mask, torch.Generator().manual_seed(5))
    want = torch.autograd.grad((whole * w).sum(), [xw] + params)
    group = _ThreadRanks(sp)
    monkeypatch.setattr(sequence, "_gather", group.gather)
    monkeypatch.setattr(sequence, "_scatter_sum", group.scatter_sum)

    def rank(r):
        seq = SeqLayout(frames, tt, r, sp)
        xb = x[:, seq.rows()].clone().requires_grad_()
        out = attn(xb, seq.block, mask, torch.Generator().manual_seed(5),
                   seq=seq)
        wb = w[:, seq.rows()].clone()
        wb[:, seq.block:] /= sp
        return out.detach(), torch.autograd.grad((out * wb).sum(),
                                                 [xb] + params)

    outs = group.run(rank)
    blk = frames // sp
    torch.testing.assert_close(torch.cat([o[:, :blk] for o, _ in outs], 1),
                               whole[:, :frames].detach(), rtol=0, atol=1e-6)
    for o, _ in outs:
        torch.testing.assert_close(o[:, blk:], whole[:, frames:].detach(),
                                   rtol=0, atol=1e-6)
    torch.testing.assert_close(
        torch.cat([gr[0][:, :blk] for _, gr in outs], 1), want[0][:, :frames],
        rtol=0, atol=1e-6)
    for i, name in enumerate(["x text"] + [n for n, _ in
                                           attn.named_parameters()]):
        if name == "linear_k.bias":
            continue
        got = functools.reduce(torch.add, [
            gr[i][:, blk:] if i == 0 else gr[i] for _, gr in outs])
        ref = want[0][:, frames:] if i == 0 else want[i]
        torch.testing.assert_close(got, ref, rtol=1e-5,
                                   atol=1e-6 * float(ref.abs().max()),
                                   msg=name)


def _lf_port(banded: bool, dilation: int, pre: int = 1):
    """The port's tiny longformer with a speech-only pre-encoder block and
    dropout 0.2 everywhere (no BatchNorm: no conv module, no postnet)."""
    from a3t_tpu_torch.models.conformer import EncoderConfig
    from a3t_tpu_torch.models.mlm import A3TModelConfig

    enc = EncoderConfig(**{**STACK, "dropout_rate": 0.2,
                           "positional_dropout_rate": 0.2,
                           "attention_dropout_rate": 0.2},
                        macaron_style=False, use_cnn_module=False,
                        attention_dilation=dilation,
                        use_pallas_attention=banded, pre_speech_layers=pre)
    return A3TModelConfig(odim=20, vocab_size=30, encoder=enc, decoder=None,
                          postnet_layers=0)


@pytest.mark.parametrize("banded,dilation", [(True, 1), (True, 2),
                                             (False, 1), (False, 2)])
def test_pre_encoder_and_joint_encoder_on_seq_ranks(monkeypatch, banded,
                                                    dilation):
    """The longformer with its speech-only pre-encoder (no text: K3-K5's
    128-key stand-in block) on ``seq.speech()`` and the joint encoder on
    ``seq.with_tail(T)``, training mode at dropout 0.2, on 4 seq ranks
    (threads): each rank's outputs are its rows of the whole forward's, and
    the ranks' parameter gradients (each of its own rows' loss) sum to the
    whole one's.  Row 1 is padding past frame 60, so ranks 2 and 3 hold
    padding alone there (C1).  ``linear_k.bias`` is left out: the softmax
    ignores a key bias, so its gradient is rounding noise."""
    model = build_model(_lf_port(banded, dilation), device="cpu", seed=3)
    model.train()
    rng = np.random.default_rng(0)
    t = 8
    batch = dict(
        speech=rng.standard_normal((2, FRAMES, 20)).astype(np.float32),
        text=rng.integers(0, 30, (2, t)).astype(np.int32),
        masked_position=rng.random((2, FRAMES)) < 0.3,
        speech_mask=np.ones((2, FRAMES), bool),
        text_mask=np.ones((2, t), bool),
        speech_segment_pos=rng.integers(0, t + 1, (2, FRAMES)).astype(
            np.int32),
        text_segment_pos=rng.integers(0, t + 1, (2, t)).astype(np.int32))
    batch["speech_mask"][1, 60:] = False
    batch["text_mask"][1, -2:] = False
    batch = {k: torch.as_tensor(v) for k, v in batch.items()}
    frame_keys = ("speech", "masked_position", "speech_mask",
                  "speech_segment_pos")
    w = torch.randn(2, FRAMES, 20, generator=torch.Generator().manual_seed(1))
    names, params = zip(*[(n, p) for n, p in model.named_parameters()
                          if not n.endswith("linear_k.bias")])
    before, _ = model(**batch, generator=torch.Generator().manual_seed(5))
    want = torch.autograd.grad((before * w).sum(), params)
    group = _ThreadRanks(4)
    monkeypatch.setattr(sequence, "_gather", group.gather)
    monkeypatch.setattr(sequence, "_scatter_sum", group.scatter_sum)

    def rank(r):
        seq = SeqLayout(FRAMES, 0, r, 4)
        inp = {k: sequence.frame_block(v, seq) if k in frame_keys else v
               for k, v in batch.items()}
        out, _ = model(**inp, generator=torch.Generator().manual_seed(5),
                       seq=seq)
        grads = torch.autograd.grad(
            (out * sequence.frame_block(w, seq)).sum(), params)
        return out.detach(), grads

    outs = group.run(rank)
    torch.testing.assert_close(torch.cat([o for o, _ in outs], 1),
                               before.detach(), rtol=1e-5, atol=1e-5)
    for i, name in enumerate(names):
        got = functools.reduce(torch.add, [g[i] for _, g in outs])
        torch.testing.assert_close(got, want[i], rtol=1e-4,
                                   atol=1e-5 * float(want[i].abs().max()),
                                   msg=name)


def test_windowed_slices_and_gathered_state():
    """The longformer's slices on the model axis: build_model at tp = 2
    gives rank t the t-th slice of every ``self_attn.linear_*`` of the
    pre-encoder and the joint encoder (by output for q, k and v, by input
    for out) and of the feed-forwards, the rest whole; the ranks' states
    gathered are the whole model's, as a checkpoint saves it."""
    from a3t_tpu_torch.parallel.sharding import (gather_state,
                                                 param_partition_spec,
                                                 shard_state)
    from a3t_tpu_torch.parallel.tensor import ModelShard

    cfg = _lf_port(True, 1)
    full = build_model(cfg, device="cpu", shard=ModelShard()).state_dict()
    parts = [build_model(cfg, device="cpu", shard=ModelShard(t, 2))
             .state_dict() for t in range(2)]
    split = {k for k in full if param_partition_spec(k) is not None}
    for stack in ("pre_speech_encoders", "encoder"):
        for proj in ("linear_q", "linear_k", "linear_v"):
            key = f"{stack}.encoders.0.self_attn.{proj}.weight"
            assert key in split and parts[1][key].shape[0] == 16
        key = f"{stack}.encoders.0.self_attn.linear_out.weight"
        assert key in split and parts[1][key].shape[1] == 16
    for t in range(2):
        want = shard_state(full, t, 2)
        assert list(parts[t]) == list(want)
        for k, v in want.items():
            assert torch.equal(parts[t][k], v), k
    whole = gather_state(parts)
    assert list(whole) == list(full)
    for k, v in full.items():
        assert torch.equal(whole[k], v), k
