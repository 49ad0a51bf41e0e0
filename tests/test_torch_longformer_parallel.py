"""The longformer on the port's seq and model axes (``models/
windowed_attention.py`` with a ``seq`` layout and a ``ModelShard``, the
banded kernels' place: ``head0``, ``heads`` and ``chunks`` with halo
chunks, ``ops/banded_attention.py``) on the CPU.  Ranks are spawned
processes in a gloo group, one intra-op thread each
(``tests/torch_sp_ranks.py``), on JAX's tiny longformer
(tests/test_train.py:240-290: d = 32, 2 heads, window 16, 1 + 1 blocks)
at 128 frames and 8 phones.

* The chunked path (``use_pallas_attention: false``, the path JAX takes
  off the TPU) at 1 x 4 x 1, 2 x 2 x 1 and 1 x 1 x 2 against JAX's
  ``MeshConfig`` meshes of the same shape and the port's one process,
  every dropout rate 0: losses within rtol 1e-5, the parameters after the
  step by JAX's cross-mesh rule (tests/test_train.py:216-237).
* The banded path (the plain K3-K5) at 1 x 4 x 1 and 1 x 2 x 2 and with
  dilation 2 at 1 x 4 x 1, every dropout site at 0.2, against the port's
  one process: losses within 1e-5 relative, every keep-mask a rank draws
  equal to its rows (and heads) of one process's, bit for bit.
* ROADMAP C1: a batch whose second row is padding past frame 50, so that
  the blocks of seq ranks 2 and 3 of 4 hold padding alone there (the
  pre-encoder has no text, so their query rows see no valid key, while
  rank 2's first chunk reads rank 1's real keys through its halo): the
  loss, grad_norm and parameters of both paths as one process's.
* In this process: the plain K3/K4/K5 on a block with halos and on one
  head equal the whole call's rows, the ranks' K5 halo rows summed back to
  their owners equal the whole call's dk and dv; the band halo equals the
  whole tensor's neighbours and returns its gradient to them; the block
  rule's message; the windowed module's slices on the model axis; the
  pre-encoder and the joint encoder on seq ranks (threads).
"""

import concurrent.futures
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
from a3t_tpu_torch.models.windowed_attention import (block_rule,
                                                     WindowedSelfAttention)
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


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _c1_batch(batch: dict) -> dict:
    """``batch`` with its second row cut to 50 frames: padding fills the
    blocks of seq ranks 2 and 3 of 4 there."""
    out = {k: v.copy() for k, v in batch.items()}
    out["audio_lengths"][1] = HOP * 49
    out["masked_position"][1, 50:] = False
    out["speech_segment_pos"][1, 50:] = 0
    return out


@pytest.fixture(scope="module")
def jax_lf():
    """JAX's one step of the tiny longformer (the chunked einsums, as JAX
    runs it off the TPU) on one device and on each of MESHES, from one
    init: the variables, the batch, each mesh's loss and parameters."""
    saved = jax_mlm.Postnet
    jax_mlm.Postnet = functools.partial(saved, dropout_rate=0.0)
    try:
        model = jax_mlm.A3TMLMModel(LF)
        fe = JaxLogMelFrontend(JaxLogMelConfig(**FRONTEND))
        batch_np = make_synthetic_batch(
            np.random.default_rng(11), batch_size=2, n_samples=HOP * 127,
            n_text=8, hop_length=HOP, vocab_size=30, fs=8000)
        batch = {k: jax.numpy.asarray(v) for k, v in batch_np.items()}
        state0 = _jax_state(model, OPTIM,
                            jax_featurize(fe, batch, use_fused=False))
        out = dict(batch=batch_np, init=jax.tree_util.tree_map(np.asarray, {
            "params": state0.params, "batch_stats": state0.batch_stats}))
        for dp, sp, tp in ((1, 1, 1),) + MESHES:
            mesh = make_mesh(MeshConfig(data_parallel=dp, sequence_parallel=sp,
                                        tensor_parallel=tp),
                             devices=jax.devices()[:dp * sp * tp])
            state = state0.replace(
                params=shard_variables(mesh, state0.params),
                opt_state=shard_opt_state(mesh, state0.opt_state))
            state, stats = jax_make_train_step(model, fe, mesh=mesh,
                                               donate=False)(
                state, jax.device_put(batch, batch_sharding(mesh)),
                jax.random.PRNGKey(0))
            out[(dp, sp, tp)] = dict(loss=float(stats["loss"]), after=mlm_state(
                jax.tree_util.tree_map(np.asarray, {
                    "params": state.params,
                    "batch_stats": state.batch_stats})))
    finally:
        jax_mlm.Postnet = saved
    return out


@pytest.fixture(scope="module")
def runs(jax_lf, tmp_path_factory):
    """Every scenario on 4 ranks (and the model axis on 2), and its
    one-process reference in this process; returns the work directory,
    whose files hold the results."""
    d = str(tmp_path_factory.mktemp("lf_runs"))
    model = build_model(port_config(LF), device="cpu")
    ranks.set_dropout(model, 0.0)
    load_state(model, mlm_state(jax_lf["init"]))
    torch.save(model.state_dict(), os.path.join(d, "init.pt"))
    with open(os.path.join(d, "setup.pkl"), "wb") as f:
        pickle.dump(dict(model=port_config(LF), optim=OPTIM,
                         frontend=FRONTEND), f)
    np.savez(os.path.join(d, "batch.npz"), **jax_lf["batch"])
    np.savez(os.path.join(d, "c1.npz"), **_c1_batch(jax_lf["batch"]))

    def step(tag, **kw):
        return ("torch_sp_ranks:sp_step", dict(workdir=d, tag=tag, **kw))

    drop = dict(dropout=0.2)
    dil = {**BANDED, "attention_dilation": 2}
    pool = concurrent.futures.ThreadPoolExecutor(2)
    four = pool.submit(ranks.spawn, 4, [
        step("c4", sp=4, model=CHUNKED),
        step("c22", sp=2, model=CHUNKED),
        step("b4", sp=4, model=BANDED, masks=True, **drop),
        step("b22", sp=2, tp=2, model=BANDED, masks=True, **drop),
        step("dil", sp=4, model=dil, masks=True, **drop),
        step("pb", sp=4, model=BANDED, batch="c1.npz", **drop),
        step("pc", sp=4, model=CHUNKED, batch="c1.npz", **drop),
    ], d)
    two = pool.submit(ranks.spawn, 2, [step("c12", tp=2, model=CHUNKED)], d)
    pool.shutdown(wait=False)
    # the one-process references
    sp_ranks.sp_step(d, "c", model=CHUNKED)
    sp_ranks.sp_step(d, "b", model=BANDED, masks=True, **drop)
    sp_ranks.sp_step(d, "dil", model=dil, masks=True, **drop)
    sp_ranks.sp_step(d, "pb", model=BANDED, batch="c1.npz", **drop)
    sp_ranks.sp_step(d, "pc", model=CHUNKED, batch="c1.npz", **drop)
    four.result()
    two.result()
    return d


# --- (1) the chunked path against JAX's meshes and one process, dropout 0

@pytest.mark.parametrize("tag,mesh", [("c4", (1, 4, 1)), ("c22", (2, 2, 1)),
                                      ("c12", (1, 1, 2))])
def test_chunked_step_equals_jax_mesh(runs, jax_lf, tag, mesh):
    dp, sp, tp = mesh
    got = [_load(runs, f"{tag}_r{r}") for r in range(dp * sp * tp)]
    w1 = _load(runs, "c_w1")
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
    dimension that differs is the seq axis's (frames 128, [frames ; text]
    136, query chunks 16, each phase's 8)."""
    return n in (STACK["attention_heads"], STACK["linear_units"])


def _rank_part(full, part, s: int, sp: int, t: int, tp: int):
    """Seq rank s and model rank t's part of one process's mask ``full``:
    along a split of the model axis the t-th of tp slices, along the seq
    axis the rank's block of the frames (or query chunks) and the rows
    after them."""
    out = full
    for dim, (n, m) in enumerate(zip(full.shape, part.shape)):
        if n == m:
            continue
        if tp > 1 and _model_dim(n):
            out = out.narrow(dim, t * m, m)
            continue
        block = (n - m) // (sp - 1)
        rows = torch.cat([torch.arange(s * block, (s + 1) * block),
                          torch.arange(n - (m - block), n)])
        out = out.index_select(dim, rows)
    return out


@pytest.mark.parametrize("tag,ref,world", [("b4", "b", 4), ("b22", "b", 4),
                                           ("dil", "dil", 4)])
def test_banded_masks_are_one_process_rows(runs, tag, ref, world):
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
            assert torch.equal(_rank_part(want, have, s, sp, t, tp),
                               have), (r, i, site)
            if want.shape != have.shape:
                split.add(site)
        # K3/K4's band and text draws and the byte masks are split
        assert split == {"byte", "banded"}, split
    _jax_rule(w1["model"], _load(runs, f"{tag}_r0")["model"], _max_update())


# --- (3) ROADMAP C1: a rank whose block holds padding alone on a row

@pytest.mark.parametrize("tag", ["pb", "pc"])
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

def _band_case(seed: int = 0, tt: int = 6):
    g = torch.Generator().manual_seed(seed)
    b, h, t, d = 2, 2, 32, 8
    q, k, v, go = (torch.randn(b, h, t, d, generator=g) for _ in range(4))
    kt, vt = (torch.randn(b, h, tt, d, generator=g) for _ in range(2))
    txm = torch.ones(b, tt, dtype=torch.int32)
    txm[1, -2:] = 0
    if tt and seed:  # no valid text: rows 12.. of row 0 see no key
        txm[:] = 0
    spm = torch.ones(b, t, dtype=torch.int32)
    spm[0, 12:] = 0
    return q, k, v, kt, vt, go, txm, spm


def _halo(x: torch.Tensor, s: int, sp: int, c: int, dim: int = 2):
    pad = [0, 0] * (x.dim() - 1 - dim) + [c, c]
    blk = x.shape[dim] // sp
    return torch.nn.functional.pad(x, pad).narrow(dim, s * blk, blk + 2 * c)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("rate", [0.0, 0.2])
@pytest.mark.parametrize("sp", [2, 4, 8])
def test_plain_banded_on_blocks_equal_whole_rows(sp, rate, seed):
    """The plain K3/K4/K5 on seq rank s's block (edge ranks with a phantom
    outer halo, interior ranks with both halos real) and on head 1 alone
    (head0 = 1 of 2) equal the whole call's rows: out, lse, dq within
    1e-6 (dq also 1e-6 relative);
    the ranks' dk and dv, each halo row added to its owner's, and their
    text gradients summed, the whole call's; phantom halo rows get zeros.
    Seed 1 has no valid text, so its padded rows see no key at all."""
    window, c = 8, 4
    q, k, v, kt, vt, go, txm, spm = _band_case(seed)
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
    blk, nl = t // sp, nc // sp
    sums = [torch.zeros(b, h, t + 2 * c, d) for _ in range(4)]
    for s in range(sp):
        for h0 in range(h):
            rows, hh = slice(s * blk, (s + 1) * blk), slice(h0, h0 + 1)
            krows = slice(s * blk, s * blk + blk + 2 * c)
            a = (q[:, hh, rows], _halo(k, s, sp, c)[:, hh],
                 _halo(v, s, sp, c)[:, hh], kt[:, hh], vt[:, hh], txm,
                 _halo(spm, s, sp, c, dim=1))
            at = dict(head0=h0, heads=h, chunks=(s * nl, nc))
            o, lo = ba.banded_attention_reference(*a, *fwd, **at)
            torch.testing.assert_close(o, out[:, hh, rows], rtol=0,
                                       atol=1e-6)
            torch.testing.assert_close(lo, lse[:, hh, rows], rtol=0,
                                       atol=1e-6)
            bw = (7, rate, go[:, hh, rows], lo, delta[:, hh, rows])
            dq1, dkt1, dvt1 = ba.banded_attention_bwd_dq_reference(
                *a, window, *bw, **at)
            torch.testing.assert_close(dq1, dq[:, hh, rows], rtol=1e-6,
                                       atol=1e-6)
            dk1, dv1 = ba.banded_attention_bwd_dkv_reference(
                a[0], a[1], a[2], a[6], window, *bw, **at)
            sums[0][:, hh, krows] += dk1
            sums[1][:, hh, krows] += dv1
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


@pytest.mark.parametrize("sp", [2, 4])
def test_band_halo_equals_whole_neighbours(monkeypatch, sp):
    """The band halo (``halo_pad`` over the frames alone, as the windowed
    module takes it) on sp ranks (threads) gives each block with c rows of
    its neighbours, zeros past the global edges, and its backward returns
    each halo row's gradient to its owner: the ranks' input gradients are
    the whole padded tensor's gradient folded back."""
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


def test_block_rule_message():
    """A seq rank's block of part of a chunk of half-window x dilation
    frames raises before any collective, naming the block, c and the
    dilation; whole chunks pass."""
    msg = ("longformer attention on the seq axis needs each rank's frame "
           "block (1024 frames / 8 ranks = 128) to be a multiple of "
           "half-window 256 x dilation 1; adjust BatcherConfig.bucket_frames "
           "or mesh.sequence_parallel")
    with pytest.raises(ValueError) as e:
        block_rule(SeqLayout(1024, 64, 0, 8), 256, 1)
    assert str(e.value) == msg
    with pytest.raises(ValueError, match=r"\(1024 frames / 4 ranks = 256\) "
                       "to be a multiple of half-window 256 x dilation 2"):
        block_rule(SeqLayout(1024, 0, 3, 4), 256, 2)
    block_rule(SeqLayout(1024, 0, 1, 4), 256, 1)
    block_rule(None, 256, 4)
    attn = WindowedSelfAttention(8, 2, 16, dilation=2)
    with pytest.raises(ValueError, match=r"\(48 frames / 2 ranks = 24\) to "
                       "be a multiple of half-window 8 x dilation 2"):
        attn(torch.zeros(1, 32, 8), 24, torch.ones(1, 56, dtype=torch.bool),
             seq=SeqLayout(48, 8, 0, 2))


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
