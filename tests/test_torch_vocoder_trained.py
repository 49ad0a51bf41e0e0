"""The trained 16 kHz vocoder in the port: ``a3t_tpu_torch/weights/
vocoder_16k`` is the JAX package's ``artifacts/vocoder`` (an orbax
``state/`` of the scan generator: 30 layers in 3 stacks, 64 residual
channels, upsampling 5 x 5 x 4 x 2, hop 200) converted once by
:func:`convert` below, which the port cannot hold itself (it imports orbax).

* The committed ``state.pt`` equals a fresh conversion tensor for tensor,
  bit for bit, and ``vocoder.json`` is the artifact's, byte for byte.
* ``check.npz`` is reproduced: the mel of
  ``artifacts/real_speech_demo/ctc_align_test_prompt.wav`` through JAX's
  rfft front-end at ``vocoder.json``'s settings (168 frames) within 1e-5
  (one machine's float32 against another's), JAX's noise
  ``jax.random.normal(PRNGKey(0), (1, 192 * 200, 1))`` bit for bit, and
  JAX's wav within 1e-5 of its peak.
* The port's ``load_vocoder`` on the committed directory, given JAX's
  noise, gives JAX's wav within 1e-4 of the wav's peak (fp32 through 30
  dilated layers, each framework summing its convolutions in its own
  order), and the committed ``check.npz`` wav the same.
"""

import dataclasses
import json
import os
import shutil

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from a3t_tpu.dsp import LogMelConfig as JaxLogMelConfig
from a3t_tpu.dsp import LogMelFrontend as JaxLogMelFrontend
from a3t_tpu.train import vocoder as jax_vocoder
from a3t_tpu_torch.compat.from_jax import pwg_state
from a3t_tpu_torch.train import vocoder

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARTIFACT = os.path.join(ROOT, "artifacts", "vocoder")
COMMITTED = os.path.join(ROOT, "a3t_tpu_torch", "weights", "vocoder_16k")
WAV = os.path.join(ROOT, "artifacts", "real_speech_demo",
                   "ctc_align_test_prompt.wav")
MAX_FRAMES = 192


def _restore_generator(src: str) -> dict:
    """The generator's parameters of a JAX vocoder directory, restored
    against an abstract template on the local device, as JAX's
    ``load_vocoder`` restores them (vocoder.py:376-402)."""
    import optax
    import orbax.checkpoint as ocp

    with open(os.path.join(src, "vocoder.json")) as f:
        meta = json.load(f)
    gcfg = jax_vocoder.PWGConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in meta["pwg"].items()})
    hop = int(np.prod(gcfg.upsample_scales))
    gen = jax_vocoder.ParallelWaveGANGeneratorScan(
        dataclasses.replace(gcfg, phase_conv=False))
    disc = jax_vocoder.PWGDiscriminator()
    tx = optax.chain(optax.clip_by_global_norm(1.0), optax.adam(1e-4))

    def build_state():
        pg = gen.init(jax.random.PRNGKey(0),
                      jnp.zeros((1, 8, gcfg.aux_channels)),
                      jnp.zeros((1, 8 * hop, gcfg.in_channels)))["params"]
        pd = disc.init(jax.random.PRNGKey(1),
                       jnp.zeros((1, 8 * hop)))["params"]
        return jax_vocoder._ckpt_tree(jnp.zeros((), jnp.int32), pg, pd,
                                      tx.init(pg), tx.init(pd))

    sharding = jax.sharding.SingleDeviceSharding(jax.local_devices()[0])
    abstract = jax.tree_util.tree_map(
        lambda s: jax.ShapeDtypeStruct(s.shape, s.dtype, sharding=sharding),
        jax.eval_shape(build_state))
    raw = ocp.StandardCheckpointer().restore(
        os.path.abspath(os.path.join(src, "state")), abstract)
    return jax.tree_util.tree_map(np.asarray, raw["params_g"])


def check_inputs(src: str):
    """(mel (1, F, 80), z (1, F_pad * hop)): the demo wav's log10-mel
    through JAX's rfft front-end at the vocoder's settings, at most
    MAX_FRAMES frames, and JAX's own noise for it (vocoder.py:411-413)."""
    from scipy.io import wavfile

    with open(os.path.join(src, "vocoder.json")) as f:
        meta = json.load(f)
    fs, pcm = wavfile.read(WAV)
    fe_cfg = JaxLogMelConfig(**meta["frontend"])
    assert fs == fe_cfg.fs
    audio = jnp.asarray(pcm.astype(np.float32)[None] / 32768.0)
    feats, flens = JaxLogMelFrontend(fe_cfg)(audio)
    mel = np.asarray(feats)[:, :min(int(flens[0]), MAX_FRAMES)]
    hop = int(np.prod(meta["pwg"]["upsample_scales"]))
    f_pad = -(-mel.shape[1] // 64) * 64
    z = np.asarray(jax.random.normal(jax.random.PRNGKey(0),
                                     (1, f_pad * hop, 1)))[..., 0]
    return mel, z


def convert(src: str, out: str) -> None:
    """A JAX vocoder directory -> the port's: ``state.pt`` holding
    ``{"params_g": ...}`` through ``pwg_state``, ``vocoder.json`` copied
    unchanged and ``check.npz`` (mel, z, JAX's wav)."""
    os.makedirs(out, exist_ok=True)
    params = _restore_generator(src)
    torch.save({"params_g": {k: torch.from_numpy(v) for k, v in
                             pwg_state({"params": params}).items()}},
               os.path.join(out, "state.pt"))
    shutil.copyfile(os.path.join(src, "vocoder.json"),
                    os.path.join(out, "vocoder.json"))
    mel, z = check_inputs(src)
    wav = jax_vocoder.load_vocoder(src)(mel)
    np.savez(os.path.join(out, "check.npz"), mel=mel, z=z,
             wav=np.asarray(wav, np.float32))


@pytest.fixture(scope="module")
def fresh(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("vocoder_16k"))
    convert(ARTIFACT, out)
    return out


def test_committed_directory_equals_a_fresh_conversion(fresh):
    assert sorted(os.listdir(COMMITTED)) == ["check.npz", "state.pt",
                                             "vocoder.json"]
    with open(os.path.join(COMMITTED, "vocoder.json"), "rb") as f, \
            open(os.path.join(ARTIFACT, "vocoder.json"), "rb") as g:
        assert f.read() == g.read()
    got = torch.load(os.path.join(COMMITTED, "state.pt"),
                     weights_only=True)["params_g"]
    want = torch.load(os.path.join(fresh, "state.pt"),
                      weights_only=True)["params_g"]
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == torch.float32 and torch.equal(got[k], want[k])
    assert sum(v.numel() for v in got.values()) == 1_334_309
    committed = np.load(os.path.join(COMMITTED, "check.npz"))
    again = np.load(os.path.join(fresh, "check.npz"))
    assert committed["mel"].shape == (1, 168, 80)
    assert committed["z"].shape == (1, 192 * 200)
    np.testing.assert_allclose(committed["mel"], again["mel"], atol=1e-5,
                               rtol=0)
    np.testing.assert_array_equal(committed["z"], again["z"])
    peak = np.abs(again["wav"]).max()
    np.testing.assert_allclose(committed["wav"], again["wav"], rtol=0,
                               atol=1e-5 * peak)


def test_port_vocoder_matches_jax(fresh):
    check = np.load(os.path.join(COMMITTED, "check.npz"))
    vocode = vocoder.load_vocoder(COMMITTED, device="cpu")
    got = vocode(check["mel"], z=check["z"]).numpy()
    want = np.load(os.path.join(fresh, "check.npz"))["wav"]
    assert got.shape == want.shape == (1, 168 * 200)
    peak = np.abs(want).max()
    assert peak > 0.01
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * peak)
    np.testing.assert_allclose(got, check["wav"], rtol=0, atol=1e-4 * peak)


def test_orbax_directory_still_raises():
    with pytest.raises(NotImplementedError, match="vocoder_16k"):
        vocoder.load_vocoder(ARTIFACT, device="cpu")
