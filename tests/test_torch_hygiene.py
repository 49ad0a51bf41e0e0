"""The port stands alone: a3t_tpu_torch/, chip_smoke.py and chip_ab.py
import no JAX stack and nothing of a3t_tpu, the kernels build without
PyTorch's headers, and the entry points run on CUDA unless the caller asks
for the CPU."""

import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "a3t_tpu_torch")
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "orbax", "a3t_tpu"}


def _sources():
    files = [os.path.join(ROOT, n) for n in ("chip_smoke.py", "chip_ab.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    return sorted(files)


def _imports(tree):
    """(root module name, imported at module level) for every import."""
    top = set()
    for node in tree.body:
        for sub in ast.walk(node):
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda)):
                break
            top.add(id(sub))
    out = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        for name in names:
            out.append((name.split(".")[0], id(node) in top))
    return out


def test_no_jax_or_a3t_tpu_imports():
    """Nowhere in the port, not even inside functions; yaml only lazily."""
    bad = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), path)
        for root, at_top in _imports(tree):
            if root in FORBIDDEN or (root == "yaml" and at_top):
                bad.append(f"{os.path.relpath(path, ROOT)}: {root}")
    assert not bad, bad


def test_import_loads_no_jax():
    """Importing every module of the port pulls in no JAX stack or yaml."""
    mods = sorted(
        os.path.relpath(p, ROOT)[:-3].replace(os.sep, ".").removesuffix(
            ".__init__") for p in _sources() if p.startswith(PKG))
    code = ("import sys\n" + "".join(f"import {m}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
            f"{sorted(FORBIDDEN | {'yaml'})!r}]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                   check=True, timeout=120)


def test_kernel_sources_use_no_torch_headers():
    csrc = os.path.join(PKG, "csrc")
    for name in os.listdir(csrc):
        with open(os.path.join(csrc, name), encoding="utf-8") as f:
            text = f.read()
        assert "torch/" not in text and "ATen" not in text, name


def test_entry_points_need_cuda_unless_asked_for_cpu(monkeypatch):
    from a3t_tpu_torch.device import resolve_device
    from a3t_tpu_torch.dsp import LogMelConfig, LogMelFrontend
    from a3t_tpu_torch.inference import SpeechEditor
    from a3t_tpu_torch.models import (A3TModelConfig, EncoderConfig,
                                      PWGConfig, build_model, build_vocoder)
    from a3t_tpu_torch.text import TokenIDConverter
    from a3t_tpu_torch.train import (create_train_state, make_eval_step,
                                     make_optimizer, make_train_step)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = EncoderConfig(attention_dim=16, attention_heads=2, linear_units=16,
                        num_blocks=1)
    cfg = A3TModelConfig(odim=8, vocab_size=10, encoder=enc, decoder=enc,
                         postnet_layers=1, postnet_chans=8)
    pwg = PWGConfig(layers=2, stacks=1, residual_channels=4, gate_channels=8,
                    skip_channels=4, aux_channels=8, upsample_scales=(2,))
    tokens = TokenIDConverter(["<blank>", "<unk>", "A"])
    model = build_model(cfg, device="cpu")
    fe = LogMelFrontend(LogMelConfig(n_mels=8), device="cpu")
    for make in (lambda **kw: build_model(cfg, **kw),
                 lambda **kw: build_vocoder(pwg, **kw),
                 lambda **kw: SpeechEditor(None, LogMelConfig(), tokens, **kw),
                 lambda **kw: LogMelFrontend(LogMelConfig(), **kw),
                 lambda **kw: create_train_state(model, make_optimizer(),
                                                 **kw),
                 lambda **kw: make_train_step(model, fe, **kw),
                 lambda **kw: make_eval_step(model, fe, **kw),
                 lambda **kw: resolve_device(**kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")
        make(device="cpu")


def test_chip_smoke_refuses_to_run_without_cuda():
    """No card: a non-zero exit and no result line."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    proc = subprocess.run([sys.executable, os.path.join(ROOT, "chip_smoke.py")],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
