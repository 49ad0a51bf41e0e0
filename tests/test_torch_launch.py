"""The port's launcher (a3t_tpu_torch/bin/launch.py) and the multi-host
flags of bin.train: the command construction and local fan-out of
tests/test_launch.py, and ``bin.launch --launcher local`` starting two CPU
ranks of ``bin.train --device cpu`` end to end, whose experiment equals one
process's (every dropout rate 0, no postnet: losses within rtol 1e-5, as
tests/test_torch_parallel.py holds the ranks)."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from a3t_tpu_torch.bin.launch import build_host_commands, main, run_commands
from a3t_tpu_torch.bin.train import main as train_main
from a3t_tpu_torch.data.miniature import generate_mini_corpus
from torch_parallel_ranks import free_port

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(ROOT, "configs", "a3t_conformer_24k.yaml")


def test_ssh_commands_carry_bootstrap_flags():
    cmds = build_host_commands(
        ["gpu-0", "gpu-1"], ["python", "-m", "a3t_tpu_torch.bin.train",
                             "--config", "c.yaml"],
        port=9999, launcher="ssh", cwd="/work")
    assert len(cmds) == 2
    assert cmds[0][0] == "ssh"
    assert "gpu-0" in cmds[0]
    remote = cmds[1][-1]
    assert "cd /work &&" in remote
    assert "--coordinator gpu-0:9999" in remote
    assert "--num-hosts 2" in remote
    assert "--host-id 1" in remote


def test_slurm_commands():
    cmds = build_host_commands(["n0", "n1"], ["train"], launcher="slurm")
    assert cmds[0][:3] == ["srun", "--nodes=1", "--ntasks=1"]
    assert "-wn1" in cmds[1]
    assert cmds[1][-2:] == ["--host-id", "1"]
    with pytest.raises(ValueError, match="launcher"):
        build_host_commands(["n0"], ["train"], launcher="pbs")


def test_local_fanout_runs_all_ranks(tmp_path):
    marker = tmp_path / "rank"
    cmd = [sys.executable, "-c",
           "import sys; open(sys.argv[sys.argv.index('--host-id')+1] + "
           f"'_{marker.name}', 'w')"]
    cmds = build_host_commands(["a", "b", "c"], cmd, launcher="local")
    procs = [subprocess.Popen(c, cwd=tmp_path) for c in cmds]
    assert all(p.wait() == 0 for p in procs)
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "0_rank", "1_rank", "2_rank"]


def test_failure_propagates():
    good = [sys.executable, "-c", "pass"]
    bad = [sys.executable, "-c", "import sys; sys.exit(3)"]
    assert run_commands([good + ["--host-id", "0"], bad]) == 3


def test_dry_run_prints(capsys):
    rc = main(["--hosts", "h0,h1", "--dry-run", "--launcher", "slurm",
               "--", "echo", "hi"])
    assert rc == 0
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 2
    assert "--coordinator h0:8476" in out[0]
    with pytest.raises(SystemExit):
        main(["--hosts", "h0", "echo", "hi"])  # no `--`


def test_stuck_rank_terminated_when_sibling_fails():
    """A rank waiting in a collective is torn down when another dies."""
    slow = [sys.executable, "-c", "import time; time.sleep(300)"]
    bad = [sys.executable, "-c", "import sys; sys.exit(2)"]
    t0 = time.time()
    assert run_commands([slow, bad]) == 2
    assert time.time() - t0 < 60


def _train_args(corpus, exp):
    sets = [f"train_data_dir={corpus[0]}", f"valid_data_dir={corpus[1]}",
            f"exp_dir={exp}", "model.postnet_layers=0",
            "batcher.batch_bins=20480", "batcher.bucket_frames=[256]",
            "batcher.batch_multiple=2", "frontend.n_mels=20",
            "trainer.max_epoch=2", "trainer.num_iters_per_epoch=2",
            "trainer.keep_nbest_models=2", "num_workers_prefetch=0",
            "optim.adam_eps=1.0e-3"]
    sets += [f"model.{s}.{k}={v}" for s in ("encoder", "decoder")
             for k, v in dict(attention_dim=32, attention_heads=2,
                              linear_units=32, num_blocks=1,
                              dropout_rate=0.0, positional_dropout_rate=0.0,
                              attention_dropout_rate=0.0).items()]
    args = ["--config", CONFIG, "--device", "cpu", "--log-level", "WARNING"]
    for s in sets:
        args += ["--set", s]
    return args


def _history(exp):
    with open(os.path.join(exp, "checkpoints", "meta.json")) as f:
        return json.load(f)["reporter"]


def test_launch_two_cpu_ranks_of_bin_train(tmp_path):
    corpus = (generate_mini_corpus(str(tmp_path / "train"), n_utts=10,
                                   fs=24000, seed=0),
              generate_mini_corpus(str(tmp_path / "valid"), n_utts=4,
                                   fs=24000, seed=1))
    exp2 = str(tmp_path / "exp2")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join(
               [ROOT, os.environ.get("PYTHONPATH", "")])}
    proc = subprocess.run(
        [sys.executable, "-m", "a3t_tpu_torch.bin.launch", "--launcher",
         "local", "--hosts", "localhost,localhost", "--port",
         str(free_port()), "--", sys.executable, "-m",
         "a3t_tpu_torch.bin.train", *_train_args(corpus, exp2)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    names = sorted(os.listdir(os.path.join(exp2, "checkpoints")))
    assert names == ["LATEST", "ave_2best.pt", "epoch_1.pt", "epoch_2.pt",
                     "meta.json"]
    # one process on the same global batches
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        exp1 = str(tmp_path / "exp1")
        _, state = train_main(_train_args(corpus, exp1))
    finally:
        torch.set_num_threads(n)
    h1, h2 = _history(exp1), _history(exp2)
    for epoch, phases in h1["history"].items():
        for phase in ("train", "valid"):
            assert h2["history"][epoch][phase]["loss"] == pytest.approx(
                phases[phase]["loss"], rel=1e-5), (epoch, phase)
    tree = torch.load(os.path.join(exp2, "checkpoints", "epoch_2.pt"),
                      weights_only=True)
    n_params = sum(p.numel() for p in state.model.parameters())
    assert tree["opt_state"]["mu"].shape == (n_params,)
    assert int(tree["opt_state"]["count"]) == int(state.opt_state.count)
