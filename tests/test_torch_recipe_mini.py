"""The port's miniature recipe (python -m a3t_tpu_torch.recipes.mini, the
port of recipes/mini/run.py) on the CPU: synthesize, align with the native
aligner, train one epoch, edit, and score; the MCD is finite over 8
utterances.  The config it writes (tasks/yaml_subset.dump, no PyYAML in the
port) reads back through PyYAML as the recipe's dict.
"""

import os

import numpy as np
import pytest
import torch
import yaml

from a3t_tpu_torch.recipes import mini


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread, so that the test workers beside this one are
    not oversubscribed."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_recipe_mini_runs_on_cpu(tmp_path):
    work = str(tmp_path / "mini")
    result = mini.main(["--workdir", work, "--epochs", "1", "--n-utts", "8",
                        "--device", "cpu"])
    assert result["n"] == 8 and np.isfinite(result["mean_mcd"])
    data, exp = os.path.join(work, "data"), os.path.join(work, "exp")
    assert os.path.exists(os.path.join(work, "aligner.bin"))
    assert not os.path.exists(os.path.join(data, "mfa_text"))
    assert os.listdir(os.path.join(exp, "checkpoints"))
    with open(os.path.join(work, "config.yaml"), encoding="utf-8") as f:
        assert yaml.safe_load(f) == mini.toy_config(data, exp, 1)
    assert any(n.endswith("_edited.wav") for n in os.listdir(work))
