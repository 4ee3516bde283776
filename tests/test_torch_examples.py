"""The port's examples (examples/torch_*.py) at tiny sizes on the CPU,
each in a process of its own: exit 0 and the JSON result line last."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]

TINY = {
    "torch_quickstart": ["--n-small", "300", "--n-large", "600",
                         "--n-eval", "300", "--small-steps", "20",
                         "--large-steps", "20", "--tune-steps", "20",
                         "--batch", "64"],
    "torch_lm_cascade": ["--n-train", "256", "--n-cal", "128",
                         "--n-eval", "128", "--small-steps", "4",
                         "--large-steps", "4", "--tune-steps", "4",
                         "--batch", "64"],
    "torch_serve_cascade": ["--requests", "12", "--max-new", "3",
                            "--slots", "4", "--ragged", "6"],
    "torch_train_100m": ["--size", "reduced", "--stage1-steps", "3",
                         "--stage2-steps", "2", "--batch", "2",
                         "--seq-len", "16", "--n-train", "8"],
}


@pytest.mark.parametrize("name", TINY)
def test_example_runs_on_cpu(name, tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"), OMP_NUM_THREADS="2")
    args = TINY[name] + ["--device", "cpu"]
    if name == "torch_train_100m":
        args += ["--ckpt", str(tmp_path / "ckpt")]
    res = subprocess.run([sys.executable, str(REPO / "examples" / f"{name}.py"),
                          *args], capture_output=True, text=True,
                         timeout=300, env=env, cwd=tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    rec = json.loads(res.stdout.strip().splitlines()[-1])
    assert rec["example"] == name
    if name == "torch_train_100m":
        assert rec["stage1"]["steps"] >= 1 and rec["stage2"]["steps"] >= 1
        assert (tmp_path / "ckpt" / "stage2").is_dir()
    elif name == "torch_serve_cascade":
        assert rec["threaded_same_tokens"] is True
    else:
        assert rec["device"] == "cpu"


def test_examples_default_to_the_card(tmp_path):
    """Without --device an example runs on CUDA, and says so where there
    is none (never a silent CPU run)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default is the card")
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    res = subprocess.run([sys.executable,
                          str(REPO / "examples" / "torch_quickstart.py")],
                         capture_output=True, text=True, timeout=120,
                         env=env, cwd=tmp_path)
    assert res.returncode != 0
    assert "found no CUDA device" in res.stderr
