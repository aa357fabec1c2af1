"""The port's launchers and example twins, run as a user runs them:
subprocesses at the smoke config on the CPU (the kernels' plain
versions). No JAX engine is built here.

  * ``launch/serve.py --horizon 1 --no-fused-decode``: colocated and PD,
    every request completes with the decode flags honoured;
  * ``examples/quickstart_torch.py``, ``pd_disaggregation_torch.py`` and
    ``autoscale_demo_torch.py`` at ``--smoke --device cpu``, and their
    ``--device`` defaulting to the card (no CPU fallback);
  * ``launch/train.py --smoke --device cpu``: a run, then one that
    checkpoints and one that resumes from it.
The serving runs start together (module fixture), so they cost about one
interpreter start.
"""
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.training import CheckpointManager
from test_torch_fixtures import one_torch_thread  # noqa: F401 (autouse)

ROOT = Path(__file__).resolve().parent.parent
RUNS = {
    "serve-colocated": ["-m", "repro_torch.launch.serve", "--smoke",
                        "--device", "cpu", "--requests", "3", "--max-new",
                        "4", "--horizon", "1", "--no-fused-decode"],
    "serve-pd": ["-m", "repro_torch.launch.serve", "--smoke", "--device",
                 "cpu", "--requests", "2", "--max-new", "4", "--horizon",
                 "1", "--no-fused-decode", "--mode", "pd"],
    "quickstart": ["examples/quickstart_torch.py", "--smoke", "--device",
                   "cpu", "--requests", "3", "--max-new", "4"],
    "pd_disaggregation": ["examples/pd_disaggregation_torch.py", "--smoke",
                          "--device", "cpu"],
    "autoscale_demo": ["examples/autoscale_demo_torch.py", "--smoke",
                       "--device", "cpu"],
    "no-card": ["examples/quickstart_torch.py", "--smoke"],
}


@pytest.fixture(scope="module")
def runs():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    procs = {name: subprocess.Popen([sys.executable, *args], cwd=ROOT,
                                    env=env, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True)
             for name, args in RUNS.items()}
    out = {}
    for name, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        out[name] = (p.returncode, stdout, stderr)
    return out


def _ok(runs, name):
    rc, stdout, stderr = runs[name]
    assert rc == 0, stderr[-2000:]
    return stdout


@pytest.mark.parametrize("mode,n", [("colocated", 3), ("pd", 2)])
def test_launcher_decode_flags(runs, mode, n):
    out = _ok(runs, f"serve-{mode}")
    assert "decode horizon 1, unfused decode" in out
    assert f"{n} requests, {n * 4} tokens" in out
    assert len(re.findall(r"-> 4 tokens", out)) == n


def test_quickstart_twin(runs):
    out = _ok(runs, "quickstart")
    assert "[quickstart] 3 completions, 12 tokens" in out
    assert "prefix cache: {'hits'" in out


def test_pd_disaggregation_twin(runs):
    out = _ok(runs, "pd_disaggregation")
    assert out.count("[pd] migrated ") == 4
    assert "[pd] 4 migrations, 4 completions" in out


def test_autoscale_demo_twin(runs):
    out = _ok(runs, "autoscale_demo")
    assert "NPU-fork x32 over ICI" in out and "scale event" in out
    assert re.search(r"live NPU-fork of \S+ on cpu: [0-9.]+ GB copied", out)


def test_examples_default_to_the_card(runs):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    rc, _, stderr = runs["no-card"]
    assert rc != 0 and "device 'cuda' requested" in stderr


# ---------------------------------------------------------------------------
# the train launcher
# ---------------------------------------------------------------------------


def _launch(*args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--smoke",
         "--device", "cpu", "--seq-len", "16", "--batch", "2", *args],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_launcher_trains_on_the_cpu():
    out = _launch("--steps", "4")
    assert "qwen3-8b-smoke: 4 layers" in out and "float32, on cpu" in out
    first, last = (float(x) for x in
                   out.split("done: loss ")[1].split(" in ")[0].split(" -> "))
    assert np.isfinite(first) and np.isfinite(last)


def test_launcher_checkpoints_and_resumes(tmp_path):
    ck = str(tmp_path / "ck")
    _launch("--steps", "4", "--ckpt-dir", ck, "--ckpt-every", "2")
    assert CheckpointManager(ck).list_steps() == [2, 4]
    out = _launch("--steps", "6", "--ckpt-dir", ck, "--resume")
    assert "resumed from step 4" in out
    assert CheckpointManager(ck).list_steps() == [2, 4, 6]
