"""`repro_torch.launch.train` under torchrun: two gloo ranks on the CPU
train the reduced Qwen2-0.5B on the (2, 1) host mesh through an injected
fault (restored from the step-2 checkpoint), and end at the loss of a
one-process run within the reference's rtol 2e-5.

torchrun's `--standalone` rendezvous takes a free port on localhost, so
two runs of the suite never meet.
"""
import os
import re
import subprocess
import sys

import numpy as np
import torch

from repro_torch.launch import train as train_cli

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
ARGS = ["--device", "cpu", "--steps", "4", "--ckpt-every", "2"]


def test_torchrun_two_ranks_through_a_fault(tmp_path, capsys):
    torch.set_num_threads(1)
    env = {**os.environ, "PYTHONPATH": SRC, "OMP_NUM_THREADS": "1"}
    out = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "-m", "repro_torch.launch.train", *ARGS, "--inject-fault-at", "2",
         "--ckpt-dir", str(tmp_path / "mesh")],
        env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    done = [line for line in out.stdout.splitlines() if line.startswith("done:")]
    assert len(done) == 1, out.stdout             # rank 0 alone prints
    assert "restored checkpoint at step 2" in out.stderr
    final = float(re.search(r"final loss (\S+)$", done[0]).group(1))
    _, losses = train_cli.main([*ARGS, "--ckpt-dir", str(tmp_path / "one")])
    capsys.readouterr()
    np.testing.assert_allclose(final, losses[-1], rtol=2e-5)
    import json
    manifest = json.loads((tmp_path / "mesh" / "step_00000004" / "manifest.json").read_text())
    assert manifest["mesh_shape"] == [2, 1]
