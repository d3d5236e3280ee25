"""``apps.train`` on 2 gloo ranks on the CPU under ``torchrun``: the
resident feed with the store sharded over the ranks, 2 steps a dispatch
(eager under gloo), an epoch written by rank 0 alone (one log line, one
``.pth``), then resumed by both ranks with ``-r``. The ranks are killed
with SIGKILL if they outlast their time limit."""

import os
import signal
import socket
import subprocess
import sys

import torch

from improved_body_parts_tpu_torch.utils import checkpoint as ckpt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _torchrun(args, timeout=240):
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
           "--master-port", str(port), "-m", "improved_body_parts_tpu_torch.apps.train",
           *args]
    proc = subprocess.Popen(cmd, cwd=REPO, env=dict(os.environ, OMP_NUM_THREADS="1"),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True, start_new_session=True)
    try:
        out = proc.communicate(timeout=timeout)[0]
    finally:
        try:
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    assert proc.returncode == 0, out[-4000:]
    return out


def test_torchrun_two_ranks_write_once_and_resume(tmp_path):
    args = ["--device", "cpu", "--tiny-model", "--image-size", "64", "--batch-size", "2",
            "--feed", "resident", "--resident-augment", "--resident-shard-store",
            "--steps-per-dispatch", "2", "--epochs", "1", "--steps-per-epoch", "3",
            "--synthetic-length", "7", "--workers", "0", "-p", str(tmp_path)]
    out = _torchrun(args)
    assert "rank 1 of 2 (gloo)" in out and "global batch 4" in out
    assert "trimming 1 records to divide over 2 ranks" in out
    first = ckpt.restore_train_state(str(tmp_path / "pth"))
    assert (first["step"], first["epoch"]) == (3, 0)
    args[args.index("--epochs") + 1] = "2"
    out = _torchrun(args + ["-r"])
    assert out.count("resumed from epoch 0") == 2
    resumed = ckpt.restore_train_state(str(tmp_path / "pth"))
    assert (resumed["step"], resumed["epoch"]) == (6, 1)
    log = (tmp_path / "log").read_text().splitlines()
    assert [line.split("\t")[0] for line in log] == ["Epoch 0", "Epoch 1"]
    assert all(torch.isfinite(v).all() for v in resumed["weights"].values()
               if v.is_floating_point())
