"""The port's multi-process dry run (``tools/dryrun_multichip.py``) on 4
gloo ranks on the CPU: the JAX dry run's mesh, data 2 × spatial 2, with
the dense, SWA frozen-BN, compact fp32 and uint8 and restored steps on
bands of rows, the resident steps and the K = 2 dispatch on the data
axis, and serving over a mesh of 4 CPU replicas; every stage agrees on
every rank."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_dryrun_on_four_cpu_ranks_takes_the_data_spatial_mesh():
    out = subprocess.run(
        [sys.executable, "-m", "improved_body_parts_tpu_torch.tools.dryrun_multichip",
         "4", "--device", "cpu", "--timeout", "300"],
        cwd=REPO, capture_output=True, text=True, timeout=330,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stdout[-3000:] + out.stderr[-3000:]
    lines = out.stdout.splitlines()
    assert "mesh: data=2 spatial=2" in lines
    assert any(ln.startswith("dryrun_multichip(4, gloo) OK: mesh data=2 spatial=2")
               for ln in lines), out.stdout[-3000:]
