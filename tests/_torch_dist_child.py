"""Ranks of the port's data-parallel tests (tests/test_torch_dist_*.py):
``run_ranks`` starts ``world`` processes of this script, each one gloo rank
on the CPU, and returns what each wrote.

    python tests/_torch_dist_child.py <spec.pt> <out_dir> <rank> <world> <port>

The spec (``torch.save``d by ``run_ranks``) holds the port's config, the
state payload to start from, the BN mode and dtype, the device (default
the CPU; "cuda:0" puts every rank on the one card, "cuda" a card a rank;
on a card cuDNN is held to deterministic kernels), the backend (default
gloo; "nccl" for ranks a card each, whose single steps run under
``torch.cuda.set_sync_debug_mode("error")``), and
either global batches (``kind="train"``: (imgs, mask, joints, mask_all) a
step, the compact feed) or a resident store with global plans
(``kind="resident"``: the store's images, and plans made with
``store_shards=world``); with ``k`` > 1 either kind takes its steps k a
dispatch (``make_multi_train_step``, ``make_multi_resident_train_step``).
With ``spatial`` S the ranks lay out as data world/S × spatial S
(``make_mesh(spatial=S)``) and each ``train`` step takes this rank's band
of the images' and the mask's rows. ``kind="spatial_ops"`` runs
``tests/_torch_spatial_cases.py`` instead. Each
rank keeps its ``process_batch_slice`` of every batch (and its record
range of the store), takes the steps of ``train_lib`` with the
data-parallel mesh, leaves the group through ``parallel/mesh.shutdown``,
and writes ``rank<r>.pt``: the metrics of every step, the bytes of storage
each step's metrics hold, and the state payload after the last. With
``graph_probe`` the K-steps dispatch holds a stand-in for a captured CUDA
graph, which the rank also keeps a reference to, and
``graph_alive_at_destroy`` says whether that graph was not yet reset when
the group was destroyed.

Every rank has a time limit (``run_ranks(timeout=)``); on a failure or
the limit every rank is killed with SIGKILL, so no rank is left behind
waiting on a collective.
"""

import os
import signal
import socket
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_ranks(spec: dict, tmp_path, world: int = 2, timeout: float = 180.0):
    """Run the spec on ``world`` gloo ranks; their outputs, rank by rank.
    Raises with every rank's output if one fails or the time runs out."""
    import torch
    spec_path = os.path.join(str(tmp_path), "spec.pt")
    torch.save(spec, spec_path)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), spec_path, str(tmp_path),
         str(r), str(world), str(port)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, start_new_session=True)
        for r in range(world)]
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
        outs = [p.communicate()[0].decode(errors="replace") for p in procs]
    if any(p.returncode != 0 for p in procs):
        raise AssertionError("ranks failed or timed out:\n" + "\n".join(
            f"--- rank {r} (rc {p.returncode}):\n{o[-4000:]}"
            for r, (p, o) in enumerate(zip(procs, outs))))
    return [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def main(spec_path, out_dir, rank, world, port):
    import numpy as np
    import torch

    sys.path.insert(0, REPO)
    from improved_body_parts_tpu_torch import train_lib
    from improved_body_parts_tpu_torch.data.resident import ResidentStore
    from improved_body_parts_tpu_torch.models.imhn import PoseNet
    from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    spec = torch.load(spec_path, weights_only=False)
    backend = spec.get("backend", "gloo")
    device = mesh_lib.initialize_multihost(f"localhost:{port}", world, rank,
                                           device=spec.get("device", "cpu"),
                                           backend=backend, timeout_s=120)
    if device.type == "cuda":
        # the same kernels in every run of a step
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    if spec["kind"] == "spatial_ops":
        from tests import _torch_spatial_cases
        out = _torch_spatial_cases.run(rank, world)
        torch.distributed.destroy_process_group()
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
        return
    mesh = mesh_lib.make_mesh(spatial=spec.get("spatial", 1))
    mesh_lib.warm(mesh)         # every group of the rank, in the same order
    spatial = mesh.spatial > 1
    cfg, dtype = spec["config"], getattr(torch, spec["dtype"])
    model = PoseNet(cfg.model, compute_dtype=torch.float32,
                    generator=torch.Generator().manual_seed(0))
    model.to(device, dtype)
    model.compute_dtype = dtype
    state = train_lib.create_train_state(model, cfg.train)
    train_lib.load_payload(state, spec["payload"])
    freeze = spec["freeze_bn"]
    local = lambda a: torch.from_numpy(np.ascontiguousarray(
        a[mesh_lib.process_batch_slice(a.shape[0], mesh=mesh)])).to(device)
    metrics = []
    if spec["kind"] == "train" and spec.get("k", 1) > 1:
        # k steps a dispatch (train_graph.MultiStep; eager under gloo), the
        # chunks staged as the trainer stages them: this rank's slice of
        # each batch, and on a spatial mesh its band of the images' and the
        # mask's rows (the joints and mask_all whole)
        k = spec["k"]
        step = train_lib.make_multi_train_step(model, cfg, freeze_bn=freeze,
                                               compact_gt=True, mesh=mesh,
                                               shard_spatial=spatial)
        mine = lambda a: a[mesh_lib.process_batch_slice(a.shape[0], mesh=mesh)]
        banded = mesh_lib.staged_chunks(
            mesh, [(mine(b[0]), mine(b[1])) for b in spec["batches"]], k,
            shard_spatial=spatial)
        whole = mesh_lib.staged_chunks(
            mesh, [(mine(b[2]), mine(b[3])) for b in spec["batches"]], k)
        for lo, ((n, (imgs, mask)), (_, heat)) in zip(
                range(0, len(spec["batches"]), k), zip(banded, whole)):
            m = step(state, imgs, mask, heat,
                     torch.tensor(spec["lrs"][lo:lo + n], dtype=dtype,
                                  device=device))
            metrics += [{key: v[i] for key, v in m.items()} for i in range(n)]
    elif spec["kind"] == "train":
        step = train_lib.make_train_step(model, cfg, freeze_bn=freeze,
                                         compact_gt=True, mesh=mesh)
        staged = []
        for imgs, mask, joints, mask_all in spec["batches"]:
            # on a spatial mesh: this rank's band of the images' and the
            # mask's rows; the joints and mask_all whole
            imgs, mask = mesh_lib.shard_batch(mesh, (imgs, mask),
                                              shard_spatial=spatial)
            staged.append((imgs, mask, (local(joints), local(mask_all))))
        # over NCCL a host sync or a copy from the host inside a step raises
        # (gloo copies CUDA tensors through the host)
        checked = device.type == "cuda" and backend == "nccl"
        if checked:
            torch.cuda.set_sync_debug_mode("error")
        try:
            for b, lr in zip(staged, spec["lrs"]):
                metrics.append(step(state, *b, lr))
        finally:
            if checked:
                torch.cuda.set_sync_debug_mode(0)
    else:
        st = spec["store"]
        store = ResidentStore(st["images"], None, None, st["joints"], st["objpos"],
                              st["scale"]).device_arrays(device, shard=(rank, world))
        k = spec.get("k", 1)
        if k == 1:
            step = train_lib.make_resident_train_step(model, cfg, freeze_bn=freeze,
                                                      mesh=mesh)
            for (idx, inv_m, joints), lr in zip(spec["plans"], spec["lrs"]):
                metrics.append(step(state, store, local(idx), local(inv_m),
                                    local(joints).to(dtype), lr))
        else:
            # k steps a dispatch (train_graph.MultiStep; eager under gloo)
            step = train_lib.make_multi_resident_train_step(
                model, cfg, freeze_bn=freeze, mesh=mesh)
            for lo in range(0, len(spec["plans"]), k):
                plans = spec["plans"][lo:lo + k]
                idx, inv_m, joints = (torch.stack([local(p[i]) for p in plans])
                                      for i in range(3))
                m = step(state, store, idx, inv_m, joints.to(dtype),
                         torch.tensor(spec["lrs"][lo:lo + k], dtype=dtype))
                metrics += [{key: v[i] for key, v in m.items()}
                            for i in range(len(plans))]
    out = {"metrics": [{k: float(v) for k, v in m.items()} for m in metrics],
           # bytes each metric keeps alive (one element, not a view of
           # the all-reduced gradient buffer)
           "metric_bytes": [max(v.untyped_storage().nbytes() for v in m.values())
                            for m in metrics],
           "payload": train_lib.state_payload(state, cfg.train)}
    if spec.get("graph_probe"):
        # a stand-in for the GraphedStep a card captures (the CPU has none),
        # still referenced here as a caller might: the group may be
        # destroyed only once its graph has been reset
        class CapturedGraph:
            live = True

            def reset(self):
                self.live = False

        held = type("GraphedStep", (), {})()
        held.graph = CapturedGraph()
        step.graphed = held
        destroy = torch.distributed.destroy_process_group

        def checked_destroy(*a, **kw):
            out["graph_alive_at_destroy"] = held.graph.live
            return destroy(*a, **kw)

        torch.distributed.destroy_process_group = checked_destroy
    mesh_lib.shutdown(mesh, step)
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]))
