"""The ``spatial`` mesh axis of the port (``parallel/spatial.py``, the
spatial ``Mesh`` of ``parallel/mesh.py``), on gloo ranks on the CPU.

  * Every conv form of the network on bands of rows, for S = 2 and S = 4
    ranks of one spatial group (``tests/_torch_spatial_cases.py``): the
    7×7 stride-2 stem, a 3×3 conv, the dilated d = 5 conv, a 1×1 conv (each
    with train-mode BatchNorm over the bands), ``max_pool2``,
    ``upsample_nearest2``, ``SELayer`` and a gathered one-row hourglass
    level, each equal to the unsharded op in output, input gradient and
    weight gradient within 1e-12 of the values' scale, float64; and the
    same for whole tiny networks at 64² (every stack and scale), with
    each ``PoseNet`` flag (``extra_attention``, ``cross_stack=False``),
    ``IndependentPoseNet`` and ``AEPoseNet``, within 1e-6 (``TOL64``: train-mode BN through
    a whole network amplifies float64 rounding, as tests/test_torch_train.py
    measures; 2e-9 is seen).
  * The rows each rank gets from ``shard_batch``/``staged_chunks`` with and
    without ``shard_spatial`` are the index of its device's shard in JAX's
    ``batch_sharding``/``chunked_batch_sharding`` on ``make_mesh(4,
    spatial=2)``.
  * ``DeviceHeatmapper.render`` of a row range equals those rows of the
    whole render, bit for bit.
  * The K-steps dispatch of a banded step runs eagerly only where a
    resident one does: under gloo, with gloo's reason; on a stand-in NCCL
    mesh on a CUDA card no reason keeps either from the CUDA graph.
  * The tiny train step (nstack 2, 64², remat) on 2 ranks as data 1 ×
    spatial 2 against the port's own one-process step on the same batch:
    float64 train-mode BN, two steps, within 1e-6 of each tensor's scale,
    the ranks bit-identical.
"""

import dataclasses

import numpy as np
import pytest
import torch

from improved_body_parts_tpu.parallel import mesh as jmesh
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.data.heatmaps_device import DeviceHeatmapper
from improved_body_parts_tpu_torch.parallel import mesh as mesh_lib
from tests._torch_dist_child import run_ranks
from tests._torch_spatial_cases import CASES, MODEL_CASES
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import port_model
from tests.test_torch_train import LRS, TOL64, _batch, _configs, _rel

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def op_errors(tmp_path_factory):
    """{S: every rank's {case: (largest error, scale)}}."""
    return {S: run_ranks({"kind": "spatial_ops"}, tmp_path_factory.mktemp(f"s{S}"),
                         world=S, timeout=120)
            for S in (2, 4)}


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", CASES)
def test_conv_forms_on_bands_equal_the_unsharded_op(op_errors, case, S):
    for rank, out in enumerate(op_errors[S]):
        err, scale = out[case]
        assert err <= 1e-12 * max(scale, 1.0), (rank, err, scale)


@pytest.mark.parametrize("S", [2, 4])
@pytest.mark.parametrize("case", MODEL_CASES)
def test_networks_on_bands_equal_the_unsharded_network(op_errors, case, S):
    for rank, out in enumerate(op_errors[S]):
        err, scale = out[case]
        assert err <= TOL64 * max(scale, 1.0), (rank, err, scale)


def _rank_mesh(rank: int) -> mesh_lib.Mesh:
    """Rank ``rank`` of 4 on a data 2 × spatial 2 mesh (no process group:
    the staging reads only the indices)."""
    return mesh_lib.Mesh((CPU,), rank=rank, world=4, spatial=2)


@pytest.mark.parametrize("shard_spatial", [True, False])
def test_shard_batch_rows_are_the_jax_shards(shard_spatial):
    jm = jmesh.make_mesh(4, spatial=2)
    x = np.arange(4 * 8 * 6 * 3, dtype=np.float32).reshape(4, 8, 6, 3)
    index = jmesh.batch_sharding(jm, shard_spatial).devices_indices_map(x.shape)
    for rank, dev in enumerate(jm.devices.flat):
        mesh = _rank_mesh(rank)
        assert (mesh.data_index, mesh.spatial_index) == (rank // 2, rank % 2)
        got = mesh_lib.shard_batch(mesh, x, shard_spatial=shard_spatial)
        np.testing.assert_array_equal(got.numpy(), x[index[dev]])


def test_staged_chunk_rows_are_the_jax_shards():
    jm = jmesh.make_mesh(4, spatial=2)
    steps = [np.random.RandomState(k).rand(4, 8, 6, 3).astype(np.float32)
             for k in range(2)]
    whole = np.stack(steps)
    index = jmesh.chunked_batch_sharding(jm, True).devices_indices_map(whole.shape)
    for rank, dev in enumerate(jm.devices.flat):
        mesh = _rank_mesh(rank)
        local = [s[mesh_lib.process_batch_slice(4, mesh=mesh)] for s in steps]
        (n, chunk), = mesh_lib.staged_chunks(mesh, local, 2, shard_spatial=True)
        assert n == 2
        np.testing.assert_array_equal(chunk.numpy(), whole[index[dev]])


class _StandInMesh(mesh_lib.Mesh):
    """Rank 1 of a data 1 × spatial 2 mesh on a CUDA card whose group is
    of ``_backend`` (no process group: the dispatch reads only the mesh)."""
    _backend = "nccl"

    @property
    def backend(self):
        return self._backend


@pytest.mark.parametrize("backend", ["gloo", "nccl"])
def test_a_banded_dispatch_runs_eagerly_only_under_gloo(monkeypatch, backend):
    """K steps a dispatch of a step sharded into bands of rows are captured
    as the data axis's are: on a CUDA card over NCCL no reason keeps them
    eager; over gloo the gloo reason does, for the banded step and the
    resident one (whole images) alike."""
    _, cfg = _configs()
    model = port_model(cfg, torch.float32)
    monkeypatch.setattr(_StandInMesh, "_backend", backend)
    mesh = _StandInMesh((torch.device("cuda", 0),), rank=1, world=2,
                        group=object(), spatial=2)
    assert mesh.data_parallel and mesh.backend == backend
    banded = train_lib.make_multi_train_step(model, cfg, mesh=mesh,
                                             shard_spatial=True)
    resident = train_lib.make_multi_resident_train_step(model, cfg, mesh=mesh)
    if backend == "gloo":
        assert banded.eager_reason == resident.eager_reason == (
            "the gloo process group cannot be captured in a CUDA graph: K "
            "steps a dispatch run eagerly")
    else:
        assert banded.eager_reason is None and resident.eager_reason is None


@pytest.mark.parametrize("S", [2, 4])
def test_render_of_a_row_range_equals_those_rows_of_the_whole(S):
    _, cfg = _configs()
    _, _, joints, mask_all = _batch(np.float32)
    r = DeviceHeatmapper(cfg)
    joints, mask_all = torch.from_numpy(joints), torch.from_numpy(mask_all)
    whole = r.render(joints, mask_all)
    assert whole.shape[1] == r.h == 16
    for s in range(S):
        lo, hi = s * r.h // S, (s + 1) * r.h // S
        assert torch.equal(r.render(joints, mask_all, rows=(lo, hi)), whole[:, lo:hi])


def remat_configs():
    jcfg, cfg = _configs()
    remat = lambda c: dataclasses.replace(c, model=dataclasses.replace(c.model,
                                                                       remat=True))
    return remat(jcfg), remat(cfg)


def spatial_spec(cfg, payload, batches, freeze_bn, dtype, spatial=2):
    return dict(kind="train", config=cfg, payload=payload, batches=batches,
                lrs=list(LRS), freeze_bn=freeze_bn, dtype=dtype, spatial=spatial)


def assert_ranks_bit_identical(outs):
    a = outs[0]["payload"]
    for o in outs[1:]:
        np.testing.assert_equal(o["metrics"], outs[0]["metrics"])
        b = o["payload"]
        for key in ("weights", "swa_params"):
            assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
        ma, mb = (p["optimizer_weight"]["momentum_buffer"] for p in (a, b))
        assert all(torch.equal(ma[k], mb[k]) for k in ma)


def test_two_bands_match_one_process_float64(tmp_path):
    _, cfg = remat_configs()
    batches = [_batch(np.float64)]
    batches.append(tuple(np.random.RandomState(1).permutation(a)
                         for a in batches[0]))
    model = port_model(cfg, torch.float64)
    state = train_lib.create_train_state(model, cfg.train)
    start = train_lib.state_payload(state, cfg.train)
    outs = run_ranks(spatial_spec(cfg, start, batches, False, "float64"),
                     tmp_path, world=2)
    assert_ranks_bit_identical(outs)
    step = train_lib.make_train_step(model, cfg, compact_gt=True)
    want = []
    for (imgs, mask, joints, mask_all), lr in zip(batches, LRS):
        t = torch.from_numpy
        m = step(state, t(imgs), t(mask), (t(joints), t(mask_all)), lr)
        want.append({k: float(v) for k, v in m.items()})
    got = outs[0]["metrics"]
    for g, w in zip(got, want):
        assert g["skipped"] == w["skipped"] == 0.0
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=1e-12)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=TOL64)
    one = train_lib.state_payload(state, cfg.train)
    two = outs[0]["payload"]
    assert _rel(two["weights"], one["weights"], 1e-6) < TOL64
    assert _rel(two["optimizer_weight"]["momentum_buffer"],
                one["optimizer_weight"]["momentum_buffer"], 1e-6) < TOL64
