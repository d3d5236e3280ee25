"""The port's PoseNet against the JAX PoseNet, the test mirror of the
reference (``torch_mirror.TPoseNet``) and the reference golden forward.

Tolerances: fp32 on the CPU everywhere. 2e-4 against Flax is the bound the
JAX package's own torch parity test uses (test_torch_parity.py); 5e-5 against
the golden is the JAX package's own golden bound (test_reference_parity.py).
"""

import dataclasses
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from improved_body_parts_tpu.configs import ModelConfig
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu.utils.checkpoint import (
    convert_torch_state_dict, export_to_torch_state_dict, map_reference_key,
)
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from improved_body_parts_tpu_torch.utils.checkpoint import (
    flax_to_reference_key, load_reference_pth, state_dict_from_flax,
)
from reference_parity_common import seeded_state_dict_arrays
from torch_mirror import TPoseNet
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden")
TINY = ModelConfig(nstack=2, inp_dim=32, increase=16, se_reduction=8)


def _port(cfg: ModelConfig) -> tconfigs.ModelConfig:
    """The same model config, as the port's ``configs`` class."""
    return tconfigs.ModelConfig(**dataclasses.asdict(cfg))


@pytest.fixture(scope="module")
def tiny_pair():
    """Flax fp32 tiny model with random weights and randomised BN stats, and
    the port built from the same variables through state_dict_from_flax."""
    fmodel = create_model(TINY, dtype=jnp.float32)
    variables = fmodel.init(jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3)), train=False)
    rng = np.random.RandomState(0)

    def randomise(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            return rng.uniform(0.5, 2.0, x.shape).astype(np.float32)
        if "scale" in name:
            return rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        return (rng.randn(*x.shape) * 0.05).astype(np.float32)

    variables = jax.tree_util.tree_map_with_path(randomise, variables)
    params, stats = variables["params"], variables["batch_stats"]
    port = PoseNet(_port(TINY), compute_dtype=torch.float32)
    port.load_state_dict(state_dict_from_flax(params, stats), strict=True)
    port.eval()
    return fmodel, params, stats, port


def test_forward_matches_flax_fp32(tiny_pair):
    fmodel, params, stats, port = tiny_pair
    imgs = np.random.RandomState(1).rand(2, 64, 64, 3).astype(np.float32)
    want = fmodel.apply({"params": params, "batch_stats": stats},
                        jnp.asarray(imgs), train=False)
    with torch.no_grad():
        got = port(torch.from_numpy(imgs))
        read_out = port.predict_maps(torch.from_numpy(imgs))
    for t in range(TINY.nstack):
        for s in range(TINY.num_scales):
            np.testing.assert_allclose(got[t][s].numpy(), np.asarray(want[t][s]),
                                       rtol=2e-4, atol=2e-4,
                                       err_msg=f"stack {t} scale {s}")
    # the serving read-out skips dead work but is the same tensor
    np.testing.assert_array_equal(read_out.numpy(), got[-1][0].numpy())


def test_loads_mirror_and_export_strict(tiny_pair):
    fmodel, params, stats, port = tiny_pair
    mirror = TPoseNet(nstack=2, inp_dim=32, oup_dim=50, increase=16,
                      reduction=8)
    assert list(port.state_dict()) == list(mirror.state_dict())
    fresh = PoseNet(_port(TINY), compute_dtype=torch.float32)
    fresh.load_state_dict(mirror.state_dict(), strict=True)
    # the JAX exporter's output (reference format) loads strictly too, and
    # carries the same weights as state_dict_from_flax
    exported = export_to_torch_state_dict(params, stats, mirror.state_dict())
    fresh.load_state_dict({k: torch.from_numpy(np.array(v))
                           for k, v in exported.items()}, strict=True)
    for k, v in port.state_dict().items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(fresh.state_dict()[k], v, rtol=0, atol=0)


@pytest.mark.parametrize("cfg", [TINY, ModelConfig()], ids=["tiny", "canonical"])
def test_key_mapping_inverts_jax_mapping(cfg):
    """For every Flax leaf the port's key is one that JAX's
    map_reference_key maps back to the same leaf, and the keys cover the
    port's state_dict exactly (full width built on the meta device)."""
    fmodel = create_model(cfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda r: fmodel.init(r, jnp.zeros((1, 64, 64, 3)),
                                                  train=False),
                            jax.random.PRNGKey(0))
    flax_leaf = {"kernel": "kernel", "bias": "bias", "scale": "weight",
                 "mean": "running_mean", "var": "running_var"}
    keys = set()
    for coll in ("params", "batch_stats"):
        for path, leaf in jax.tree_util.tree_leaves_with_path(shapes[coll]):
            names = tuple(p.key for p in path)
            key = flax_to_reference_key(names[:-1], names[-1])
            assert map_reference_key(key) == (names[:-1], flax_leaf[names[-1]]), key
            keys.add(key)
    port_keys = {k for k in PoseNet(_port(cfg), device="meta").state_dict()
                 if not k.endswith("num_batches_tracked")}
    assert keys == port_keys


def test_matches_reference_golden(tmp_path):
    """The golden forward of the REAL reference PoseNet (nstack 2, full width,
    128^2) through a reference-format .pth file."""
    d = np.load(os.path.join(GOLDEN, "model_forward_golden.npz"))
    manifest = json.loads(bytes(d["manifest"]).decode())
    keys = [k for k, _ in manifest]
    sd = seeded_state_dict_arrays(keys, {k: tuple(s) for k, s in manifest})
    weights = {"module." + k: (torch.from_numpy(sd[k]) if k in sd
                               else torch.tensor(0))   # num_batches_tracked
               for k in keys}
    path = tmp_path / "ref.pth"
    torch.save({"weights": weights, "epoch": 0}, path)
    model = PoseNet(tconfigs.ModelConfig(nstack=2), compute_dtype=torch.float32)
    model.load_state_dict(load_reference_pth(str(path)), strict=True)
    model.eval()
    with torch.no_grad():
        outs = model(torch.from_numpy(d["input"]))
    for t in range(2):
        for s in range(5):
            np.testing.assert_allclose(outs[t][s].permute(0, 3, 1, 2).numpy(),
                                       d[f"out_t{t}_s{s}"], atol=5e-5,
                                       err_msg=f"stack {t} scale {s}")


def test_flax_and_jax_converter_agree():
    """state_dict_from_flax inverts JAX's convert_torch_state_dict leaf for
    leaf (the round trip torch -> flax -> torch is exact)."""
    mirror = TPoseNet(nstack=2, inp_dim=32, oup_dim=50, increase=16,
                      reduction=8)
    sd = mirror.state_dict()
    params, stats = convert_torch_state_dict(sd)
    back = state_dict_from_flax(jax.tree_util.tree_map(np.asarray, params),
                                jax.tree_util.tree_map(np.asarray, stats))
    assert set(back) == set(sd)
    for k, v in sd.items():
        if not k.endswith("num_batches_tracked"):
            torch.testing.assert_close(back[k], v, rtol=0, atol=0)


def test_unported_variants_raise():
    """Every variant is ported (tests/test_torch_variants.py); what still
    raises: ``legacy_blocks`` through ``PoseNet`` (``create_model`` builds
    ``IndependentPoseNet``), quantizing ``IndependentPoseNet`` (as in JAX),
    and an unknown quant mode."""
    from improved_body_parts_tpu_torch.models.imhn import create_model
    legacy = tconfigs.ModelConfig(legacy_blocks=True, cross_stack=False)
    with pytest.raises(ValueError, match="create_model"):
        PoseNet(legacy, device="meta")
    with pytest.raises(ValueError, match="live PoseNet"):
        create_model(legacy, device="meta", quant="int8")
    with pytest.raises(ValueError, match="quant mode"):
        PoseNet(_port(TINY), device="meta", quant="int4")
    assert PoseNet(tconfigs.ModelConfig(extra_attention=True), device="meta",
                   quant="int8").chattn is not None
