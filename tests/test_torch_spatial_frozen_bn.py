"""The port's spatially sharded train step with frozen BatchNorm (the SWA
epochs' mode) in fp32 on 4 gloo ranks as data 2 × spatial 2, against the
JAX step on ``make_mesh(2, spatial=2)`` with the images' rows on the
spatial axis (the setting of tests/test_torch_spatial_train.py), two
steps of the compact feed: with fp32 images, and with the uint8 wire
format (``--feed compact-u8``: the images cross as uint8 and are
normalized in the step). Held at 1e-5 of each tensor's scale (loss,
gradient norm, parameters, momentum buffers), the BN statistics
unchanged, the four ranks bit-identical.

The JAX step on ``make_mesh(4, spatial=2)`` is not held: with frozen BN
too its gradient of the scale-3 features' first BN shift is 0.0064 of
that tensor's scale off its own unsharded step's (and the port's, which
agrees with the unsharded JAX step within 8e-6; ROADMAP §C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.models.imhn import create_model
from improved_body_parts_tpu_torch import train_lib
from tests._torch_dist_child import run_ranks
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)
from tests.test_torch_resident import assert_held, jax_state, port_model
from tests.test_torch_spatial import (
    assert_ranks_bit_identical, remat_configs, spatial_spec,
)
from tests.test_torch_spatial_train import jax_spatial_steps, two_batches

TOL = 1e-5


@pytest.mark.parametrize("wire", ["fp32", "uint8"])
def test_four_ranks_data2_spatial2_frozen_bn_match_jax_fp32(tmp_path, wire):
    jcfg, cfg = remat_configs()
    batches = two_batches(np.float32)
    if wire == "uint8":
        batches = [(np.clip(np.round(b[0] * 255.0), 0, 255).astype(np.uint8),
                    *b[1:]) for b in batches]
    model = port_model(cfg, torch.float32)
    jstep = jtrain_lib.make_train_step(create_model(jcfg.model, dtype=jnp.float32),
                                       jcfg, donate=False, freeze_bn=True,
                                       compact_gt=True)
    traj = jax_spatial_steps(jstep, jax_state(model, jcfg, np.float32), batches,
                             np.float32, n=2)
    start = train_lib.state_payload(train_lib.create_train_state(
        model, cfg.train), cfg.train)
    outs = run_ranks(spatial_spec(cfg, start, batches, True, "float32"),
                     tmp_path, world=4)
    assert_ranks_bit_identical(outs)
    assert_held(outs[0]["payload"], outs[0]["metrics"][-1], traj[-1][0],
                traj[-1][1], traj[0][0], freeze_bn=True, tol=TOL)
    np.testing.assert_allclose([m["loss"] for m in outs[0]["metrics"]],
                               [m["loss"] for _, m in traj], rtol=TOL)
