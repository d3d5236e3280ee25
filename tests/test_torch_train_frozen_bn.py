"""The port's train step with frozen BatchNorm (the SWA epochs' mode),
its dense and compact feeds, and SWA, against the JAX package's; the
helpers, the configuration and the tolerances are tests/test_torch_train.py's
(kept in a file of its own so the two JAX compilations run on two test
workers).
"""

import jax
import pytest
import torch

from improved_body_parts_tpu import train_lib as jtrain_lib
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch import train_lib
from improved_body_parts_tpu_torch.utils import checkpoint as ckpt
from tests.test_torch_train import (
    LRS, _configs, _feed, _port_state, _rel, check_two_steps, jax_trajectory,
)
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module")
def jax_run():
    return jax_trajectory(freeze_bn=True)


@pytest.mark.parametrize("feed", ["dense", "compact"])
def test_two_frozen_bn_steps_match_jax(jax_run, feed):
    check_two_steps(jax_run, feed, freeze_bn=True)


def test_dense_and_compact_feeds_take_the_same_step(jax_run):
    model, cfg, batch, runs = jax_run
    out = []
    for compact in (False, True):
        state = _port_state(model, cfg, runs[True][0])
        step = train_lib.make_train_step(state.model, cfg, compact_gt=compact)
        metrics = step(state, *_feed(batch, cfg, compact), LRS[0])
        out.append((float(metrics["loss"]), train_lib.state_payload(state, cfg.train)))
    assert out[0][0] == pytest.approx(out[1][0], rel=1e-5)
    assert _rel(out[0][1]["weights"], out[1][1]["weights"]) < 1e-5


def test_swa_update_and_swap_match_jax(jax_run):
    model, cfg, _, runs = jax_run
    jcfg, _ = _configs()
    payload, _ = runs[True][1]
    state = _port_state(model, cfg, payload)
    jstate = jtrain_lib.create_train_state(
        *convert_torch_state_dict(payload["weights"]), jcfg.train)
    for _ in range(2):                        # avg of the same params, twice
        train_lib.swa_update(state)
        jstate = jtrain_lib.swa_update(jstate)
    with torch.no_grad():
        for p in state.model.parameters():
            p.mul_(0.5)
    jstate = jstate._replace(params=jax.tree_util.tree_map(
        lambda p: p * 0.5, jstate.params))
    train_lib.swa_update(state)
    jstate = jtrain_lib.swa_update(jstate)
    want = ckpt.train_state_from_flax(jstate)
    got = train_lib.state_payload(state, cfg.train)
    assert got["swa_count"] == want["swa_count"] == 3
    assert _rel(got["swa_params"], want["swa_params"]) < 1e-6
    train_lib.swa_swap(state)
    want = ckpt.train_state_from_flax(jtrain_lib.swa_swap(jstate))
    got = train_lib.state_payload(state, cfg.train)
    params = {k: got["weights"][k] for k in want["swa_params"]}
    assert _rel(params, {k: want["weights"][k] for k in params}) < 1e-6
    assert _rel(got["swa_params"], want["swa_params"]) < 1e-6


