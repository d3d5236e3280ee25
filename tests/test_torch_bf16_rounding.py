"""The port's bf16 network rounds no more than the JAX package's with every
op rounded (ROADMAP §C, the bf16 item of the metric level).

The tiny model (nstack 2, inp_dim 32, increase 16) with Kaiming-drawn
weights and random BatchNorm statistics (``chip_smoke.fan_in_init``'s
draw, from seed 0), in inference mode, on 4 × 128² random frames: the
relative L2 distance of the bf16 network's last-stack finest maps from the
fp32 network's, in each package on the same weights. The JAX bf16 network
runs under ``jax.disable_jit()``, so every op's result is rounded to bf16
as the port's eager ops round theirs; its fp32 network runs jitted (fp32
has no excess precision to keep). Held: the port's distance ≤ 1.05 × the
JAX package's. The JAX jit-compiled distance, where XLA keeps fp32 inside
its fusions and lands closer to fp32, is printed beside it and not held.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu.utils.checkpoint import convert_torch_state_dict
from improved_body_parts_tpu_torch import configs as tconfigs
from improved_body_parts_tpu_torch.models.imhn import PoseNet
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

TINY = dict(nstack=2, inp_dim=32, increase=16)
FRAMES, SIZE, SEED = 4, 128, 0
RATIO = 1.05


@torch.no_grad()
def kaiming_model(seed: int) -> PoseNet:
    """The tiny fp32 network, conv and linear weights N(0, 2 / fan_in),
    biases and BatchNorm statistics drawn (``chip_smoke.fan_in_init``)."""
    g = torch.Generator().manual_seed(seed)
    model = PoseNet(tconfigs.ModelConfig(**TINY), compute_dtype=torch.float32,
                    generator=g)
    for m in model.modules():
        if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            m.weight.normal_(0.0, (2.0 / m.weight[0].numel()) ** 0.5, generator=g)
            if m.bias is not None:
                m.bias.normal_(0.0, 0.1, generator=g)
        elif isinstance(m, torch.nn.BatchNorm2d):
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 2.0, generator=g)
            m.weight.uniform_(0.5, 1.0, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
    return model.eval()


def _rel_l2(a: np.ndarray, b: np.ndarray) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_port_bf16_rounds_no_more_than_jax_with_every_op_rounded():
    state = kaiming_model(SEED).state_dict()
    x = np.random.RandomState(SEED).rand(FRAMES, SIZE, SIZE, 3).astype(np.float32)
    port = {}
    for dt in (torch.float32, torch.bfloat16):
        m = PoseNet(tconfigs.ModelConfig(**TINY), compute_dtype=dt)
        m.load_state_dict(state, strict=True)
        with torch.no_grad():
            port[dt] = m.eval()(torch.from_numpy(x))[-1][0].float().numpy()
    params, stats = convert_torch_state_dict(state)
    variables = {"params": params, "batch_stats": stats}
    jx = {}
    for dt in (jnp.float32, jnp.bfloat16):
        jm = jimhn.create_model(jconfigs.ModelConfig(**TINY), dtype=dt)
        fwd = lambda v, a, jm=jm: jm.apply(v, a, train=False)[-1][0]
        jx["jit", dt] = np.asarray(jax.jit(fwd)(variables, jnp.asarray(x)), np.float32)
    with jax.disable_jit():
        jm = jimhn.create_model(jconfigs.ModelConfig(**TINY), dtype=jnp.bfloat16)
        jx["eager", jnp.bfloat16] = np.asarray(
            jm.apply(variables, jnp.asarray(x), train=False)[-1][0], np.float32)
    # the fp32 networks agree (tests/test_torch_parity.py's tolerance)
    np.testing.assert_allclose(port[torch.float32], jx["jit", jnp.float32],
                               atol=2e-4)
    ours = _rel_l2(port[torch.bfloat16], port[torch.float32])
    rounded = _rel_l2(jx["eager", jnp.bfloat16], jx["jit", jnp.float32])
    fused = _rel_l2(jx["jit", jnp.bfloat16], jx["jit", jnp.float32])
    print(f"bf16 against fp32, relative L2 of the last stack's finest maps: "
          f"port {ours:.5f}, JAX every op rounded {rounded:.5f} "
          f"({ours / rounded:.3f}x), JAX jit-compiled {fused:.5f} (not held)")
    assert ours <= RATIO * rounded, (ours, rounded, fused)
