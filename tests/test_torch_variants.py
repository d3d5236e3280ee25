"""The port's model variants against the JAX package's: ``PoseNet`` with
``cross_stack=False`` and with ``extra_attention``, ``IndependentPoseNet``
(``legacy_blocks``) and ``AEPoseNet``, at the tiny size of
tests/test_variants.py (nstack 2, inp_dim 32, increase 16, 64² images).

Each JAX model is initialised, its weights and BN statistics randomised
from a numpy seed and carried across by ``state_dict_from_flax`` (strict
load). Forward in fp32 on the CPU: every output within 1e-4 of its span
(summation order differs). ``AEPoseNet`` in train mode: the forward, the
multi-task loss, every gradient and the updated BN statistics in float64
in both packages (``jax_float64`` of tests/test_torch_train.py, also
widening ``models/ae_pose.py``'s casts), within 1e-6 of each tensor's
scale. Then the entry points: ``create_model`` for every registry config,
``build_predictor`` serving ``Independent`` and ``FinalAttention`` (their
flags at the tiny width) and ``apps.train --model ae``.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from improved_body_parts_tpu import configs as jconfigs
from improved_body_parts_tpu import losses as jlosses
from improved_body_parts_tpu.models import ae_pose as jae
from improved_body_parts_tpu.models import imhn as jimhn
from improved_body_parts_tpu_torch import configs, losses
from improved_body_parts_tpu_torch.apps import demo_image as tdemo
from improved_body_parts_tpu_torch.models.ae_pose import AEPoseNet
from improved_body_parts_tpu_torch.models.imhn import (
    IndependentPoseNet, PoseNet, create_model,
)
from improved_body_parts_tpu_torch.utils.checkpoint import state_dict_from_flax
from tests.test_torch_train import jax_float64
from tests.test_torch_predict import single_torch_thread  # noqa: F401  (autouse)

TINY = dict(nstack=2, inp_dim=32, increase=16)
SIZE = 64
CPU = torch.device("cpu")
VARIANTS = {
    "cross_stack_false": dict(cross_stack=False),
    "extra_attention": dict(extra_attention=True),
    "independent": dict(cross_stack=False, legacy_blocks=True),
    "ae": dict(),
}


def run_jitted(fn, *args):
    """``jax.jit(fn)(*args)`` compiled without XLA's backend optimizations:
    these one-shot reference programs compile in half the time."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


@contextlib.contextmanager
def jax_float64_ae():
    """``jax_float64``, and ``models/ae_pose.py``'s ``jnp`` swapped for the
    same widened namespace."""
    with jax_float64():
        saved = jae.jnp
        jae.jnp = jimhn.jnp
        try:
            yield
        finally:
            jae.jnp = saved


def _jax_model(name, dtype, **extra):
    cfg = jconfigs.ModelConfig(**TINY, **VARIANTS[name], **extra)
    if name == "ae":
        return jae.AEPoseNet(cfg=cfg, dtype=dtype)
    return jimhn.create_model(cfg, dtype=dtype)


def _port_model(name, dtype=torch.float32, **extra):
    cfg = configs.ModelConfig(**TINY, **VARIANTS[name], **extra)
    if name == "ae":
        return AEPoseNet(cfg, compute_dtype=dtype, device="meta")
    return create_model(cfg, compute_dtype=dtype, device="meta")


def _randomised(variables, seed, dtype=np.float32):
    """Weights N(0, 0.05), BN scale U(0.5, 1.5), var U(0.5, 2), mean and
    shift N(0, 0.05), from a numpy seed."""
    rng = np.random.RandomState(seed)

    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "var" in name:
            v = rng.uniform(0.5, 2.0, x.shape)
        elif "scale" in name:
            v = rng.uniform(0.5, 1.5, x.shape)
        else:
            v = rng.randn(*x.shape) * 0.05
        return v.astype(dtype).reshape(x.shape)

    return jax.tree_util.tree_map_with_path(draw, variables)


def _pair(name, seed=0, dtype=np.float32, **extra):
    """(JAX model, randomised variables, port model with the same weights);
    ``extra`` model-config fields."""
    jdt = jnp.float64 if dtype == np.float64 else jnp.float32
    jmodel = _jax_model(name, jdt, **extra)
    # every value is drawn again, so the init is traced for its shapes only
    variables = jax.eval_shape(lambda x: jmodel.init(jax.random.PRNGKey(0), x,
                                                     train=False),
                               jnp.zeros((1, SIZE, SIZE, 3), jdt))
    variables = _randomised(variables, seed, dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    port = _port_model(name, tdt, **extra).to_empty(device=CPU).to(tdt)
    port.load_state_dict(state_dict_from_flax(variables["params"],
                                              variables["batch_stats"]), strict=True)
    return jmodel, variables, port


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_variant_forward_matches_jax_fp32(name):
    jmodel, variables, port = _pair(name)
    imgs = np.random.RandomState(1).rand(2, SIZE, SIZE, 3).astype(np.float32)
    want = run_jitted(lambda v, x: jmodel.apply(v, x, train=False), variables,
                      jnp.asarray(imgs))
    with torch.no_grad():
        got = port(torch.from_numpy(imgs))
        read_out = port.predict_maps(torch.from_numpy(imgs))
    assert len(got) == len(want) == TINY["nstack"]
    for t, (gs, ws) in enumerate(zip(got, want)):
        assert len(gs) == len(ws) == (1 if name == "ae" else 5)
        for s, (g, w) in enumerate(zip(gs, ws)):
            w = np.asarray(w)
            span = float(w.max() - w.min())
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-4 * span,
                                       err_msg=f"{name} stack {t} scale {s}")
    # the serving read-out skips dead work but is the same tensor
    torch.testing.assert_close(read_out, got[-1][0], rtol=0, atol=0)


def _rel(a, b, floor=1e-6):
    """max|a - b| over each tensor's own scale (at least ``floor`` of the
    largest), the worst over the dict."""
    top = max(float(np.abs(v).max()) for v in b.values())
    return max(float(np.abs(np.asarray(a[k]) - b[k]).max())
               / max(float(np.abs(b[k]).max()), floor * top) for k in b)


def test_ae_train_mode_loss_grads_and_bn_stats_match_jax_float64():
    """One train-mode forward of AEPoseNet (batch statistics in every BN),
    the multi-task loss with the single scale weight, its gradient with
    respect to every parameter, and the updated running statistics. The
    hourglasses are one level deep here (the forward test above holds the
    full depth), which cuts the JAX trace and compile to a third."""
    jtcfg = jconfigs.TrainConfig()
    rng = np.random.RandomState(2)
    imgs = rng.rand(2, SIZE, SIZE, 3)
    gt = rng.rand(2, SIZE // 4, SIZE // 4, 50)
    mask = (rng.rand(2, SIZE // 4, SIZE // 4, 1) > 0.2).astype(np.float64)
    with jax_float64_ae():
        jmodel, variables, port = _pair("ae", seed=3, dtype=np.float64, depth=1)
        params, stats = variables["params"], variables["batch_stats"]

        def loss_fn(p):
            preds, mut = jmodel.apply({"params": p, "batch_stats": stats},
                                      jnp.asarray(imgs), train=True,
                                      mutable=["batch_stats"])
            return jlosses.multi_task_loss(preds, jnp.asarray(gt),
                                           jnp.asarray(mask), jtcfg), mut
        (jloss, jmut), jgrads = run_jitted(
            jax.value_and_grad(loss_fn, has_aux=True), params)
        jloss = float(jloss)
        jgrads = jax.tree_util.tree_map(np.asarray, jgrads)
        jstats = jax.tree_util.tree_map(np.asarray, jmut["batch_stats"])

    bn_stats = {}
    preds = port(torch.from_numpy(imgs), bn_stats=bn_stats)
    assert [len(p) for p in preds] == [1, 1] and preds[0][0].dtype == torch.float64
    loss = losses.multi_task_loss(preds, torch.from_numpy(gt), torch.from_numpy(mask),
                                  configs.TrainConfig(**dataclasses.asdict(jtcfg)))
    names = [k for k, _ in port.named_parameters()]
    grads = torch.autograd.grad(loss, [p for _, p in port.named_parameters()])
    np.testing.assert_allclose(loss.item(), jloss, rtol=1e-9)

    want = state_dict_from_flax(jgrads, {})
    got = {k: g.numpy() for k, g in zip(names, grads)}
    assert set(got) == set(want)
    assert _rel(got, {k: v.numpy() for k, v in want.items()}) < 1e-6

    # running statistics as the JAX step commits them: 0.9 old + 0.1 batch
    module_name = {m: n for n, m in port.named_modules()}
    run = {}
    for bn, (mean, var) in bn_stats.items():
        n = module_name[bn]
        run[f"{n}.running_mean"] = (0.9 * bn.running_mean + 0.1 * mean).numpy()
        run[f"{n}.running_var"] = (0.9 * bn.running_var + 0.1 * var).numpy()
    jrun = {k: v.numpy() for k, v in state_dict_from_flax({}, jstats).items()
            if "running" in k}
    assert set(run) == set(jrun) and len(run) > 0
    assert _rel(run, jrun) < 1e-6


@pytest.mark.parametrize("name", sorted(configs.CONFIGS))
def test_create_model_builds_every_registry_config(name):
    cfg = configs.get_config(name).model
    model = create_model(cfg, device="meta")
    want = IndependentPoseNet if cfg.legacy_blocks else PoseNet
    assert type(model) is want
    if want is PoseNet:
        assert (model.chattn is not None) == cfg.extra_attention
        assert len(model.merge_preds) == (cfg.nstack - 1 if cfg.cross_stack else 0)
    if cfg.legacy_blocks:
        with pytest.raises(ValueError, match="live PoseNet"):
            create_model(cfg, device="meta", quant="int8")


@pytest.mark.parametrize("name", ["Independent", "FinalAttention"])
def test_build_predictor_serves_the_variants(name, monkeypatch):
    """The registry entry's model flags at the tiny width, registered under
    a test name, built from a fresh init and served on the CPU."""
    flags = {k: getattr(configs.get_config(name).model, k)
             for k in ("legacy_blocks", "cross_stack", "extra_attention")}
    tiny = configs.CanonicalConfig(width=SIZE, height=SIZE,
                                   model=configs.ModelConfig(**TINY, **flags))
    monkeypatch.setitem(configs.CONFIGS, f"Tiny{name}", tiny)
    pred = tdemo.build_predictor("", f"Tiny{name}", device=CPU, dtype=torch.float32)
    assert type(pred.model) is (IndependentPoseNet if flags["legacy_blocks"]
                                else PoseNet)
    frames = np.random.RandomState(4).randint(0, 255, (2, SIZE, SIZE, 3), np.uint8)
    results = pred.predict_batch(frames)
    assert len(results) == 2 and all(k.shape[1:] == (18, 3) for k, _ in results)


def test_train_cli_model_ae_takes_a_step(tmp_path, capsys):
    from improved_body_parts_tpu_torch.apps import train as ttrain
    out = tmp_path / "ck"
    assert ttrain.main(["--device", "cpu", "--tiny-model", "--model", "ae",
                        "--epochs", "1", "--steps-per-epoch", "1", "--batch-size",
                        "1", "--image-size", "64", "-p", str(out), "--workers",
                        "0", "--print-freq", "1", "--dtype", "float32"]) == 0
    assert "=== epoch 0: train" in capsys.readouterr().out
    saved = torch.load(out / "pth" / "epoch_0.pth", weights_only=True)
    assert saved["step"] == 1
    assert any(k.startswith("hg0.d0_up1.convBlock") for k in saved["weights"])
