"""PyTorch/CUDA port of the serving path of ``improved_body_parts_tpu``.

The JAX package beside it is the reference this port is held against. This
package imports ``torch`` and never ``jax``; the jax-free host modules of the
JAX package (``configs``, ``ops.group``, ``ops.group_cpp``, ``data.synthetic``,
``data.heatmaps``, ``utils.common``, ``infer.serving``) are reused, not copied.

Layout mirrors the JAX package: ``models/`` (the IMHN ``PoseNet``), ``ops/``
(peaks, limbs, warps, the two hand-written CUDA kernels and their build),
``infer/`` (the ``Predictor``: flip, multi-scale and rotation TTA),
``apps/`` (the demo and evaluate entry points), ``utils/`` (device and
checkpoint helpers) and ``csrc/`` (the CUDA sources).
"""
