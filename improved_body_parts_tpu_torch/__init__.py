"""PyTorch/CUDA port of the serving path of ``improved_body_parts_tpu``.

The JAX package beside it is the reference this port is held against. This
package imports ``torch`` and never ``jax``, and nothing of the JAX package:
the jax-free host modules it needs (``configs``, ``ops.group``,
``ops.group_cpp`` with ``csrc/grouping.cpp``, ``data.heatmaps``,
``data.synthetic``, ``utils.common``, ``utils.oks_eval``,
``infer.serving``) are kept here as copies, under the same names, and the
tests hold each copy against its original.

Layout mirrors the JAX package: ``models/`` (the IMHN ``PoseNet``), ``ops/``
(peaks, limbs, warps, grouping, the two hand-written CUDA kernels and their
build), ``infer/`` (the ``Predictor`` and ``PipelinedServer``), ``apps/``
(the demo and evaluate entry points), ``data/`` (synthetic scenes and their
ground-truth maps), ``utils/`` (device, checkpoint, drawing and OKS
evaluation helpers) and ``csrc/`` (the CUDA and C++ sources).
"""
