"""PyTorch/CUDA port of ``improved_body_parts_tpu`` for one NVIDIA H100.

It serves (batched flip-TTA behind ``PipelinedServer``, multi-scale and
rotation TTA, the demo and evaluate entry points), trains (loss, train-mode
BatchNorm, the SGD step, GT rendered on the device, checkpoints,
``apps/train.py``), quantizes to int8 after training (fold, calibrate,
int8 serving) and builds every model variant of the JAX package
(``extra_attention``, ``cross_stack=False``, ``IndependentPoseNet``,
``AEPoseNet``).

The JAX package beside it is the reference this port is held against. This
package imports ``torch`` and never ``jax``, and nothing of the JAX package:
the jax-free host modules it needs (``configs``, ``ops.group``,
``ops.group_cpp`` with ``csrc/grouping.cpp``, ``data.heatmaps``,
``data.synthetic``, ``utils.common``, ``utils.oks_eval``,
``infer.serving``) are kept here as copies, under the same names, and the
tests hold each copy against its original.

Layout mirrors the JAX package: ``models/`` (the IMHN ``PoseNet``, its
variants and int8 quantization), ``ops/`` (peaks, limbs, warps, grouping,
the hand-written CUDA kernels ``nms``, ``fused_peaks``, ``int8_quantize``
and ``int8_conv`` and their build), ``infer/`` (the ``Predictor`` and
``PipelinedServer``), ``apps/`` (the demo, evaluate and train entry
points), ``data/`` (synthetic scenes, their ground-truth maps and the
training feeds), ``utils/`` (device, checkpoint, drawing and OKS evaluation
helpers), ``tools/`` (the int8 kernel's probe) and ``csrc/`` (the CUDA and
C++ sources).
"""
