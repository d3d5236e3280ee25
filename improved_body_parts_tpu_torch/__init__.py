"""PyTorch/CUDA port of ``improved_body_parts_tpu`` for one NVIDIA H100.

It serves (batched flip-TTA behind ``PipelinedServer``, multi-scale and
rotation TTA, the demo and evaluate entry points), trains (loss, train-mode
BatchNorm, the SGD step, GT rendered on the device, the device-resident
feed with its augmentation on the card, K steps a dispatch replayed from a
CUDA graph of the captured step, checkpoints, ``apps/train.py``), on one
card or on several over the JAX package's data × spatial mesh
(``parallel/mesh.py``: one process a card, train-mode BatchNorm over the
global batch, the resident store sharded over the data axis; with a
``spatial`` axis the image height sharded over cards, halos exchanged
around every conv, ``parallel/spatial.py``; mesh-sharded serving),
quantizes to int8 after
training (fold, calibrate,
int8 serving) and builds every model variant of the JAX package
(``extra_attention``, ``cross_stack=False``, ``IndependentPoseNet``,
``AEPoseNet``). Its measurement and evaluation entry points (the e2e
benchmark, network-only speed with MFU, the post-processing and train-step
profiles, crowd grouping, the int8 export, the AP curve and the
trained-checkpoint smoke) run on the card too, and ``tools/metric_level``
trains ``Canonical`` with the JAX package's recipe and scores it there.

The JAX package beside it is the reference this port is held against. This
package imports ``torch`` and never ``jax``, and nothing of the JAX package:
the jax-free host modules it needs (``configs``, ``ops.group``,
``ops.group_cpp`` with ``csrc/grouping.cpp``, ``data.heatmaps``,
``data.synthetic``, ``utils.common``, ``utils.oks_eval``,
``utils.config_reader``, ``infer.serving``) are kept here as copies, under the same names, and the
tests hold each copy against its original.

Layout mirrors the JAX package: ``models/`` (the IMHN ``PoseNet``, its
variants and int8 quantization), ``ops/`` (peaks, limbs, warps, grouping,
the hand-written CUDA kernels ``nms``, ``fused_peaks``, ``int8_quantize``
and ``int8_conv`` and their build), ``infer/`` (the ``Predictor`` and
``PipelinedServer``), ``apps/`` (the demo, evaluate, train, bench and
inference-speed entry points), ``data/`` (synthetic scenes, their ground-truth maps and the
training feeds, the resident store among them), ``train_lib`` and
``train_graph`` (the train steps and their CUDA-graph dispatch),
``parallel/`` (process groups, the mesh, the data-parallel collectives,
the spatial axis's halo exchanges),
``utils/`` (device, checkpoint, drawing, OKS evaluation, profiling and
INI helpers), ``tools/`` (the int8 kernel's probe, the multi-process dry
run, the measurement and evaluation tools) and
``csrc/`` (the CUDA and C++ sources).
"""
