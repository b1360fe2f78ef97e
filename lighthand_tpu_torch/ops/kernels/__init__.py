"""Hand-written CUDA kernels (``csrc/``) that take the place of the JAX
package's Pallas kernels, each with its wrapper and plain twin:

- ``fused_aug.fused_aug_targets_cuda`` (K1) replaces
  ``lighthand_tpu/ops/pallas/fused_aug.py:fused_aug_targets_pallas``;
- ``heatmap.generate_target_batch_cuda`` (K2) replaces
  ``lighthand_tpu/ops/pallas/heatmap.py:generate_target_batch_pallas``;

and three with no Pallas counterpart:

- ``int8_conv.int8_conv2d_cuda``, the int8 convolution of the
  ``int8_fwd`` policy, which the JAX package leaves to XLA
  (``lighthand_tpu/ops/quant.py:54``);
- ``rasterize.rasterize_mesh_cuda``, the mesh renderer's z-buffered
  rasterizer, which the JAX package runs on the host in numpy
  (``lighthand_tpu/utils/mesh_render.py:119``);
- ``batch_norm.batch_norm`` (the ``batch_norm_train_cuda``,
  ``batch_norm_eval_cuda`` and ``batch_norm_backward_cuda`` wrappers), the
  models' BatchNorm with its fused ReLU or residual block end (add and
  ReLU), which the JAX package leaves to XLA (Flax's ``nn.BatchNorm`` in
  ``lighthand_tpu/models/layers.py:111``).
"""
