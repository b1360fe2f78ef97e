"""LightHand on PyTorch and CUDA: the HRNet train and eval steps on an NVIDIA GPU.

A second package beside ``lighthand_tpu`` (JAX on a TPU), which stays the
reference. Module for module it mirrors that package: ``core/dtypes``,
``models``, ``ops`` (plain PyTorch), ``ops/kernels`` (the hand-written CUDA
kernels that take the place of ``lighthand_tpu/ops/pallas``), ``train`` and
``utils/weights``. It imports neither ``jax`` nor ``lighthand_tpu``.

Entry points (``create_train_state``, ``make_fused_train_step``,
``make_train_step``, ``make_eval_step``, ``make_predict_step``) run on
``cuda`` unless the caller passes ``device="cpu"``; without a card and
without that argument they raise.
"""

__version__ = "0.1.0"
