"""LightHand on PyTorch and CUDA: training SimpleBaseline and HRNet on an
NVIDIA GPU.

A second package beside ``lighthand_tpu`` (JAX on a TPU), which stays the
reference. Module for module it mirrors that package: ``config``, ``cli``,
``core``, ``data``, ``eval``, ``models``, ``ops`` (plain PyTorch),
``ops/kernels`` (the hand-written CUDA kernels that take the place of
``lighthand_tpu/ops/pallas``), ``parallel``, ``train`` and ``utils``. It
imports neither ``jax`` nor ``lighthand_tpu``.

Entry points (``python -m lighthand_tpu_torch.cli.train``, ``Trainer``,
``create_train_state``, ``make_fused_train_step``, ``make_train_step``,
``make_eval_step``, ``make_predict_step``) run on ``cuda`` unless the
caller passes ``--platform cpu`` / ``device="cpu"``; without a card and
without that argument they raise.
"""

__version__ = "0.1.0"

from lighthand_tpu_torch import ops  # noqa: E402,F401
