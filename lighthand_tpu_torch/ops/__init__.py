"""Plain PyTorch ops; the CUDA kernels are in ``ops/kernels``."""

from lighthand_tpu_torch.ops.decode import get_max_preds, soft_argmax_preds
from lighthand_tpu_torch.ops.heatmap import (
    generate_heatmap_max,
    generate_target,
    generate_target_batch,
)
from lighthand_tpu_torch.ops.metrics import (
    bbox_diagonal,
    epe_train,
    epe_visible,
    joints_mse_loss,
    pck_2d,
    pck_2d_visible,
    pck_curve,
)
from lighthand_tpu_torch.ops.procrustes import (
    compute_similarity_transform,
    reconstruction_error,
)

__all__ = [
    "generate_target",
    "generate_target_batch",
    "generate_heatmap_max",
    "get_max_preds",
    "soft_argmax_preds",
    "bbox_diagonal",
    "pck_2d",
    "pck_2d_visible",
    "pck_curve",
    "epe_train",
    "epe_visible",
    "joints_mse_loss",
    "compute_similarity_transform",
    "reconstruction_error",
]
