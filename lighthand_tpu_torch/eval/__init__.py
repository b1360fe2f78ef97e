from lighthand_tpu_torch.eval.harness import (
    pred_store,
    pred_eval,
    pred_store_test,
    pred_test,
)

__all__ = ["pred_store", "pred_eval", "pred_store_test", "pred_test"]
