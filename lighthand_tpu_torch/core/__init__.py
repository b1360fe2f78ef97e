from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy

__all__ = ["DEFAULT_POLICY", "DTypePolicy", "resolve_device"]
