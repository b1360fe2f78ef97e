from lighthand_tpu_torch.core.device import resolve_device
from lighthand_tpu_torch.core.dtypes import DEFAULT_POLICY, DTypePolicy
from lighthand_tpu_torch.core.mesh import MeshSpec, create_mesh, is_host_leader

__all__ = ["DEFAULT_POLICY", "DTypePolicy", "MeshSpec", "create_mesh",
           "is_host_leader", "resolve_device"]
