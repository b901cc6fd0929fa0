from ocr_system_tpu_torch.core.config import Settings, get_settings
from ocr_system_tpu_torch.core.dtypes import DTypePolicy, default_policy
from ocr_system_tpu_torch.core.mesh import MeshConfig, get_mesh, mesh_context

__all__ = [
    "Settings",
    "get_settings",
    "DTypePolicy",
    "default_policy",
    "MeshConfig",
    "get_mesh",
    "mesh_context",
]
