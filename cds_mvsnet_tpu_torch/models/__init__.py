from .cds_mvsnet import CDSMVSNet, build_model, resolve_device, strict_fp32, to_tensors
from .warp_routes import Routes

__all__ = ["CDSMVSNet", "Routes", "build_model", "resolve_device", "strict_fp32", "to_tensors"]
