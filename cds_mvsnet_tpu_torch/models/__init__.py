from .cds_mvsnet import CDSMVSNet, build_model, resolve_device, strict_fp32, to_tensors

__all__ = ["CDSMVSNet", "build_model", "resolve_device", "strict_fp32", "to_tensors"]
