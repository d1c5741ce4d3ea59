"""Device time of the collectives a step on rank 0: kernels whose name
holds ``nccl`` (the global BN's all-reduces in every BN call, the
gradient's and the losses' all-reduces), waits for the other ranks
included, as NCCL's kernels spin until their peers arrive."""


def read(t, cfg):
    s = t.kernel_seconds("nccl")
    return None if not s or not t.units else s / t.units * 1e3
