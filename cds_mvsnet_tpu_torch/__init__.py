"""PyTorch/CUDA port of CDS-MVSNet (the eval cascade and training) for one
NVIDIA H100.

The JAX package ``cds_mvsnet_tpu`` is the reference this package is held
against; nothing here imports it or JAX. Module names follow the JAX package
so each counterpart is easy to find. The hot spots that the JAX package ran
as Pallas kernels run here as hand-written CUDA kernels
(``ops/kernels/`` wrappers, ``csrc/*.cu`` sources), each with a plain
PyTorch version beside it.
"""

from .config import ModelConfig

__all__ = ["ModelConfig"]
