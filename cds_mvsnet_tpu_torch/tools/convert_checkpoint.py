"""Convert a released PyTorch CDS-MVSNet checkpoint to the ``.npz`` format.

    python -m cds_mvsnet_tpu_torch.tools.convert_checkpoint SRC DST

Counterpart of the JAX package's ``tools/convert_checkpoint.py``: ``SRC`` (an
upstream ``.pth``/``.ckpt``, or a ``save_params`` ``.npz``) through
``load_any_checkpoint`` to ``DST``, an ``.npz`` in the JAX package's
``save_params`` format, which ``build_model(params=...)`` and the JAX
package's ``load_params`` read; prints the same line. The conversion is
host work; like every entry point of the port the tool runs where a card is
present unless ``main(device="cpu")`` is asked for, and raises otherwise.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, device=None) -> dict:
    """Convert; returns the written tree's leaves by dotted key."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("src", help=".pth/.ckpt torch checkpoint")
    p.add_argument("dst", help="output .npz path")
    args = p.parse_args(argv)

    from ..models.cds_mvsnet import resolve_device
    from ..models.convert import flatten_params, load_any_checkpoint, save_params

    resolve_device(device or "cuda")
    params = load_any_checkpoint(args.src)
    save_params(args.dst, params)
    flat = flatten_params(params)
    total = sum(np.asarray(v).size for v in flat.values())
    print(f"converted {len(flat)} tensors / {total} elements -> {args.dst}")
    return flat


if __name__ == "__main__":
    main()
