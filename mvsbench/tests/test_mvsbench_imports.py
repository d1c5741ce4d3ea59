"""Nothing the benchmark runs loads JAX or the JAX package, compared by
whole top-level names; the reference loads nothing of the port."""

import subprocess
import sys

from mvsbench.harness import BENCH_DIR, forbidden_modules

ROOT = BENCH_DIR.parent


def _modules_after(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
                          "for m in sys.modules})))"], cwd=ROOT, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_the_harness_loads_no_jax():
    mods = _modules_after("import mvsbench.run, mvsbench.drivers.eval, mvsbench.drivers.train, mvsbench.trace, "
                          "mvsbench.calibrate, mvsbench.program as p\n"
                          "p.parameter_shapes({'model': {'refine': True, 'ndepths': [48, 32, 8], "
                          "'depth_intervals_ratio': [4, 2, 1], 'share_cr': False, 'cr_base_chs': [8, 8, 8], "
                          "'grad_method': 'detach'}})\np.launch_counts()")
    assert "cds_mvsnet_tpu_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "cds_mvsnet_tpu"}


def test_the_reference_loads_nothing_of_the_port():
    mods = _modules_after("import mvsbench.reference.model, mvsbench.reference.train, mvsbench.reference.compare, "
                          "mvsbench.roofline.flops, mvsbench.roofline.kernels, mvsbench.inputs.synthetic, "
                          "mvsbench.weights")
    assert not mods & {"jax", "jaxlib", "flax", "cds_mvsnet_tpu", "cds_mvsnet_tpu_torch"}


def test_the_look_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "cds_mvsnet_tpu_torch_fake", sys)
    assert "cds_mvsnet_tpu" not in forbidden_modules()
    monkeypatch.setitem(sys.modules, "cds_mvsnet_tpu.models", sys)
    assert forbidden_modules() == ["cds_mvsnet_tpu"]
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert forbidden_modules() == ["cds_mvsnet_tpu", "jax"]
