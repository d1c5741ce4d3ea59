"""The trace's reduction: kernels to spans through the launch correlation,
the device's busy time as a union, idle gaps by what the host did."""

from mvsbench.trace import summarize


def _x(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur, "tid": tid, "args": args}


def test_kernels_go_to_the_span_that_launched_them():
    ev = [
        _x("mvsbench.window", "user_annotation", 0, 1000),
        _x("mvsbench.forward", "user_annotation", 10, 500),
        _x("mvsbench.feature", "user_annotation", 20, 100),
        _x("cudaLaunchKernel", "cuda_runtime", 30, 5, correlation=1),
        _x("cudaLaunchKernel", "cuda_runtime", 200, 5, correlation=2),
        _x("aten::conv2d", "cpu_op", 600, 300),
        _x("autograd::engine::evaluate_function: X", "cpu_op", 700, 100, tid=2),
        _x("cuLaunchKernel", "cuda_driver", 710, 5, tid=2, correlation=3),
        _x("dynconv_kernel", "kernel", 40, 100, tid=7, correlation=1),
        _x("warp_entropy_kernel<16>", "kernel", 120, 80, tid=7, correlation=2),
        _x("conv_bwd", "kernel", 720, 50, tid=7, correlation=3),
        _x("Memcpy HtoD", "gpu_memcpy", 900, 200, tid=7),
    ]
    s = summarize(ev, units=2)
    assert abs(s.window_s - 1000e-6) < 1e-12
    assert abs(s.busy_s - (160 + 50 + 100) * 1e-6) < 1e-12  # 40-200, 720-770, 900-1000 (clipped)
    assert abs(s.spans["mvsbench.feature"] - 100e-6) < 1e-12
    assert abs(s.spans["mvsbench.forward"] - 180e-6) < 1e-12
    assert abs(s.spans["autograd"] - 50e-6) < 1e-12
    assert s.launches == 3 and s.kernel_launches("warp_entropy") == 1
    assert abs(s.kernel_seconds("warp_entropy") - 80e-6) < 1e-12
    labels = dict(s.gaps)
    assert abs(labels["aten::conv2d"] - (130 + 720 - 770 + 900 - 720 + 0) * 1e-6) > -1  # the gaps under conv2d
    assert abs(sum(labels.values()) - (1000 - 310) * 1e-6) < 1e-12


def test_no_window_reads_nothing():
    assert summarize([_x("k", "kernel", 0, 1)], units=1) is None
