"""On the card: the benchmark's conv ranges hold every K1 and K2 launch of
a traced training step, as many as the port's launch counters count.
Skips where no CUDA card is visible (decided inside the test)."""

import time

import pytest
import torch

from small import SEED, cell

K_NAMES = ("gather_gemm_", "conv_dw_")  # within the kernels' names; the split sums follow them
SUMS = "sum_splits_kernel"


@pytest.mark.cuda
def test_conv_ranges_hold_every_k1_and_k2_launch():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import minkowskiengine_tpu_torch as mt
    from minkowskiengine_tpu_torch.kernels.conv_dw import conv_dw
    from minkowskiengine_tpu_torch.kernels.gather_gemm import gather_gemm

    from portbench import harness, tracing

    c = harness.load_cell("minkunet34.train.scan5cm")  # the cell's own size
    dev = torch.device("cuda:0")
    tracer = tracing.Tracer(True)
    traffic = harness.traffic_class(c["kind"])(c, SEED, dev, tracer)
    spec = harness.reference_module(c["config"]).parameter_spec(c["config"])
    traffic.setup(mt, harness.make_weights(spec, SEED, dev), 1)
    convs = tracing.ConvRanges(traffic.model, mt.MinkowskiConvolutionBase, True)
    with tracing.HostClock(mt.CoordinateManager, tracer):
        before = gather_gemm.launches + conv_dw.launches
        with tracing.profiled() as prof:
            with tracer.span("step"):
                traffic.step()
        launches = gather_gemm.launches + conv_dw.launches - before
    convs.close()
    xs = [e for e in prof["events"] if e.get("ph") == "X" and "dur" in e]
    device = [e for e in xs if e.get("cat") in tracing.DEVICE_CATS]
    mains = [e for e in device if any(k in e["name"] for k in K_NAMES)]
    ours = mains + [e for e in device if SUMS in e["name"]]
    inside = {id(e) for e in tracing.in_conv_ranges(xs, device)}
    assert ours and all(id(e) in inside for e in ours)
    assert len(mains) == launches


@pytest.mark.cuda
def test_small_cells_trace_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import minkowskiengine_tpu_torch as mt

    from portbench import harness

    for name in ("minkunet34.train.scan5cm", "minkunet34.infer.room2cm", "completionnet.train"):
        result, checks, _ = harness.run_cell(cell(name), SEED, 1.0, 1, "cuda:0", time.perf_counter(),
                                          harness.benchmark(), mt)
        assert result["device"]["busy_s"] > 0, (name, checks)
