"""The program's own ``me.*`` spans and counters beside what the benchmark
draws from outside: every reader returns what it returned on a trace
without the program's spans, and the program's ``coords`` counter agrees
with the benchmark's host clock on a completion step."""

import copy

import torch

from small import SEED, cell

from portbench import harness, tracing

CPU_OPS = ("aten::add", "aten::index_select")


def _trace(with_program_spans):
    """A Chrome trace of two steps: the benchmark's ranges, launches with
    their kernels, gaps between them, and (if asked) the program's spans
    over the same stretches, as a traced run records them."""
    xs, corr = [], [0]

    def host(name, ts, dur, cat="user_annotation", tid=1):
        xs.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid})

    def launch(ts, kernel_ts, dur, name="gather_gemm_mma_kernel"):
        corr[0] += 1
        xs.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                   "dur": 5, "tid": 1, "args": {"correlation": corr[0]}})
        xs.append({"ph": "X", "cat": "kernel", "name": name, "ts": kernel_ts, "dur": dur,
                   "tid": 7, "args": {"correlation": corr[0]}})

    for base in (0, 10_000):
        host("portbench.step", base, 9_000)
        host("portbench.forward", base + 100, 4_000)
        host("portbench.coords.kernel_map", base + 200, 1_500)
        launch(base + 300, base + 320, 200, "vectorized_gather_kernel")
        host("portbench.conv.fwd", base + 1_800, 1_000)
        launch(base + 1_900, base + 1_950, 600)
        host("portbench.backward", base + 5_000, 3_000)
        host("portbench.conv.bwd", base + 5_100, 2_000, tid=2)
        launch(base + 5_200, base + 5_300, 900, "conv_dw_mma_kernel")
        for name in CPU_OPS:
            host(name, base + 400, 50, cat="cpu_op")
        if with_program_spans:
            host("me.coords.kernel_map", base + 210, 1_450)
            host("me.coords.probe_grid", base + 220, 300)
            host("me.sync.register_unique.bbox", base + 600, 700)
            host("me.conv.fwd", base + 1_850, 900)
            host("me.k1.mma", base + 1_880, 100)
            host("me.conv.dw", base + 5_150, 1_500, tid=2)
    return xs


def _summary(events):
    base = {"role": "train", "peak_flops": 495e12, "on_card": True,
            "unprofiled_step_s": [0.08, 0.09, 0.085], "coords_host_s": [0.03, 0.031, 0.029],
            "profiled_steps": 2, "flop_per_step": 3e11, "conv_bound_s": 2e-4}
    base.update(tracing.read_trace(events))
    return base


def test_every_reader_reads_the_same_with_the_programs_spans_in_the_trace():
    plain = _summary(_trace(False))
    spans = _summary(_trace(True))
    assert plain["conv_device_s"] > 0 and plain["busy_s"] > 0
    for infer in (False, True):
        a, b = copy.deepcopy(plain), copy.deepcopy(spans)
        if infer:
            a["role"] = b["role"] = "infer"
        for m in harness.benchmark()["per_layer"]:
            read = harness.reader(m["name"])
            assert read(a) == read(b), m["name"]


def test_the_programs_coords_counter_agrees_with_the_host_clock_on_a_completion_step():
    import minkowskiengine_tpu_torch as mt
    from minkowskiengine_tpu_torch.utils import profiling

    c = cell("completionnet.train")
    dev = torch.device("cpu")
    traffic = harness.traffic_class(c["kind"])(c, SEED, dev, tracing.Tracer(False))
    spec = harness.reference_module(c["config"]).parameter_spec(c["config"])
    traffic.setup(mt, harness.make_weights(spec, SEED, dev), 0)
    with tracing.HostClock(mt.CoordinateManager, traffic.tracer) as clock:
        before = profiling.counters()
        traffic.step()
        after = profiling.counters()
    levels = len(traffic.record["levels"][0])
    program_s = after["coords"]["seconds"] - before["coords"]["seconds"]
    keep_n = (after["sync.completion.keep"]["count"]
              - before.get("sync.completion.keep", {"count": 0})["count"])
    assert clock.keep_any_n == keep_n == levels > 1
    assert 0.8 * clock.seconds <= program_s <= clock.seconds, (program_s, clock.seconds)
