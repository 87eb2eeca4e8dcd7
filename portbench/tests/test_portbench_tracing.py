"""The host clock behind ``coords_host_ms`` finds the decoder's level
syncs: one ``keep.any()`` per level and step of CompletionNet.  Found by
the decoder loop's name, they would drop out of the metric unseen if the
loop were renamed or the sync moved out of it; this test sees that."""

import torch

from small import SEED, cell


def test_host_clock_counts_every_level_sync_of_a_completion_step():
    import minkowskiengine_tpu_torch as mt

    from portbench import harness, tracing

    c = cell("completionnet.train")
    dev = torch.device("cpu")
    traffic = harness.traffic_class(c["kind"])(c, SEED, dev, tracing.Tracer(False))
    spec = harness.reference_module(c["config"]).parameter_spec(c["config"])
    traffic.setup(mt, harness.make_weights(spec, SEED, dev), 0)
    with tracing.HostClock(mt.CoordinateManager, traffic.tracer) as clock:
        traffic.step()
        traffic.step()
    levels = len(traffic.record["levels"][0])
    assert levels > 1 and clock.keep_any_n == 2 * levels
    assert clock.seconds > 0
