"""Device milliseconds of the sampler per grad step in the traced slice,
from the program's spans: the event pairs of ``sampler.draw`` (uniforms,
strata, descent), ``sampler.weights`` (beta, IS weights) and
``sampler.writeback`` (the priorities and the trees' repair), over the
slice's ``learner.step`` spans. An event pair times what the stream did
between the span's start and end, so where the host lagged behind the
device it counts the idle too (``host_lead_ms`` tells which). None
without spans, or without a write-back (uniform replay)."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(
        ("sampler.draw", "sampler.weights", "sampler.writeback"))
