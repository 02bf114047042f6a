"""Device milliseconds of the model step per grad step in the traced
slice, from the program's ``update`` spans (augment, target, critic and
actor steps, soft targets) over its ``learner.step`` spans. An event
pair times what the stream did between the span's start and end, so
where the host lagged behind the device it counts the idle too
(``host_lead_ms`` tells which). None without spans."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(("update",))
