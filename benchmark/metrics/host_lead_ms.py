"""How far the host ran ahead of the device, in milliseconds: the median
over the traced slice's ``learner.step`` spans of the device's arrival
at the span's start event less the host's stamp of it. The device's
times go on the host clock with the least offset under which no marker
is reached before the host recorded it (``SpanTable.markers``); the
slice opens after a synchronize, so its first marker is a true zero. A
lead near zero is a step the device waited for: the host paced it, and
event-pair times there count idle. None without spans or events."""

import statistics

from harness import spans


def read(ctx):
    s = spans.summary()
    if s is None or not s["lead_ms"]:
        return None
    return statistics.median(s["lead_ms"])
