"""Device milliseconds of CURL's contrastive step per grad step in the
traced slice, from the program's ``update.contrastive`` spans (the
anchor's and the key's encoder forwards, the logits, the loss, its
backward, both Adams and the tie) over its ``learner.step`` spans. An
event pair times what the stream did between the span's start and end,
idle included where the host lagged behind it. None without the span (a
program without CURL's step)."""

from harness import spans


def read(ctx):
    return spans.device_ms_per_step(("update.contrastive",))
