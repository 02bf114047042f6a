"""The most device memory the program held at once over set-up, the
window and the traced slice (``torch.cuda.max_memory_allocated``, the
fullest card on a mesh), in GB."""


def read(ctx):
    peak = ctx.outcome.get("memory_peak_bytes")
    return peak / 1e9 if peak else None
