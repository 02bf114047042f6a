"""Host-side CUDA API calls that put work on a stream (kernel and graph
launches, asynchronous copies and sets) per grad step of the traced
slice, from the profiler's host events (rank 0 on a mesh)."""


def read(ctx):
    tr = ctx.outcome.get("trace")
    if tr is None or not tr.launches:
        return None
    return tr.launches / ctx.outcome["trace_steps"]
