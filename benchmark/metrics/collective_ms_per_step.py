"""Device milliseconds of NCCL's kernels per grad step on rank 0 in the
traced slice: the gradient averages, the metrics' averages and the IS
normalizer's minimum. None when the slice ran no NCCL kernel."""


def read(ctx):
    t = ctx.kernel_s("nccl")
    if not t:
        return None
    return 1e3 * t / ctx.outcome["trace_steps"]
