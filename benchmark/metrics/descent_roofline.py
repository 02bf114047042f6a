"""The PER descent kernel's share of its roofline: the least time for a
grad step's queries (``flops/descent.py``: the distinct tree nodes they
read, their masses and slots, at the card's bandwidth) over the kernel's
device time per grad step in the traced slice (rank 0 on a mesh). None
when the slice ran no descent."""


def read(ctx):
    t = ctx.kernel_s("descent_kernel")
    bw = ctx.peak("hbm_bytes_per_s")
    need = ctx.outcome.get("descent_bytes_per_step")
    if not t or bw is None or need is None:
        return None
    return 100.0 * (need / bw) / (t / ctx.outcome["trace_steps"])
