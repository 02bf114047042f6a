"""The fused projection + cross-entropy kernels' share of their roofline:
the least time for one forward and one backward at the cell's batch and
atoms (``flops/projection_ce.py``: bytes at the card's bandwidth) over
their device time per grad step in the traced slice. None when the
slice ran neither kernel."""


def read(ctx):
    t = ctx.kernel_s("ce_forward_kernel", "ce_backward_kernel")
    bw = ctx.peak("hbm_bytes_per_s")
    if not t or bw is None:
        return None
    b = int(ctx.cell.traffic["batch_size"])
    a = int(ctx.cell.config["n_atoms"])
    need = ctx.plugin("flops", "projection_ce").bytes_per_step(b, a) / bw
    return 100.0 * need / (t / ctx.outcome["trace_steps"])
