"""The share of the traced slice in which the device ran nothing: one
less the union of its activity intervals (averaged over the cards) over
the slice's length."""


def read(ctx):
    tr = ctx.outcome.get("trace")
    if tr is None or not ctx.outcome.get("busy_s"):
        return None
    return 100.0 * (1.0 - ctx.outcome["busy_s"] / tr.window_s)
