"""The whole grad step's share of the cards' peak: the model FLOPs of a
step (the family's file under ``flops/``, from the configuration's
shapes) times the window's grad steps per second, over the peak of the
configuration's precision on every card the cell uses (``peaks.json``).
None on a card the table does not hold."""


def read(ctx):
    peak = ctx.peak(ctx.precision)
    if peak is None:
        return None
    flops = ctx.flops_per_step()
    rate = ctx.outcome["steps"] / ctx.outcome["elapsed"]
    return 100.0 * flops * rate / (peak * ctx.cell.chips)
