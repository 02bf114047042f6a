"""Grad steps completed in the timed window over all of its time: from
the synchronize that opens it to the one that closes its last chunk (on
a mesh, global steps over the global batch, read on rank 0)."""


def read(ctx):
    return ctx.outcome["steps"] / ctx.outcome["elapsed"]
