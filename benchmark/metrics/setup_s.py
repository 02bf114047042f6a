"""Seconds from the process's start to the timed window's first step:
imports, CUDA, the kernel library's load (and build, in a checkout's
first run), the ring's fill, the checked first steps and the warm-up
chunk (on a mesh, the ranks' start and the process group too)."""


def read(ctx):
    return ctx.outcome["setup_s"]
