"""Kernel launches per frame over the profiled slice."""


def read(ctx):
    s = ctx["slice"]
    return s["launches"] / s["frames"] if s["frames"] else None
