"""Share, in %, of the profiled slice's wall time in which no kernel, copy
or set ran on the card (a trace of CUDA activity only)."""


def read(ctx):
    s = ctx["slice"]
    return 100.0 * (1.0 - s["busy_s"] / s["wall_s"]) if s["wall_s"] > 0 else None
