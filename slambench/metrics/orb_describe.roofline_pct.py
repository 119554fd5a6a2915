"""`orb_describe`'s share of its roofline, in %, over the profiled slice:
the least time its launches could take (the bytes each frame's keypoints
need, `kernels.orb_describe_bytes`, over the H100's 3.35 TB/s) over the
device time of those launches in the trace.  The card's power limit is
printed beside it."""


def read(ctx):
    s = ctx["slice"]
    bound, took = s["describe_bound_s"], s["orb_describe_s"]
    if not took or len(bound) != len(took):
        return None
    return 100.0 * sum(bound) / sum(took)
