"""Device ms per `features/extractor.extract` call: the kernels, copies and
sets whose launch lies inside the call's range, in a few extractions after
the window, each profiled alone (`trace.range_table`)."""


def read(ctx):
    v = ctx.get("extract_device_s") or []
    return 1e3 * sum(v) / len(v) if v else None
