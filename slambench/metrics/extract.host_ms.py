"""Host median, in ms, of the port's `extract` span (`System._extract`
around `features/extractor.extract`: the time the host takes to enqueue the
extraction's ~1,500 launches) over the window's frames; the program's own
span, read through `slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    w = spans.window(ctx)
    return None if w is None else spans.median_ms(w, "extract")
