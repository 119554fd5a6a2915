"""Blocking host reads a frame: the program's `host_reads` counter (each
warning of `torch.cuda.set_sync_debug_mode("warn")` while the tracer is on,
in the innermost open span) summed over the window's frames, over the
window's frames; 0 where no card is present.  Read through
`slambench/spans.py`."""

from slambench import spans

spans.install()


def read(ctx):
    w = spans.window(ctx)
    if w is None:
        return None
    reads = w.counters.get("host_reads", {})
    return sum(reads.get(f, 0) for f in w.frames) / len(w.frames)
