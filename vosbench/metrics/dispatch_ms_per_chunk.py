"""Host ms a chunk spends in the engine's ``step_chunk_small`` (the
dispatch: the chunk's frames copied, the encode and the propagation steps
queued), on the host's clock over the window's chunks dispatched before the
traced slice opens, so that the profiler's own cost per op is not in it."""


def read(s):
    v = s.extra.get("dispatch_s")
    return v * 1e3 if v else None
