"""Host ms a chunk spends moving its frames to the card: the program's
span ``engine.upload`` (``from_numpy`` / ``np.require`` and ``.to(device)``
in ``PropagationEngine.encode``) inside ``engine.step``, summed and
divided by the ``engine.step`` calls of the traced slice. A pageable copy
waits there for the work queued before it."""

from vosbench.spans import steps, summary, within


def read(_slice):
    s = summary()
    n, up = steps(s, "engine.step"), within(s, "engine.upload", "engine.step")
    return up["host_s"] / n * 1e3 if n and up else None
