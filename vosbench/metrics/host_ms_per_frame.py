"""Host ms a frame costs the engine once its upload is left out: the
program's span ``engine.step`` less ``engine.upload`` inside it, over the
frames stepped (counter ``engine.frames``) in the traced slice; the pace of
the host's dispatch when the upload no longer waits."""

from vosbench.spans import steps, summary, within


def read(_slice):
    s = summary()
    frames = s["counters"].get("engine.frames") if s else None
    if not steps(s, "engine.step") or not frames:
        return None
    up = within(s, "engine.upload", "engine.step")
    return (s["spans"]["engine.step"]["host_s"] - (up["host_s"] if up else 0.0)) / frames * 1e3
