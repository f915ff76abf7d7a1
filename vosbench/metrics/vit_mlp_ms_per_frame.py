"""Device ms a frame spends in the ViT's MLP halves of its blocks (each
block's LN2, fc1, GELU, fc2 and residual add): the program's span
``vit.mlp``, timed on the card by CUDA events, over the frames the ViT
encoded (counter ``vit.frames``) in the traced slice; None where the
program has no such span or nothing was timed on a card."""

from vosbench.spans import summary


def read(_slice):
    s = summary()
    frames = s["counters"].get("vit.frames") if s else None
    row = s["spans"].get("vit.mlp") if s else None
    if not frames or not row or row.get("device_s") is None:
        return None
    return row["device_s"] / frames * 1e3
