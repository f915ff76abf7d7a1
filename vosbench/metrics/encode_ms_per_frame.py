"""Device ms a frame spends in the encoder: the kernels launched inside
``PropagationEngine.encode`` (stem, cuDNN convolutions, the products of the
1x1 convolutions, the bottleneck kernel), over the images it encoded."""


def read(s):
    images = sum(c["images"] for c in s.calls.get("encode", []))
    dev = s.device_s.get("encode", 0.0)
    return dev / images * 1e3 if images and dev > 0 else None
