"""PyTorch / CUDA port of ``semi_supervised_vos_tpu``.

Label-propagation video object segmentation on an NVIDIA Hopper card. The
module layout mirrors the JAX package so that every counterpart is easy to
find; the two Pallas kernels of the ``single``-strategy inference path are
hand-written CUDA C++ kernels for ``sm_90a`` (``csrc/``), each with a plain
PyTorch version beside its wrapper (``ops/affinity.py``,
``ops/bottleneck.py``).

The package imports ``torch`` and never ``jax``. Entry point:
``python -m semi_supervised_vos_tpu_torch {train,validation,inference,evaluation}``.
"""
