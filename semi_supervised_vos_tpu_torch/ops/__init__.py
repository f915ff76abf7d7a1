"""Device ops (the JAX package's ``ops``, every name it exports): nearest
resize and one-hot encoding here; the hand-written kernels' wrappers are
``ops/affinity.py`` and ``ops/bottleneck.py``, built at first use."""

from semi_supervised_vos_tpu_torch.ops.onehot import color_to_class, davis_centroids, index_to_onehot  # noqa: F401
from semi_supervised_vos_tpu_torch.ops.resize import nearest_resize  # noqa: F401
