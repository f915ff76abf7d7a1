"""Propagation math: frame sampling, spatial weights, the affinity softmax
(the JAX package's ``core``, every name it exports)."""

from semi_supervised_vos_tpu_torch.core.propagation import (  # noqa: F401
    affinity_logits,
    affinity_propagate,
    batch_predict,
    batch_similarity,
)
from semi_supervised_vos_tpu_torch.core.sampling import sample_frames, sample_frames_host  # noqa: F401
from semi_supervised_vos_tpu_torch.core.spatial import (  # noqa: F401
    descriptor_weight,
    spatial_coords,
    spatial_weight,
    temporal_weight,
)
