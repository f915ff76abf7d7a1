"""DAVIS-layout datasets (the JAX package's ``data``, every name it
exports)."""

from semi_supervised_vos_tpu_torch.data.davis import (  # noqa: F401
    ANTIALIAS,
    InferenceDataset,
    TrainDataset,
    TripletLossTrainDataset,
    list_image_folder,
)
