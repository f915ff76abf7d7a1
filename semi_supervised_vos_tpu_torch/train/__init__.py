"""Training: losses, triplet miners, optimizer and checkpoints, early
stopping, and the train / eval steps (the JAX package's ``train``, every
name it exports)."""

from semi_supervised_vos_tpu_torch.train.losses import (  # noqa: F401
    contrastive_loss,
    cross_entropy_loss,
    focal_loss,
    triplet_loss_with_miner,
)
