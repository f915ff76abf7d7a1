"""Training: losses, triplet miners, optimizer and checkpoints, early
stopping, and the train / eval steps (the JAX package's ``train/``)."""
