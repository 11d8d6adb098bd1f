"""Mask-estimation networks and their training: the NN bricks, the CRNN and
the 2-D RNN, the converter that carries the JAX package's weights across,
the losses, optax's RMSprop, the training loop with checkpoints both
packages read, and the windowed datasets."""
