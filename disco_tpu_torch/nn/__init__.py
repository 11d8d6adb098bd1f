"""Mask-estimation networks: the NN bricks, the CRNN and the 2-D RNN, and
the converter that carries the JAX package's weights across."""
