"""Kernel families of the port: the wrappers of the hand-written CUDA
kernels (``csrc/``, built by ``_build``), their plain PyTorch versions,
and the ``impl``/precision dispatch around them."""
