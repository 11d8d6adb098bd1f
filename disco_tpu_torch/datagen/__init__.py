"""Training-data generation (counterpart of ``disco_tpu/datagen``): so far
the mixing pass, :class:`~disco_tpu_torch.datagen.postgen.PostGenerator`."""
from disco_tpu_torch.datagen.postgen import PostGenerator

__all__ = ["PostGenerator"]
