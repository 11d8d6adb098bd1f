"""Host-side utilities of the port (the counterpart of ``disco_tpu/utils``):
:mod:`~disco_tpu_torch.utils.resilience`, the retry, watchdog and preflight
seams, and :mod:`~disco_tpu_torch.utils.plotting`, the room top-view
figure.  The JAX package's ``transfer`` module has no copy here: the
port's batched copies are ``device.to_host`` and
``device.as_device_tensors``."""
