"""disco_tpu_torch — the PyTorch/CUDA port of ``disco_tpu`` for one NVIDIA
H100 (Hopper, ``sm_90a``).

The package mirrors ``disco_tpu``'s module paths and function names so that
each function's counterpart is found at the same place; inside, it is plain
PyTorch on tensors.  It imports ``torch`` and numpy only — never ``jax``,
``flax``, ``triton`` or any ``disco_tpu`` module (pinned by
tests/test_torch_port_imports.py).

Device rule.  Entry points (``enhance.tango.tango``,
``enhance.fused.tango_clip_fused`` and ``streaming_clip_fused``,
``enhance.streaming.streaming_tango``, ``streaming_tango_scan`` and
``streaming_step1``, the mask stage ``enhance.inference.crnn_mask`` and
``crnn_masks_batched``, ``enhance.zexport.compute_z_signals``,
``enhance.driver.estimate_masks`` and ``_batched_masks``, and
``enhance.separation``) run on ``"cuda"`` unless the caller passes
``device="cpu"``; with no CUDA device and no ``device="cpu"`` they
raise ``RuntimeError`` — they never move to the CPU silently.  Below the
entry points every kernel wrapper routes by the device of the tensor it is
given: a CUDA tensor launches the hand-written kernel (``csrc/``) or
raises, a CPU tensor takes the kernel's plain PyTorch version.  No knob,
environment variable or ``try`` sends a CUDA tensor to a plain version.

Precision.  Importing the package sets
``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32`` to False: the f32 lane of the
reference pins true float32 products (``disco_tpu/ops/stft_ops.py``'s
``precision="float32"`` DFT passes, ``Precision.HIGHEST`` in
``disco_tpu/ops/cov_ops.py``), and TF32 keeps only ~3 decimal digits.
The opt-in bf16 lane (``precision='bf16'``) rounds operands to bf16 at
the points ``ops/resolve.py`` lists and accumulates in float32.

Weights and state.  The two-step TANGO paths have no learned
parameters (the DFT/IDFT/Hann tables are computed); the CRNN mask
estimators of ``nn`` do, and weights of the JAX package's flax modules
cross through ``nn.convert.state_dict_from_flax``.  A model is never moved
to the call's device: one on another device raises ValueError.  The
streaming continuation state crosses through
``enhance.streaming.state_from_numpy`` (and back through
``state_to_numpy``).
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from disco_tpu_torch.device import is_hopper, resolve_device  # noqa: E402

__all__ = ["is_hopper", "resolve_device"]
