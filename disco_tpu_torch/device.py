"""Device resolution for the port's entry points.

Counterpart of ``disco_tpu/utils/backend.py::is_tpu``: the JAX package
routes by the backend's device kind; the port routes by the device of the
tensors it is given, and its entry points resolve that device here.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``"cuda"`` when ``device`` is
    None, else the requested device.

    Raises RuntimeError when CUDA is requested (explicitly or by default)
    and no CUDA device exists — the port never falls back to the CPU on its
    own; callers that want the plain versions on the host pass
    ``device="cpu"``.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {dev}; expected 'cuda' or 'cpu'")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "disco_tpu_torch: no CUDA device is available; pass device='cpu' "
            "to run the plain PyTorch versions on the host"
        )
    return dev


def is_hopper() -> bool:
    """True when the current CUDA device is a Hopper card (compute
    capability 9.0), the only target the kernels in ``csrc/`` are built
    for."""
    return torch.cuda.is_available() and torch.cuda.get_device_capability() == (9, 0)



def check_module_device(module: torch.nn.Module, dev: torch.device) -> None:
    """Raise ValueError unless every parameter and buffer of ``module`` lies
    on ``dev`` — a model is never moved to the caller's device silently."""
    for name, t in list(module.named_parameters()) + list(module.named_buffers()):
        if t.device.type != dev.type or (dev.index is not None and t.device.index != dev.index):
            raise ValueError(
                f"the model's {name} lies on {t.device}, the call runs on {dev}; move the model "
                f"with model.to({str(dev)!r}) first"
            )
