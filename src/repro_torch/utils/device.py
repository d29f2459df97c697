"""Device resolution shared by every public entry point of the port."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means the CUDA card.  Without CUDA that raises: the port
    runs on the CPU only when the caller asks for ``device="cpu"``.
    ``"meta"`` gives shapes and dtypes with nothing allocated (the dry
    run's inputs, ``launch/specs.py``)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def f32_on(v, device) -> torch.Tensor:
    """A config value (Python number or tensor) as f32 on ``device``.  A
    Python number becomes a device-side fill: ``torch.as_tensor`` would
    copy it from pageable host memory, which synchronises the stream."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)
