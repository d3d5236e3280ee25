"""Device selection. Nothing on the serving path falls back to the CPU on its
own: callers pass an explicit ``device``, and ``require_cuda`` is the one
place that asks for the card."""

from __future__ import annotations

import torch


def require_cuda() -> torch.device:
    """Return ``torch.device("cuda")``, or raise if no CUDA card is visible."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a CUDA device is required (torch.cuda.is_available() is False; "
            f"torch {torch.__version__}, built for CUDA {torch.version.cuda})")
    return torch.device("cuda")


def constant(values, device: torch.device, dtype=None) -> torch.Tensor:
    """Host values (a sequence or a numpy array) as a tensor on ``device``,
    copied without a host sync: to a card from pinned memory with
    ``non_blocking=True`` (a plain copy from pageable memory waits for the
    card). For constants made once and kept on the device."""
    t = torch.as_tensor(values, dtype=dtype)
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)
