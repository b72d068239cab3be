"""Where host data goes when it enters the port.

Numpy arrays, lists and scalars that enter the port (``GriddedArray`` data,
``Dataset`` data variables, ``from_numpy_dataset`` variables, numpy targets
of ``transform``) become tensors on the CUDA card.  A caller who wants the
CPU asks for it, per call with ``device="cpu"`` or once for the process
with :func:`set_default_device`, as ``torch.set_default_device`` does for
PyTorch's factory functions.  Torch tensors keep their device.  With no
card and no request for the CPU the port raises; it never carries on on the
CPU by itself.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["get_default_device", "resolve_device", "set_default_device"]

_default: Optional[torch.device] = None


def set_default_device(device: Union[str, torch.device, None]) -> None:
    """Device for host data entering the port; ``None`` restores the
    default, the CUDA card."""
    global _default
    _default = None if device is None else torch.device(device)


def get_default_device() -> torch.device:
    """The device set with :func:`set_default_device`, else the CUDA card;
    raises ``RuntimeError`` when neither is there."""
    if _default is not None:
        return _default
    if not torch.cuda.is_available():
        raise RuntimeError(
            "xgcm_tpu_torch puts host data on the CUDA card, and none is "
            "available. To run on the CPU, ask for it: pass device='cpu', or "
            "call xgcm_tpu_torch.set_default_device('cpu') once."
        )
    return torch.device("cuda")


def resolve_device(device: Union[str, torch.device, None] = None) -> torch.device:
    """``device`` as a ``torch.device``, or the default when it is None."""
    return get_default_device() if device is None else torch.device(device)
