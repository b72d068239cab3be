"""Where host data goes when it enters the port.

Numpy arrays, lists and scalars that enter the port (``GriddedArray`` data,
``Dataset`` data variables, ``from_numpy_dataset`` variables, numpy targets
of ``transform``) become tensors on the CUDA card.  A caller who wants the
CPU asks for it, per call with ``device="cpu"`` or once for the process
with :func:`set_default_device`, as ``torch.set_default_device`` does for
PyTorch's factory functions.  Torch tensors keep their device.  With no
card and no request for the CPU the port raises; it never carries on on the
CPU by itself.

Every copy between the host and a device goes through one bridge:
:func:`to_device` for host data, :func:`to_host` for a tensor.  Each is one
call of PyTorch's copy.  A copy to or from a device other than the CPU runs
under the span ``xtt.bridge.to_device`` or ``xtt.bridge.to_host`` and adds
its bytes and one copy to :data:`BRIDGE`; on the CPU nothing is copied where
numpy and torch can share memory, and nothing is counted.  The bridge keeps
nothing between calls: no device copy of a host buffer (its owner may change
it in place) and no staging buffer that a later call would overwrite.
"""

from __future__ import annotations

import collections
from typing import Optional, Union

import numpy as np
import torch

from ..utils.profiling import span

__all__ = ["BRIDGE", "get_default_device", "resolve_device", "set_default_device", "to_device",
           "to_host"]

# bytes and copies that crossed between the host and a device other than
# the CPU: h2d_bytes, h2d_copies, d2h_bytes, d2h_copies
BRIDGE: collections.Counter = collections.Counter()
# device types whose tensors live in host memory: the bridge copies nothing
# there where numpy allows, opens no span and counts nothing
HOST_MEMORY = ("cpu",)

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


def to_device(array, device: Union[str, torch.device, None] = None) -> torch.Tensor:
    """Host data (a numpy array, a nested sequence or a scalar) as a tensor on
    ``device``, else on the default device.  On the CPU the tensor shares
    numpy's memory where numpy allows it."""
    device = resolve_device(device)
    host = np.asarray(array)
    if device.type in HOST_MEMORY:
        return torch.as_tensor(host, device=device)
    with span("xtt.bridge.to_device"):
        out = torch.as_tensor(host, device=device)
    BRIDGE["h2d_bytes"] += out.numel() * out.element_size()
    BRIDGE["h2d_copies"] += 1
    return out


def to_host(tensor: torch.Tensor) -> np.ndarray:
    """``tensor`` as a host numpy array that no later call of the port
    overwrites; a CPU tensor's array shares its memory, as ``.numpy()``
    does."""
    if tensor.device.type in HOST_MEMORY:
        return tensor.detach().cpu().numpy()
    with span("xtt.bridge.to_host"):
        out = tensor.detach().cpu().numpy()
    BRIDGE["d2h_bytes"] += out.nbytes
    BRIDGE["d2h_copies"] += 1
    return out
