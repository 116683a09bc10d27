"""Host arrays <-> the port's device state.

OceanDrift has no weights: what crosses between the JAX package and the
port is the element state and the per-reader forcing tables.  Both are
dicts of arrays on each side, so the bridge is numpy: ``np.asarray`` of a
JAX ``ElementState.data`` or device-state dict goes in, and the inverses
give numpy back for comparison.  The port's readers also build their
device states as host arrays and go through here.

Frame times ('times') stay on the host as float32 numpy: the samplers
compare them with the scalar step time there, never per element.
"""

import numpy as np
import torch

from .elements import ElementState

HOST_KEYS = ("times",)


def _tensor(array, device):
    """A tensor on ``device`` from a host array (copied first when the
    array is read-only, as views of other frameworks' buffers are)."""
    a = np.ascontiguousarray(np.asarray(array))
    if not a.flags.writeable:
        a = a.copy()
    return torch.as_tensor(a, device=device)


def element_state_from_numpy(arrays, device):
    """``{name: array}`` -> :class:`ElementState` on ``device``."""
    return ElementState({k: _tensor(v, device) for k, v in arrays.items()})


def element_state_to_numpy(state):
    """:class:`ElementState` -> ``{name: numpy array}``."""
    return {k: v.cpu().numpy() for k, v in state.data.items()}


def device_state_from_numpy(arrays, device):
    """A reader's host state -> its device state: arrays become tensors on
    ``device`` (float32 stays float32), host keys stay numpy, non-array
    entries pass through."""
    out = {}
    for k, v in dict(arrays).items():
        if k in HOST_KEYS:
            out[k] = np.asarray(v, dtype=np.float32)
        elif isinstance(v, (np.ndarray, np.generic)) or hasattr(
                v, "__array__"):
            out[k] = _tensor(v, device)
        else:
            out[k] = v
    return out


def device_state_to_numpy(state):
    """The inverse of :func:`device_state_from_numpy`."""
    return {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
            for k, v in dict(state).items()}
