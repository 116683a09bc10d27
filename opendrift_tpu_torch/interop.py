"""Host arrays <-> the port's device state.

OceanDrift has no weights: what crosses between the JAX package and the
port is the element state and the per-reader forcing tables.  Both are
dicts of arrays on each side, so the bridge is numpy: ``np.asarray`` of a
JAX ``ElementState.data`` or device-state dict goes in, and the inverses
give numpy back for comparison.  The port's readers also build their
device states as host arrays and go through here.

Frame times ('times') stay on the host as float32 numpy: the samplers
compare them with the scalar step time there, never per element.

The two table storages cross as plain dicts of arrays: a
``CompensatedTable`` as ``{"kind": "compensated", "data", "scale"}``, a
``SplitTable`` as ``{"kind": "split", "data", "factor", "dtype"}`` (``data``
the JAX package's uint16/uint8 array or the port's int16/uint8 one: the
bits are the same).  A corner block (the 5-tuple of
``PackedSampler.gather_corner_block``) crosses with
:func:`corner_block_from_numpy` / :func:`corner_block_to_numpy`.
"""

import numpy as np
import torch

from .elements import ElementState
from .ops.interp import CompensatedTable, SplitTable

HOST_KEYS = ("times",)


def resolve_device(device):
    """The device an entry point runs on: ``cuda`` unless the caller asks
    for another.  A CUDA device without a card raises; the port never
    carries on quietly on the CPU."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "opendrift_tpu_torch runs on a CUDA device by default and none "
            "is available; pass device='cpu' to run on the CPU")
    return device


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


def tile_states_from_numpy(arrays, n_tiles, devices):
    """The JAX package's domain-decomposition layout — flat
    ``(n_tiles * cap,)`` host arrays (``(C, n_tiles * cap)`` for a
    per-component array), slot ``t*cap+s`` being slot ``s`` of tile
    ``t`` — -> the port's per-tile states: a list of ``n_tiles``
    :class:`ElementState` of ``cap`` slots, tile ``t`` on
    ``devices[t]``."""
    arrays = {k: np.asarray(v) for k, v in arrays.items()}
    cap = next(iter(arrays.values())).shape[-1] // n_tiles
    return [ElementState({k: _tensor(v[..., t * cap:(t + 1) * cap],
                                     devices[t])
                          for k, v in arrays.items()})
            for t in range(n_tiles)]


def tile_states_to_numpy(states):
    """The inverse of :func:`tile_states_from_numpy`: per-tile states (or
    dicts of per-slot tensors) -> the flat ``t*cap+s`` host layout."""
    datas = [getattr(s, "data", s) for s in states]
    return {k: np.concatenate([d[k].cpu().numpy() for d in datas], axis=-1)
            for k in datas[0]}


def table_to_numpy(table):
    """A packed table of either package -> host form: a numpy array, or the
    dict of a compensated or split table (see the module docstring).  Takes
    the port's classes and any object with the JAX classes' attributes."""
    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    name = type(table).__name__
    if name == "CompensatedTable":
        return {"kind": "compensated", "data": host(table.data),
                "scale": host(table.scale)}
    if name == "SplitTable":
        dtype = getattr(table, "dtype_name", None) or str(
            np.dtype(table.dtype))
        return {"kind": "split", "data": host(table.data),
                "factor": int(table.factor), "dtype": dtype}
    return host(table)


def table_from_numpy(value, device):
    """The inverse of :func:`table_to_numpy`, onto ``device``."""
    if isinstance(value, (CompensatedTable, SplitTable)):
        return value.to(device)
    if isinstance(value, dict) and value.get("kind") == "compensated":
        return CompensatedTable(np.asarray(value["data"], np.float16),
                                np.asarray(value["scale"], np.float32)
                                ).to(device)
    if isinstance(value, dict) and value.get("kind") == "split":
        data = np.ascontiguousarray(value["data"])
        if data.dtype.itemsize == 2:
            data = data.view(np.int16)       # uint16 bits, kept as int16
        return SplitTable(data, value["factor"], value["dtype"]).to(device)
    return _tensor(value, device)


def corner_block_from_numpy(block, device):
    """A corner block with numpy members -> the port's, on ``device``."""
    g_y0, g_y1, x0, y0, col_of = block
    return (_tensor(g_y0, device), _tensor(g_y1, device),
            _tensor(np.asarray(x0, np.int32), device),
            _tensor(np.asarray(y0, np.int32), device),
            {v: (int(c), str(kind)) for v, (c, kind) in col_of.items()})


def corner_block_to_numpy(block):
    """A corner block of either package -> numpy members."""
    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    g_y0, g_y1, x0, y0, col_of = block
    return (host(g_y0), host(g_y1), host(x0), host(y0), dict(col_of))


def device_state_from_numpy(arrays, device, keep_host=()):
    """A reader's host state -> its device state: arrays become tensors on
    ``device`` (float32 stays float32), tensors go there (no copy when
    they are there already: a static raster's state is built once), table
    storages their device form, host keys stay numpy, other entries pass
    through.  A tuple of states (the operand readers of
    ``fields/operators.py``) becomes a tuple of device states.  Keys in
    ``keep_host`` stay as they are (a domain-decomposed reader's table,
    which the run splits into per-tile bands)."""
    if isinstance(arrays, (tuple, list)):
        return tuple(device_state_from_numpy(a, device, keep_host)
                     for a in arrays)
    out = {}
    for k, v in dict(arrays).items():
        if k in keep_host:
            out[k] = v
        elif k in HOST_KEYS:
            out[k] = np.asarray(v, dtype=np.float32)
        elif isinstance(v, (CompensatedTable, SplitTable)) or (
                isinstance(v, dict) and "kind" in v):
            out[k] = table_from_numpy(v, device)
        elif torch.is_tensor(v):
            out[k] = v.to(device)
        elif isinstance(v, (np.ndarray, np.generic)) or hasattr(
                v, "__array__"):
            out[k] = _tensor(v, device)
        else:
            out[k] = v
    return out


def device_state_to_numpy(state):
    """The inverse of :func:`device_state_from_numpy`."""
    return {k: (table_to_numpy(v) if torch.is_tensor(v) or isinstance(
                    v, (CompensatedTable, SplitTable)) else v)
            for k, v in dict(state).items()}


def host_nbytes(arrays, device, keep_host=()):
    """The bytes :func:`device_state_from_numpy` hands to ``device`` for
    the same arguments: host arrays and tables, tensors on another device;
    host keys, ``keep_host`` keys and other entries count 0."""
    if isinstance(arrays, (tuple, list)):
        return sum(host_nbytes(a, device, keep_host) for a in arrays)
    device = torch.device(device)

    def nbytes(v):
        if torch.is_tensor(v):
            there = v.device.type == device.type and device.index in (
                None, v.device.index)
            return 0 if there else v.numel() * v.element_size()
        if isinstance(v, (np.ndarray, np.generic)) or hasattr(
                v, "__array__"):
            return np.asarray(v).nbytes
        return 0
    total = 0
    for k, v in dict(arrays).items():
        if k in keep_host or k in HOST_KEYS:
            continue
        if isinstance(v, CompensatedTable):
            total += nbytes(v.data) + nbytes(v.scale)
        elif isinstance(v, SplitTable):
            total += nbytes(v.data)
        elif isinstance(v, dict) and "kind" in v:
            total += nbytes(v["data"]) + nbytes(v.get("scale"))
        else:
            total += nbytes(v)
    return total
