"""A numpy-named namespace over torch.

``utils/geodesic.py`` and ``utils/crs.py`` are written against a generic
array namespace ``xp`` (numpy on the host).  Passing :data:`tnp` runs the
same formulas on torch tensors, so the port keeps one copy of that math
instead of a torch rewrite.  Only the names those two modules use are
provided (every projection of ``crs.py``, the tmerc series and Mercator's
logarithms included).
"""

import torch


class _TorchNumpy:
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    tan = staticmethod(torch.tan)
    sqrt = staticmethod(torch.sqrt)
    arctan = staticmethod(torch.arctan)
    arctan2 = staticmethod(torch.arctan2)
    arcsin = staticmethod(torch.arcsin)
    arctanh = staticmethod(torch.arctanh)
    sinh = staticmethod(torch.sinh)
    cosh = staticmethod(torch.cosh)
    log = staticmethod(torch.log)
    exp = staticmethod(torch.exp)
    abs = staticmethod(torch.abs)
    radians = staticmethod(torch.deg2rad)
    degrees = staticmethod(torch.rad2deg)
    zeros_like = staticmethod(torch.zeros_like)
    clip = staticmethod(torch.clip)

    @staticmethod
    def where(cond, a, b):
        return torch.where(cond, a, b)

    @staticmethod
    def maximum(a, b):
        if not torch.is_tensor(b):
            return torch.clamp_min(a, b)
        if not torch.is_tensor(a):
            return torch.clamp_min(b, a)
        return torch.maximum(a, b)


tnp = _TorchNumpy()
