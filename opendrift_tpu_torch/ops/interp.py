"""Packed-row field sampling and host-side field preparation.

Port of the part of ``opendrift_tpu/ops/interp.py`` this slice reaches.
The host packs, for every (z, y, x) cell of a reader's grid, all variables
x all window frames plus the neighbour cells of the interpolation stencil
into one row of a (Z*Y*X, C*k) table (``fields/grid.py``); a sample is
then one row gather per z-plane and a blend:

* 'xyz' (k = 8): the row holds the full trilinear stencil, x+1/y+1/z+1
  included, so a 3D sample is ONE gather;
* 'xy' (k = 4): the bilinear stencil, one gather per bracketing z-plane.

The JAX package leaves these gathers to XLA; there is no Pallas kernel
here, and the port keeps them as plain torch indexing (a fused Hopper
sampler is a later performance item, ROADMAP D.1).  The 'x'/'none' tiers,
``CompensatedTable``/``SplitTable`` storage and the corner-block
single-fetch path come with ROADMAP A.2's remainder.

Frame times stay on the host: the step time ``t`` is one float32 scalar,
so the bracketing frame and its weight are computed there in float32
(:func:`time_weights`), exactly as the JAX package computes them.
"""

import numpy as np
import torch


def take_rows(packed, lin):
    """The packed-table row gather, indices clamped like ``mode='clip'``."""
    return packed.index_select(0, lin.clamp(0, packed.shape[0] - 1))


def time_weights(times, t, F):
    """Bracketing frame index (int) and linear weight (float32) for the
    host time ``t`` in the host float32 ``times`` (clamped)."""
    times = np.asarray(times, dtype=np.float32)
    t = np.float32(t)
    ti = int(np.clip(np.searchsorted(times, t, side="right") - 1, 0,
                     max(F - 2, 0)))
    if F < 2:
        return ti, np.float32(0.0)
    denom = times[ti + 1] - times[ti]
    tw = (t - times[ti]) / denom if denom != 0 else np.float32(0.0)
    return ti, np.float32(np.clip(tw, 0.0, 1.0))


class PackedSampler:
    """Static metadata + gathers for the packed-row layout (see the module
    docstring).  ``col_of``: variable -> (first column, kind) with kind
    't' (one column per frame), 'static' (one column, bilinear) or 'near'
    (one column, nearest corner)."""

    def __init__(self, Z, Y, X, n_frames, col_of, pair_mode):
        if pair_mode not in ("xy", "xyz"):
            raise NotImplementedError(
                f"packed tier '{pair_mode}' is not ported yet (ROADMAP A.2: "
                "the 'x'/'none' tiers)")
        self.Z, self.Y, self.X = Z, Y, X
        self.F = n_frames
        self.col_of = col_of
        self.pair_mode = pair_mode

    def _z_bracket(self, depth, depths, like):
        if self.Z > 1:
            z0 = torch.clamp(torch.searchsorted(depths, depth, right=True)
                             - 1, 0, self.Z - 2)
            dz = depths[z0 + 1] - depths[z0]
            fz = torch.where(dz != 0, (depth - depths[z0]) / dz, 0.0)
            return z0, torch.clamp(fz, 0.0, 1.0)[:, None]
        return torch.zeros_like(like), None

    def gather_rows(self, packed, xi, yi, depth, depths, row_offset=0,
                    nearest_cols=None):
        """Gather and spatially interpolate rows -> (N, C/k) with the
        vertical bracketing applied.  ``nearest_cols``: columns also
        returned nearest-corner sampled (masks), from the same gather;
        then returns (rows, {col: float32[N]})."""
        Y, X = self.Y, self.X
        x0 = torch.clamp(torch.floor(xi).to(torch.int32), 0, max(X - 2, 0))
        y0 = torch.clamp(torch.floor(yi).to(torch.int32), 0, max(Y - 2, 0))
        fx = torch.clamp(xi - x0, 0.0, 1.0)[:, None]
        fy = torch.clamp(yi - y0, 0.0, 1.0)[:, None]
        z0, fz = self._z_bracket(depth, depths, x0)
        k = 8 if self.pair_mode == "xyz" else 4
        q = packed.shape[-1] // k
        near = {}

        def lin_of(zz):
            return ((zz.to(torch.int64) * Y + y0) * X + x0 + row_offset)

        def blend(h):
            row_y0 = h[:, :q] * (1.0 - fx) + h[:, q:2 * q] * fx
            row_y1 = h[:, 2 * q:3 * q] * (1.0 - fx) + h[:, 3 * q:4 * q] * fx
            return row_y0 * (1.0 - fy) + row_y1 * fy

        g = take_rows(packed, lin_of(z0))
        for c in (nearest_cols or ()):
            gy0 = torch.where(fx[:, 0] > 0.5, g[:, q + c], g[:, c])
            gy1 = torch.where(fx[:, 0] > 0.5, g[:, 3 * q + c], g[:, 2 * q + c])
            near[c] = torch.where(fy[:, 0] > 0.5, gy1, gy0).to(torch.float32)
        out = blend(g[:, :4 * q])
        if self.Z > 1:
            if self.pair_mode == "xyz":
                upper = blend(g[:, 4 * q:])
            else:
                upper = blend(take_rows(packed,
                                        lin_of(torch.clamp_max(z0 + 1,
                                                               self.Z - 1))))
            out = out * (1.0 - fz) + upper * fz
        return (out, near) if nearest_cols else out

    def values(self, rows, times, t, varnames):
        """Blend the bracketing frame columns per variable."""
        F = self.F
        ti, tw = time_weights(times, t, F)
        w0, w1 = float(np.float32(1.0) - tw), float(tw)
        out = {}
        for v in varnames:
            col, kind = self.col_of[v]
            if kind == "static":
                out[v] = rows[:, col]
            else:
                v0 = rows[:, col + ti]
                v1 = rows[:, col + min(ti + 1, F - 1)]
                out[v] = v0 * w0 + v1 * w1
        return out


# ------------------------------------------------------------ host prep --

def fill_invalid(field):
    """Replace NaNs with the nearest valid value (2D horizontal fill, per
    slice), host side at frame load.  Returns (filled, any_valid).

    The JAX package uses its native library when it is built and this
    same scipy Euclidean-distance fill otherwise; the port keeps the
    scipy path (equal where the nearest valid cell is unique)."""
    out = np.ascontiguousarray(field, dtype=np.float32).copy()
    any_valid = bool(np.isfinite(out).any())
    if not np.isfinite(out).all():
        from scipy.ndimage import distance_transform_edt
        flat = out.reshape(-1, *out.shape[-2:])
        for i in range(flat.shape[0]):
            sl = flat[i]
            mask = ~np.isfinite(sl)
            if mask.all() or not mask.any():
                continue
            idx = distance_transform_edt(mask, return_distances=False,
                                         return_indices=True)
            flat[i] = sl[tuple(idx)]
    return out, any_valid


def fill_towards_seafloor(block):
    """Propagate the deepest valid value downward along z (reference
    interpolation/structured.py:50-71); ``block`` is (Z, Y, X) with z
    index 0 at the surface."""
    out = np.ascontiguousarray(block, dtype=np.float32).copy()
    for k in range(1, out.shape[0]):
        nan = ~np.isfinite(out[k])
        out[k][nan] = out[k - 1][nan]
    return out
