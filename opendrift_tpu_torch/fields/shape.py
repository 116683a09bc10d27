"""Landmask reader from polygon shapefiles.

Port of ``opendrift_tpu/fields/shape.py`` (reference:
opendrift/readers/reader_shape.py:1-180, GDAL/cartopy-based): the polygons
are parsed by the from-scratch .shp reader, rasterised once onto a regular
lon/lat grid, and sampled on the device by nearest cell; point-in-polygon
never runs inside the step.
"""

import logging

import numpy as np
import torch

from .base import ContinuousReader
from ..interop import resolve_device
from ..utils.shapefile import shapefile_polygons, rasterize_polygons

logger = logging.getLogger(__name__)


class RasterMask(ContinuousReader):
    """A static land_binary_mask raster on a regular lon/lat grid (origin
    ``_lon0``/``_lat0``, steps ``_dlon``/``_dlat``), sampled by nearest
    cell.  Its device state is built once per device and kept: the raster
    never changes, so no window copies it again.  ``device``: where the
    state goes; the environment a reader is added to sets it to its own."""

    variables = ["land_binary_mask"]
    device = None

    def __init__(self):
        self._device_states = {}
        super().__init__()

    def _host_arrays(self):
        """{name: host array} of the device state."""
        return {"mask": self._mask}

    def device_state(self, window_start=None, window_end=None):
        device = resolve_device(self.device)
        cache = self._device_states
        if device not in cache:
            state = {k: torch.as_tensor(v, device=device)
                     for k, v in self._host_arrays().items()}
            # the grid as float32 device scalars: the index arithmetic is
            # float32 as in the JAX package, and a tensor divisor keeps it
            # a true division on the card
            for k in ("_lon0", "_lat0", "_dlon", "_dlat"):
                state[k] = torch.tensor(getattr(self, k), dtype=torch.float32,
                                        device=device)
            cache[device] = state
        return cache[device]

    def _cell(self, state, lon, lat):
        """(flat cell index, inside the raster's index bounds) on the
        device; the JAX package's ``jnp.round`` rounds half to even, as
        ``torch.round`` does."""
        ny, nx = self._mask.shape
        xi = torch.clamp(torch.round((lon - state["_lon0"]) / state["_dlon"])
                         .to(torch.int64), 0, nx - 1)
        yi = torch.clamp(torch.round((lat - state["_lat0"]) / state["_dlat"])
                         .to(torch.int64), 0, ny - 1)
        inside = ((lon >= state["_lon0"]) & (lat >= state["_lat0"])
                  & (xi < nx - 1) & (yi < ny - 1))
        return yi * nx + xi, inside

    def _indices_np(self, lon, lat):
        """Host (xi, yi, inside) in float64, as the JAX package's host
        checks compute them."""
        lon = np.asarray(lon, np.float64)
        lat = np.asarray(lat, np.float64)
        ny, nx = self._mask.shape
        xi = np.clip(np.round((lon - self._lon0) / self._dlon)
                     .astype(np.int32), 0, nx - 1)
        yi = np.clip(np.round((lat - self._lat0) / self._dlat)
                     .astype(np.int32), 0, ny - 1)
        inside = ((lon >= self._lon0) & (lat >= self._lat0)
                  & (xi < nx - 1) & (yi < ny - 1))
        return xi, yi, inside

    def contains(self, lon, lat):
        """Host-side point-on-land check (seeding diagnostics)."""
        xi, yi, inside = self._indices_np(lon, lat)
        return inside & (self._mask[yi, xi] > 0.5)


class ShapeReader(RasterMask):
    """land_binary_mask = 1 inside the polygons of a shapefile."""

    def __init__(self, shapefile, resolution_deg=0.001, invert=False,
                 name=None):
        polys = shapefile_polygons(shapefile)
        if not polys:
            raise ValueError(f"No polygons in {shapefile}")
        allpts = np.vstack(polys)
        pad = 10 * resolution_deg
        self._lon0 = float(allpts[:, 0].min() - pad)
        self._lat0 = float(allpts[:, 1].min() - pad)
        lon1 = allpts[:, 0].max() + pad
        lat1 = allpts[:, 1].max() + pad
        self._dlon = self._dlat = resolution_deg
        nx = min(int((lon1 - self._lon0) / resolution_deg) + 1, 20000)
        ny = min(int((lat1 - self._lat0) / resolution_deg) + 1, 20000)
        lons = self._lon0 + np.arange(nx) * resolution_deg
        lats = self._lat0 + np.arange(ny) * resolution_deg
        mask = rasterize_polygons(polys, lons, lats)
        if invert:
            mask = ~mask
        self._mask = mask.astype(np.float32)
        self._polys = polys
        super().__init__()
        self.name = name or f"shape_landmask_{shapefile}"
        logger.info("Rasterised %d polygons to %dx%d grid (%.1f%% inside)",
                    len(polys), ny, nx, 100 * mask.mean())

    def sample(self, dev_state, varnames, t, lon, lat, z):
        lin, inside = self._cell(dev_state, lon, lat)
        return {"land_binary_mask": dev_state["mask"].view(-1)[lin]}, inside

    def contains(self, lon, lat):
        """Host-side point-in-mask check (seeding diagnostics): the
        nearest cell, clamped to the raster, as in the JAX package."""
        xi, yi, _ = self._indices_np(lon, lat)
        return self._mask[yi, xi] > 0.5
