"""Global coastline landmask.

Port of ``opendrift_tpu/fields/landmask.py``, the counterpart of the
reference's ``reader_global_landmask`` (reference:
opendrift/readers/reader_global_landmask.py:201-260), which samples the
GSHHG polygons.  Coverage comes from, in priority order:

1. a polygon shapefile supplied by the deployment (``shapefile=`` or
   ``OPENDRIFT_LANDMASK_SHP``), rasterised by :class:`ShapeReader`;
2. the bundled coarse raster ``opendrift_tpu_torch/data/coastline_mask.npz``
   (a byte copy of the JAX package's: 0.08 degrees, covering the Nordic,
   Barents, Arctic and Benguela test domains);
3. landmasks of gridded ocean readers' own grids.

Positions outside the raster's coverage are reported as not covered, so a
stranding run without a usable mask fails loudly (``models/base.py``).
"""

import logging
import os

import numpy as np

from .shape import RasterMask, ShapeReader

logger = logging.getLogger(__name__)

BUNDLED = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "coastline_mask.npz")


class GlobalLandmask(RasterMask):
    """Rasterised landmask from a shapefile or the bundled raster."""

    def __new__(cls, shapefile=None, resolution_deg=0.01):
        shapefile = shapefile or os.environ.get("OPENDRIFT_LANDMASK_SHP")
        if shapefile is not None:
            if not os.path.exists(shapefile):
                raise FileNotFoundError(shapefile)
            return ShapeReader(shapefile, resolution_deg=resolution_deg,
                               name="global_landmask")
        return super().__new__(cls)

    def __init__(self, shapefile=None, resolution_deg=0.01):
        if not os.path.exists(BUNDLED):
            raise FileNotFoundError(
                "No coastline dataset: neither OPENDRIFT_LANDMASK_SHP nor "
                f"the bundled raster ({BUNDLED}) is available")
        d = np.load(BUNDLED)
        shape = tuple(d["shape"])
        self._mask = np.unpackbits(
            d["land"], axis=1)[:, :shape[1]].astype(np.float32)
        self._covered = np.unpackbits(
            d["covered"], axis=1)[:, :shape[1]].astype(bool)
        self._lon0 = float(d["lon0"])
        self._lat0 = float(d["lat0"])
        self._dlon = float(d["dlon"])
        self._dlat = float(d["dlat"])
        super().__init__()
        self.name = "global_landmask"
        logger.info(
            "Bundled coastline raster: %dx%d at %.2f deg, lon >= %.2f, "
            "lat >= %.2f (coverage limited to the bundled domains)",
            *self._mask.shape, self._dlon, self._lon0, self._lat0)

    def _host_arrays(self):
        return {"mask": self._mask, "covered": self._covered}

    def sample(self, dev_state, varnames, t, lon, lat, z):
        lin, inside = self._cell(dev_state, lon, lat)
        covers = inside & dev_state["covered"].view(-1)[lin]
        return {"land_binary_mask": dev_state["mask"].view(-1)[lin]}, covers

    def covers_positions(self, lon, lat):
        """Host-side coverage of the positions (float64)."""
        xi, yi, inside = self._indices_np(lon, lat)
        return inside & self._covered[yi, xi]
