"""Post-processing: density maps, residence time, FTLE/LCS, statistics.

Port of ``opendrift_tpu/models/postprocess.py`` without its plots: host
numpy over the result, as there.  A re-implementation of the reference's
analysis surface (reference: opendrift/models/basemodel/__init__.py:
4057-4930) without the xhistogram/xarray/GDAL dependencies — plain numpy
histograms over the trajectory dataset, NetCDF density-map export through
scipy's NetCDF-3 writer.
"""

import logging
from datetime import timedelta

import numpy as np

from ..utils.plotting import colormap

logger = logging.getLogger(__name__)


class PostProcessingMixin:
    """Mixed into OpenDriftSimulation (requires ``self.result``)."""

    def get_lonlat_bins(self, pixelsize_m):
        """(reference basemodel/__init__.py:4040-4055)."""
        lat = self.result["lat"].values
        lon = self.result["lon"].values
        # buffer proportional to the domain span (the reference's fixed
        # 0.1 deg would explode bin counts for metre-scale test domains)
        blat = max(0.05 * (np.nanmax(lat) - np.nanmin(lat)), 1e-7)
        blon = max(0.05 * (np.nanmax(lon) - np.nanmin(lon)), 1e-7)
        latmin = np.nanmin(lat) - blat
        latmax = np.nanmax(lat) + blat
        lonmin = np.nanmin(lon) - blon
        lonmax = np.nanmax(lon) + blon
        deltalat = pixelsize_m / 111320.0
        deltalon = deltalat / np.cos(np.radians((latmin + latmax) / 2))
        latbin = np.arange(latmin - deltalat, latmax + deltalat, deltalat)
        lonbin = np.arange(lonmin - deltalon, lonmax + deltalon, deltalon)
        return lonbin, latbin

    def get_histogram(self, pixelsize_m, weights=None, density=False):
        """Per-time, per-origin-marker 2D histograms
        (reference basemodel/__init__.py:4057-4089).

        Returns (hist[time, lon_bin, lat_bin, origin_marker],
        lon_centres, lat_centres)."""
        lonbin, latbin = self.get_lonlat_bins(pixelsize_m)
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        om = self.result["origin_marker"].values
        n_time = lon.shape[1]
        max_om = int(np.nanmax(om)) if np.isfinite(om).any() else 0
        H = np.zeros((n_time, len(lonbin) - 1, len(latbin) - 1, max_om + 1))
        for ti in range(n_time):
            for m in range(max_om + 1):
                sel = (om[:, ti] == m) & np.isfinite(lon[:, ti])
                w = weights[sel] if weights is not None else None
                h, _, _ = np.histogram2d(lon[sel, ti], lat[sel, ti],
                                         bins=[lonbin, latbin], weights=w,
                                         density=density)
                H[ti, :, :, m] = h
        lon_c = 0.5 * (lonbin[:-1] + lonbin[1:])
        lat_c = 0.5 * (latbin[:-1] + latbin[1:])
        return H, lon_c, lat_c

    def get_density_array(self, pixelsize_m, weight=None):
        """Density split into surface / submerged / stranded
        (reference basemodel/__init__.py:4091-4180).

        Returns (H_surface, H_submerged, H_stranded, lon_array, lat_array)
        with H dims (time, lon, lat)."""
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        z = self.result["z"].values
        status = self.result["status"].values
        n_time = lon.shape[1]
        lonbin, latbin = self.get_lonlat_bins(pixelsize_m)
        w = self.result[weight].values if weight is not None else None
        try:
            strandnum = self.status_categories.index("stranded")
        except ValueError:
            strandnum = -999
        shape = (n_time, len(lonbin) - 1, len(latbin) - 1)
        H_surf = np.zeros(shape)
        H_sub = np.zeros(shape)
        H_str = np.zeros(shape)
        for ti in range(n_time):
            ok = np.isfinite(lon[:, ti])
            stranded = ok & (status[:, ti] == strandnum)
            surf = ok & ~stranded & (z[:, ti] >= 0)
            sub = ok & ~stranded & (z[:, ti] < 0)
            for H, sel in ((H_surf, surf), (H_sub, sub), (H_str, stranded)):
                ww = w[sel, ti] if w is not None else None
                h, _, _ = np.histogram2d(lon[sel, ti], lat[sel, ti],
                                         bins=[lonbin, latbin], weights=ww)
                H[ti] = h
        return H_surf, H_sub, H_str, lonbin, latbin

    def get_density_array_proj(self, pixelsize_m, density_proj=None,
                               llcrnrlon=None, llcrnrlat=None,
                               urcrnrlon=None, urcrnrlat=None,
                               weight=None):
        """Particle density on a projected grid
        (reference basemodel/__init__.py:4148-4240).

        Returns (H[time, y, x], x_edges, y_edges, crs)."""
        from ..utils import crs as crslib
        if density_proj is None:
            crs = crslib.from_proj4("+proj=latlong")
            pixel = pixelsize_m / 111320.0
        else:
            crs = crslib.from_proj4(density_proj) \
                if isinstance(density_proj, str) else density_proj
            pixel = float(pixelsize_m)
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        x, y = crs.fwd(np, np.nan_to_num(lon, nan=0.0),
                       np.nan_to_num(lat, nan=0.0))
        valid = np.isfinite(lon)
        if llcrnrlon is not None:
            x0, y0 = crs.fwd(np, np.float64(llcrnrlon),
                             np.float64(llcrnrlat))
            x1, y1 = crs.fwd(np, np.float64(urcrnrlon),
                             np.float64(urcrnrlat))
        else:
            x0 = np.nanmin(np.where(valid, x, np.nan))
            x1 = np.nanmax(np.where(valid, x, np.nan))
            y0 = np.nanmin(np.where(valid, y, np.nan))
            y1 = np.nanmax(np.where(valid, y, np.nan))
        xe = np.arange(x0, x1 + pixel, pixel)
        ye = np.arange(y0, y1 + pixel, pixel)
        n_time = lon.shape[1]
        H = np.zeros((n_time, len(ye) - 1, len(xe) - 1))
        w_arr = None
        if weight is not None:
            w_arr = self.result[weight].values if isinstance(weight, str) \
                else np.asarray(weight)
        for ti in range(n_time):
            sel = valid[:, ti]
            w = None
            if w_arr is not None:
                w = w_arr[sel, ti] if w_arr.ndim == 2 else w_arr[sel]
            h, _, _ = np.histogram2d(y[sel, ti], x[sel, ti],
                                     bins=[ye, xe], weights=w)
            H[ti] = h
        return H, xe, ye, crs

    def write_netcdf_density_map_proj(self, filename, pixelsize_m=1000.0,
                                      density_proj=None, **corner_kw):
        """Projected density map file
        (reference basemodel/__init__.py:4342-4440)."""
        from scipy.io import netcdf_file
        H, xe, ye, crs = self.get_density_array_proj(
            pixelsize_m, density_proj=density_proj, **corner_kw)
        xc = 0.5 * (xe[:-1] + xe[1:])
        yc = 0.5 * (ye[:-1] + ye[1:])
        times = np.asarray(self.result.coords["time"]) \
            .astype("datetime64[s]").astype("float64")
        f = netcdf_file(filename, "w", version=2)
        try:
            f.createDimension("time", H.shape[0])
            f.createDimension("y", len(yc))
            f.createDimension("x", len(xc))
            tv = f.createVariable("time", "d", ("time",))
            tv[:] = times
            tv.units = "seconds since 1970-01-01 00:00:00"
            xv = f.createVariable("x", "d", ("x",))
            xv[:] = xc
            yv = f.createVariable("y", "d", ("y",))
            yv[:] = yc
            dv = f.createVariable("density", "f", ("time", "y", "x"))
            dv[:] = H.astype(np.float32)
            dv.grid_mapping = "projection"
            f.proj4 = getattr(crs, "proj4", "+proj=latlong")
        finally:
            f.close()

    def write_geotiff(self, filename, pixelsize_km=0.2):
        """Write one georeferenced TIFF per time step (reference
        basemodel/__init__.py:4444-4504).  Without GDAL each frame is a
        plain RGBA TIFF (matplotlib's viridis, written by Pillow) plus an
        ESRI world file (.tfw) and a .prj, the georeferencing every GIS
        accepts."""
        from PIL import Image
        cmap = colormap("viridis")
        H, lon_c, lat_c = self.get_histogram(pixelsize_m=pixelsize_km
                                             * 1000.0)
        H = H.sum(axis=-1)  # collapse origin markers
        times = np.asarray(self.result.coords["time"]) \
            .astype("datetime64[s]").tolist()
        written = []
        for ti, when in enumerate(times):
            fname = when.strftime(filename) if "%" in filename \
                else filename.replace(".tif", f"_{ti:04d}.tif")
            h = H[ti].T[::-1]  # (lat desc, lon) image orientation
            hn = h / max(h.max(), 1)
            rgba = (cmap(hn) * 255).astype(np.uint8)
            rgba[..., 3] = np.where(h > 0, 255, 0)
            Image.fromarray(rgba).save(fname)
            dlon = lon_c[1] - lon_c[0] if len(lon_c) > 1 else 1e-3
            dlat = lat_c[1] - lat_c[0] if len(lat_c) > 1 else 1e-3
            with open(fname[:-4] + ".tfw", "w") as fw:
                fw.write(f"{dlon}\n0.0\n0.0\n{-dlat}\n"
                         f"{lon_c[0]}\n{lat_c[-1]}\n")
            with open(fname[:-4] + ".prj", "w") as fp:
                fp.write('GEOGCS["WGS 84",DATUM["WGS_1984",'
                         'SPHEROID["WGS 84",6378137,298.257223563]],'
                         'PRIMEM["Greenwich",0],'
                         'UNIT["degree",0.0174532925199433]]')
            written.append(fname)
        return written

    def get_residence_time(self, pixelsize_m):
        """Accumulated element counts over the run
        (reference basemodel/__init__.py:4247-4251)."""
        H_surf, H_sub, H_str, lons, lats = \
            self.get_density_array(pixelsize_m)
        return (H_surf + H_sub).sum(axis=0), lons, lats

    def write_netcdf_density_map(self, filename, pixelsize_m=1000.0):
        """Density-map NetCDF export
        (reference basemodel/__init__.py:4253-4340)."""
        from scipy.io import netcdf_file
        H_surf, H_sub, H_str, lonbin, latbin = \
            self.get_density_array(pixelsize_m)
        lon_c = 0.5 * (lonbin[:-1] + lonbin[1:])
        lat_c = 0.5 * (latbin[:-1] + latbin[1:])
        times = self.result.coords["time"].astype("datetime64[s]")
        secs = (times - np.datetime64("1970-01-01T00:00:00", "s")
                ).astype("float64")
        f = netcdf_file(filename, "w", version=2)
        try:
            f.createDimension("time", H_surf.shape[0])
            f.createDimension("lon", len(lon_c))
            f.createDimension("lat", len(lat_c))
            v = f.createVariable("time", "d", ("time",))
            v[:] = secs
            v.units = "seconds since 1970-01-01 00:00:00"
            v = f.createVariable("lon", "d", ("lon",))
            v[:] = lon_c
            v.units = "degrees_east"
            v = f.createVariable("lat", "d", ("lat",))
            v[:] = lat_c
            v.units = "degrees_north"
            for name, H in (("density_surface", H_surf),
                            ("density_submerged", H_sub),
                            ("density_stranded", H_str)):
                v = f.createVariable(name, "f", ("time", "lon", "lat"))
                v[:] = H.astype(np.float32)
                v.units = "1"
            f.flush()
        finally:
            f.close()

    def center_of_gravity(self, onlysurface=False):
        """Mean position (and std) per time step
        (reference basemodel/__init__.py:4925-4954)."""
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        if onlysurface:
            z = self.result["z"].values
            mask = ~(z >= 0)
            lon = np.where(mask, np.nan, lon)
            lat = np.where(mask, np.nan, lat)
        return (np.nanmean(lon, axis=0), np.nanmean(lat, axis=0),
                np.nanstd(lon, axis=0), np.nanstd(lat, axis=0))

    # --------------------------------------------------------- FTLE/LCS ---
    def clone(self):
        """A fresh simulation of the same class, config and readers, on
        the same device (reference basemodel/__init__.py:4750-4780)."""
        c = type(self)(loglevel=logging.WARNING, device=self.device)
        for key, item in self._config.items():
            if key in c._config:
                c._config[key].value = item.value
        for reader in self.env.readers.values():
            c.add_reader(reader)
        return c

    def calculate_ftle(self, reader=None, delta=None, domain=None,
                       time=None, time_step=None, duration=None, z=0.0,
                       RLCS=True, ALCS=True):
        """Finite-time Lyapunov exponents by cloned forward/backward runs
        on a regular grid (reference basemodel/__init__.py:4844-4923)."""
        from ..ops.lcs import ftle
        if reader is None:
            reader = list(self.env.readers.values())[0]
        crs = reader.crs
        if not isinstance(duration, timedelta):
            duration = timedelta(seconds=duration)
        if domain is None:
            xs = np.arange(reader.xmin, reader.xmax, delta)
            ys = np.arange(reader.ymin, reader.ymax, delta)
        else:
            xmin, xmax, ymin, ymax = domain
            xs = np.arange(xmin, xmax, delta)
            ys = np.arange(ymin, ymax, delta)
        X, Y = np.meshgrid(xs, ys)
        lons, lats = crs.inv(np, X, Y)
        if time is None:
            time = reader.start_time
        if not isinstance(time, list):
            time = [time]
        lcs = {"time": time, "lon": lons, "lat": lats,
               "RLCS": np.zeros((len(time),) + X.shape),
               "ALCS": np.zeros((len(time),) + X.shape)}
        T = abs(duration.total_seconds())

        def final_xy(o):
            lon = o.result["lon"].values
            lat = o.result["lat"].values
            # forward-fill dead elements to their last position
            lon = np.where(np.isfinite(lon), lon, np.nan)
            idx = np.arange(lon.shape[1])
            filled_lon = lon.copy()
            filled_lat = lat.copy()
            for tcol in range(1, lon.shape[1]):
                nanmask = ~np.isfinite(filled_lon[:, tcol])
                filled_lon[nanmask, tcol] = filled_lon[nanmask, tcol - 1]
                filled_lat[nanmask, tcol] = filled_lat[nanmask, tcol - 1]
            return crs.fwd(np, filled_lon[:, -1].reshape(X.shape),
                           filled_lat[:, -1].reshape(X.shape))

        def run(o, step):
            # only the end of a run is read: one output interval of lon, lat
            # and status (the JAX package keeps every step of every
            # variable; the same fields, without gigabytes on the host at
            # millions of seeds)
            dt = abs(_seconds_td(step)) if step is not None else \
                60.0 * self.get_config("general:time_step_minutes")
            o.run(duration=duration, time_step=step,
                  time_step_output=max(1, int(round(T / dt))) * dt,
                  export_variables=["lon", "lat", "status"])

        for i, t in enumerate(time):
            if RLCS:
                o = self.clone()
                o.seed_elements(lons.ravel(), lats.ravel(), time=t, z=z,
                                number=lons.size)
                run(o, time_step)
                bx, by = final_xy(o)
                lcs["RLCS"][i] = ftle(bx - X, by - Y, delta, T)
            if ALCS:
                o = self.clone()
                o.seed_elements(lons.ravel(), lats.ravel(),
                                time=t + duration, z=z,
                                number=lons.size)
                run(o, -abs(_seconds_td(time_step)))
                bx, by = final_xy(o)
                lcs["ALCS"][i] = ftle(bx - X, by - Y, delta, T)
        return lcs


def _seconds_td(value):
    if isinstance(value, timedelta):
        return value.total_seconds()
    return float(value)
