"""Eulerian convection-diffusion solver (eulerdrift subpackage).

Port of ``opendrift_tpu/models/eulerdrift.py``, the counterpart of the
reference's finite-difference Eulerian drift model (reference:
opendrift/models/eulerdrift/simulation.py:1-282, grid.py:1-118,
diff.py:1-10, readers.py:1-104): solves

    dc/dt = D * laplacian(c) - U . grad(c)

on a regular UTM-projected grid.  The field is a float32 tensor on the
simulation's device; each step is a ``torch.roll`` 5-point stencil (the
JAX package's ``lax.scan`` body), and the forcing is sampled onto the grid
on the host for every step time first, then stacked on the device, so the
device loop never waits for the host.  Only the snapshots that
``store_every`` returns are kept.
"""

import logging
from datetime import datetime, timedelta

import numpy as np
import torch

from ..interop import resolve_device
from ..utils import crs as crslib
from ..utils.plotting import pyplot

logger = logging.getLogger(__name__)


def utm_proj4(lon, lat):
    """Proj4 string of the UTM zone containing (lon, lat) (reference:
    eulerdrift/srs.py:8-27 ``find_utm_proj``)."""
    zone = int((lon + 180.0) // 6.0) + 1
    south = " +south" if lat < 0 else ""
    return (f"+proj=utm +zone={zone}{south} +ellps=WGS84 +units=m")


def vec_nearest(X, xp):
    """Index of the element of ``X`` nearest each ``xp`` (reference:
    eulerdrift/interp.py:4-19)."""
    xp = np.atleast_1d(xp)
    return np.argmin(np.abs(np.asarray(X)[:, None] - xp), axis=0)


def grad2d(f, dx, dy):
    """Smoothed first derivatives (Gaussian-derivative filter, sigma=1)
    of a 2D field (reference: eulerdrift/diff.py:6-10 ``grad2d``)."""
    from scipy import ndimage
    f = np.asarray(f)
    return (ndimage.gaussian_filter1d(f, sigma=1, axis=0, order=1,
                                      mode="constant", cval=0.0) / dx,
            ndimage.gaussian_filter1d(f, sigma=1, axis=1, order=1,
                                      mode="constant", cval=0.0) / dy)


class Reader:
    """Eulerdrift reader interface: ``read_grid(grid, var, t)`` returns
    one array per variable, shaped like the grid (reference:
    eulerdrift/readers.py:7-34)."""

    def variables(self):
        return []

    def read_grid(self, grid, var, t):
        raise NotImplementedError


class ConstantReader(Reader):
    """Constant fields (reference: eulerdrift/readers.py:37-62)."""

    def __init__(self, consts):
        self.consts = dict(consts)

    def variables(self):
        return list(self.consts)

    def read_grid(self, grid, var, _):
        for v in var:
            assert v in self.consts, f"missing variable {v}"
        return tuple(np.full(grid.shape, self.consts[v], np.float32)
                     for v in var)

    @staticmethod
    def new_xy(x=0.5, y=0.5):
        return ConstantReader({"x_sea_water_velocity": x,
                               "y_sea_water_velocity": y})


class OpendriftReader(Reader):
    """Wrap any of the port's field readers as eulerdrift forcing,
    sampled through its ``sample_at`` on the grid's device (reference:
    eulerdrift/readers.py:65-104 ``OpendriftReader``)."""

    def __init__(self, reader):
        logger.info("opendrift reader: %s (%s)", reader.name,
                    ", ".join(reader.variables))
        self.r = reader

    def variables(self):
        return list(self.r.variables)

    def read_grid(self, grid, var, t):
        env = self.r.sample_at(grid.lons.ravel(), grid.lats.ravel(),
                               t, variables=list(var), device=grid.device)
        out = tuple(np.asarray(env[v], np.float32).reshape(grid.shape)
                    for v in var)
        for arr, name in zip(out, var):
            if np.isnan(arr).any():
                logger.warning("nan's in %s", name)
        return out


class EulerGrid:
    """Regular projected grid holding a scalar concentration field, a
    float32 tensor on ``device`` (reference: eulerdrift/grid.py:7-118
    ``RegularGrid``)."""

    def __init__(self, lon0, lat0, res, shape, device=None):
        self.device = resolve_device(device)
        self.res = float(res)
        self.shape = tuple(shape)
        self.crs = crslib.from_proj4(utm_proj4(lon0, lat0))
        x0, y0 = self.crs.fwd(np, np.float64(lon0), np.float64(lat0))
        ny, nx = self.shape
        self.x = np.asarray(x0) + np.arange(nx) * self.res
        self.y = np.asarray(y0) + np.arange(ny) * self.res
        XX, YY = np.meshgrid(self.x, self.y)
        self.lons, self.lats = self.crs.inv(np, XX, YY)
        self.field = torch.zeros(self.shape, dtype=torch.float32,
                                 device=self.device)

    @classmethod
    def new(cls, lon0=10.0, lat0=65.0, res=10.0, shape=(100, 100),
            device=None):
        return cls(lon0, lat0, res, shape, device=device)

    def contains(self, lon, lat):
        x, y = self.crs.fwd(np, np.asarray(lon), np.asarray(lat))
        return bool(np.all((x >= self.x[0]) & (x <= self.x[-1])
                           & (y >= self.y[0]) & (y <= self.y[-1])))

    def index_of(self, lon, lat):
        x, y = self.crs.fwd(np, np.float64(lon), np.float64(lat))
        return (int(np.argmin(np.abs(self.y - y))),
                int(np.argmin(np.abs(self.x - x))))

    def _update_slice(self, X, iy, ix):
        """Write ``X`` with its corner at (iy, ix) as the JAX package's
        ``lax.dynamic_update_slice`` does: a negative index counts from
        the far edge, then the corner is clamped so that ``X`` lies inside
        the field (so a blob off the low edge lands at the high one,
        ROADMAP C.6)."""
        X = np.asarray(X, np.float32)
        h, w = X.shape
        ny, nx = self.shape
        iy, ix = iy + ny if iy < 0 else iy, ix + nx if ix < 0 else ix
        iy = min(max(iy, 0), ny - h)
        ix = min(max(ix, 0), nx - w)
        field = self.field.clone()
        field[iy:iy + h, ix:ix + w] = torch.as_tensor(X, device=self.device)
        self.field = field

    def source(self, lon, lat, X):
        """Add a patch ``X`` with lower-left corner at (lon, lat)
        (reference: eulerdrift/simulation.py:100-115)."""
        iy, ix = self.index_of(lon, lat)
        self._update_slice(X, iy, ix)

    def source_gaussian_blob(self, lon, lat, A=1.0, N=10, sigma=10.0):
        """Deposit a 2D Gaussian of amplitude A centred at (lon, lat)
        (reference: eulerdrift/simulation.py:117-147)."""
        iy, ix = self.index_of(lon, lat)
        k = np.arange(N) - (N - 1) / 2.0
        g = np.exp(-0.5 * (k * self.res / sigma) ** 2)
        S = A * np.outer(g, g).astype(np.float32)
        self._update_slice(S, iy - N // 2, ix - N // 2)

    def total_mass(self):
        return float(self.field.sum()) * self.res ** 2

    def center(self):
        """(lon, lat) of the grid centre (reference: eulerdrift/
        grid.py:100-108 ``center``)."""
        ny, nx = self.shape
        lon, lat = self.crs.inv(np, np.float64(self.x[nx // 2]),
                                np.float64(self.y[ny // 2]))
        return float(lon), float(lat)

    def plot(self, ax=None, show=False, cmap="inferno"):
        """Show the concentration field, brought to the host (reference:
        eulerdrift/grid.py:110-118 ``plot``; a matplotlib extent plot, no
        cartopy)."""
        plt = pyplot()
        if ax is None:
            _, ax = plt.subplots()
        im = ax.imshow(self.field.cpu().numpy(), origin="lower",
                       extent=[self.x[0], self.x[-1],
                               self.y[0], self.y[-1]], cmap=cmap)
        plt.colorbar(im, ax=ax, orientation="horizontal")
        ax.set_xlabel("easting [m]")
        ax.set_ylabel("northing [m]")
        if show:
            plt.show()
        return ax


def _step_kernel(c, u, v, D, dx, dt):
    """One explicit convection-diffusion step; roll-based 5-point
    stencil (equivalent of ndimage.laplace + np.gradient central
    differences, reference eulerdrift/simulation.py:252-276)."""
    cN = torch.roll(c, -1, dims=0)
    cS = torch.roll(c, 1, dims=0)
    cE = torch.roll(c, -1, dims=1)
    cW = torch.roll(c, 1, dims=1)
    lap = (cN + cS + cE + cW - 4.0 * c) / dx ** 2
    gy = (cN - cS) / (2.0 * dx)
    gx = (cE - cW) / (2.0 * dx)
    return c + dt * (D * lap - (u * gx + v * gy))


class ExplSimulation:
    """Explicit forward-in-time integration of the convection equation
    (reference: eulerdrift/simulation.py:224-282 ``ExplSimulation``)."""

    def __init__(self, grid, D=0.1, rho=1.0, t0=None):
        self.grid = grid
        self.D = float(D)
        self.rho = float(rho)
        self.readers = []
        self.t0 = t0 or datetime(2020, 1, 1)
        self.t = 0.0

    @classmethod
    def new(cls, lon0=10.0, lat0=65.0, res=10.0, shape=(100, 100),
            device=None, **kw):
        """A simulation on a new grid, on ``cuda`` unless ``device`` says
        otherwise."""
        return cls(EulerGrid.new(lon0, lat0, res, shape, device=device),
                   **kw)

    def stability(self, umax):
        """(min resolvable dx, max stable dt) for the explicit scheme
        (reference: eulerdrift/simulation.py:238-245)."""
        h = 2.0 * self.D / (self.rho * max(umax, 1e-12))
        dt = self.grid.res ** 2 / (2.0 * self.D)
        return h, dt

    # ------------------------------------------------------------ forcing
    def _sample_uv(self, when):
        """Grid u/v at one time from the reader chain (or zeros)."""
        ny, nx = self.grid.shape
        uv = ["x_sea_water_velocity", "y_sea_water_velocity"]
        for r in self.readers:
            if callable(r):  # plain function (lons, lats, t) -> (u, v)
                return r(self.grid.lons, self.grid.lats, when)
            if isinstance(r, Reader):          # eulerdrift reader layer
                return r.read_grid(self.grid, uv, when)
            # a bare field reader of the port: wrap on the fly
            return OpendriftReader(r).read_grid(self.grid, uv, when)
        return (np.zeros((ny, nx), np.float32),
                np.zeros((ny, nx), np.float32))

    # ---------------------------------------------------------- integrate
    def integrate(self, dt=None, max_t=None, max_steps=None,
                  store_every=0):
        """Step the field.  Returns the final field; with
        ``store_every>0`` also a (K, ny, nx) stack of the snapshots after
        every ``store_every``-th step."""
        if max_steps is None:
            if max_t is None:
                logger.warning("no termination condition, "
                               "using max_steps=1000")
                max_steps = 1000
            else:
                if dt is None:
                    _, dt = self.stability(1.0)
                max_steps = int(np.ceil(max_t / dt))
        # sample the forcing of every step on the host first, then stack it
        # on the device
        frames_u, frames_v = [], []
        probe_dt = dt if dt is not None else 1.0
        for k in range(max_steps):
            when = self.t0 + timedelta(seconds=self.t + k * probe_dt)
            u, v = self._sample_uv(when)
            frames_u.append(np.nan_to_num(np.asarray(u, np.float32)))
            frames_v.append(np.nan_to_num(np.asarray(v, np.float32)))
        frames_u, frames_v = np.stack(frames_u), np.stack(frames_v)
        umax = float(np.max(np.hypot(frames_u, frames_v)))
        h, ddt = self.stability(umax)
        if h > self.grid.res:
            logger.warning("dx too big: dx=%.3g > h=%.3g",
                           self.grid.res, h)
        if dt is None:
            dt = ddt
        elif dt > ddt:
            logger.warning("dt too big: dt=%.3g > stable %.3g", dt, ddt)
        device = self.grid.device
        U = torch.as_tensor(frames_u, device=device)
        V = torch.as_tensor(frames_v, device=device)
        del frames_u, frames_v

        D, dx = self.D, self.grid.res
        every = int(store_every)
        c = self.grid.field
        snapshots = []
        for k in range(max_steps):
            c = _step_kernel(c, U[k], V[k], D, dx, dt)
            if every and (k + 1) % every == 0:
                snapshots.append(c)
        self.grid.field = c
        self.t += max_steps * dt
        if every:
            if snapshots:
                return c, torch.stack(snapshots)
            return c, c.new_zeros((0,) + tuple(c.shape))
        return c

    def step(self, dt=None):
        return self.integrate(dt=dt, max_steps=1)
