"""Plain reference of an OceanDrift forecast on gridded file forcing.

What a forecast of the ``oceandrift_*`` configurations computes, written
out once with numpy, for a sample of its elements.  It takes what the
benchmark itself made: the forcing arrays before they were written to
the files (int16 with their scale, offset and fill value) and the seeded
positions.  It takes nothing the program derived.

One step of ``dt`` seconds, as OpenDrift defines it (upstream
``basemodel/__init__.py`` run loop and ``physics_methods.py``):

1. sample the environment at the position and depth: currents and the
   seafloor depth from the ocean file, wind from the wind file, each
   bilinear in the file's projected grid, linear between its depth levels
   and between its frames, grid-relative vectors turned east and north;
   a cell with no value (land, below the seafloor) takes the value of the
   level above it, then of the nearest ocean cell of its level;
2. an element on a land cell of the ocean file (nearest grid point)
   strands where three bisections of its last move first find land;
   an element below the seafloor is lifted to it;
3. (the output frame is the state here)
4. move: fourth-order Runge-Kutta in the currents (stage 4 displaced by
   half a step, as upstream does), windage of 2 % decaying to nothing at
   0.1 m depth, a horizontal random walk of diffusivity ``D``; Visser's
   (1997) vertical random walk in Large et al.'s (1994) diffusivity of the
   wind, on 1 m levels, with reflections at the surface and seafloor.

Positions, depths and fields are held in float32, as the configuration
states; arithmetic on them is float64 except for the vertical walk, which
runs in float32.  The draws are those of ``draws.py``.  The fill takes the
Euclidean nearest ocean cell of the whole grid; where two cells are nearly
equally near, a program may take the other, so an element that samples a
land cell can differ (the comparison allows for a few such).
"""

import numpy as np
from scipy import ndimage

from . import draws, proj

WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
# wind drift (upstream defaults): factor and the depth it decays over
WIND_DRIFT_FACTOR = 0.02
WIND_DRIFT_DEPTH = 0.1
# Large et al. (1994) as upstream physics_methods.py writes it
RHO_AIR = 1.22
DRAG = 1.25e-3
MIXED_LAYER = 50.0
BACKGROUND_K = 1.2e-5
COAST_BISECTIONS = 3


# ------------------------------------------------------------- geodesy --

def geodesic_direct(lat, lon, azimuth_deg, distance):
    """Vincenty's direct solution on WGS84 (float64, iterated to
    convergence): the point ``distance`` metres from (lat, lon) along the
    initial ``azimuth_deg``."""
    a, f = WGS84_A, WGS84_F
    b = a * (1.0 - f)
    phi1 = np.radians(lat)
    alpha1 = np.radians(azimuth_deg)
    sa1, ca1 = np.sin(alpha1), np.cos(alpha1)
    tanU1 = (1.0 - f) * np.tan(phi1)
    cosU1 = 1.0 / np.sqrt(1.0 + tanU1 ** 2)
    sinU1 = tanU1 * cosU1
    sigma1 = np.arctan2(tanU1, ca1)
    sin_alpha = cosU1 * sa1
    cos2_alpha = 1.0 - sin_alpha ** 2
    u2 = cos2_alpha * (a * a - b * b) / (b * b)
    A = 1.0 + u2 / 16384.0 * (4096.0 + u2 * (-768.0 + u2 * (320.0
                                                          - 175.0 * u2)))
    B = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    sigma = distance / (b * A)
    for _ in range(8):
        c2sm = np.cos(2.0 * sigma1 + sigma)
        ss, cs = np.sin(sigma), np.cos(sigma)
        dsigma = B * ss * (c2sm + B / 4.0 * (
            cs * (-1.0 + 2.0 * c2sm ** 2)
            - B / 6.0 * c2sm * (-3.0 + 4.0 * ss ** 2)
            * (-3.0 + 4.0 * c2sm ** 2)))
        sigma = distance / (b * A) + dsigma
    ss, cs = np.sin(sigma), np.cos(sigma)
    c2sm = np.cos(2.0 * sigma1 + sigma)
    tmp = sinU1 * ss - cosU1 * cs * ca1
    phi2 = np.arctan2(sinU1 * cs + cosU1 * ss * ca1,
                      (1.0 - f) * np.sqrt(sin_alpha ** 2 + tmp ** 2))
    lam = np.arctan2(ss * sa1, cosU1 * cs - sinU1 * ss * ca1)
    C = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
    L = lam - (1.0 - C) * f * sin_alpha * (sigma + C * ss * (
        c2sm + C * cs * (-1.0 + 2.0 * c2sm ** 2)))
    return np.degrees(phi2), lon + np.degrees(L)


def move(lat, lon, u, v, seconds):
    """(lat, lon) after moving with east/north velocity (u, v) m/s."""
    az = np.degrees(np.arctan2(u, v))
    return geodesic_direct(lat, lon, az, np.hypot(u, v) * seconds)


# -------------------------------------------------------------- fields --

def _nearest_fill(field):
    """NaN cells of each 2D layer of ``field`` (..., Y, X) take the value
    of the nearest finite cell of their layer (Euclidean)."""
    out = field.reshape(-1, *field.shape[-2:])
    cache = {}
    for i in range(out.shape[0]):
        bad = ~np.isfinite(out[i])
        if not bad.any() or bad.all():
            continue
        key = bad.tobytes()
        if key not in cache:
            cache[key] = ndimage.distance_transform_edt(
                bad, return_distances=False, return_indices=True)
        out[i] = out[i][tuple(cache[key])]
    return out.reshape(field.shape)


def _fill_down(field):
    """Below-seafloor cells (NaN under a finite level) take the value of
    the level above, along axis -3 (levels from the surface down)."""
    for k in range(1, field.shape[-3]):
        cur = field[..., k, :, :]
        up = field[..., k - 1, :, :]
        bad = ~np.isfinite(cur)
        cur[bad] = up[bad]
    return field


class Grid:
    """One forcing file's fields on its projected grid."""

    def __init__(self, record, wanted):
        self.proj = record["proj"]
        self.x0 = float(record["x"][0])
        self.y0 = float(record["y"][0])
        self.dx = float(record["x"][1] - record["x"][0])
        self.dy = float(record["y"][1] - record["y"][0])
        self.nx, self.ny = len(record["x"]), len(record["y"])
        self.times = np.asarray(record["times_s"], np.float64)
        self.depths = record["depths"]
        self.fields = {}
        self.land = None
        for std, var in record["vars"].items():
            if std not in wanted:
                continue
            if "packed" in var:
                raw = var["packed"]
                values = (raw.astype(np.float64) * var["scale"]
                          + var["offset"]).astype(np.float32)
                values[raw == var["fill"]] = np.nan
                if std == "x_sea_water_velocity":
                    # land: where the first frame's surface current is fill
                    self.land = ~np.isfinite(values[0, 0])
                if self.depths is not None:
                    values = _fill_down(values)
            else:
                values = np.asarray(var["values"], np.float32).copy()
            self.fields[std] = _nearest_fill(values)
        if "h" in record:
            self.fields["sea_floor_depth_below_sea_level"] = _nearest_fill(
                np.asarray(record["h"], np.float32).copy())

    def index(self, lon, lat):
        x, y = proj.fwd(self.proj, lon, lat)
        return (x - self.x0) / self.dx, (y - self.y0) / self.dy

    def covers(self, xi, yi, eps=1e-2):
        return ((xi >= -eps) & (xi <= self.nx - 1 + eps)
                & (yi >= -eps) & (yi <= self.ny - 1 + eps))

    @staticmethod
    def _cell(i, n):
        i0 = np.clip(np.floor(i), 0, n - 2).astype(np.int64)
        return i0, np.clip(i - i0, 0.0, 1.0)

    def _frames(self, t):
        """The two frames around ``t`` and their weights."""
        ti = int(np.clip(np.searchsorted(self.times, t, side="right") - 1,
                         0, len(self.times) - 2))
        tw = float(np.clip((t - self.times[ti])
                           / (self.times[ti + 1] - self.times[ti]), 0, 1))
        return ((ti, 1.0 - tw), (ti + 1, tw))

    def _levels(self, depth):
        """The two levels around each ``depth`` and their weights."""
        d = self.depths
        z0 = np.clip(np.searchsorted(d, depth, side="right") - 1, 0,
                     len(d) - 2)
        fz = np.clip((depth - d[z0]) / (d[z0 + 1] - d[z0]), 0.0, 1.0)
        return ((z0, 1.0 - fz), (z0 + 1, fz))

    def sample(self, std, lon, lat, depth=None, t=None):
        """A static (y, x), a (time, y, x) or a (time, level, y, x) field
        at the positions (float64)."""
        xi, yi = self.index(lon, lat)
        x0, fx = self._cell(xi, self.nx)
        y0, fy = self._cell(yi, self.ny)
        f = self.fields[std]
        planes = [((), 1.0)]
        if f.ndim >= 3:
            planes = [((tt,), wt) for tt, wt in self._frames(t)]
        if f.ndim == 4:
            planes = [(p + (zz,), w * wz) for p, w in planes
                      for zz, wz in self._levels(depth)]
        out = 0.0
        for plane, w in planes:
            def at(yy, xx):
                return f[plane + (yy, xx)].astype(np.float64)
            out = out + w * ((at(y0, x0) * (1 - fx) + at(y0, x0 + 1) * fx)
                             * (1 - fy)
                             + (at(y0 + 1, x0) * (1 - fx)
                                + at(y0 + 1, x0 + 1) * fx) * fy)
        return out

    def on_land(self, lon, lat):
        """The land mask at the nearest grid point of the cell."""
        xi, yi = self.index(lon, lat)
        x0, fx = self._cell(xi, self.nx)
        y0, fy = self._cell(yi, self.ny)
        return self.land[y0 + (fy > 0.5), x0 + (fx > 0.5)]

    def vector(self, names, lon, lat, depth, t):
        """East and north components of a grid-relative vector field."""
        return proj.to_east_north(self.proj, lon,
                                  self.sample(names[0], lon, lat, depth, t),
                                  self.sample(names[1], lon, lat, depth, t))


# ------------------------------------------------------------ the walk --

def _large1994(wind, depth):
    """Large et al. (1994) diffusivity (float32, upstream's expression)."""
    f32 = np.float32
    depth = np.abs(depth)
    stress = wind * wind * f32(DRAG) * f32(RHO_AIR)
    mld = f32(MIXED_LAYER)
    sigma = depth / mld
    g = sigma - f32(2.0) * (sigma * sigma) + sigma * sigma * sigma
    g = np.where(g >= f32(1.0), f32(0.0), g)
    k = mld * f32(0.2) * f32(0.4) * g * stress + sigma * f32(BACKGROUND_K)
    return np.where(depth >= mld, f32(BACKGROUND_K), k).astype(np.float32)


def visser_walk(z, wind, zmin, ids, seed, ntimes, dt_mix):
    """Visser's random walk over ``ntimes`` substeps (float32): 1 m
    nearest levels, a one-sided gradient at the surface, reflection at
    the surface and the seafloor; an element at the surface stays."""
    f32 = np.float32
    z = z.astype(np.float32)
    wind = wind.astype(np.float32)
    zmin = zmin.astype(np.float32)
    base = draws.walk_base(ids, seed)
    dt = f32(dt_mix)
    upper = f32(MIXED_LAYER) + f32(1.0)
    for i in range(ntimes):
        surface = z == 0
        lvl = np.minimum(np.maximum(np.round(np.abs(z)), f32(0.0)), upper)
        k = _large1994(wind, lvl)
        k_up = _large1994(wind, lvl + f32(1.0))
        k_dn = _large1994(wind, np.maximum(lvl - f32(1.0), f32(0.0)))
        dkdz = np.where(lvl == 0, k_up - k, (k_up - k_dn) * f32(0.5))
        r = draws.walk_draw(base, i)
        z = z - (dkdz * dt - r * np.sqrt(k * abs(dt) * f32(6.0)))
        z = np.where(z >= 0, -z, z)
        z = np.where(z < zmin, f32(2.0) * zmin - z, z)
        z = np.where(surface, f32(0.0), z)
        z = np.minimum(z, f32(0.0))
        z = np.maximum(z, zmin).astype(np.float32)
    return z


# ------------------------------------------------------------ forecast --

STATUS = ("active", "stranded", "missing_data", "outside")


SAMPLED = ("x_sea_water_velocity", "y_sea_water_velocity", "x_wind",
           "y_wind")


# what this reference follows, as the configuration states it
FOLLOWS = {"drift:advection_scheme": "runge-kutta4",
           "drift:vertical_mixing": True,
           "vertical_mixing:diffusivitymodel": "windspeed_Large1994"}


def prepare(config, forcing):
    """The fields the forecast samples, from the writers' records, by the
    role the configuration gives each forcing file ('ocean', 'wind')."""
    stated = {k: config["config"].get(k) for k in FOLLOWS}
    if config["model"] != "OceanDrift" or stated != FOLLOWS:
        raise ValueError(f"this reference follows OceanDrift with "
                         f"{FOLLOWS}, not {config['model']} with {stated}")
    return {spec["role"]: Grid(forcing[spec["name"]], SAMPLED)
            for spec in config["forcing"]}


def simulate(config, traffic, grids, checked):
    """Follow one forecast's sampled elements.  ``checked``: (the seeded
    (lon, lat, z) of all elements, the model's seed, the sample's 0-based
    slots).  The elements are released at the forecast's start and
    stepped ``duration_h`` hours by ``time_step_s``, with output every
    ``output_step_s``.  Returns {lon, lat, z: float64 (S, T), status:
    names (S, T)} at every output frame."""
    if float(traffic["release"].get("over_h", 0.0)) > 0:
        raise ValueError("this reference follows a release at the start")
    (lon_all, lat_all, z_all), model_seed, idx = checked
    lon, lat, z = lon_all[idx], lat_all[idx], z_all[idx]
    ids = np.asarray(idx, np.int64) + 1       # 1-based slots
    n_total = int(traffic["elements"])
    dt = float(traffic["time_step_s"])
    steps = int(round(traffic["duration_h"] * 3600.0 / dt))
    steps_per_output = int(round(traffic["output_step_s"] / dt))
    hdiff = float(config["config"]["drift:horizontal_diffusivity"])
    dt_mix = float(config["config"]["vertical_mixing:timestep"])
    ocean, wind = grids["ocean"], grids["wind"]
    uv = ("x_sea_water_velocity", "y_sea_water_velocity")
    wuv = ("x_wind", "y_wind")
    lon = np.asarray(lon, np.float32).astype(np.float64)
    lat = np.asarray(lat, np.float32).astype(np.float64)
    z = np.asarray(z, np.float32).astype(np.float64)
    S = len(ids)
    status = np.zeros(S, np.int64)      # index into STATUS
    prev_lon, prev_lat = lon.copy(), lat.copy()
    frames = {k: [] for k in ("lon", "lat", "z", "status")}
    key0 = draws.prng_key(model_seed)
    std = float(np.sqrt(np.float32(2.0) * np.float32(hdiff)
                        / np.float32(abs(dt))))
    ntimes = max(1, abs(int(dt / dt_mix)))
    f32 = np.float32

    def to32(a):
        return a.astype(np.float32).astype(np.float64)

    for step in range(steps + 1):
        t = step * dt
        active = status == 0
        # 1. the environment at the step's start
        depth = np.maximum(-z, 0.0)
        xi, yi = ocean.index(lon, lat)
        covered = ocean.covers(xi, yi)
        u, v = ocean.vector(uv, lon, lat, depth, t)
        u, v = to32(u), to32(v)
        seafloor = to32(ocean.sample("sea_floor_depth_below_sea_level",
                                     lon, lat))
        xw, yw = wind.vector(wuv, lon, lat, None, t)
        xw, yw = to32(xw), to32(yw)
        land = ocean.on_land(lon, lat)
        # 2. missing forcing, bad positions, the coast, the seafloor
        status = np.where(active & ~covered, 2, status)
        active = status == 0
        bad = ~np.isfinite(lon) | ~np.isfinite(lat) | (np.abs(lat) > 90)
        status = np.where(active & bad, 3, status)
        active = status == 0
        strand = active & land
        if strand.any():
            lo, hi = np.zeros(S), np.ones(S)
            for _ in range(COAST_BISECTIONS):
                mid = 0.5 * (lo + hi)
                hit = ocean.on_land(prev_lon + mid * (lon - prev_lon),
                                    prev_lat + mid * (lat - prev_lat))
                hi = np.where(hit, mid, hi)
                lo = np.where(hit, lo, mid)
            lon = np.where(strand, to32(prev_lon + hi * (lon - prev_lon)),
                           lon)
            lat = np.where(strand, to32(prev_lat + hi * (lat - prev_lat)),
                           lat)
            status = np.where(strand, 1, status)
        active = status == 0
        z = np.where(active & (z < -seafloor), -seafloor, z)
        # 3. the output frame
        if step % steps_per_output == 0:
            for k, a in (("lon", lon), ("lat", lat), ("z", z)):
                frames[k].append(a.copy())
            frames["status"].append(status.copy())
        if step == steps:
            break
        # 4. the move
        prev_lon, prev_lat = lon.copy(), lat.copy()
        key = draws.fold_in(draws.fold_in(key0, step // steps_per_output),
                            step % steps_per_output)
        # Runge-Kutta 4 in the currents
        lat2, lon2 = move(lat, lon, u, v, 0.5 * dt)
        u2, v2 = ocean.vector(uv, lon2, lat2, np.maximum(-z, 0.0),
                              t + 0.5 * dt)
        lat3, lon3 = move(lat, lon, u2, v2, 0.5 * dt)
        u3, v3 = ocean.vector(uv, lon3, lat3, np.maximum(-z, 0.0),
                              t + 0.5 * dt)
        lat4, lon4 = move(lat, lon, u3, v3, 0.5 * dt)
        u4, v4 = ocean.vector(uv, lon4, lat4, np.maximum(-z, 0.0), t + dt)
        vel_u = (u + 2.0 * u2 + 2.0 * u3 + u4) / 6.0
        vel_v = (v + 2.0 * v2 + 2.0 * v3 + v4) / 6.0
        # windage, decaying linearly to nothing at WIND_DRIFT_DEPTH
        wdf = np.where(z > 0, WIND_DRIFT_FACTOR,
                       WIND_DRIFT_FACTOR * (WIND_DRIFT_DEPTH + z)
                       / WIND_DRIFT_DEPTH)
        wdf = np.where(z >= -WIND_DRIFT_DEPTH, wdf, 0.0)
        vel_u = vel_u + xw * wdf
        vel_v = vel_v + yw * wdf
        # the vertical walk (its seed: the step key's first use)
        seed = draws.scalar_bits(draws.fold_in(key, 1))
        zmin = -seafloor
        z_new = visser_walk(z, np.hypot(xw, yw), zmin, ids, seed, ntimes,
                            dt_mix).astype(np.float64)
        # the horizontal walk (the step key's second use)
        noise = draws.normal_at(draws.fold_in(key, 2),
                                np.stack([ids - 1, n_total + ids - 1]))
        vel_u = vel_u + f32(std) * noise[0].astype(np.float64)
        vel_v = vel_v + f32(std) * noise[1].astype(np.float64)
        lat_n, lon_n = move(lat, lon, vel_u, vel_v, dt)
        lon = np.where(active, to32(lon_n), lon)
        lat = np.where(active, to32(lat_n), lat)
        z = np.where(active, z_new, z)
    out = {k: np.stack(v, axis=1) for k, v in frames.items()}
    out["status"] = np.asarray(STATUS, dtype=object)[out["status"]]
    return out
