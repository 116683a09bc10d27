"""Spherical map projections of the forcing files, in float64 numpy.

Polar stereographic (north pole, true scale at ``lat_ts``) and Lambert
conformal conic with one standard parallel, on a sphere of radius ``R``
(Snyder, Map Projections: A Working Manual, 1987, ch. 21 and 15), and the
grid convergence that turns grid-relative vector components east and north.
Each projection is a dict ``{"proj": "stere" | "lcc", ...}``, as the forcing
writers record it.
"""

import numpy as np


def _lcc_constants(p):
    phi1 = np.radians(p["lat_1"])
    n = np.sin(phi1)
    F = np.cos(phi1) * np.tan(np.pi / 4 + phi1 / 2) ** n / n
    rho0 = p["R"] * F / np.tan(np.pi / 4 + np.radians(p["lat_0"]) / 2) ** n
    return n, F, rho0


def _dlon(p, lon):
    d = np.radians(np.asarray(lon, np.float64) - p["lon_0"])
    return np.arctan2(np.sin(d), np.cos(d))


def fwd(p, lon, lat):
    """(x, y) in metres of (lon, lat) in degrees."""
    phi = np.radians(np.asarray(lat, np.float64))
    d = _dlon(p, lon)
    if p["proj"] == "stere":
        k = 0.5 * (1.0 + np.sin(np.radians(p["lat_ts"])))
        rho = 2.0 * p["R"] * k * np.tan(np.pi / 4 - phi / 2)
        return rho * np.sin(d), -rho * np.cos(d)
    n, F, rho0 = _lcc_constants(p)
    rho = p["R"] * F / np.tan(np.pi / 4 + phi / 2) ** n
    return rho * np.sin(n * d), rho0 - rho * np.cos(n * d)


def inv(p, x, y):
    """(lon, lat) in degrees of (x, y) in metres."""
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if p["proj"] == "stere":
        k = 0.5 * (1.0 + np.sin(np.radians(p["lat_ts"])))
        rho = np.hypot(x, y)
        phi = np.pi / 2 - 2.0 * np.arctan(rho / (2.0 * p["R"] * k))
        lam = np.arctan2(x, -y)
    else:
        n, F, rho0 = _lcc_constants(p)
        dy = rho0 - y
        rho = np.hypot(x, dy)
        phi = 2.0 * np.arctan((p["R"] * F / rho) ** (1.0 / n)) - np.pi / 2
        lam = np.arctan2(x, dy) / n
    return p["lon_0"] + np.degrees(lam), np.degrees(phi)


def convergence(p, lon):
    """The angle (radians) from true north to grid north at ``lon``."""
    d = _dlon(p, lon)
    if p["proj"] == "stere":
        return d
    return _lcc_constants(p)[0] * d


def to_east_north(p, lon, ux, uy):
    """Grid-relative (ux, uy) as (east, north) components at ``lon``."""
    g = convergence(p, lon)
    c, s = np.cos(g), np.sin(g)
    return ux * c + uy * s, -ux * s + uy * c
