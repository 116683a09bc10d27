"""Map projections (proj4-string subset), generic over the array namespace.

The port's copy of ``opendrift_tpu/utils/crs.py``: longlat, stere
(spherical oblique and polar, ellipsoidal polar, conformal-sphere
oblique), merc, lcc (one or two standard parallels), tmerc/utm (Krüger
series, 4th order), ob_tran (rotated pole over longlat), and the ESRI WKT
parser of .prj files.  Functions take the array namespace ``xp`` (numpy
on the host, ``utils.xp.tnp`` for torch tensors on the reader's device,
inside the samplers); the formulas are the JAX package's, unchanged.

Formulae follow Snyder, "Map Projections — A Working Manual" (USGS PP 1395)
and Karney (2011) for the transverse-Mercator series.
"""

import math

# ---------------------------------------------------------------------------
# proj4 string parsing

_ELLPS = {
    "WGS84": (6378137.0, 298.257223563),
    "GRS80": (6378137.0, 298.257222101),
    "intl": (6378388.0, 297.0),
    "clrk66": (6378206.4, 294.9786982),
    "sphere": (6370997.0, 0.0),  # f=0 -> sphere
}


def parse_proj4(proj4):
    """Parse a proj4 string into a dict (numbers converted to float)."""
    params = {}
    for token in proj4.split():
        token = token.lstrip("+")
        if "=" in token:
            k, v = token.split("=", 1)
            try:
                params[k] = float(v)
            except ValueError:
                params[k] = v
        else:
            params[token] = True
    return params


def _ellipsoid(params):
    """Resolve (a, f) from proj4 params. Returns (a, f, e, e2)."""
    if "R" in params:
        a, f = float(params["R"]), 0.0
    elif "a" in params:
        a = float(params["a"])
        if "b" in params:
            b = float(params["b"])
            f = (a - b) / a
        elif "rf" in params:
            f = 1.0 / float(params["rf"])
        elif "f" in params:
            f = float(params["f"])
        elif "e" in params:
            e = float(params["e"])
            f = 1.0 - math.sqrt(1.0 - e * e)
        else:
            f = 0.0  # sphere by default when only +a given
    else:
        name = params.get("ellps", "WGS84")
        a, rf = _ELLPS.get(name, _ELLPS["WGS84"])
        f = 0.0 if rf == 0.0 else 1.0 / rf
    e2 = f * (2.0 - f)
    e = math.sqrt(e2)
    return a, f, e, e2


# ---------------------------------------------------------------------------
# shared ellipsoidal helpers (conformal latitude machinery)

def _ts(xp, phi, e):
    """Snyder's t(phi) = tan(pi/4 - phi/2) / ((1-e sin phi)/(1+e sin phi))^(e/2)."""
    sinphi = xp.sin(phi)
    con = e * sinphi
    return xp.tan(0.5 * (math.pi / 2.0 - phi)) / ((1.0 - con) / (1.0 + con)) ** (e / 2.0)


def _phi_from_ts(xp, ts, e, iterations=6):
    """Invert t(phi) by fixed-point iteration (Snyder 7-9)."""
    phi = math.pi / 2.0 - 2.0 * xp.arctan(ts)
    for _ in range(iterations):
        con = e * xp.sin(phi)
        phi = math.pi / 2.0 - 2.0 * xp.arctan(
            ts * ((1.0 - con) / (1.0 + con)) ** (e / 2.0))
    return phi


def _msfn(sinphi, cosphi, e2):
    return cosphi / math.sqrt(1.0 - e2 * sinphi * sinphi)


class CRS:
    """A projected (or geographic) coordinate reference system.

    ``fwd(xp, lon, lat)`` -> (x, y) in projection units;
    ``inv(xp, x, y)`` -> (lon, lat) degrees;
    ``convergence(xp, lon, lat)`` -> angle gamma (radians) from true north to
    grid north, positive clockwise, so that rotating grid-relative (u_x, u_y)
    to east/north is ``u_e = u_x cos(g) + u_y sin(g)`` ... see
    :func:`rotate_to_eastnorth`.
    """

    is_latlon = False

    def __init__(self, proj4):
        self.proj4 = proj4
        p = self.params = parse_proj4(proj4)
        self.a, self.f, self.e, self.e2 = _ellipsoid(p)
        self.lon_0 = float(p.get("lon_0", 0.0))
        self.lat_0 = float(p.get("lat_0", 0.0))
        self.x_0 = float(p.get("x_0", 0.0))
        self.y_0 = float(p.get("y_0", 0.0))
        self.k_0 = float(p.get("k", p.get("k_0", 1.0)))
        # 'units=km' scales outputs
        self.to_meter = {"km": 1000.0, "m": 1.0}.get(p.get("units", "m"), 1.0)

    # -- public API --------------------------------------------------------
    def fwd(self, xp, lon, lat):
        x, y = self._fwd(xp, xp.radians(lon - self.lon_0), xp.radians(lat))
        return ((x + self.x_0) / self.to_meter,
                (y + self.y_0) / self.to_meter)

    def inv(self, xp, x, y):
        lonr, latr = self._inv(xp, x * self.to_meter - self.x_0,
                               y * self.to_meter - self.y_0)
        lon = xp.degrees(lonr) + self.lon_0
        # precision-safe wrap (see utils/geodesic.py wrap_longitude)
        lon = xp.where(lon > 180.0, lon - 360.0, lon)
        lon = xp.where(lon < -180.0, lon + 360.0, lon)
        return lon, xp.degrees(latr)

    def convergence(self, xp, lon, lat):
        """Grid convergence angle gamma (radians), analytic per projection."""
        raise NotImplementedError

    def __repr__(self):
        return f"{type(self).__name__}({self.proj4!r})"


class LatLonCRS(CRS):
    is_latlon = True

    def fwd(self, xp, lon, lat):
        return lon, lat

    def inv(self, xp, x, y):
        return x, y

    def convergence(self, xp, lon, lat):
        return xp.zeros_like(lon + lat)


class StereographicCRS(CRS):
    """+proj=stere.  Spherical: exact oblique/polar (Snyder ch. 21).
    Ellipsoidal: exact polar aspect (Snyder 21-33..21-41); oblique
    ellipsoidal is approximated via the conformal sphere (PROJ's approach
    for +proj=sterea, accurate to mm for the oblique ocean grids in use)."""

    def __init__(self, proj4):
        super().__init__(proj4)
        self.lat_ts = float(self.params.get("lat_ts", self.lat_0))
        phi0 = math.radians(self.lat_0)
        self.polar = abs(abs(self.lat_0) - 90.0) < 1e-8
        self.north = self.lat_0 > 0
        if self.e == 0.0:
            self.sinphi0 = math.sin(phi0)
            self.cosphi0 = math.cos(phi0)
            # spherical lat_ts scale: k0' = k0 * cos(lat_ts) applies only to
            # polar aspect; oblique uses k_0 directly.
            if self.polar and "lat_ts" in self.params:
                ts = math.radians(self.lat_ts)
                self.k_eff = 0.5 * (1.0 + (math.sin(ts) if self.north
                                           else -math.sin(ts)))
            else:
                self.k_eff = self.k_0
        else:
            if not self.polar:
                # conformal-sphere setup (Snyder ch. 3 / PROJ sterea)
                self._setup_conformal_sphere(phi0)
            else:
                e = self.e
                if abs(abs(self.lat_ts) - 90.0) < 1e-8:
                    self.rho_factor = (
                        2.0 * self.a * self.k_0
                        / math.sqrt((1.0 + e) ** (1.0 + e) * (1.0 - e) ** (1.0 - e)))
                else:
                    phits = math.radians(abs(self.lat_ts))
                    m_c = _msfn(math.sin(phits), math.cos(phits), self.e2)
                    t_c = _ts(math, phits, e)
                    self.rho_factor = self.a * m_c / t_c

    def _setup_conformal_sphere(self, phi0):
        e, e2 = self.e, self.e2
        sp0, cp0 = math.sin(phi0), math.cos(phi0)
        self.R_c = self.a * math.sqrt(1.0 - e2) / (1.0 - e2 * sp0 * sp0)
        # conformal latitude of origin
        chi0 = 2.0 * math.atan(math.tan(math.pi / 4 + phi0 / 2)
                               * ((1 - e * sp0) / (1 + e * sp0)) ** (e / 2)) - math.pi / 2
        self.chi0 = chi0
        self.sinchi0 = math.sin(chi0)
        self.coschi0 = math.cos(chi0)

    def _chi(self, xp, phi):
        e = self.e
        sp = xp.sin(phi)
        return 2.0 * xp.arctan(xp.tan(math.pi / 4 + phi / 2)
                               * ((1 - e * sp) / (1 + e * sp)) ** (e / 2)) - math.pi / 2

    def _fwd(self, xp, dlon, lat):
        if self.e == 0.0:
            sinp, cosp = xp.sin(lat), xp.cos(lat)
            sinl, cosl = xp.sin(dlon), xp.cos(dlon)
            if self.polar:
                sign = 1.0 if self.north else -1.0
                t = xp.tan(math.pi / 4 - sign * lat / 2)
                rho = 2.0 * self.a * self.k_eff * t
                return rho * sinl, -sign * rho * cosl
            denom = 1.0 + self.sinphi0 * sinp + self.cosphi0 * cosp * cosl
            k = 2.0 * self.a * self.k_eff / denom
            x = k * cosp * sinl
            y = k * (self.cosphi0 * sinp - self.sinphi0 * cosp * cosl)
            return x, y
        if self.polar:
            sign = 1.0 if self.north else -1.0
            t = _ts(xp, sign * lat, self.e)
            rho = self.rho_factor * t
            return rho * xp.sin(dlon), -sign * rho * xp.cos(dlon)
        # oblique ellipsoidal via conformal sphere
        chi = self._chi(xp, lat)
        sinc, cosc = xp.sin(chi), xp.cos(chi)
        sinl, cosl = xp.sin(dlon), xp.cos(dlon)
        denom = 1.0 + self.sinchi0 * sinc + self.coschi0 * cosc * cosl
        k = 2.0 * self.R_c * self.k_0 / denom
        return k * cosc * sinl, k * (self.coschi0 * sinc - self.sinchi0 * cosc * cosl)

    def _inv(self, xp, x, y):
        if self.e == 0.0:
            rho = xp.sqrt(x * x + y * y)
            if self.polar:
                sign = 1.0 if self.north else -1.0
                c = 2.0 * xp.arctan(rho / (2.0 * self.a * self.k_eff))
                lat = sign * (math.pi / 2 - c)
                lon = xp.arctan2(x, -sign * y)
                return lon, lat
            c = 2.0 * xp.arctan(rho / (2.0 * self.a * self.k_eff))
            sinc, cosc = xp.sin(c), xp.cos(c)
            safe_rho = xp.where(rho == 0.0, 1.0, rho)
            lat = xp.arcsin(cosc * self.sinphi0 + y * sinc * self.cosphi0 / safe_rho)
            lat = xp.where(rho == 0.0, self.lat_0 * math.pi / 180.0, lat)
            lon = xp.arctan2(x * sinc,
                             safe_rho * self.cosphi0 * cosc - y * self.sinphi0 * sinc)
            lon = xp.where(rho == 0.0, xp.zeros_like(lon), lon)
            return lon, lat
        if self.polar:
            sign = 1.0 if self.north else -1.0
            rho = xp.sqrt(x * x + y * y)
            t = rho / self.rho_factor
            lat = sign * _phi_from_ts(xp, t, self.e)
            lon = xp.arctan2(x, -sign * y)
            return lon, lat
        rho = xp.sqrt(x * x + y * y)
        c = 2.0 * xp.arctan(rho / (2.0 * self.R_c * self.k_0))
        sinc, cosc = xp.sin(c), xp.cos(c)
        safe_rho = xp.where(rho == 0.0, 1.0, rho)
        chi = xp.arcsin(cosc * self.sinchi0 + y * sinc * self.coschi0 / safe_rho)
        chi = xp.where(rho == 0.0, self.chi0, chi)
        lon = xp.arctan2(x * sinc,
                         safe_rho * self.coschi0 * cosc - y * self.sinchi0 * sinc)
        lon = xp.where(rho == 0.0, xp.zeros_like(lon), lon)
        # invert conformal latitude by iteration
        e = self.e
        phi = chi
        for _ in range(5):
            sp = xp.sin(phi)
            phi = 2.0 * xp.arctan(xp.tan(math.pi / 4 + chi / 2)
                                  * ((1 + e * sp) / (1 - e * sp)) ** (e / 2)) - math.pi / 2
        return lon, phi

    def convergence(self, xp, lon, lat):
        if self.polar:
            dlon = xp.radians(lon - self.lon_0)
            dlon = xp.arctan2(xp.sin(dlon), xp.cos(dlon))
            return dlon if self.north else -dlon
        return _numeric_convergence(self, xp, lon, lat)


class MercatorCRS(CRS):
    def __init__(self, proj4):
        super().__init__(proj4)
        lat_ts = float(self.params.get("lat_ts", 0.0))
        phits = math.radians(lat_ts)
        if self.e == 0.0:
            self.k_eff = self.k_0 * math.cos(phits)
        else:
            self.k_eff = self.k_0 * _msfn(math.sin(phits), math.cos(phits), self.e2)

    def _fwd(self, xp, dlon, lat):
        x = self.a * self.k_eff * dlon
        if self.e == 0.0:
            y = self.a * self.k_eff * xp.log(xp.tan(math.pi / 4 + lat / 2))
        else:
            y = -self.a * self.k_eff * xp.log(_ts(xp, lat, self.e))
        return x, y

    def _inv(self, xp, x, y):
        lon = x / (self.a * self.k_eff)
        if self.e == 0.0:
            lat = math.pi / 2 - 2.0 * xp.arctan(xp.exp(-y / (self.a * self.k_eff)))
        else:
            lat = _phi_from_ts(xp, xp.exp(-y / (self.a * self.k_eff)), self.e)
        return lon, lat

    def convergence(self, xp, lon, lat):
        return xp.zeros_like(lon + lat)


class LambertConformalCRS(CRS):
    """+proj=lcc (Snyder ch. 15)."""

    def __init__(self, proj4):
        super().__init__(proj4)
        p = self.params
        lat_1 = float(p.get("lat_1", self.lat_0))
        lat_2 = float(p.get("lat_2", lat_1))
        phi1, phi2 = math.radians(lat_1), math.radians(lat_2)
        phi0 = math.radians(self.lat_0)
        e, e2 = self.e, self.e2
        m1 = _msfn(math.sin(phi1), math.cos(phi1), e2)
        t1 = _ts(math, phi1, e) if e > 0 else math.tan(math.pi / 4 - phi1 / 2)
        if abs(lat_1 - lat_2) > 1e-10:
            m2 = _msfn(math.sin(phi2), math.cos(phi2), e2)
            t2 = _ts(math, phi2, e) if e > 0 else math.tan(math.pi / 4 - phi2 / 2)
            self.n = math.log(m1 / m2) / math.log(t1 / t2)
        else:
            self.n = math.sin(phi1)
        self.F = m1 / (self.n * t1 ** self.n)
        t0 = _ts(math, phi0, e) if e > 0 else math.tan(math.pi / 4 - phi0 / 2)
        self.rho0 = self.a * self.F * t0 ** self.n * self.k_0

    def _t(self, xp, lat):
        if self.e > 0:
            return _ts(xp, lat, self.e)
        return xp.tan(math.pi / 4 - lat / 2)

    def _fwd(self, xp, dlon, lat):
        t = self._t(xp, lat)
        rho = self.a * self.F * t ** self.n * self.k_0
        theta = self.n * dlon
        return rho * xp.sin(theta), self.rho0 - rho * xp.cos(theta)

    def _inv(self, xp, x, y):
        n = self.n
        yy = self.rho0 - y
        rho = math.copysign(1.0, n) * xp.sqrt(x * x + yy * yy)
        theta = xp.arctan2(math.copysign(1.0, n) * x, math.copysign(1.0, n) * yy)
        lon = theta / n
        t = (rho / (self.a * self.F * self.k_0)) ** (1.0 / n)
        if self.e > 0:
            lat = _phi_from_ts(xp, t, self.e)
        else:
            lat = math.pi / 2 - 2.0 * xp.arctan(t)
        return lon, lat

    def convergence(self, xp, lon, lat):
        dlon = xp.radians(lon - self.lon_0)
        dlon = xp.arctan2(xp.sin(dlon), xp.cos(dlon))
        return self.n * dlon


class TransverseMercatorCRS(CRS):
    """+proj=tmerc / +proj=utm — Krüger series, 4th order (Karney 2011)."""

    def __init__(self, proj4):
        super().__init__(proj4)
        p = self.params
        if p.get("proj") == "utm":
            zone = int(p.get("zone", 31))
            self.lon_0 = zone * 6.0 - 183.0
            self.k_0 = 0.9996
            self.x_0 = 500000.0
            self.y_0 = 10000000.0 if "south" in p else 0.0
        f = self.f
        n = f / (2.0 - f)
        self.n = n
        self.A_rect = self.a / (1.0 + n) * (1.0 + n * n / 4.0 + n ** 4 / 64.0)
        self.alpha = [
            n / 2.0 - 2.0 / 3.0 * n ** 2 + 5.0 / 16.0 * n ** 3 + 41.0 / 180.0 * n ** 4,
            13.0 / 48.0 * n ** 2 - 3.0 / 5.0 * n ** 3 + 557.0 / 1440.0 * n ** 4,
            61.0 / 240.0 * n ** 3 - 103.0 / 140.0 * n ** 4,
            49561.0 / 161280.0 * n ** 4,
        ]
        self.beta = [
            n / 2.0 - 2.0 / 3.0 * n ** 2 + 37.0 / 96.0 * n ** 3 - 1.0 / 360.0 * n ** 4,
            1.0 / 48.0 * n ** 2 + 1.0 / 15.0 * n ** 3 - 437.0 / 1440.0 * n ** 4,
            17.0 / 480.0 * n ** 3 - 37.0 / 840.0 * n ** 4,
            4397.0 / 161280.0 * n ** 4,
        ]

    def _fwd(self, xp, dlon, lat):
        e = self.e
        sinphi = xp.sin(lat)
        # conformal latitude
        t = xp.sinh(xp.arctanh(sinphi) - e * xp.arctanh(e * sinphi)) \
            if e > 0 else xp.sinh(xp.arctanh(sinphi))
        xi = xp.arctan2(t, xp.cos(dlon))
        eta = xp.arctanh(xp.sin(dlon) / xp.sqrt(1.0 + t * t))
        x = eta
        y = xi
        for j, aj in enumerate(self.alpha, start=1):
            x = x + aj * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
            y = y + aj * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
        return (self.k_0 * self.A_rect * x, self.k_0 * self.A_rect * y)

    def _inv(self, xp, x, y):
        eta = x / (self.k_0 * self.A_rect)
        xi = y / (self.k_0 * self.A_rect)
        xi_p, eta_p = xi, eta
        for j, bj in enumerate(self.beta, start=1):
            xi_p = xi_p - bj * xp.sin(2 * j * xi) * xp.cosh(2 * j * eta)
            eta_p = eta_p - bj * xp.cos(2 * j * xi) * xp.sinh(2 * j * eta)
        chi = xp.arcsin(xp.clip(
            xp.sin(xi_p) / xp.cosh(eta_p), -1.0, 1.0))
        # invert the conformal latitude by fixed-point iteration
        e = self.e
        phi = chi
        for _ in range(5):
            sp = xp.sin(phi)
            phi = 2.0 * xp.arctan(
                xp.tan(math.pi / 4 + chi / 2)
                * ((1 + e * sp) / (1 - e * sp)) ** (e / 2)) - math.pi / 2
        lon = xp.arctan2(xp.sinh(eta_p), xp.cos(xi_p))
        return lon, phi

    def convergence(self, xp, lon, lat):
        return _numeric_convergence(self, xp, lon, lat)


class ObTranCRS(CRS):
    """+proj=ob_tran +o_proj=longlat (rotated pole, spherical).

    NB: like PROJ, outputs are in *radians* times the sphere radius unless
    the caller rescales; here we output degrees in the rotated frame, which
    is what gridded rotated-pole datasets index by.
    """

    def __init__(self, proj4):
        super().__init__(proj4)
        p = self.params
        o_lat_p = math.radians(float(p.get("o_lat_p", 90.0)))
        self.o_lon_p = math.radians(float(p.get("o_lon_p", 0.0)))
        self.sin_theta = math.sin(o_lat_p)
        self.cos_theta = math.cos(o_lat_p)
        self.lon0r = math.radians(self.lon_0)

    def fwd(self, xp, lon, lat):
        lam = xp.radians(lon) - self.lon0r
        phi = xp.radians(lat)
        st, ct = self.sin_theta, self.cos_theta
        sinp = xp.sin(phi)
        cosp = xp.cos(phi)
        rot_lat = xp.arcsin(xp.clip(st * sinp - ct * cosp * xp.cos(lam), -1, 1))
        rot_lon = xp.arctan2(cosp * xp.sin(lam),
                             st * cosp * xp.cos(lam) + ct * sinp) - self.o_lon_p
        return xp.degrees(rot_lon), xp.degrees(rot_lat)

    def inv(self, xp, x, y):
        lam = xp.radians(x) + self.o_lon_p
        phi = xp.radians(y)
        st, ct = self.sin_theta, self.cos_theta
        sinp = xp.sin(phi)
        cosp = xp.cos(phi)
        lat = xp.arcsin(xp.clip(st * sinp + ct * cosp * xp.cos(lam), -1, 1))
        lon = xp.arctan2(cosp * xp.sin(lam),
                         st * cosp * xp.cos(lam) - ct * sinp) + self.lon0r
        lon = xp.degrees(lon)
        lon = (lon + 180.0) % 360.0 - 180.0
        return lon, xp.degrees(lat)

    def convergence(self, xp, lon, lat):
        return _numeric_convergence(self, xp, lon, lat)


def _numeric_convergence(crs, xp, lon, lat, dnorth=1e-4):
    """Convergence from finite difference along the meridian — the generic
    fallback mirroring the reference's azimuth-of-north method
    (reference: opendrift/readers/basereader/variables.py:59-109)."""
    x0, y0 = crs.fwd(xp, lon, lat)
    x1, y1 = crs.fwd(xp, lon, lat + dnorth)
    return xp.arctan2(x1 - x0, y1 - y0)


_PROJ_CLASSES = {
    "longlat": LatLonCRS, "latlong": LatLonCRS, "lonlat": LatLonCRS,
    "latlon": LatLonCRS,
    "stere": StereographicCRS,
    "sterea": StereographicCRS,
    "merc": MercatorCRS,
    "lcc": LambertConformalCRS,
    "tmerc": TransverseMercatorCRS,
    "utm": TransverseMercatorCRS,
    "ob_tran": ObTranCRS,
}


def from_esri_wkt(wkt):
    """Build a CRS from an ESRI/OGC WKT string (.prj files).

    Covers the projections this package implements; the reference parses
    .prj via GDAL (unavailable here)."""
    import re as _re

    def param(name, default=0.0):
        m = _re.search(rf'PARAMETER\["{name}",([-0-9.eE]+)\]', wkt,
                       _re.IGNORECASE)
        return float(m.group(1)) if m else default

    sph = _re.search(r'SPHEROID\["[^"]*",([-0-9.eE]+),([-0-9.eE]+)\]', wkt)
    if sph:
        a = float(sph.group(1))
        rf = float(sph.group(2))
        ell = f"+a={a} +rf={rf}" if rf > 0 else f"+R={a}"
    else:
        ell = "+ellps=WGS84"

    proj_m = _re.search(r'PROJECTION\["([^"]+)"\]', wkt, _re.IGNORECASE)
    if proj_m is None:
        return from_proj4("+proj=latlong")
    pname = proj_m.group(1).lower()
    lon0 = param("Central_Meridian")
    lat0 = param("Latitude_Of_Origin")
    x0 = param("False_Easting")
    y0 = param("False_Northing")
    if "mercator" in pname and "transverse" not in pname:
        lat_ts = param("Standard_Parallel_1")
        return from_proj4(f"+proj=merc +lon_0={lon0} +lat_ts={lat_ts} "
                          f"+x_0={x0} +y_0={y0} {ell}")
    if "transverse_mercator" in pname:
        k0 = param("Scale_Factor", 1.0)
        return from_proj4(f"+proj=tmerc +lon_0={lon0} +lat_0={lat0} "
                          f"+k_0={k0} +x_0={x0} +y_0={y0} {ell}")
    if "lambert_conformal" in pname:
        lat1 = param("Standard_Parallel_1")
        lat2 = param("Standard_Parallel_2", lat1)
        return from_proj4(f"+proj=lcc +lon_0={lon0} +lat_0={lat0} "
                          f"+lat_1={lat1} +lat_2={lat2} +x_0={x0} "
                          f"+y_0={y0} {ell}")
    if "stereographic" in pname:
        return from_proj4(f"+proj=stere +lon_0={lon0} +lat_0={lat0} "
                          f"+x_0={x0} +y_0={y0} {ell}")
    raise NotImplementedError(f"WKT projection '{pname}' not supported")


def from_proj4(proj4):
    """Construct a CRS from a proj4 string."""
    params = parse_proj4(proj4)
    name = params.get("proj")
    if name not in _PROJ_CLASSES:
        raise NotImplementedError(
            f"Projection '+proj={name}' is not implemented "
            f"(supported: {sorted(set(_PROJ_CLASSES))})")
    return _PROJ_CLASSES[name](proj4)


def rotate_to_eastnorth(xp, u_x, u_y, gamma):
    """Rotate grid-relative vector components to east/north using the grid
    convergence angle gamma (radians, clockwise from true north to grid
    north).  Inverse of :func:`rotate_from_eastnorth`."""
    cg = xp.cos(gamma)
    sg = xp.sin(gamma)
    u_e = u_x * cg + u_y * sg
    v_n = -u_x * sg + u_y * cg
    return u_e, v_n


def rotate_from_eastnorth(xp, u_e, v_n, gamma):
    cg = xp.cos(gamma)
    sg = xp.sin(gamma)
    return u_e * cg - v_n * sg, u_e * sg + v_n * cg
