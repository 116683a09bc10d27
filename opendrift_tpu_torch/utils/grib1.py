"""GRIB edition-1 file parser, from scratch (no pygrib dependency).

The port's copy of ``opendrift_tpu/utils/grib1.py``, host numpy and
unchanged.  The reference's ``reader_grib.py`` reads GRIB1 through pygrib; this
decoder covers the operational core of the edition-1 format (WMO
FM 92-VIII Ed.1): PDS/GDS/BMS/BDS sections, IBM-float reference
values, simple packing, regular lat-lon (data representation 0) and
polar-stereographic (type 5) grids, WMO parameter table 2 mapping to
CF standard names.  Messages expose the same surface as
``utils.grib2.Grib2Message`` so ``fields.grib.GribReader`` consumes
both editions transparently.
"""

from datetime import datetime, timedelta

import numpy as np

__all__ = ["Grib1File", "Grib1Message"]


def _u(data, off, n):
    return int.from_bytes(data[off:off + n], "big")


def _sm(data, off, n):
    """Sign-magnitude big-endian integer (GRIB1 convention)."""
    raw = _u(data, off, n)
    top = 1 << (8 * n - 1)
    return -(raw & (top - 1)) if raw & top else raw


def _ibm_float(b):
    """IBM System/360 32-bit float: s(1) e(7, base-16 excess-64)
    m(24); value = (-1)^s * m * 16^(e-64) / 2^24."""
    sign = -1.0 if b[0] & 0x80 else 1.0
    expo = (b[0] & 0x7F) - 64
    mant = _u(b, 1, 3)
    return sign * mant * 16.0 ** expo / 2.0 ** 24


def ibm_float_bytes(value):
    """Encode an IBM 32-bit float (used by the test fixture builder)."""
    if value == 0:
        return bytes(4)
    sign = 0x80 if value < 0 else 0
    value = abs(value)
    expo = 64
    mant = value
    # normalise mantissa into [1/16, 1)
    while mant >= 1.0:
        mant /= 16.0
        expo += 1
    while mant < 1.0 / 16.0:
        mant *= 16.0
        expo -= 1
    m = int(round(mant * 2.0 ** 24))
    if m >= 1 << 24:        # rounding overflow
        m >>= 4
        expo += 1
    return bytes([sign | expo]) + m.to_bytes(3, "big")


# WMO parameter table 2 (the operational core) -> CF standard name
PARAMETER_MAP_GRIB1 = {
    1: "air_pressure",
    2: "air_pressure_at_sea_level",
    7: "geopotential_height",
    11: "air_temperature",
    33: "x_wind",
    34: "y_wind",
    49: "x_sea_water_velocity",
    50: "y_sea_water_velocity",
    51: "specific_humidity",
    82: "sea_surface_height",
    91: "sea_ice_area_fraction",
    92: "sea_ice_thickness",
    100: "sea_surface_wave_significant_height",
}

_TIME_UNIT_SECONDS = {0: 60, 1: 3600, 2: 86400, 10: 3 * 3600,
                      11: 6 * 3600, 12: 12 * 3600, 254: 1}


class Grib1Message:
    """One decoded GRIB1 message, Grib2Message-compatible surface:
    x/y/shape/proj4/standard_name/valid_time/level/values()."""

    def __init__(self, fname, msg, offset):
        self.file = fname
        self.offset = offset
        p = 8                                  # after the 8-byte IS
        pds_len = _u(msg, p, 3)
        pds = msg[p:p + pds_len]
        p += pds_len
        self._parse_pds(pds)
        gds = bms = None
        if self._has_gds:
            gds_len = _u(msg, p, 3)
            gds = msg[p:p + gds_len]
            p += gds_len
        if self._has_bms:
            bms_len = _u(msg, p, 3)
            bms = msg[p:p + bms_len]
            p += bms_len
        bds_len = _u(msg, p, 3)
        self._bds = msg[p:p + bds_len]
        self._bms = bms
        if gds is None:
            raise NotImplementedError(
                "GRIB1 message without GDS (predefined grid) "
                "not supported")
        self._parse_gds(gds)
        self._parse_bds_header()

    # ----------------------------------------------------------------- PDS
    def _parse_pds(self, pds):
        self.table_version = pds[3]
        self.centre = pds[4]
        flags = pds[7]
        self._has_gds = bool(flags & 0x80)
        self._has_bms = bool(flags & 0x40)
        self.parameter = pds[8]
        self.level_type = pds[9]
        self.level = float(_u(pds, 10, 2))
        century = pds[24] if len(pds) > 24 else 21
        year = (century - 1) * 100 + pds[12]
        self.ref_time = datetime(year, pds[13], pds[14], pds[15], pds[16])
        unit = pds[17]
        p1 = pds[18]
        p2 = pds[19]
        tri = pds[20]          # time-range indicator, PDS octet 21
        unit_s = _TIME_UNIT_SECONDS.get(unit, 3600)
        if tri in (0, 113, 118, 123):   # forecast valid at ref + P1
            lead = p1
        elif tri == 1:                  # analysis/initialised at ref
            lead = 0
        elif tri in (2, 3, 4, 5):       # range/average/accumulation/
            lead = p2                   # difference: valid at end P2
        elif tri == 10:                 # P1 spans octets 19-20
            lead = _u(pds, 18, 2)
        else:
            raise NotImplementedError(
                f"GRIB1 time-range indicator {tri} not supported")
        self.lead_seconds = lead * unit_s
        self.valid_time = self.ref_time + timedelta(
            seconds=self.lead_seconds)
        self.D = _sm(pds, 26, 2) if len(pds) >= 28 else 0
        self.standard_name = PARAMETER_MAP_GRIB1.get(self.parameter)
        self.parameter_key = self.parameter

    # ----------------------------------------------------------------- GDS
    def _parse_gds(self, gds):
        rep = gds[5]
        self.grid_template = rep
        if rep == 0:          # regular lat/lon, millidegrees
            ni = _u(gds, 6, 2)
            nj = _u(gds, 8, 2)
            la1 = _sm(gds, 10, 3) * 1e-3
            lo1 = _sm(gds, 13, 3) * 1e-3
            la2 = _sm(gds, 17, 3) * 1e-3
            lo2 = _sm(gds, 20, 3) * 1e-3
            scan = gds[27]
            if lo2 < lo1:
                lo2 += 360.0
            self.shape = (nj, ni)
            self.proj4 = "+proj=latlong"
            self.x = np.linspace(lo1, lo2, ni)
            self.y = np.linspace(la1, la2, nj)
            # GRIB1 scan flag bit 2 (0x40): +j direction; unset = N->S
            self.scan_neg_j = not bool(scan & 0x40)
            if self.scan_neg_j and la1 > la2:
                self.y = np.linspace(la2, la1, nj)
        elif rep == 5:        # polar stereographic, lat_ts=60 by spec
            nx = _u(gds, 6, 2)
            ny = _u(gds, 8, 2)
            la1 = _sm(gds, 10, 3) * 1e-3
            lo1 = _sm(gds, 13, 3) * 1e-3
            lov = _sm(gds, 17, 3) * 1e-3
            dx = float(_u(gds, 20, 3))
            dy = float(_u(gds, 23, 3))
            south = bool(gds[26] & 0x80)
            scan = gds[27]
            lat0 = -90 if south else 90
            lat_ts = -60 if south else 60
            self.proj4 = (f"+proj=stere +lat_0={lat0} +lat_ts={lat_ts} "
                          f"+lon_0={lov} +x_0=0 +y_0=0 +R=6371229")
            from . import crs as crslib
            p = crslib.from_proj4(self.proj4)
            x1, y1 = p.fwd(np, np.float64(lo1), np.float64(la1))
            self.shape = (ny, nx)
            self.x = float(x1) + np.arange(nx) * dx
            self.scan_neg_j = not bool(scan & 0x40)
            # (x1,y1) is the FIRST grid point.  With +j scanning it is
            # the y minimum; with -j scanning (N->S rows) row j sits at
            # y1 - j*dy.  values() flips rows to ascending y, so the
            # axis must start at the last row's y1-(ny-1)*dy.
            if self.scan_neg_j:
                self.y = float(y1) - (ny - 1 - np.arange(ny)) * dy
            else:
                self.y = float(y1) + np.arange(ny) * dy
        else:
            raise NotImplementedError(
                f"GRIB1 data representation type {rep} not supported "
                "(lat-lon 0 and polar-stereographic 5 are)")

    # ----------------------------------------------------------------- BDS
    def _parse_bds_header(self):
        bds = self._bds
        flags = bds[3]
        if flags & 0x40:
            raise NotImplementedError(
                "GRIB1 harmonic-coefficient data not supported")
        if flags & 0x20:
            raise NotImplementedError(
                "GRIB1 complex/second-order packing not supported "
                "(simple packing covers operational GRIB1)")
        self._unused_bits = flags & 0x0F
        self.E = _sm(bds, 4, 2)
        self.R = _ibm_float(bds[6:10])
        self.nbits = bds[10]
        self.packing_template = 0        # "simple", Grib2-compatible

    def values(self):
        """Unpack to (ny, nx) float32, row 0 = y.min()."""
        payload = self._bds[11:]
        n_points = self.shape[0] * self.shape[1]
        if self._bms is not None:
            bm = np.unpackbits(np.frombuffer(self._bms[6:],
                                             dtype=np.uint8))
            bm = bm[:n_points].astype(bool)
            n_values = int(bm.sum())
        else:
            bm = None
            n_values = n_points
        if self.nbits == 0:
            X = np.zeros(n_values, dtype=np.float64)
        else:
            bits = np.unpackbits(np.frombuffer(payload, dtype=np.uint8))
            bits = bits[:n_values * self.nbits].reshape(n_values,
                                                        self.nbits)
            weights = (1 << np.arange(self.nbits - 1, -1, -1)
                       ).astype(np.float64)
            X = bits @ weights
        vals = (self.R + X * 2.0 ** self.E) / 10.0 ** self.D
        if bm is not None:
            full = np.full(n_points, np.nan)
            full[bm] = vals
            vals = full
        grid = np.asarray(vals, dtype=np.float32).reshape(self.shape)
        if self.scan_neg_j:
            grid = grid[::-1]
        return grid

    def __repr__(self):
        return (f"Grib1Message(param {self.parameter} "
                f"{self.standard_name or '?'} @ {self.valid_time}, "
                f"grid type {self.grid_template} {self.shape})")


class Grib1File:
    """All messages of a GRIB edition-1 file."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self.messages = []
        pos = 0
        while pos < len(data) - 8:
            idx = data.find(b"GRIB", pos)
            if idx < 0:
                break
            if data[idx + 7] != 1:
                pos = idx + 4
                continue
            total = _u(data, idx + 4, 3)
            msg = data[idx:idx + total]
            if msg[-4:] != b"7777":
                pos = idx + 4
                continue
            try:
                self.messages.append(Grib1Message(path, msg, idx))
            except NotImplementedError:
                pass
            pos = idx + total
        if not self.messages:
            raise ValueError(f"{path}: no decodable GRIB1 messages")
