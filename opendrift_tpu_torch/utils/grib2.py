"""GRIB2 file parser, from scratch (no pygrib/eccodes dependency).

The port's copy of ``opendrift_tpu/utils/grib2.py``, host numpy and
unchanged in what it parses: grid templates 3.0 (lat-lon), 3.20 (polar
stereographic) and 3.30 (Lambert conformal); packing templates 5.0
(simple, numpy only) and 5.40 (JPEG2000, decoded through Pillow/OpenJPEG).
Pillow is imported when a JPEG2000 payload is first unpacked; where it is
not installed that raises an ``ImportError`` that names it, as
``utils/ncio.py`` does for h5py.
"""

import struct
from datetime import datetime, timedelta

import numpy as np

__all__ = ["Grib2File", "Grib2Message"]


def _sm_int(raw):
    """GRIB sign-magnitude integer: MSB set means negative."""
    sign = -1 if raw & (1 << (raw.bit_length() - 1)) and False else 1
    return sign * raw


def _signed(data, off, n):
    """Read an n-byte sign-magnitude big-endian integer."""
    raw = int.from_bytes(data[off:off + n], "big")
    top = 1 << (8 * n - 1)
    if raw & top:
        return -(raw & (top - 1))
    return raw


def _u(data, off, n):
    return int.from_bytes(data[off:off + n], "big")


_TIME_UNIT_SECONDS = {0: 60, 1: 3600, 2: 86400, 10: 3 * 3600,
                      11: 6 * 3600, 12: 12 * 3600, 13: 1}

# (discipline, parameterCategory, parameterNumber) -> CF standard name
PARAMETER_MAP = {
    (0, 2, 2): "x_wind",
    (0, 2, 3): "y_wind",
    (0, 3, 5): "geopotential_height",
    (0, 0, 0): "air_temperature",
    (0, 3, 0): "air_pressure",
    (10, 1, 2): "x_sea_water_velocity",
    (10, 1, 3): "y_sea_water_velocity",
    (10, 3, 0): "sea_surface_height",
    (10, 0, 3): "sea_surface_wave_significant_height",
    (10, 2, 0): "sea_ice_area_fraction",
    (0, 1, 0): "specific_humidity",
}


class Grib2Message:
    """One decoded GRIB2 message: grid description + lazily unpacked
    data values."""

    def __init__(self, fname, sections, offset):
        self._sections = sections
        self.file = fname
        self.offset = offset
        self._parse_identification()
        self._parse_grid()
        self._parse_product()
        self._parse_representation()

    # ---------------------------------------------------------------- sec1
    def _parse_identification(self):
        s1 = self._sections[1]
        self.centre = _u(s1, 5, 2)
        self.ref_time = datetime(_u(s1, 12, 2), s1[14], s1[15],
                                 s1[16], s1[17], s1[18])

    # ---------------------------------------------------------------- sec3
    def _parse_grid(self):
        s3 = self._sections[3]
        self.n_points = _u(s3, 6, 4)
        tmpl = _u(s3, 12, 2)
        self.grid_template = tmpl
        if tmpl == 0:     # regular lat/lon
            ni = _u(s3, 30, 4)
            nj = _u(s3, 34, 4)
            la1 = _signed(s3, 46, 4) * 1e-6
            lo1 = _signed(s3, 50, 4) * 1e-6
            la2 = _signed(s3, 55, 4) * 1e-6
            lo2 = _signed(s3, 59, 4) * 1e-6
            scan = s3[71]
            self.shape = (nj, ni)
            self.proj4 = "+proj=latlong"
            if lo2 < lo1:
                lo2 += 360.0
            self.x = np.linspace(lo1, lo2, ni)
            ys = np.linspace(la1, la2, nj)
            self.y = ys
            self.scan_neg_j = not bool(scan & 0x40)  # j scans -ve = N->S
        elif tmpl == 20:  # polar stereographic
            nx = _u(s3, 30, 4)
            ny = _u(s3, 34, 4)
            la1 = _signed(s3, 38, 4) * 1e-6
            lo1 = _signed(s3, 42, 4) * 1e-6
            lad = _signed(s3, 47, 4) * 1e-6
            lov = _signed(s3, 51, 4) * 1e-6
            dx = _u(s3, 55, 4) * 1e-3
            dy = _u(s3, 59, 4) * 1e-3
            pcf = s3[63]
            scan = s3[64]
            south = bool(pcf & 0x80)
            lat0 = -90 if south else 90
            self.proj4 = (f"+proj=stere +lat_0={lat0} +lat_ts={lad} "
                          f"+lon_0={lov} +x_0=0 +y_0=0 +R=6371229")
            from . import crs as crslib
            p = crslib.from_proj4(self.proj4)
            x1, y1 = p.fwd(np, np.float64(lo1), np.float64(la1))
            self.shape = (ny, nx)
            self.x = float(x1) + np.arange(nx) * dx
            self.scan_neg_j = not bool(scan & 0x40)
            # (x1,y1) is the FIRST grid point; with -j scanning row j
            # sits at y1 - j*dy and values() flips rows to ascending y,
            # so the axis must start at y1-(ny-1)*dy (see grib1.py).
            if self.scan_neg_j:
                self.y = float(y1) - (ny - 1 - np.arange(ny)) * dy
            else:
                self.y = float(y1) + np.arange(ny) * dy
        elif tmpl == 30:  # Lambert conformal
            nx = _u(s3, 30, 4)
            ny = _u(s3, 34, 4)
            la1 = _signed(s3, 38, 4) * 1e-6
            lo1 = _signed(s3, 42, 4) * 1e-6
            lad = _signed(s3, 47, 4) * 1e-6
            lov = _signed(s3, 51, 4) * 1e-6
            dx = _u(s3, 55, 4) * 1e-3
            dy = _u(s3, 59, 4) * 1e-3
            scan = s3[64]
            lat1 = _signed(s3, 65, 4) * 1e-6
            lat2 = _signed(s3, 69, 4) * 1e-6
            self.proj4 = (f"+proj=lcc +lat_1={lat1} +lat_2={lat2} "
                          f"+lat_0={lad} +lon_0={lov} +R=6371229")
            from . import crs as crslib
            p = crslib.from_proj4(self.proj4)
            x1, y1 = p.fwd(np, np.float64(lo1), np.float64(la1))
            self.shape = (ny, nx)
            self.x = float(x1) + np.arange(nx) * dx
            self.scan_neg_j = not bool(scan & 0x40)
            # (x1,y1) is the FIRST grid point; with -j scanning row j
            # sits at y1 - j*dy and values() flips rows to ascending y,
            # so the axis must start at y1-(ny-1)*dy (see grib1.py).
            if self.scan_neg_j:
                self.y = float(y1) - (ny - 1 - np.arange(ny)) * dy
            else:
                self.y = float(y1) + np.arange(ny) * dy
        else:
            raise NotImplementedError(
                f"GRIB2 grid template 3.{tmpl} not supported")

    # ---------------------------------------------------------------- sec4
    def _parse_product(self):
        s0 = self._sections[0]
        s4 = self._sections[4]
        self.discipline = s0[6]
        tmpl = _u(s4, 7, 2)
        self.product_template = tmpl
        self.parameter_category = s4[9]
        self.parameter_number = s4[10]
        unit = s4[17]
        fct = _u(s4, 18, 4)
        self.lead_seconds = fct * _TIME_UNIT_SECONDS.get(unit, 3600)
        self.valid_time = self.ref_time + timedelta(
            seconds=self.lead_seconds)
        self.level_type = s4[22]
        sf = s4[23]
        sv = _u(s4, 24, 4)
        self.level = sv * 10.0 ** (-sf) if sf < 127 else float(sv)
        key = (self.discipline, self.parameter_category,
               self.parameter_number)
        self.standard_name = PARAMETER_MAP.get(key)
        self.parameter_key = key

    # ---------------------------------------------------------------- sec5
    def _parse_representation(self):
        s5 = self._sections[5]
        self.n_values = _u(s5, 5, 4)
        self.packing_template = _u(s5, 9, 2)
        if self.packing_template in (0, 40):
            self.R = struct.unpack(">f", s5[11:15])[0]
            self.E = _signed(s5, 15, 2)
            self.D = _signed(s5, 17, 2)
            self.nbits = s5[19]
        else:
            raise NotImplementedError(
                f"GRIB2 packing template 5.{self.packing_template} "
                f"not supported (only 5.0 simple and 5.40 JPEG2000)")

    # ---------------------------------------------------------------- data
    def values(self):
        """Unpack the field to a (ny, nx) float32 array (row 0 = south)."""
        s6 = self._sections[6]
        s7 = self._sections[7]
        payload = s7[5:]
        if self.packing_template == 40:
            import io
            try:
                from PIL import Image
            except ImportError as e:
                raise ImportError(
                    f"{self.file}: a JPEG2000-packed GRIB2 message (template "
                    "5.40) is decoded with Pillow, and Pillow is not "
                    "installed; install Pillow (with OpenJPEG) or repack the "
                    "file with simple packing") from e
            img = Image.open(io.BytesIO(payload))
            X = np.asarray(img, dtype=np.float64).ravel()
        else:  # simple packing
            if self.nbits == 0:
                X = np.zeros(self.n_values, dtype=np.float64)
            else:
                bits = np.unpackbits(
                    np.frombuffer(payload, dtype=np.uint8))
                n = self.n_values
                bits = bits[:n * self.nbits].reshape(n, self.nbits)
                weights = (1 << np.arange(self.nbits - 1, -1, -1)
                           ).astype(np.float64)
                X = bits @ weights
        vals = (self.R + X * 2.0 ** self.E) / 10.0 ** self.D
        # bitmap (section 6 indicator 0): scatter into full grid
        if s6 is not None and s6[5] == 0:
            bm = np.unpackbits(np.frombuffer(s6[6:], dtype=np.uint8))
            bm = bm[:self.n_points].astype(bool)
            full = np.full(self.n_points, np.nan)
            full[bm] = vals
            vals = full
        grid = np.asarray(vals, dtype=np.float32).reshape(self.shape)
        if self.scan_neg_j:  # stored N->S: flip so row 0 = y.min()
            grid = grid[::-1]
        return grid

    def __repr__(self):
        return (f"Grib2Message({self.parameter_key} "
                f"{self.standard_name or '?'} @ {self.valid_time}, "
                f"grid 3.{self.grid_template} {self.shape}, "
                f"packing 5.{self.packing_template})")


class Grib2File:
    """All messages of a GRIB2 file."""

    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            data = f.read()
        self.messages = []
        pos = 0
        while pos < len(data) - 16:
            idx = data.find(b"GRIB", pos)
            if idx < 0:
                break
            if data[idx + 7] != 2:
                pos = idx + 4
                continue
            total = _u(data, idx + 8, 8)
            msg = data[idx:idx + total]
            sections = {0: msg[:16]}
            p = 16
            while p < total - 4:
                if msg[p:p + 4] == b"7777":
                    break
                seclen = _u(msg, p, 4)
                secnum = msg[p + 4]
                sections[secnum] = msg[p:p + seclen]
                p += seclen
            sections.setdefault(6, None)
            try:
                self.messages.append(Grib2Message(path, sections, idx))
            except NotImplementedError:
                pass  # skip unsupported grids/packings
            pos = idx + total
        if not self.messages:
            raise ValueError(f"{path}: no decodable GRIB2 messages")
