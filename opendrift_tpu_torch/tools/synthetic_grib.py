"""GRIB editions 1 and 2 written from numpy, for the tests and the smoke run.

Independent write paths for the port's parsers (``utils/grib1.py``,
``utils/grib2.py``), from the WMO layouts (FM 92 GRIB editions 1 and 2):

* :func:`grib1_message`: one edition-1 message, simple packing with an
  IBM-float reference value, a regular lat-lon (type 0) or polar
  stereographic (type 5) GDS, an optional bitmap section, either scan
  direction and any time-range indicator;
* :func:`grib2_message`: one edition-2 message, grid template 3.0
  (lat-lon), 3.20 (polar stereographic) or 3.30 (Lambert conformal),
  product template 4.0, simple packing (5.0) or JPEG2000 (5.40, encoded
  with Pillow where it has OpenJPEG), an optional bitmap (section 6);
* :func:`write_ecmwf_wind`: an ECMWF-HRES-like file of 10 m wind
  (parameters 0-2-2 and 0-2-3) on a regular lat-lon grid scanned north to
  south, 16-bit simple packing, hourly frames.

Fields are given with row 0 = the first scanned row.  Each writer of a file
returns its path.
"""

import struct
from datetime import datetime

import numpy as np

from ..utils.grib1 import _ibm_float, ibm_float_bytes


def _u(v, n):
    return int(v).to_bytes(n, "big")


def _sm(v, n):
    """Sign-magnitude big-endian integer (the GRIB convention)."""
    raw = abs(int(v)) | ((1 << (8 * n - 1)) if v < 0 else 0)
    return raw.to_bytes(n, "big")


def _pack_bits(X, nbits):
    """Unsigned integers ``X`` as a big-endian bit stream of ``nbits``
    each, zero-padded to whole bytes."""
    X = np.asarray(X, dtype=np.int64).ravel()
    shifts = np.arange(nbits - 1, -1, -1, dtype=np.int64)
    bits = ((X[:, None] >> shifts) & 1).astype(np.uint8)
    return np.packbits(bits.ravel()).tobytes()


def _simple_pack(values, D, nbits):
    """(R, E) of simple packing: value * 10^D = R + X * 2^E, with the
    smallest E >= 0 for which X fits ``nbits``."""
    scaled = np.asarray(values, np.float64) * 10.0 ** D
    R = float(scaled.min()) if scaled.size else 0.0
    E = 0
    while np.round((scaled - R) / 2.0 ** E).max(initial=0) >= (1 << nbits):
        E += 1
    return R, E


def _packed_ints(values, R, E, D, nbits):
    """X of ``values`` for the reference value ``R`` as the file stores it
    (so the rounding of R cannot push an X out of range)."""
    return np.clip(np.round((np.asarray(values, np.float64) * 10.0 ** D
                             - R) / 2.0 ** E), 0,
                   (1 << nbits) - 1).astype(np.int64)


def grib1_message(field, grid, param, ref_time, unit=1, p1=0, p2=0,
                  tri=0, nbits=12, D=2, mask=None, scan_neg_j=True):
    """One GRIB1 message of ``field`` (nj, ni).

    ``grid``: ``("latlon", la1, lo1, la2, lo2)`` (degrees; the first and
    last grid points) or ``("stere", la1, lo1, lov, dx, dy, south)``
    (metres).  ``mask``: points present (bitmap section); ``scan_neg_j``:
    rows scanned north to south (scan flag 0x00, else 0x40)."""
    nj, ni = field.shape
    flat = np.asarray(field, np.float64).ravel()
    present = flat if mask is None else flat[np.asarray(mask).ravel()]
    R, E = _simple_pack(present, D, nbits)
    R = _ibm_float(ibm_float_bytes(R))
    X = _packed_ints(present, R, E, D, nbits)
    unused = (-X.size * nbits) % 8
    bds_body = (bytes([unused & 0x0F]) + _sm(E, 2) + ibm_float_bytes(R)
                + bytes([nbits]) + _pack_bits(X, nbits))
    bds = _u(len(bds_body) + 3, 3) + bds_body
    scan = 0x00 if scan_neg_j else 0x40
    if grid[0] == "latlon":
        _, la1, lo1, la2, lo2 = grid
        gds_body = (bytes([0, 255, 0]) + _u(ni, 2) + _u(nj, 2)
                    + _sm(round(la1 * 1000), 3) + _sm(round(lo1 * 1000), 3)
                    + bytes([0x80])
                    + _sm(round(la2 * 1000), 3) + _sm(round(lo2 * 1000), 3)
                    + _u(round(abs(lo2 - lo1) / max(ni - 1, 1) * 1000), 2)
                    + _u(round(abs(la2 - la1) / max(nj - 1, 1) * 1000), 2)
                    + bytes([scan]) + bytes(4))
    else:
        _, la1, lo1, lov, dx, dy, south = grid
        gds_body = (bytes([0, 255, 5]) + _u(ni, 2) + _u(nj, 2)
                    + _sm(round(la1 * 1000), 3) + _sm(round(lo1 * 1000), 3)
                    + bytes([0x80]) + _sm(round(lov * 1000), 3)
                    + _u(dx, 3) + _u(dy, 3)
                    + bytes([0x80 if south else 0x00]) + bytes([scan])
                    + bytes(4))
    gds = _u(len(gds_body) + 3, 3) + gds_body
    bms = b""
    if mask is not None:
        bms_body = bytes([0]) + _u(0, 2) + np.packbits(
            np.asarray(mask).ravel().astype(np.uint8)).tobytes()
        bms = _u(len(bms_body) + 3, 3) + bms_body
    yy = ref_time.year % 100 or 100
    century = (ref_time.year - 1) // 100 + 1
    flags = 0x80 | (0x40 if mask is not None else 0)
    pds_body = (bytes([2, 98, 1, 255, flags, param, 1]) + _u(0, 2)
                + bytes([yy, ref_time.month, ref_time.day, ref_time.hour,
                         ref_time.minute])
                + bytes([unit, p1, p2, tri]) + _u(0, 2) + bytes([0])
                + bytes([century, 0]) + _sm(D, 2))
    pds = _u(len(pds_body) + 3, 3) + pds_body
    body = pds + gds + bms + bds
    return b"GRIB" + _u(8 + len(body) + 4, 3) + bytes([1]) + body + b"7777"


def _sec(num, body):
    return struct.pack(">IB", 5 + len(body), num) + body


def _grid_section(grid, ni, nj, scan):
    """Section 3 for ``grid`` (see :func:`grib2_message`)."""
    head = struct.pack(">BIBBH", 0, ni * nj, 0, 0, {"latlon": 0,
                                                      "stere": 20,
                                                      "lcc": 30}[grid[0]])
    earth = struct.pack(">BBIBIBI", 6, 0, 0, 0, 0, 0, 0)
    dims = struct.pack(">II", ni, nj)
    if grid[0] == "latlon":
        _, la1, lo1, la2, lo2 = grid
        di = round(abs(lo2 - lo1) / max(ni - 1, 1) * 1e6)
        dj = round(abs(la2 - la1) / max(nj - 1, 1) * 1e6)
        body = (dims + struct.pack(">II", 0, 0)
                + _sm(round(la1 * 1e6), 4) + _sm(round(lo1 * 1e6), 4)
                + bytes([0x30])
                + _sm(round(la2 * 1e6), 4) + _sm(round(lo2 * 1e6), 4)
                + _u(di, 4) + _u(dj, 4) + bytes([scan]))
    else:
        la1, lo1, lad, lov, dx, dy = grid[1:7]
        body = (dims + _sm(round(la1 * 1e6), 4) + _sm(round(lo1 * 1e6), 4)
                + bytes([0x30]) + _sm(round(lad * 1e6), 4)
                + _sm(round(lov * 1e6), 4) + _u(round(dx * 1e3), 4)
                + _u(round(dy * 1e3), 4))
        if grid[0] == "stere":
            body += bytes([0x80 if grid[7] else 0x00, scan])
        else:
            lat1, lat2 = grid[7], grid[8]
            body += (bytes([0x00, scan]) + _sm(round(lat1 * 1e6), 4)
                     + _sm(round(lat2 * 1e6), 4) + _sm(-90_000_000, 4)
                     + _sm(0, 4))
    return _sec(3, head + earth + body)


def grib2_message(field, grid, key, ref_time, lead_hours=0, level=10,
                  nbits=16, D=2, mask=None, scan_neg_j=False,
                  jpeg2000=False):
    """One GRIB2 message of ``field`` (nj, ni).

    ``grid``: ``("latlon", la1, lo1, la2, lo2)`` (degrees, first and last
    grid points), ``("stere", la1, lo1, lad, lov, dx, dy, south)`` or
    ``("lcc", la1, lo1, lad, lov, dx, dy, latin1, latin2)`` (metres);
    ``key``: (discipline, category, number); ``mask``: points present
    (bitmap in section 6); ``scan_neg_j``: rows scanned north to south.
    ``jpeg2000`` packs with template 5.40 through Pillow."""
    nj, ni = field.shape
    flat = np.asarray(field, np.float64).ravel()
    present = flat if mask is None else flat[np.asarray(mask).ravel()]
    R, E = _simple_pack(present, D, nbits)
    R = float(np.float32(R))
    X = _packed_ints(present, R, E, D, nbits)
    discipline, cat, num = key
    s1 = _sec(1, struct.pack(">HHBBBHBBBBBBB", 98, 0, 2, 1, 1,
                             ref_time.year, ref_time.month, ref_time.day,
                             ref_time.hour, ref_time.minute,
                             ref_time.second, 0, 1))
    s3 = _grid_section(grid, ni, nj, 0x00 if scan_neg_j else 0x40)
    p = struct.pack(">HHBBBBBHBBI", 0, 0, cat, num, 2, 0, 0, 0, 0, 1,
                    lead_hours)
    p += struct.pack(">BBI", 103, 0, level)
    p += struct.pack(">BBI", 255, 0, 0)
    s4 = _sec(4, p)
    template = 40 if jpeg2000 else 0
    s5 = _sec(5, struct.pack(">IH", X.size, template)
              + struct.pack(">f", R) + _sm(E, 2) + _sm(D, 2)
              + bytes([nbits, 0]))
    s6 = _sec(6, b"\xff") if mask is None else _sec(
        6, b"\x00" + np.packbits(
            np.asarray(mask).ravel().astype(np.uint8)).tobytes())
    if jpeg2000:
        import io
        from PIL import Image
        img = Image.fromarray(X.reshape(1, -1).astype(np.uint16)
                              if mask is not None
                              else X.reshape(nj, ni).astype(np.uint16))
        buf = io.BytesIO()
        img.save(buf, format="JPEG2000", irreversible=False)
        payload = buf.getvalue()
    else:
        payload = _pack_bits(X, nbits)
    s7 = _sec(7, payload)
    body = s1 + s3 + s4 + s5 + s6 + s7 + b"7777"
    s0 = b"GRIB" + b"\x00\x00" + bytes([discipline, 2]) \
        + struct.pack(">Q", 16 + len(body))
    return s0 + body


def write_ecmwf_wind(path, lon0=8.0, lon1=20.0, lat0=65.0, lat1=71.0,
                     res=0.1, nt=9, step_h=1,
                     t0=datetime(2024, 3, 1), seed=0):
    """ECMWF-HRES-like 10 m wind: u and v (0-2-2, 0-2-3) on the regular
    lat-lon grid ``lon0..lon1`` x ``lat0..lat1`` at ``res`` degrees
    (template 3.0, rows scanned north to south as ECMWF writes them),
    16-bit simple packing, ``nt`` frames ``step_h`` hours apart from
    ``t0``: a westerly of 6-10 m/s with a travelling wave and noise from
    ``seed``."""
    rng = np.random.default_rng(seed)
    ni = int(round((lon1 - lon0) / res)) + 1
    nj = int(round((lat1 - lat0) / res)) + 1
    lon = lon0 + np.arange(ni) * res
    lat = lat1 - np.arange(nj) * res
    LON, LAT = np.meshgrid(lon, lat)
    grid = ("latlon", lat1, lon0, lat0, lon1)
    out = []
    for k in range(nt):
        ph = 0.3 * k
        u = 8.0 + 2.0 * np.sin(np.radians(40 * LON) + ph) \
            + 0.3 * rng.standard_normal(LON.shape)
        v = 2.0 * np.cos(np.radians(60 * LAT) - ph) \
            + 0.3 * rng.standard_normal(LON.shape)
        for key, f in (((0, 2, 2), u), ((0, 2, 3), v)):
            out.append(grib2_message(f, grid, key, t0, scan_neg_j=True,
                                     lead_hours=k * step_h))
    with open(path, "wb") as fh:
        fh.write(b"".join(out))
    return path
