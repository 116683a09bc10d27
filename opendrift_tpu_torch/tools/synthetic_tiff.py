"""Synthetic satellite oil-slick products: a categorical GeoTIFF and a
KSAT-style GML, written with numpy and ``struct`` alone.

Spill responders seed OpenOil from two kinds of satellite product: a
slick-thickness map (C. Hu's categories 1-4 of the Deepwater Horizon
rasters, read by ``OpenOil.seed_from_geotiff_thickness``) and a radar
oil-detection GML of slick polygons (KSAT's, read by
``OpenOil.seed_from_gml``).  The real products are not in this repository,
so these writers make files of the same form:

* :func:`write_geotiff`: a classic little- or big-endian TIFF, one band,
  strips, uncompressed, LZW (the TIFF variant: MSB-first codes, early
  change, CLEAR at each strip's start) or PackBits, with the GeoTIFF
  ModelPixelScale, ModelTiepoint and GeoKeyDirectory tags of a geographic
  WGS84 raster;
* :func:`slick_categories`: a categorical slick (uint8, 0 = no oil, 1-4
  thicker towards the core) with a ragged, speckled edge, from a seed;
* :func:`write_gml`: ``od:oilDetection`` members with ``gml:Polygon``
  exteriors and a ``od:detectionTime``; :func:`slick_polygons` draws
  irregular slick rings around a centre.

Neither Pillow nor matplotlib is needed.
"""

import struct

import numpy as np

# TIFF field types
_SHORT, _LONG, _DOUBLE = 3, 4, 12
_COMPRESSION = {"none": 1, "lzw": 5, "packbits": 32773}
_SAMPLE = {np.dtype(np.uint8): (8, 1), np.dtype(np.uint16): (16, 1),
           np.dtype(np.int16): (16, 2), np.dtype(np.float32): (32, 3)}
M_PER_DEG_LAT = 110540.0
M_PER_DEG_LON_EQ = 111320.0


def lzw_encode(data):
    """TIFF LZW of ``data`` (bytes): CLEAR first, EOI last, codes MSB
    first, the code width grown one code early, the table cleared before
    it passes 4093 entries."""
    CLEAR, EOI = 256, 257
    table = {bytes([i]): i for i in range(256)}
    out = bytearray()
    bitbuf = 0
    bitcnt = 0
    width = 9
    dec_len = 258          # the decoder's table length, one entry behind
    first = True

    def emit(code):
        nonlocal bitbuf, bitcnt, width, dec_len, first
        bitbuf = (bitbuf << width) | code
        bitcnt += width
        while bitcnt >= 8:
            bitcnt -= 8
            out.append((bitbuf >> bitcnt) & 0xFF)
        bitbuf &= (1 << bitcnt) - 1
        if code == CLEAR:
            width, dec_len, first = 9, 258, True
            return
        if not first:
            dec_len += 1
        first = False
        if dec_len + 1 >= (1 << width) and width < 12:
            width += 1

    emit(CLEAR)
    next_code = 258
    w = b""
    for c in data:
        wc = w + bytes((c,))
        if wc in table:
            w = wc
            continue
        emit(table[w])
        table[wc] = next_code
        next_code += 1
        w = bytes((c,))
        if next_code >= 4093:
            emit(CLEAR)
            table = {bytes([i]): i for i in range(256)}
            next_code = 258
    if w:
        emit(table[w])
    emit(EOI)
    if bitcnt:
        out.append((bitbuf << (8 - bitcnt)) & 0xFF)
    return bytes(out)


def packbits_encode(data):
    """PackBits of ``data`` (bytes): runs of 3 to 128 equal bytes as one
    repeat, everything else as literals of up to 128 bytes."""
    out = bytearray()
    n = len(data)
    i = 0
    literal = bytearray()

    def flush():
        while literal:
            chunk = literal[:128]
            out.append(len(chunk) - 1)
            out.extend(chunk)
            del literal[:128]
    while i < n:
        j = i + 1
        while j < n and j - i < 128 and data[j] == data[i]:
            j += 1
        run = j - i
        if run >= 3:
            flush()
            out.append(257 - run)
            out.append(data[i])
        else:
            literal.extend(data[i:j])
        i = j
    flush()
    return bytes(out)


def _compress(raw, compression):
    if compression == "none":
        return raw
    if compression == "lzw":
        return lzw_encode(raw)
    if compression == "packbits":
        return packbits_encode(raw)
    raise ValueError(f"unknown compression {compression}")


def write_geotiff(path, data, lon0, lat0, dlon, dlat, compression="lzw",
                  rows_per_strip=16, byteorder="<"):
    """Write ``data`` (ny, nx; uint8, uint16, int16 or float32) as a
    single-band GeoTIFF whose pixel (0, 0) has its outer (top-left) corner
    at (``lon0``, ``lat0``) and whose pixels are ``dlon`` x ``dlat``
    degrees (``dlat`` > 0; rows run southward).  Returns the bytes
    written."""
    data = np.ascontiguousarray(data)
    if data.dtype not in _SAMPLE:
        raise ValueError(f"unsupported sample type {data.dtype}")
    bits, sample_format = _SAMPLE[data.dtype]
    ny, nx = data.shape
    e = byteorder
    rows_per_strip = max(1, min(int(rows_per_strip), ny))
    swapped = data.astype(data.dtype.newbyteorder(e))
    strips = [_compress(swapped[r:r + rows_per_strip].tobytes(), compression)
              for r in range(0, ny, rows_per_strip)]
    geokeys = [1, 1, 0, 3,
               1024, 0, 1, 2,        # GTModelTypeGeoKey: geographic
               1025, 0, 1, 1,        # GTRasterTypeGeoKey: pixel is area
               2048, 0, 1, 4326]     # GeographicTypeGeoKey: WGS 84
    # (tag, type, values), in ascending tag order as TIFF requires
    entries = [(256, _LONG, [nx]), (257, _LONG, [ny]),
               (258, _SHORT, [bits]),
               (259, _SHORT, [_COMPRESSION[compression]]),
               (262, _SHORT, [1]),                        # BlackIsZero
               (273, _LONG, [0] * len(strips)),           # filled below
               (277, _SHORT, [1]),
               (278, _LONG, [rows_per_strip]),
               (279, _LONG, [len(s) for s in strips]),
               (284, _SHORT, [1]),
               (339, _SHORT, [sample_format]),
               (33550, _DOUBLE, [dlon, dlat, 0.0]),
               (33922, _DOUBLE, [0.0, 0.0, 0.0, lon0, lat0, 0.0]),
               (34735, _SHORT, geokeys)]
    fmt = {_SHORT: "H", _LONG: "I", _DOUBLE: "d"}
    size = {_SHORT: 2, _LONG: 4, _DOUBLE: 8}
    ifd_off = 8
    ifd_len = 2 + 12 * len(entries) + 4
    extra_off = ifd_off + ifd_len
    # values longer than 4 bytes go after the IFD, then the strips
    extra_len = sum(size[t] * len(v) for _, t, v in entries
                    if size[t] * len(v) > 4)
    strip_off = extra_off + extra_len
    offsets = []
    pos = strip_off
    for s in strips:
        offsets.append(pos)
        pos += len(s)
    entries[5] = (273, _LONG, offsets)
    ifd = struct.pack(e + "H", len(entries))
    extra = b""
    for tag, typ, vals in entries:
        payload = struct.pack(e + str(len(vals)) + fmt[typ], *vals)
        if len(payload) <= 4:
            field = payload.ljust(4, b"\0")
        else:
            field = struct.pack(e + "I", extra_off + len(extra))
            extra += payload
        ifd += struct.pack(e + "HHI", tag, typ, len(vals)) + field
    ifd += struct.pack(e + "I", 0)
    header = (b"II" if e == "<" else b"MM") + struct.pack(e + "HI", 42,
                                                          ifd_off)
    blob = header + ifd + extra + b"".join(strips)
    with open(path, "wb") as f:
        f.write(blob)
    return len(blob)


def pixel_degrees(pixel_m, lat):
    """(dlon, dlat) of a ``pixel_m`` metre pixel at latitude ``lat``, by
    the metres per degree that the oil seeders use."""
    return (pixel_m / (M_PER_DEG_LON_EQ * np.cos(np.radians(lat))),
            pixel_m / M_PER_DEG_LAT)


def slick_categories(shape=(1000, 1000), semi_axes_px=(220.0, 110.0),
                     seed=0):
    """A categorical slick raster (uint8, 0 = no oil, 1-4 thicker towards
    the core): an ellipse of ``semi_axes_px`` (north-south, east-west
    half-widths in pixels) centred in the raster, its edge and its
    thickness bands made ragged by smooth noise, and a speckle of lone
    pixels of a neighbouring category along the edges, as classified
    satellite slicks have."""
    r = np.random.default_rng(seed)
    ny, nx = shape
    yy, xx = np.mgrid[0:ny, 0:nx].astype(np.float64)
    ry = (yy - (ny - 1) / 2) / semi_axes_px[0]
    rx = (xx - (nx - 1) / 2) / semi_axes_px[1]
    rho = np.hypot(rx, ry)
    theta = np.arctan2(ry, rx)
    wobble = np.zeros_like(rho)
    for k in range(2, 7):     # |wobble| < 0.2: the slick stays within
        wobble += r.uniform(0.01, 0.04) * np.sin(   # 1.32 semi-axes
            k * theta + r.uniform(0, 2 * np.pi))
    # smooth streaks along the slick, as wind rows break it up
    streak = 0.05 * np.sin(yy / 9.0 + 2.0 * np.sin(xx / 37.0))
    d = rho * (1.0 + wobble) + streak
    cat = np.zeros(shape, np.uint8)
    for c, edge in zip((1, 2, 3, 4), (1.0, 0.75, 0.5, 0.25)):
        cat[d < edge] = c
    speckle = (r.random(shape) < 0.05) & (d < 1.05) & (d > 0.2)
    step = r.choice(np.array([-1, 1], np.int16), size=shape)
    cat[speckle] = np.clip(cat[speckle].astype(np.int16) + step[speckle],
                           0, 4).astype(np.uint8)
    return cat


def slick_polygons(lon_c, lat_c, radius_m, count=3, vertices=48, seed=0):
    """``count`` irregular slick rings (lon, lat arrays, open: the last
    vertex is not repeated) around (``lon_c``, ``lat_c``) within about
    ``radius_m``: elongated north-south and apart from each other."""
    r = np.random.default_rng(seed)
    mx = M_PER_DEG_LON_EQ * np.cos(np.radians(lat_c))
    rings = []
    for i in range(count):
        cy = lat_c + (i - (count - 1) / 2) * 0.8 * radius_m / M_PER_DEG_LAT
        cx = lon_c + r.uniform(-0.15, 0.15) * radius_m / mx
        a = radius_m * r.uniform(0.18, 0.3)      # east-west half-width
        b = radius_m * r.uniform(0.25, 0.4)      # north-south
        t = np.linspace(0.0, 2 * np.pi, vertices, endpoint=False)
        k = 1.0 + sum(r.uniform(0.02, 0.08) * np.sin(m * t
                                                       + r.uniform(0, 6.3))
                      for m in (2, 3, 5))
        rings.append((cx + a * k * np.cos(t) / mx,
                      cy + b * k * np.sin(t) / M_PER_DEG_LAT))
    return rings


def write_gml(path, rings, detection_time):
    """A KSAT-style oil-detection GML: one ``od:oilDetectionMember`` whose
    ``od:oilDetection`` holds the ``od:detectionTime`` (a datetime) and
    one ``od:oilSpill`` per ring (``(lons, lats)``), each a
    ``gml:Polygon`` with a closed ``gml:posList`` of lon lat pairs."""
    stamp = detection_time.strftime("%Y-%m-%dT%H:%M:%S.%f") + "Z"
    spills = []
    for lons, lats in rings:
        lons = np.append(lons, lons[0])
        lats = np.append(lats, lats[0])
        pos = " ".join(f"{x:.9f} {y:.9f}" for x, y in zip(lons, lats))
        spills.append(
            "      <od:oilSpill>\n"
            "        <gml:Polygon srsName=\"EPSG:4326\">\n"
            "          <gml:exterior><gml:LinearRing>\n"
            f"            <gml:posList>{pos}</gml:posList>\n"
            "          </gml:LinearRing></gml:exterior>\n"
            "        </gml:Polygon>\n"
            "      </od:oilSpill>\n")
    text = (
        "<?xml version=\"1.0\" encoding=\"UTF-8\"?>\n"
        "<od:oilDetectionCollection\n"
        "    xmlns:od=\"http://cweb.ksat.no/cweb/schema/geoweb/oil\"\n"
        "    xmlns:gml=\"http://www.opengis.net/gml\">\n"
        "  <od:oilDetectionMember>\n"
        "    <od:oilDetection>\n"
        f"      <od:detectionTime>{stamp}</od:detectionTime>\n"
        + "".join(spills)
        + "    </od:oilDetection>\n"
        "  </od:oilDetectionMember>\n"
        "</od:oilDetectionCollection>\n")
    with open(path, "w") as f:
        f.write(text)
    return path
