"""Minimal GeoTIFF reader, enough to ingest categorical slick rasters.

The port's copy of ``opendrift_tpu/utils/geotiff.py`` (numpy and
``struct``; no plotting dependency, so it runs on the card machines too).
The reference reads satellite oil-thickness GeoTIFFs through GDAL
(reference: opendrift/models/openoil/openoil.py:1869-1888); without GDAL
this parses the TIFF container directly: classic (non-Big) TIFF, single
band, uint8/uint16/int16/float32, strip-based, compression none (1), LZW
(5) or PackBits (32773), with the GeoTIFF ModelPixelScale/ModelTiepoint
tags for the geographic affine.
"""

import struct

import numpy as np

_TYPE_SIZES = {1: 1, 2: 1, 3: 2, 4: 4, 5: 8, 6: 1, 7: 1, 8: 2, 9: 4,
               10: 8, 11: 4, 12: 8}
_TYPE_FMT = {1: "B", 3: "H", 4: "I", 6: "b", 8: "h", 9: "i", 11: "f",
             12: "d"}


def _read_ifd(buf, off, endian):
    (count,) = struct.unpack_from(endian + "H", buf, off)
    tags = {}
    p = off + 2
    for _ in range(count):
        tag, typ, n = struct.unpack_from(endian + "HHI", buf, p)
        size = _TYPE_SIZES.get(typ, 1) * n
        if size <= 4:
            data_off = p + 8
        else:
            (data_off,) = struct.unpack_from(endian + "I", buf, p + 8)
        if typ == 5:  # RATIONAL
            vals = []
            for i in range(n):
                a, b = struct.unpack_from(endian + "II", buf,
                                          data_off + 8 * i)
                vals.append(a / b if b else 0.0)
        elif typ in _TYPE_FMT:
            fmt = endian + str(n) + _TYPE_FMT[typ]
            vals = list(struct.unpack_from(fmt, buf, data_off))
        else:
            vals = [buf[data_off:data_off + size]]
        tags[tag] = vals
        p += 12
    return tags


def _unpackbits(data, expected):
    out = bytearray()
    i = 0
    while i < len(data) and len(out) < expected:
        n = data[i]
        i += 1
        if n < 128:
            out += data[i:i + n + 1]
            i += n + 1
        elif n > 128:
            out += bytes([data[i]]) * (257 - n)
            i += 1
    return bytes(out)


def _lzw_decode(data, expected):
    """TIFF-variant LZW (MSB-first codes, early change)."""
    CLEAR, EOI = 256, 257
    out = bytearray()
    table = None
    code_len = 9
    prev = None
    bitbuf = 0
    bitcnt = 0
    pos = 0
    while len(out) < expected:
        while bitcnt < code_len:
            if pos >= len(data):
                return bytes(out)
            bitbuf = (bitbuf << 8) | data[pos]
            pos += 1
            bitcnt += 8
        code = (bitbuf >> (bitcnt - code_len)) & ((1 << code_len) - 1)
        bitcnt -= code_len
        if code == CLEAR:
            table = [bytes([i]) for i in range(256)] + [b"", b""]
            code_len = 9
            prev = None
            continue
        if code == EOI:
            break
        if table is None:
            raise ValueError("LZW stream does not start with CLEAR")
        if code < len(table):
            entry = table[code]
            if prev is not None:
                table.append(prev + entry[:1])
        elif code == len(table) and prev is not None:
            entry = prev + prev[:1]
            table.append(entry)
        else:
            raise ValueError("Corrupt LZW code")
        out += entry
        prev = entry
        # early-change convention: grow one code before the table fills
        if len(table) + 1 >= (1 << code_len) and code_len < 12:
            code_len += 1
    return bytes(out)


def read_geotiff(path):
    """Read a single-band GeoTIFF.

    Returns ``(data[ny, nx], (lon0, dlon, lat0, dlat))`` where
    (lon0, lat0) is the outer corner of pixel (0, 0) (top-left) and
    dlat is negative for north-up rasters.
    """
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:2] == b"II":
        endian = "<"
    elif buf[:2] == b"MM":
        endian = ">"
    else:
        raise ValueError(f"{path} is not a TIFF file")
    magic, ifd_off = struct.unpack_from(endian + "HI", buf, 2)
    if magic != 42:
        raise ValueError(f"{path}: unsupported TIFF magic {magic}")
    tags = _read_ifd(buf, ifd_off, endian)

    nx = int(tags[256][0])
    ny = int(tags[257][0])
    bits = int(tags.get(258, [8])[0])
    compression = int(tags.get(259, [1])[0])
    sample_format = int(tags.get(339, [1])[0])
    offsets = tags[273]
    rows_per_strip = int(tags.get(278, [ny])[0])
    counts = tags[279]
    predictor = int(tags.get(317, [1])[0])

    dtype = {(8, 1): np.uint8, (16, 1): np.uint16, (16, 2): np.int16,
             (32, 3): np.float32, (32, 2): np.int32,
             (64, 3): np.float64}.get((bits, sample_format))
    if dtype is None:
        raise NotImplementedError(
            f"{path}: {bits}-bit sample format {sample_format}")
    itemsize = bits // 8

    raw = bytearray()
    for i, (off, cnt) in enumerate(zip(offsets, counts)):
        strip = buf[off:off + cnt]
        n_rows = min(rows_per_strip, ny - i * rows_per_strip)
        expected = n_rows * nx * itemsize
        if compression == 1:
            raw += strip[:expected]
        elif compression == 5:
            raw += _lzw_decode(strip, expected)
        elif compression == 32773:
            raw += _unpackbits(strip, expected)
        else:
            raise NotImplementedError(
                f"{path}: TIFF compression {compression}")
    data = np.frombuffer(bytes(raw), dtype=np.dtype(dtype).newbyteorder(
        endian)).reshape(ny, nx)
    if predictor == 2:
        data = np.cumsum(data.astype(np.int64), axis=1).astype(dtype)

    # GeoTIFF affine: ModelPixelScale (33550) + ModelTiepoint (33922),
    # or a full ModelTransformation (34264)
    if 34264 in tags:
        m = tags[34264]
        lon0, dlon = m[3], m[0]
        lat0, dlat = m[7], m[5]
    elif 33550 in tags and 33922 in tags:
        sx, sy = tags[33550][0], tags[33550][1]
        tp = tags[33922]
        # tiepoint: raster (i, j, k) -> model (x, y, z)
        i, j = tp[0], tp[1]
        x, y = tp[3], tp[4]
        dlon, dlat = sx, -sy
        lon0 = x - i * dlon
        lat0 = y - j * dlat
    else:
        lon0, dlon, lat0, dlat = 0.0, 1.0, 0.0, -1.0
    return data, (lon0, dlon, lat0, dlat)
