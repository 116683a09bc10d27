"""Minimal ESRI shapefile reader and polygon rasteriser, from scratch.

The port's copy of ``opendrift_tpu/utils/shapefile.py``.  The .shp format
is a simple public binary layout (ESRI whitepaper, 1998): Polygon (type 5)
and PolygonZ (15), Point (1) and PolyLine (3, 13) records are parsed.  The
point-in-polygon test is :func:`points_in_ring`, numpy's even-odd crossing
test (the JAX package calls matplotlib's ``Path.contains_points``, which
the machines that run the port need not have).
"""

import os
import struct

import numpy as np

from .crs import from_esri_wkt


def read_shapefile(path):
    """Parse a .shp file.

    Returns a list of shapes; each is a dict ``{"type": int, "parts":
    [np.ndarray (n, 2) rings or points]}``.
    """
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack(">i", data[0:4])[0] != 9994:
        raise ValueError(f"{path}: not an ESRI shapefile")
    file_len = struct.unpack(">i", data[24:28])[0] * 2
    shapes = []
    offset = 100
    while offset < file_len:
        (_recno, content_len) = struct.unpack(">ii", data[offset:offset + 8])
        offset += 8
        shp_type = struct.unpack("<i", data[offset:offset + 4])[0]
        rec = data[offset:offset + content_len * 2]
        if shp_type in (5, 15, 3, 13):  # Polygon(Z) / PolyLine(Z)
            num_parts, num_points = struct.unpack("<ii", rec[36:44])
            parts = struct.unpack(f"<{num_parts}i",
                                  rec[44:44 + 4 * num_parts])
            pts = np.frombuffer(rec, dtype="<f8", count=2 * num_points,
                                offset=44 + 4 * num_parts).reshape(-1, 2)
            bounds = list(parts) + [num_points]
            rings = [pts[bounds[i]:bounds[i + 1]].copy()
                     for i in range(num_parts)]
            shapes.append({"type": shp_type, "parts": rings})
        elif shp_type == 1:  # Point
            x, y = struct.unpack("<dd", rec[4:20])
            shapes.append({"type": 1, "parts": [np.array([[x, y]])]})
        # type 0 (null) and others: skip
        offset += content_len * 2
    return shapes


def shapefile_polygons(path, to_lonlat=True):
    """All polygon rings from a shapefile as (n, 2) lon/lat arrays.

    When a sibling .prj declares a projected CRS and ``to_lonlat`` is
    True, the rings are inverse-projected to lon/lat (``utils/crs.py``
    ``from_esri_wkt``), as in the JAX package."""
    polys = []
    for shape in read_shapefile(path):
        if shape["type"] in (5, 15):
            polys.extend(shape["parts"])
    prj = os.path.splitext(path)[0] + ".prj"
    if to_lonlat and os.path.exists(prj):
        with open(prj) as f:
            wkt = f.read()
        crs = from_esri_wkt(wkt)
        if not crs.is_latlon:
            polys = [np.column_stack(crs.inv(np, ring[:, 0], ring[:, 1]))
                     for ring in polys]
    return polys


def points_in_ring(x, y, ring):
    """Boolean mask of the points (x, y) inside the closed ring ``ring``
    ((n, 2) vertices; the edge from the last vertex back to the first is
    implied), by the even-odd crossing rule.  The same float64 predicate
    as matplotlib's ``Path.contains_points``, so equal to it on every point
    (and on its choice for points on an edge); vectorised over the points,
    one pass a vertex."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    ring = np.asarray(ring, dtype=np.float64)
    inside = np.zeros(np.broadcast(x, y).shape, dtype=bool)
    x0, y0 = ring[-1]
    yflag0 = y0 >= y
    for x1, y1 in ring:
        yflag1 = y1 >= y
        crossing = yflag0 != yflag1
        # the edge (x0, y0) -> (x1, y1) crosses the horizontal ray from
        # the point towards +x
        right = ((y1 - y) * (x0 - x1) >= (x1 - x) * (y0 - y1)) == yflag1
        inside ^= crossing & right
        x0, y0, yflag0 = x1, y1, yflag1
    return inside


def rasterize_polygons(polys, lons, lats):
    """Even-odd rasterisation of polygon rings onto a lon/lat grid.

    Returns a boolean (len(lats), len(lons)) inside-mask: each ring's
    inside count over the points of its bounding box, summed over the
    rings, odd = inside (outer rings fill, holes unfill, whatever the
    rings' orientation)."""
    LO, LA = np.meshgrid(lons, lats)
    px, py = LO.ravel(), LA.ravel()
    inside = np.zeros(px.shape[0], dtype=int)
    for ring in polys:
        if len(ring) < 3:
            continue
        lo0, la0 = ring.min(axis=0)
        lo1, la1 = ring.max(axis=0)
        sel = (px >= lo0) & (px <= lo1) & (py >= la0) & (py <= la1)
        if not sel.any():
            continue
        inside[sel] += points_in_ring(px[sel], py[sel], ring)
    return (inside % 2 == 1).reshape(LO.shape)
