"""Native triangular-mesh sampling: barycentric interpolation on the device.

Port of ``opendrift_tpu/fields/mesh.py`` (reference: opendrift/readers/
basereader/unstructured.py:146-187 nearest-node queries,
reader_schism_native.py:878-1076 KD-tree caches).  The mesh is rasterised
once on the host, at reader construction, into a uniform triangle-lookup
grid; after that every sample is a fixed chain of gathers on the device

  cell id -> triangle id -> (3 node ids, affine transform) -> node values

with barycentric weights from a per-triangle 2x2 inverse transform.  Where
the file gives element connectivity (FVCOM ``nv``, SCHISM
``SCHISM_hgrid_face_nodes``, Telemac IKLE) the lookup grid keeps the
mesh's coastline holes and islands: cells no element covers are land.

Host tables, built as in the JAX package but for the locator:

* the JAX package locates the lookup cell centres with matplotlib's
  ``TrapezoidMapTriFinder`` (a Python loop over every triangle where
  matplotlib is missing, as it is on the card machine).  The port
  rasterises instead, vectorised over chunks of triangles: each triangle
  tests the cell centres of its bounding box with the trapezoid map's own
  predicate (the float64 orientation of the point against each edge,
  edges ordered left to right, triangles turned anticlockwise), and
  resolves the cells the predicate shares as the trapezoid map does: a
  centre on an interior edge belongs to the triangle above the edge, one
  on a boundary edge to its only triangle, one on a node to the
  lowest-numbered triangle at that node;
* the neighbour table is built by sorting the edges, vectorised, with the
  same result as the JAX package's dictionary walk.

Device side: :meth:`MeshSampler.locate_device` (the four cells around a
point, the best-containing candidate, a two-step walk to the neighbour),
and :meth:`MeshSampler.blend_columns`, which gathers only the node values a
variable needs (two frames by two levels by three nodes) where the JAX
package blends whole node rows (``combine_rows``); the arithmetic of each
value is the same.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)

# (triangle, lookup cell) pairs the rasteriser tests in one chunk
RASTER_CHUNK_PAIRS = 1 << 21


def _triangle_transforms(px, py, triangles):
    """Per-triangle inverse affine for barycentric coordinates.

    Returns (n_tri, 6) f32: [m00, m01, m10, m11, x3, y3] with
    w1 = m00*(x-x3) + m01*(y-y3), w2 = m10*(x-x3) + m11*(y-y3),
    w3 = 1 - w1 - w2.
    """
    t = np.asarray(triangles, dtype=np.int64)
    x1, x2, x3 = px[t[:, 0]], px[t[:, 1]], px[t[:, 2]]
    y1, y2, y3 = py[t[:, 0]], py[t[:, 1]], py[t[:, 2]]
    a = x1 - x3
    b = x2 - x3
    c = y1 - y3
    d = y2 - y3
    det = a * d - b * c
    # guard degenerate (zero-area) triangles: weights collapse to node 3
    bad = np.abs(det) < 1e-30
    det = np.where(bad, 1.0, det)
    m00 = np.where(bad, 0.0, d / det)
    m01 = np.where(bad, 0.0, -b / det)
    m10 = np.where(bad, 0.0, -c / det)
    m11 = np.where(bad, 0.0, a / det)
    return np.stack([m00, m01, m10, m11, x3, y3], axis=1).astype(np.float32)


def tri_neighbors(triangles):
    """(n_tri, 3) int32: neighbour across the edge opposite vertex k (-1 on
    the boundary).  Edges are visited in the JAX package's order (vertex k
    outer, triangle inner): the first triangle of an edge pairs with each
    later one, and keeps the last."""
    t = np.asarray(triangles, dtype=np.int64)
    n_tri = len(t)
    nb = np.full((n_tri, 3), -1, dtype=np.int32)
    if n_tri == 0:
        return nb
    a = np.concatenate([t[:, (k + 1) % 3] for k in range(3)])
    b = np.concatenate([t[:, (k + 2) % 3] for k in range(3)])
    lo, hi = np.minimum(a, b), np.maximum(a, b)
    seq = np.arange(3 * n_tri)
    order = np.lexsort((seq, hi, lo))
    lo_s, hi_s = lo[order], hi[order]
    new = np.ones(len(order), dtype=bool)
    new[1:] = (lo_s[1:] != lo_s[:-1]) | (hi_s[1:] != hi_s[:-1])
    start = np.flatnonzero(new)
    size = np.diff(np.append(start, len(order)))
    group = np.cumsum(new) - 1
    first = order[start[group]]          # each edge's first visit
    later = ~new                         # every visit after the first
    e_tri, e_k = order % n_tri, order // n_tri
    f_tri = first % n_tri
    nb[e_tri[later], e_k[later]] = f_tri[later]
    last = order[(start + size - 1)[size > 1]]
    f = order[start[size > 1]]
    nb[f % n_tri, f // n_tri] = last % n_tri
    return nb


def _right_of(ax, ay, bx, by):
    """``a`` after ``b`` in the trapezoid map's order (x, then y)."""
    return (ax > bx) | ((ax == bx) & (ay > by))


def locate_grid(x, y, triangles, x0, dx, nx, y0, dy, ny):
    """Triangle id containing each centre of the ``ny`` x ``nx`` lookup
    grid ``(x0 + i*dx, y0 + j*dy)`` (row-major, -1 where none does), by
    the trapezoid map's predicate (see the module docstring), vectorised
    over chunks of triangles."""
    x = np.asarray(x, dtype=np.float64)
    y = np.asarray(y, dtype=np.float64)
    t = np.array(triangles, dtype=np.int64)
    n_tri, n_nodes = len(t), len(x)
    out = np.full(nx * ny, np.iinfo(np.int64).max, dtype=np.int64)
    if n_tri == 0:
        return np.full(nx * ny, -1, dtype=np.int64)
    # anticlockwise, as matplotlib's Triangulation corrects them
    px, py = x[t], y[t]
    cw = ((px[:, 1] - px[:, 0]) * (py[:, 2] - py[:, 0])
          - (py[:, 1] - py[:, 0]) * (px[:, 2] - px[:, 0])) < 0.0
    t[cw, 1], t[cw, 2] = t[cw, 2].copy(), t[cw, 1].copy()
    px, py = x[t], y[t]
    # edge e runs from vertex e to vertex e+1; a boundary edge has no
    # reversed twin
    start = t
    end = np.roll(t, -1, axis=1)
    keys = np.sort((start * n_nodes + end).ravel())
    twin = (end * n_nodes + start).ravel()
    pos = np.clip(np.searchsorted(keys, twin), 0, len(keys) - 1)
    boundary = (keys[pos] != twin).reshape(n_tri, 3)
    sx, sy = px, py
    ex, ey = np.roll(px, -1, axis=1), np.roll(py, -1, axis=1)
    # the triangle lies above an edge that points right (its own left side)
    above = _right_of(ex, ey, sx, sy)
    lx, ly = np.where(above, sx, ex), np.where(above, sy, ey)
    rx, ry = np.where(above, ex, sx), np.where(above, ey, sy)
    # a node belongs to the first triangle that has it
    vtri = np.full(n_nodes, n_tri, dtype=np.int64)
    for k in range(3):
        np.minimum.at(vtri, t[:, k], np.arange(n_tri))
    # lookup cells whose centres may lie in each triangle's bounding box
    ix_lo = np.clip(np.floor((px.min(1) - x0) / dx) - 1, 0, nx - 1)
    ix_hi = np.clip(np.floor((px.max(1) - x0) / dx) + 1, 0, nx - 1)
    iy_lo = np.clip(np.floor((py.min(1) - y0) / dy) - 1, 0, ny - 1)
    iy_hi = np.clip(np.floor((py.max(1) - y0) / dy) + 1, 0, ny - 1)
    width = (ix_hi - ix_lo + 1).astype(np.int64)
    count = width * (iy_hi - iy_lo + 1).astype(np.int64)
    ix_lo, iy_lo = ix_lo.astype(np.int64), iy_lo.astype(np.int64)
    ends = np.cumsum(count)
    lo_tri = 0
    while lo_tri < n_tri:
        done = ends[lo_tri - 1] if lo_tri else 0
        hi_tri = max(int(np.searchsorted(ends, done + RASTER_CHUNK_PAIRS,
                                         side="right")), lo_tri + 1)
        tri = np.repeat(np.arange(lo_tri, hi_tri), count[lo_tri:hi_tri])
        local = done + np.arange(len(tri)) - (ends[tri] - count[tri])
        ix = ix_lo[tri] + local % width[tri]
        iy = iy_lo[tri] + local // width[tri]
        qx = x0 + ix * dx
        qy = y0 + iy * dy
        inner = np.zeros((3, len(tri)), dtype=bool)
        zero = np.zeros((3, len(tri)), dtype=bool)
        for e in range(3):
            cross = ((qx - lx[tri, e]) * (ry[tri, e] - ly[tri, e])
                     - (qy - ly[tri, e]) * (rx[tri, e] - lx[tri, e]))
            # inside: above an edge the triangle lies above, else below
            inner[e] = np.where(above[tri, e], cross < 0.0, cross > 0.0)
            zero[e] = cross == 0.0
        claim = inner.all(axis=0)
        for e in range(3):
            others = inner[(e + 1) % 3] & inner[(e + 2) % 3]
            claim |= (zero[e] & others
                      & (above[tri, e] | boundary[tri, e]))
        for k in range(3):
            node = t[tri, k]
            claim |= ((qx == x[node]) & (qy == y[node])
                      & (vtri[node] == tri))
        cell = (iy * nx + ix)[claim]
        np.minimum.at(out, cell, tri[claim])
        lo_tri = hi_tri
    out[out == np.iinfo(np.int64).max] = -1
    return out


class MeshSampler:
    """Host-side rasterisation + device-side barycentric sampling.

    Coordinates are whatever plane the caller passes (typically lon/lat
    degrees): the lookup grid and transforms live in that plane.  The
    device tables are made once per device (:meth:`tables`).
    """

    def __init__(self, x_nodes, y_nodes, triangles=None,
                 lookup_factor=4.0, max_lookup=2048, dilate_cells=4):
        x = np.asarray(x_nodes, dtype=np.float64).ravel()
        y = np.asarray(y_nodes, dtype=np.float64).ravel()
        self.n_nodes = len(x)
        if triangles is None:
            from scipy.spatial import Delaunay
            tri = Delaunay(np.column_stack([x, y]))
            triangles = tri.simplices
        triangles = np.asarray(triangles, dtype=np.int32)
        if triangles.shape[1] == 4:
            # split quads (e.g. SCHISM hybrid meshes) into two triangles;
            # pure triangles carry a fill value in the 4th column
            fill = (triangles[:, 3] < 0) | \
                (triangles[:, 3] >= self.n_nodes)
            quads = triangles[~fill]
            tris = triangles[fill][:, :3]
            if len(quads):
                t2 = np.stack([quads[:, 0], quads[:, 2], quads[:, 3]],
                              axis=1)
                triangles = np.concatenate([tris, quads[:, :3], t2])
            else:
                triangles = tris
        self.triangles = triangles
        n_tri = len(triangles)

        # ---- lookup grid: ~lookup_factor cells per triangle ------------
        x0, x1 = float(x.min()), float(x.max())
        y0, y1 = float(y.min()), float(y.max())
        span_x = max(x1 - x0, 1e-9)
        span_y = max(y1 - y0, 1e-9)
        cell = np.sqrt(span_x * span_y / max(lookup_factor * n_tri, 1.0))
        nx = int(np.clip(np.ceil(span_x / cell) + 1, 4, max_lookup))
        ny = int(np.clip(np.ceil(span_y / cell) + 1, 4, max_lookup))
        self.lx0, self.ly0 = x0, y0
        self.ldx = span_x / (nx - 1)
        self.ldy = span_y / (ny - 1)
        self.nx, self.ny = nx, ny

        raw = locate_grid(x, y, triangles, x0, self.ldx, nx, y0, self.ldy,
                          ny)
        raw = raw.reshape(ny, nx).astype(np.int32)
        self._raw = raw

        # dilate a few cells outward so samples just off the mesh edge
        # (f32 rounding, particles mid-stranding) still find a triangle
        dil = raw.copy()
        if (raw < 0).any() and (raw >= 0).any():
            from scipy.ndimage import distance_transform_edt
            dist, idx = distance_transform_edt(raw < 0,
                                               return_indices=True)
            near = raw[tuple(idx)]
            dil = np.where((raw < 0) & (dist <= dilate_cells), near, raw)
        self._dil = dil.astype(np.int32)

        self._transforms = _triangle_transforms(x, y, triangles)
        self._nodes_i32 = triangles.astype(np.int32)
        self._neighbors = tri_neighbors(triangles)
        self._tables = {}
        logger.debug("MeshSampler: %d nodes, %d triangles, lookup %dx%d",
                     self.n_nodes, n_tri, ny, nx)

    # ------------------------------------------------------------ device -
    def device_arrays(self):
        """The host tables, under the JAX package's names."""
        return {
            "mesh_lookup": self._dil.ravel(),
            "mesh_lookup_raw": self._raw.ravel(),
            "mesh_transforms": self._transforms,
            "mesh_tri_nodes": self._nodes_i32,
            "mesh_neighbors": self._neighbors,
        }

    def tables(self, device):
        """The tables as tensors on ``device``, made once per device (the
        mesh never changes), with the lookup grid's origin and cell size
        as float32 tensors: a tensor divisor keeps the cell index a true
        float32 division on the card."""
        if device not in self._tables:
            def f32(v):
                return torch.tensor(np.float32(v), device=device)
            st = {k: torch.as_tensor(np.ascontiguousarray(v), device=device)
                  for k, v in self.device_arrays().items()}
            st.update(lx0=f32(self.lx0), ly0=f32(self.ly0),
                      ldx=f32(self.ldx), ldy=f32(self.ldy))
            self._tables[device] = st
        return self._tables[device]

    @staticmethod
    def _weights(st, tid, xf, yf):
        """Barycentric weights (N, 3) of (xf, yf) in triangles ``tid``."""
        tr = st["mesh_transforms"][torch.clamp_min(tid, 0).long()]
        dx = xf - tr[:, 4]
        dy = yf - tr[:, 5]
        w1 = tr[:, 0] * dx + tr[:, 1] * dy
        w2 = tr[:, 2] * dx + tr[:, 3] * dy
        return torch.stack([w1, w2, 1.0 - w1 - w2], dim=1)

    def locate_device(self, x, y):
        """(tri_id, w (N, 3), node_idx (N, 3), inside_mesh, valid) of the
        positions ``x``, ``y`` on their device.

        A lookup cell stores the triangle at its *centre*, so a point may
        straddle into a neighbouring triangle; the four surrounding cells'
        candidates are all evaluated and the one that best contains the
        point (max min-barycentric-weight) wins, exact whenever any of the
        four contains the point.  ``inside_mesh`` uses the raw (undilated)
        grid for land/coverage semantics.
        """
        st = self.tables(x.device)
        xf = x.to(torch.float32)
        yf = y.to(torch.float32)
        cx = (xf - st["lx0"]) / st["ldx"]
        cy = (yf - st["ly0"]) / st["ldy"]
        in_bbox = ((cx >= -0.5) & (cx <= self.nx - 0.5)
                   & (cy >= -0.5) & (cy <= self.ny - 0.5))

        def cell(c, n, rnd):
            # a NaN position takes cell 0 (its weights stay NaN)
            c = torch.nan_to_num(rnd(c), nan=0.0)
            return torch.clamp(c, 0, n - 1).to(torch.int64)
        x0 = cell(cx, self.nx, torch.floor)
        y0 = cell(cy, self.ny, torch.floor)
        x1 = torch.clamp_max(x0 + 1, self.nx - 1)
        y1 = torch.clamp_max(y0 + 1, self.ny - 1)

        lookup = st["mesh_lookup"]
        best_tid = torch.full_like(x0, -1, dtype=torch.int32)
        best_w = None
        best_min = torch.full_like(xf, -float("inf"))
        for yy, xx in ((y0, x0), (y0, x1), (y1, x0), (y1, x1)):
            tid = lookup[yy * self.nx + xx]
            w = self._weights(st, tid, xf, yf)
            minw = torch.where(tid >= 0, torch.amin(w, dim=1),
                               -float("inf"))
            take = minw > best_min
            best_min = torch.where(take, minw, best_min)
            best_tid = torch.where(take, tid, best_tid)
            best_w = w if best_w is None else \
                torch.where(take[:, None], w, best_w)
        best_w, tid = self._walk(st, xf, yf, best_w, best_tid)
        # clamp slightly-outside points to the triangle edge (bounded
        # extrapolation; the reference's nearest-node behaviour is the
        # cruder version of the same clamp)
        w = torch.clamp_min(best_w, 0.0)
        w = w / torch.clamp_min(torch.sum(w, dim=1, keepdim=True), 1e-12)
        nidx = st["mesh_tri_nodes"][torch.clamp_min(tid, 0).long()]
        # coverage from the raw (undilated) grid at the nearest cell
        ixn = cell(cx, self.nx, torch.round)
        iyn = cell(cy, self.ny, torch.round)
        tid_raw = st["mesh_lookup_raw"][iyn * self.nx + ixn]
        inside = in_bbox & (tid_raw >= 0)
        valid = in_bbox & (tid >= 0)
        return tid, w, nidx, inside, valid

    def _walk(self, st, xf, yf, w, tid, iters=2):
        """Fixed-count triangle walk: when the candidate does not contain
        the point (a triangle smaller than a lookup cell), step to the
        neighbour across the most-violated edge and recompute weights.
        ``iters=2`` makes sub-cell misses vanish in practice, and the
        remaining error is bounded by the edge clamp either way."""
        for _ in range(iters):
            minw = torch.amin(w, dim=1)
            need = (minw < -1e-6) & (tid >= 0)
            kmin = torch.argmin(w, dim=1)
            nb = st["mesh_neighbors"][torch.clamp_min(tid, 0).long()]
            nb_tid = torch.gather(nb, 1, kmin[:, None])[:, 0]
            step = need & (nb_tid >= 0)
            new_tid = torch.where(step, nb_tid, tid)
            neww = self._weights(st, new_tid, xf, yf)
            w = torch.where(step[:, None], neww, w)
            tid = new_tid
        return w, tid

    @staticmethod
    def blend_columns(node_rows, w, nidx, col):
        """The barycentric blend of column ``col`` (an int, or (N,) per
        element) of the node rows: 3 gathers of one value an element, the
        JAX package's ``combine_rows(...)[:, col]`` without the whole
        rows."""
        C = node_rows.shape[1]
        flat = node_rows.reshape(-1)
        nidx = nidx.long()
        return (flat[nidx[:, 0] * C + col] * w[:, 0]
                + flat[nidx[:, 1] * C + col] * w[:, 1]
                + flat[nidx[:, 2] * C + col] * w[:, 2])
