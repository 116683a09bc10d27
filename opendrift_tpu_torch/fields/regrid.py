"""Scattered-node -> regular-grid regridding (shared helper).

The port's copy of ``opendrift_tpu/fields/regrid.py``, host numpy/scipy
and unchanged: Delaunay barycentric weights from the mesh nodes to a
regular lon/lat target grid are computed once, then each frame is
regridded at load with one weighted combine, so the device samples the
packed regular-grid table for every mesh type (the reference runs
per-fetch scattered interpolation instead,
readers/basereader/unstructured.py:146-187).
"""

import numpy as np


class DelaunayRegridder:
    def __init__(self, lon_nodes, lat_nodes, resolution_deg=None,
                 max_cells=2048):
        from scipy.spatial import Delaunay
        lon_nodes = np.asarray(lon_nodes, dtype=np.float64).ravel()
        lat_nodes = np.asarray(lat_nodes, dtype=np.float64).ravel()
        self.n_nodes = len(lon_nodes)
        if resolution_deg is None:
            # match the native node spacing roughly
            area = ((lon_nodes.max() - lon_nodes.min())
                    * (lat_nodes.max() - lat_nodes.min()))
            resolution_deg = max(np.sqrt(area / max(self.n_nodes, 1)) / 1.5,
                                 1e-5)
        nx = min(int((lon_nodes.max() - lon_nodes.min())
                     / resolution_deg) + 2, max_cells)
        ny = min(int((lat_nodes.max() - lat_nodes.min())
                     / resolution_deg) + 2, max_cells)
        self.lons = np.linspace(lon_nodes.min(), lon_nodes.max(),
                                max(nx, 4))
        self.lats = np.linspace(lat_nodes.min(), lat_nodes.max(),
                                max(ny, 4))
        pts = np.column_stack([lon_nodes, lat_nodes])
        self._tri = Delaunay(pts)
        TX, TY = np.meshgrid(self.lons, self.lats)
        targets = np.column_stack([TX.ravel(), TY.ravel()])
        simplex = self._tri.find_simplex(targets)
        self.outside = simplex < 0
        sc = np.where(self.outside, 0, simplex)
        trans = self._tri.transform[sc]
        bary = np.einsum("nij,nj->ni", trans[:, :2, :],
                         targets - trans[:, 2, :])
        self.weights = np.concatenate(
            [bary, 1.0 - bary.sum(axis=1, keepdims=True)], axis=1)
        self.vertex = self._tri.simplices[sc]
        self.shape = (len(self.lats), len(self.lons))

    def __call__(self, node_values):
        """(..., n_nodes) node data -> (..., ny, nx) grid, NaN outside."""
        node_values = np.asarray(node_values, dtype=np.float64)
        flat = node_values.reshape(-1, self.n_nodes)
        out = np.empty((flat.shape[0],) + self.shape, dtype=np.float32)
        for i in range(flat.shape[0]):
            vals = (flat[i][self.vertex] * self.weights).sum(axis=1)
            vals[self.outside] = np.nan
            out[i] = vals.reshape(self.shape).astype(np.float32)
        return out.reshape(node_values.shape[:-1] + self.shape)
