"""Telemac Selafin (.slf) file parser, from scratch.

The port's copy of ``opendrift_tpu/utils/selafin.py``, host numpy and
unchanged.  The reference reads Selafin through its own parser embedded in
``reader_telemac_selafin`` (reference: opendrift/readers/
reader_telemac_selafin.py:1-297).  The format is a sequence of Fortran
unformatted records (4-byte big-endian length framing): title, variable
names, IPARAM, optional date, mesh dimensions, connectivity, boundary
array, node x/y, then one time record plus one record per variable per
frame.
"""

import struct

import numpy as np


class SelafinFile:
    def __init__(self, path):
        self.path = path
        with open(path, "rb") as f:
            self._data = f.read()
        self._pos = 0
        self._parse_header()

    # Fortran record framing -------------------------------------------
    def _record(self):
        if self._pos + 4 > len(self._data):
            raise ValueError(f"{self.path}: truncated Selafin file "
                             f"(unexpected EOF at byte {self._pos})")
        n = struct.unpack(">i", self._data[self._pos:self._pos + 4])[0]
        if self._pos + 8 + n > len(self._data):
            raise ValueError(f"{self.path}: truncated Selafin file "
                             f"(record at byte {self._pos} overruns EOF)")
        payload = self._data[self._pos + 4:self._pos + 4 + n]
        tail = struct.unpack(
            ">i", self._data[self._pos + 4 + n:self._pos + 8 + n])[0]
        if tail != n:
            raise ValueError(f"{self.path}: corrupt Fortran record framing")
        self._pos += 8 + n
        return payload

    def _parse_header(self):
        self.title = self._record().decode("latin-1").strip()
        nbv1, nbv2 = struct.unpack(">ii", self._record())
        self.variable_names = []
        self.variable_units = []
        for _ in range(nbv1 + nbv2):
            rec = self._record().decode("latin-1")
            self.variable_names.append(rec[:16].strip())
            self.variable_units.append(rec[16:32].strip())
        iparam = struct.unpack(">10i", self._record())
        self.iparam = iparam
        self.date = None
        if iparam[9] == 1:
            self.date = struct.unpack(">6i", self._record())
        nelem, npoin, ndp, _ = struct.unpack(">4i", self._record())
        self.n_elements = nelem
        self.n_nodes = npoin
        self.nodes_per_element = ndp
        ikle = np.frombuffer(self._record(), dtype=">i4")
        self.connectivity = ikle.reshape(nelem, ndp) - 1  # 0-based
        self._record()  # IPOBO boundary array
        self.x = np.frombuffer(self._record(), dtype=">f4").astype(
            np.float64)
        self.y = np.frombuffer(self._record(), dtype=">f4").astype(
            np.float64)
        # index the time frames: each frame = 1 time record + NBV records
        self._frames = []
        self.times_seconds = []
        nvars = len(self.variable_names)
        while self._pos < len(self._data):
            t = struct.unpack(">f", self._record())[0]
            self.times_seconds.append(float(t))
            offsets = []
            for _ in range(nvars):
                offsets.append(self._pos)
                self._record()
            self._frames.append(offsets)

    def read_variable(self, var_index, frame_index):
        """Node values (n_nodes,) float32 for one variable and frame."""
        pos = self._frames[frame_index][var_index]
        n = struct.unpack(">i", self._data[pos:pos + 4])[0]
        vals = np.frombuffer(self._data[pos + 4:pos + 4 + n], dtype=">f4")
        return vals.astype(np.float32)

    def __repr__(self):
        return (f"SelafinFile({self.path!r}, '{self.title}', "
                f"{self.n_nodes} nodes, {self.n_elements} elements, "
                f"{len(self.times_seconds)} frames, "
                f"vars={self.variable_names})")
