"""Engine-integrated forcing-grid domain decomposition.

Port of ``opendrift_tpu/parallel/tiled.py``.  With
``o.set_config("parallel:domain_decomposition", True)`` and a mesh of
more than one tile (``set_mesh``), ``run()`` splits the primary
structured reader's packed table over a ``(ty, tx)`` grid of tiles — Y
bands by default, or ``parallel:tile_grid = "RxC"`` — and every step
(release, environment fetch, RK stage sampling, geodesic update,
landmask and seafloor handling, the model's ``update()``, vertical
mixing) runs on each tile's own elements against its own extended
forcing band.  This is the slot of the reference's per-reader block
buffers (reference: opendrift/readers/basereader/structured.py:121-123)
for grids too large to replicate per device.

Design:

* The host uploads **core** bands only.  The halo cells — the
  reference's buffer rule ``max_speed*dt/dy+2`` (reference
  variables.py:616-617), doubled for RK stage excursions — come from the
  neighbour tiles once a forcing window (:meth:`DDContext.local_dev_states`):
  a Y phase, then an X phase of the Y-extended band, which carries the
  corners.  With several processes each reads only its own bands
  (``grid.packed_rows``).
* JAX runs the K-step advance inside one ``shard_map``.  PyTorch has
  none, so the tiles are interleaved step by step: ``for step: for tile:
  step(tile); migrate(all tiles)`` (:meth:`DDContext.wrap_advance`).
  Each tile runs the engine's unchanged step program.
* **Particles** live in fixed-capacity per-tile buffers.  After every
  step, the elements whose grid cell left their tile go to the adjacent
  tile, one hop per direction and axis (dimension-ordered: a Y pass,
  then an X pass delivers diagonal movers within one exchange).  A
  message is a copy between the tiles' devices, or a
  ``torch.distributed`` send between processes (``multihost.exchange``).
* **Conservation is unconditional**: a receiver claims arrivals into its
  free slots in a fixed order and acknowledges how many it took; the
  sender frees only acknowledged slots, so an element that finds no
  free slot stays put (still sampled from the halo) and retries at the
  next step.  The per-tile counts are the only host synchronisation: one
  a step and axis, after which every tile's shipments, claims and
  acknowledgements are known on the host, and each message carries just
  its elements (the JAX package ships fixed-size leaver buffers).
* The random draws are the JAX package's: each tile folds its index into
  the interval key and draws at its own capacity, so a tiled run
  reproduces the JAX package's tiled run draw for draw.
* Readers with no grid (analytic fields, constants) run unchanged in each
  tile; structured readers on a *different* grid than the primary (a
  coarse wind) stay replicated — decomposition targets the grid that
  dominates memory.
"""

import logging
import math
import os
import time

import numpy as np
import torch

from .. import rng
from ..elements import ElementState
from ..elements.elements import NOT_RELEASED, ACTIVE
from . import multihost
from .mesh import _on_device, move, replicate

logger = logging.getLogger(__name__)


def _first_true(mask, count):
    """Indices of the first ``count`` True entries of a 1D mask, in
    ascending order, with no host synchronisation (cumsum ranks and a
    scatter: ``count`` is known on the host)."""
    n = mask.shape[0]
    if count <= 0:
        return torch.empty(0, dtype=torch.int64, device=mask.device)
    rank = torch.cumsum(mask, 0) - 1
    pos = torch.where(mask & (rank < count), rank, count)
    out = torch.zeros(count + 1, dtype=torch.int64, device=mask.device)
    out.scatter_(0, pos, torch.arange(n, dtype=torch.int64,
                                      device=mask.device))
    return out[:count]


class TiledStates(list):
    """Per local tile, the window's reader states: the tiled readers' core
    bands ('packed_core') beside every other reader's replicated state."""


class DDContext:
    """Per-run state of an engine-level domain decomposition over
    ``mesh`` (``parallel.mesh.Mesh``; its tiles are numbered row-major
    over the (ty, tx) grid)."""

    def __init__(self, sim, max_speed, dt, mesh, capacity_factor=2.0,
                 max_leavers=None, tile_grid="auto"):
        from ..fields.grid import StructuredGridReader

        self.mesh = mesh
        self.n_tiles = mesh.n_tiles
        if tile_grid in (None, "auto", ""):
            self.n_ty, self.n_tx = self.n_tiles, 1
        else:
            try:
                r, c = tile_grid.lower().split("x")
                self.n_ty, self.n_tx = int(r), int(c)
            except ValueError:
                raise ValueError(
                    f"parallel:tile_grid must be 'auto' or 'RxC', got "
                    f"{tile_grid!r}")
            if self.n_ty * self.n_tx != self.n_tiles:
                raise ValueError(
                    f"parallel:tile_grid {tile_grid} needs "
                    f"{self.n_ty * self.n_tx} tiles, the mesh has "
                    f"{self.n_tiles}")
        self.sim = sim
        self.multihost = mesh.world > 1
        self.defer_pack = self.multihost or \
            os.environ.get("OPENDRIFT_DD_PER_HOST_READS") == "1"
        env = sim.env

        tops = env.priority_list.get("x_sea_water_velocity", [])
        primary = None
        self.primary_idx = None
        for i, (reader, served) in enumerate(env._plan):
            if tops and reader.name == tops[0] and \
                    isinstance(reader, StructuredGridReader):
                primary, self.primary_idx = reader, i
                break
        if primary is None:
            raise ValueError(
                "parallel:domain_decomposition needs a structured gridded "
                "reader serving x_sea_water_velocity (analytic/constant "
                "current sources have no grid to decompose — use plain "
                "particle sharding)")
        self.primary = primary

        ny = primary._iy.stop - primary._iy.start
        nx = primary._ix.stop - primary._ix.start
        self.rows = -(-ny // self.n_ty)
        self.cols = -(-nx // self.n_tx)
        dy = abs(primary.delta_y)
        dx = abs(primary.delta_x)
        # grid spacing in metres: curvilinear readers have native-index
        # axes and a precomputed minimum cell size; geographic grids
        # shrink dx with cos(lat) at the subset's highest |lat| (floored
        # near the pole); projected grids are in metres already
        latlon = getattr(primary.crs, "is_latlon", False)
        if getattr(primary, "_curvilinear", False):
            cell_m = getattr(primary, "_min_cell_m", None)
            if cell_m is None:
                raise ValueError(
                    "parallel:domain_decomposition on a curvilinear "
                    "primary reader requires its minimum cell size "
                    "(reader lacks _min_cell_m)")
            dy_m = dy * cell_m
            dx_m = dx * cell_m
        elif latlon:
            ys = np.asarray(primary.y, np.float64)[primary._iy]
            max_abs_lat = min(89.0, float(np.max(np.abs(ys))))
            coslat = max(math.cos(math.radians(max_abs_lat)), 0.02)
            dy_m = dy * 111320.0
            dx_m = dx * 111320.0 * coslat
        else:
            dy_m, dx_m = dy, dx
        # the reference's buffer rule, doubled for RK stage excursions,
        # plus one unacknowledged-migration step of slack
        self.halo = int(math.ceil(2.0 * max_speed * abs(dt) / dy_m)) + 2
        self.halo_x = 0 if self.n_tx == 1 else \
            int(math.ceil(2.0 * max_speed * abs(dt) / dx_m)) + 2
        if self.halo > self.rows:
            raise ValueError(
                f"Domain decomposition infeasible: halo ({self.halo} rows) "
                f"exceeds tile height ({self.rows} rows of {ny}); use "
                f"fewer tiles or a shorter time step")
        if self.halo_x > self.cols:
            raise ValueError(
                f"Domain decomposition infeasible: halo ({self.halo_x} "
                f"columns) exceeds tile width ({self.cols} of {nx}); use "
                f"fewer X tiles or a shorter time step")
        self.capacity_factor = float(capacity_factor)
        self.max_leavers = max_leavers
        self.cap = None
        self.last_in_transit = 0
        # diagnostics of the run (see ``stats``): CUDA events (the host
        # clock on the CPU) around each halo exchange and migration
        self._events = {"halo": [], "migrate": []}
        self.leavers = []
        self.peak_occupancy = 0
        self.id_checks = []

        # tile every plan reader on the primary's exact grid (typically
        # the one reader serving u/v/T/S together)
        self.tiled_idx = []
        for i, (reader, served) in enumerate(env._plan):
            if not isinstance(reader, StructuredGridReader):
                continue
            same = (reader is primary or (
                getattr(reader, "proj4", None)
                == getattr(primary, "proj4", None)
                and reader._iy == primary._iy
                and reader._ix == primary._ix
                and abs(reader.delta_y - primary.delta_y) < 1e-9 * dy
                and abs(reader.delta_x - primary.delta_x) < 1e-9 * dx
                and reader.y[reader._iy.start]
                == primary.y[primary._iy.start]
                and reader.x[reader._ix.start]
                == primary.x[primary._ix.start]))
            if same:
                self.tiled_idx.append(i)
                reader._dd_keep_host = True
                reader._dd_defer_pack = self.defer_pack

    # ------------------------------------------------------------ tiles --
    def tile_yx(self, g):
        """(ty, tx) of global tile ``g`` (row-major, the slot layout of
        :meth:`bin_initial_state`)."""
        return divmod(g, self.n_tx)

    def _tile_of(self, lon, lat):
        """Host-side linear tile of positions (numpy)."""
        r = self.primary
        x, y = r.lonlat2xy(lon, lat)
        # positions outside the grid map to NaN: bin them to tile 0
        yi = np.nan_to_num(
            (np.asarray(y) - r.y[r._iy.start]) / r.delta_y, nan=0.0)
        ty = np.clip((yi // self.rows).astype(int), 0, self.n_ty - 1)
        if self.n_tx == 1:
            return ty
        xi = np.nan_to_num(
            (np.asarray(x) - r.x[r._ix.start]) / r.delta_x, nan=0.0)
        tx = np.clip((xi // self.cols).astype(int), 0, self.n_tx - 1)
        return ty * self.n_tx + tx

    def bin_initial_state(self, arrays, n_real):
        """Re-layout flat host state arrays into per-tile fixed buffers:
        new arrays of ``n_tiles * cap`` slots, slot ``t*cap+s`` being slot
        ``s`` of tile ``t``.  Empty slots: ID 0, status NOT_RELEASED,
        release_tau inf (never released, skipped on output)."""
        dest = self._tile_of(arrays["lon"][:n_real], arrays["lat"][:n_real])
        counts = np.bincount(dest, minlength=self.n_tiles)
        cap = max(int(counts.max()),
                  int(math.ceil(self.capacity_factor * n_real
                                / self.n_tiles)))
        cap = -(-cap // 8) * 8
        self.cap = cap
        if self.max_leavers is None:
            self.max_leavers = cap
        order = np.argsort(dest, kind="stable")
        slot_in_tile = np.empty(n_real, dtype=np.int64)
        slot_in_tile[order] = np.arange(n_real) - np.concatenate(
            [[0], np.cumsum(counts)[:-1]])[dest[order]]
        slots = dest * cap + slot_in_tile
        total = self.n_tiles * cap
        out = {}
        for name, v in arrays.items():
            v = np.asarray(v)
            shape = v.shape[:-1] + (total,)
            if name == "ID":
                a = np.zeros(shape, v.dtype)
            elif name == "status":
                a = np.full(shape, NOT_RELEASED, v.dtype)
            elif name == "release_tau":
                a = np.full(shape, np.inf, v.dtype)
            else:
                a = np.zeros(shape, v.dtype)
            a[..., slots] = v[..., :n_real]
            out[name] = a
        logger.info("Domain decomposition: %d tiles (%dx%d) x %d rows "
                    "(halo %d), %d slots/tile for %d elements",
                    self.n_tiles, self.n_ty, self.n_tx, self.rows,
                    self.halo, cap, n_real)
        return out

    # --------------------------------------------------------- forcing --
    def retile(self, dev_states):
        """Split each tiled reader's packed table into this process's core
        bands (halos come from the neighbours in
        :meth:`local_dev_states`), replicate every other reader's state on
        the tiles' devices, and set the tiled readers' samplers to the
        extended band's geometry.  Call it right after
        ``build_device_states`` and before the next window's prefetch
        starts: a per-process read uses the window's pack plan."""
        from ..ops.interp import PackedSampler
        if isinstance(dev_states, TiledStates):
            return dev_states
        rows, cols = self.rows, self.cols
        n_ty, n_tx = self.n_ty, self.n_tx
        others = tuple(None if i in self.tiled_idx else ds
                       for i, ds in enumerate(dev_states))
        out = TiledStates(list(t) for t in replicate(others, self.mesh))
        for i in self.tiled_idx:
            ds = dev_states[i]
            if ds is None:
                continue
            reader = self.sim.env._plan[i][0]
            s = reader._dd_full_sampler
            rest = {k: v for k, v in ds.items()
                    if k not in ("packed", "packed_deferred")}
            if ds.get("packed_deferred"):
                def core_of(g, reader=reader):
                    ty, tx = self.tile_yx(g)
                    band = reader.packed_rows(ty * rows, (ty + 1) * rows)
                    b = band[:, :, tx * cols:(tx + 1) * cols]
                    if b.shape[2] < cols:   # pad past the right edge
                        b = np.concatenate(
                            [b, np.repeat(b[:, :, -1:],
                                          cols - b.shape[2], axis=2)],
                            axis=2)
                    return b
            else:
                packed = np.asarray(ds["packed"])
                C = packed.shape[-1]
                MZ = packed.shape[0] // (s.Y * s.X)
                pk = packed.reshape(MZ, s.Y, s.X, C)
                pad_y = rows * n_ty - s.Y
                if pad_y:
                    pk = np.concatenate(
                        [pk, np.repeat(pk[:, -1:], pad_y, axis=1)], axis=1)
                pad_x = cols * n_tx - s.X
                if pad_x:
                    pk = np.concatenate(
                        [pk, np.repeat(pk[:, :, -1:], pad_x, axis=2)],
                        axis=2)

                def core_of(g, pk=pk):
                    ty, tx = self.tile_yx(g)
                    return pk[:, ty * rows:(ty + 1) * rows,
                              tx * cols:(tx + 1) * cols]
            for j, g in enumerate(self.mesh.tiles):
                dev = self.mesh.device_of(g)
                d = move(rest, dev)
                d["packed_core"] = torch.as_tensor(
                    np.ascontiguousarray(core_of(g)), device=dev)
                out[j][i] = d
            reader._sampler = PackedSampler(
                s.Z, rows + 2 * self.halo, cols + 2 * self.halo_x, s.F,
                s.col_of, s.pair_mode)
        return out

    def local_dev_states(self, tiled):
        """Halo-exchange each tiled core band into its extended band and
        attach the tile's global offsets: per local tile, its reader
        states.  Two phases: Y rows between (ty, tx) and (ty±1, tx), then
        X columns of the Y-extended band between (ty, tx±1), which carry
        the corners; the domain edges replicate their own edge cells."""
        t_start = self._event()
        with torch.profiler.record_function("dd.halo_exchange"):
            out = self._extend(tiled)
        self._record("halo", t_start)
        return out

    def _extend(self, tiled):
        h, hx = self.halo, self.halo_x
        mesh = self.mesh
        out = [list(t) for t in tiled]
        for i in self.tiled_idx:
            if tiled[0][i] is None:
                continue
            cores = {g: tiled[j][i]["packed_core"]
                     for j, g in enumerate(mesh.tiles)}
            ext = self._phase(cores, h, axis=1, step=self.n_tx,
                              n=self.n_ty, pos=lambda g: self.tile_yx(g)[0],
                              tag=2 * i)
            if self.n_tx > 1 and hx > 0:
                ext = self._phase(ext, hx, axis=2, step=1, n=self.n_tx,
                                  pos=lambda g: self.tile_yx(g)[1],
                                  tag=2 * i + 1)
            for j, g in enumerate(mesh.tiles):
                ty, tx = self.tile_yx(g)
                d = {k: v for k, v in tiled[j][i].items()
                     if k != "packed_core"}
                e = ext[g]
                d["packed"] = e.reshape(-1, e.shape[-1])
                d["y_off"] = float(ty * self.rows - h)
                if self.n_tx > 1 and hx > 0:
                    d["x_off"] = float(tx * self.cols - hx)
                out[j][i] = d
        return [tuple(t) for t in out]

    def _phase(self, bands, h, axis, step, n, pos, tag):
        """One halo phase along the mesh axis whose neighbours are ``step``
        tiles apart (``n`` tiles along it, ``pos(g)`` a tile's place):
        each band gains ``h`` cells of each neighbour on ``axis``."""
        mesh = self.mesh
        sends, expect = {}, {}
        for g, b in bands.items():
            p = pos(g)
            lo = b.narrow(axis, 0, h)
            hi = b.narrow(axis, b.shape[axis] - h, h)
            if p < n - 1:
                sends[(g, g + step, tag)] = hi      # my top -> above
                expect[(g + step, g, tag)] = (tuple(lo.shape), b.dtype)
            if p > 0:
                sends[(g, g - step, tag)] = lo      # my bottom -> below
                expect[(g - step, g, tag)] = (tuple(lo.shape), b.dtype)
        got = multihost.exchange(mesh, sends, expect)
        out = {}
        for g, b in bands.items():
            p = pos(g)
            reps = [1] * b.dim()
            reps[axis] = h
            below = got[(g - step, g, tag)] if p > 0 else \
                b.narrow(axis, 0, 1).repeat(*reps)
            above = got[(g + step, g, tag)] if p < n - 1 else \
                b.narrow(axis, b.shape[axis] - 1, 1).repeat(*reps)
            out[g] = torch.cat([below, b, above], dim=axis)
        return out

    # -------------------------------------------------------- migration --
    def migrate(self, states):
        """Neighbour-only element exchange with receiver acknowledgement
        over the local tiles' states (a list of :class:`ElementState`);
        returns the new list.  Dimension-ordered: the Y pass, then the X
        pass."""
        t_start = self._event()
        datas = [dict(s.data) for s in states]
        shipped = 0
        with torch.profiler.record_function("dd.migrate"):
            if self.n_ty > 1:
                datas, k = self._migrate_axis(datas, "y")
                shipped += k
            if self.n_tx > 1:
                datas, k = self._migrate_axis(datas, "x")
                shipped += k
        self.leavers.append(shipped)
        self._record("migrate", t_start)
        return [ElementState(d) for d in datas]

    def _migrate_axis(self, datas, which):
        mesh = self.mesh
        if which == "y":
            n, size, step = self.n_ty, self.rows, self.n_tx
            pos = lambda g: self.tile_yx(g)[0]          # noqa: E731
        else:
            n, size, step = self.n_tx, self.cols, 1
            pos = lambda g: self.tile_yx(g)[1]          # noqa: E731
        cap = self.cap
        L = min(self.max_leavers, cap)
        masks, counts = [], []
        for g, d in zip(mesh.tiles, datas):
            idx = pos(g)
            xi, yi = self.primary._grid_indices(d["lon"], d["lat"])
            gi = yi if which == "y" else xi
            occ = d["ID"] > 0
            movable = occ & (d["status"] == ACTIVE) & torch.isfinite(gi)
            dest = torch.clamp(torch.floor(gi / size).nan_to_num(0.0)
                               .to(torch.int64), 0, n - 1)
            # neighbour-only: the halo rule bounds one step's travel to
            # under a tile, and clamping makes a pathological mover hop
            # one tile an exchange
            dest = torch.clamp(dest, idx - 1, idx + 1)
            dest = torch.where(movable, dest, idx)
            go_up = dest > idx
            go_dn = dest < idx
            masks.append((occ, go_up, go_dn))
            counts.append(torch.stack([go_up.sum(), go_dn.sum(),
                                       (~occ).sum()]))
        # the step's one host synchronisation: every tile's counts, joined
        # on the first tile's device and read at once
        first = counts[0].device
        local = torch.stack([c.to(first) for c in counts]).cpu().numpy()
        table = multihost.all_counts(local)
        n_up = np.minimum(table[:, 0], L)
        n_dn = np.minimum(table[:, 1], L)
        n_free = table[:, 2]
        occupancy = cap - n_free
        self.peak_occupancy = max(self.peak_occupancy, int(occupancy.max()))

        def arrivals(r):
            """(from below, from above) counts arriving at tile r."""
            a = int(n_up[r - step]) if pos(r) > 0 else 0
            b = int(n_dn[r + step]) if pos(r) < n - 1 else 0
            return a, b

        def acks(r):
            """How many of (from below, from above) tile r claims."""
            a, b = arrivals(r)
            free = int(n_free[r])
            return min(a, free), min(b, max(free - a, 0))

        keys = sorted(datas[0])
        groups = {}
        for k in keys:
            v = datas[0][k]
            # one message a dtype: floats keep theirs, the rest go as int64
            kind = v.dtype if v.is_floating_point() else torch.int64
            groups.setdefault(kind, []).append(k)

        def pack(d, idx):
            mats = {}
            for kind, ks in groups.items():
                cols = []
                for k in ks:
                    cols.append(d[k].reshape(-1, cap)[:, idx].T.to(kind))
                mats[kind] = torch.cat(cols, dim=1)
            return mats

        sends, expect = {}, {}
        shipped_idx = []
        for g, d, (occ, go_up, go_dn) in zip(mesh.tiles, datas, masks):
            up = _first_true(go_up, int(n_up[g])) if pos(g) < n - 1 \
                else _first_true(go_up, 0)
            dn = _first_true(go_dn, int(n_dn[g])) if pos(g) > 0 \
                else _first_true(go_dn, 0)
            shipped_idx.append((up, dn))
            for (dst, idx, tag) in ((g + step, up, 0), (g - step, dn, 1)):
                if idx.shape[0] == 0:
                    continue
                for j, (kind, mat) in enumerate(pack(d, idx).items()):
                    sends[(g, dst, 2 * j + tag)] = mat
            a, b = arrivals(g)
            for src, cnt, tag in ((g - step, a, 0), (g + step, b, 1)):
                if cnt == 0:
                    continue
                for j, (kind, ks) in enumerate(groups.items()):
                    width = sum(datas[0][k].reshape(-1, cap).shape[0]
                                for k in ks)
                    expect[(src, g, 2 * j + tag)] = ((cnt, width), kind)
        got = multihost.exchange(mesh, sends, expect)

        out = []
        for g, d, (occ, go_up, go_dn), (up, dn) in zip(
                mesh.tiles, datas, masks, shipped_idx):
            a, b = arrivals(g)
            take_a, take_b = acks(g)
            d = dict(d)
            # claim: arrivals from below, then from above, into the free
            # slots in ascending order, as many as there are free slots
            parts = []
            for src, take, tag in ((g - step, take_a, 0),
                                   (g + step, take_b, 1)):
                if take:
                    parts.append({kind: got[(src, g, 2 * j + tag)][:take]
                                  for j, kind in enumerate(groups)})
            if parts:
                slots = _first_true(~occ, take_a + take_b)
                mats = {kind: torch.cat([p[kind] for p in parts])
                        for kind in groups}
                for kind, ks in groups.items():
                    c0 = 0
                    for k in ks:
                        v = d[k].reshape(-1, cap)
                        w = v.shape[0]
                        new = v.clone()
                        new[:, slots] = mats[kind][:, c0:c0 + w].T.to(v.dtype)
                        d[k] = new.reshape(d[k].shape)
                        c0 += w
            # free the acknowledged shipments: the receiver claimed the
            # first ack of each direction's list
            ack_up = acks(g + step)[0] if pos(g) < n - 1 else 0
            ack_dn = acks(g - step)[1] if pos(g) > 0 else 0
            freed = torch.cat([up[:ack_up], dn[:ack_dn]])
            if freed.shape[0]:
                d["ID"] = d["ID"].index_fill(0, freed, 0)
                d["status"] = d["status"].index_fill(0, freed, NOT_RELEASED)
                d["release_tau"] = d["release_tau"].index_fill(
                    0, freed, float("inf"))
            out.append(d)
        total = int(n_up.sum() + n_dn.sum())
        return out, total

    # -------------------------------------------------------- the steps --
    def wrap_advance(self, step, K, dt, sign):
        """The interval callable ``(states, dev_states, t0_rel, key) ->
        (states, snapshots)`` over the local tiles: halo exchange once,
        then K steps, each running ``step`` on every tile and migrating
        after it.  Tile ``g`` folds its index into the interval key, as
        the JAX package's shard_map does."""
        def call(states, dev_states, t0_rel, key):
            local = self.local_dev_states(self.retile(dev_states))
            keys = [rng.fold_in(key, g) for g in self.mesh.tiles]
            t0 = np.float32(t0_rel)
            states = list(states)
            snaps = [None] * len(states)
            for i in range(K):
                t_rel = t0 + np.float32(i) * np.float32(dt) if i else t0
                for j, g in enumerate(self.mesh.tiles):
                    with _on_device(self.mesh.device_of(g)):
                        states[j], snap = step(
                            states[j], local[j], t_rel,
                            t_rel * np.float32(sign),
                            rng.fold_in(keys[j], i), i == 0)
                    if i == 0:
                        snaps[j] = snap
                states = self.migrate(states)
            return states, snaps
        return call

    def wrap_final(self, final_snapshot):
        def call(states, dev_states, t_rel):
            local = self.local_dev_states(self.retile(dev_states))
            snaps = []
            for g, st, ds in zip(self.mesh.tiles, states, local):
                with _on_device(self.mesh.device_of(g)):
                    snaps.append(final_snapshot(st, ds, t_rel))
            return snaps
        return call

    # ---------------------------------------------------- diagnostics --
    def _event(self):
        dev = self.mesh.devices[0]
        if dev.type == "cuda":
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e
        return time.perf_counter()

    def _record(self, name, start):
        if isinstance(start, float):
            self._events[name].append(
                (time.perf_counter() - start) * 1e3)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        self._events[name].append((start, end))

    def stats(self):
        """Halo milliseconds a window and migration milliseconds a step
        (CUDA events on the card, the host clock on the CPU), leavers a
        step and the peak occupancy of a tile, over the run."""
        if any(isinstance(v, tuple) for v in self._events["halo"]
               + self._events["migrate"]):
            torch.cuda.synchronize()

        def ms(v):
            return v if isinstance(v, float) else v[0].elapsed_time(v[1])
        halo = [ms(v) for v in self._events["halo"]]
        mig = [ms(v) for v in self._events["migrate"]]
        return {"halo_ms_per_window": float(np.mean(halo)) if halo else None,
                "migrate_ms_per_step": float(np.mean(mig)) if mig else None,
                "windows": len(halo), "steps": len(mig),
                "leavers_per_step": float(np.mean(self.leavers))
                if self.leavers else 0.0,
                "peak_occupancy": self.peak_occupancy, "cap": self.cap}

    # ----------------------------------------------------------- output --
    def reorder_frame(self, frame, n_real, keep_id=False):
        """Re-index a gathered snapshot (per-slot arrays; slots move with
        migration) into trajectory order by element ID.  Counts the
        ACTIVE elements whose position tile differs from their owning
        tile (stuck in transit: destination buffers full) into
        ``last_in_transit`` and warns: within the halo they are still
        sampled exactly, beyond it they degrade to the uncovered-position
        semantics."""
        frame = dict(frame)
        order = list(frame)
        ids = np.asarray(frame.pop("ID"))
        if not keep_id:
            order.remove("ID")
        valid = (ids > 0) & (ids <= n_real)
        # conservation, frame by frame: (duplicated, missing) element IDs
        held = np.unique(ids[valid]).size
        self.id_checks.append((int(valid.sum()) - held, n_real - held))
        if "lon" in frame and "status" in frame and self.cap:
            act = valid & (np.asarray(frame["status"]) == ACTIVE)
            own = np.arange(ids.shape[0]) // self.cap
            where = self._tile_of(np.asarray(frame["lon"])[act],
                                  np.asarray(frame["lat"])[act])
            n_transit = int((own[act] != where).sum())
            self.last_in_transit = n_transit
            if n_transit:
                logger.warning(
                    "%d element(s) stuck in-transit (destination tile "
                    "buffers full) — raise parallel:tile_capacity_factor",
                    n_transit)
        out = {}
        for name in order:
            if name == "ID":
                out["ID"] = np.arange(1, n_real + 1, dtype=ids.dtype)
                continue
            v = np.asarray(frame[name])
            shape = v.shape[:-1] + (n_real,)
            if np.issubdtype(v.dtype, np.floating):
                a = np.full(shape, np.nan, v.dtype)
            elif name == "status":
                a = np.full(shape, NOT_RELEASED, v.dtype)
            else:
                a = np.zeros(shape, v.dtype)
            a[..., ids[valid] - 1] = v[..., valid]
            out[name] = a
        return out
