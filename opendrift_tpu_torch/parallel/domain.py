"""Forcing-grid domain decomposition: the standalone planar stepper.

Port of ``opendrift_tpu/parallel/domain.py``, the small version of the
engine's mechanics (``parallel/tiled.py``):

* the field grid is split along Y into one tile per mesh entry; the host
  uploads **core** tiles only, and the halo rows — sized by the
  reference's buffer rule ``max_speed*dt/dy + 2`` (reference
  variables.py:616-617) — come from the neighbour tiles' cores by a copy
  between the tiles' devices (:func:`halo_exchange`);
* particles live in fixed-capacity per-tile buffers; after each step the
  elements that left their tile are packed into a bounded leaver buffer,
  every tile sees every buffer (an all-gather) and claims its arrivals
  into free slots — shapes stay fixed, nothing is compacted.

JAX runs the whole advance in one ``shard_map``; PyTorch has none, so the
tiles are interleaved step by step: ``for step: for tile: step(tile);
migrate(all tiles)``.  A mesh is a list of torch devices, repeats allowed
(``["cpu"] * 8`` in the tests).  One process only: the engine's
decomposition (``tiled.py``) also spans processes.
"""

import logging

import numpy as np
import torch

logger = logging.getLogger(__name__)


def _devices(mesh):
    return [torch.device(d) for d in getattr(mesh, "devices", mesh)]


class TiledGrid:
    """Host-side tiling of a (V, F, Y, X) block group along Y, row-packed
    like the structured readers' ``PackedSampler``: per cell one row
    holding all variables x frames plus the x+1 neighbour's copy, so a
    sample needs two row gathers whatever V and F."""

    def __init__(self, blocks, times, y0, dy, x0, dx, n_tiles, halo):
        """``blocks``: numpy (V, F, Y, X).  Core rows per tile are equal
        (the grid is padded with edge rows if needed)."""
        blocks = np.asarray(blocks, dtype=np.float32)
        V, F, Y, X = blocks.shape
        rows = -(-Y // n_tiles)
        pad = rows * n_tiles - Y
        if pad:
            blocks = np.concatenate(
                [blocks, np.repeat(blocks[:, :, -1:], pad, axis=2)], axis=2)
        self.n_tiles = n_tiles
        self.halo = int(halo)
        self.rows = rows
        self.V, self.F, self.X = V, F, X
        self.y0, self.dy, self.x0, self.dx = y0, dy, x0, dx
        self.ny_global = Y
        packed = blocks.transpose(2, 3, 0, 1).reshape(
            rows * n_tiles, X, V * F)
        xnbr = np.concatenate([packed[:, 1:], packed[:, -1:]], axis=1)
        packed = np.concatenate([packed, xnbr], axis=2)
        # (tiles, rows, X, C): tile d owns rows [d*rows, (d+1)*rows)
        self.core = np.stack(
            [packed[d * rows:(d + 1) * rows] for d in range(n_tiles)])
        self.times = np.asarray(times, dtype=np.float32)

    def device_arrays(self, mesh):
        """(core tile of each mesh entry on its device, frame times)."""
        devs = _devices(mesh)
        if len(devs) != self.n_tiles:
            raise ValueError(f"{self.n_tiles} tiles need {self.n_tiles} "
                             f"devices, the mesh has {len(devs)}")
        cores = [torch.as_tensor(self.core[d], device=dev)
                 for d, dev in enumerate(devs)]
        return cores, torch.as_tensor(self.times)


def halo_exchange(cores, halo):
    """Pad each (rows, X, C) core tile with ``halo`` rows of its ring
    neighbours, copied between the tiles' devices; the domain ends
    replicate their own edge rows.  Returns the extended tiles."""
    n = len(cores)
    out = []
    for d, core in enumerate(cores):
        if d == 0:
            below = core[:1].expand(halo, -1, -1)
        else:
            below = cores[d - 1][-halo:].to(core.device)
        if d == n - 1:
            above = core[-1:].expand(halo, -1, -1)
        else:
            above = cores[d + 1][:halo].to(core.device)
        out.append(torch.cat([below, core, above], dim=0))
    return out


def _sample_tile(tile, times, xi, yi_local, t, halo, V, F):
    """Bilinear sample of an extended packed tile (rows+2h, X, 2*V*F) at
    fractional indices; ``yi_local`` is relative to the tile's core row 0.
    Two row gathers for all variables and frames.  Returns (V, N)."""
    H, X, C = tile.shape
    q = C // 2
    yi = yi_local + halo
    x0 = torch.clamp(torch.floor(xi).to(torch.int64), 0, X - 2)
    y0 = torch.clamp(torch.floor(yi).to(torch.int64), 0, H - 2)
    fx = torch.clamp(xi - x0, 0.0, 1.0)[:, None]
    fy = torch.clamp(yi - y0, 0.0, 1.0)[:, None]
    flat = tile.reshape(H * X, C)
    g0 = flat[torch.clamp(y0 * X + x0, 0, H * X - 1)]
    g1 = flat[torch.clamp((y0 + 1) * X + x0, 0, H * X - 1)]
    row0 = g0[:, :q] * (1.0 - fx) + g0[:, q:] * fx
    row1 = g1[:, :q] * (1.0 - fx) + g1[:, q:] * fx
    rows = row0 * (1.0 - fy) + row1 * fy          # (N, V*F)
    if F == 1:
        return rows.T
    times = np.asarray(times, np.float32)
    t = np.float32(t)
    ti = int(np.clip(np.searchsorted(times, t, side="right") - 1, 0,
                     max(F - 2, 0)))
    t1 = min(ti + 1, F - 1)
    tw = np.float32(np.clip((t - times[ti]) / max(times[t1] - times[ti],
                                                  np.float32(1e-9)),
                            0.0, 1.0))
    vf = rows.reshape(-1, V, F)
    return (vf[..., ti] * (1.0 - tw) + vf[..., t1] * tw).T


def make_tiled_stepper(grid, mesh, dt, n_substeps, max_leavers,
                       migrate_every=1):
    """The multi-step advance over the decomposed domain.

    Particle buffers: dict of (n_tiles, cap) tensors with an ``alive``
    mask; u/v are blocks 0/1 of the tiled field.  Returns
    ``advance(core_tiles, times, particles, t0) -> particles``.

    ``migrate_every``: exchange every K substeps instead of every substep,
    valid while ``K * max_speed * dt <= (halo - 1) * dy``."""
    halo = grid.halo
    rows = grid.rows
    dy, dx = grid.dy, grid.dx
    y0g, x0g = grid.y0, grid.x0
    devs = _devices(mesh)
    n = len(devs)
    L = int(max_leavers)

    def local_step(d, tile_ext, times, p, t):
        """One Euler substep on tile ``d`` (x/y in metres)."""
        xi = (p["x"] - x0g) / dx
        yi_local = (p["y"] - y0g) / dy - d * rows
        uv = _sample_tile(tile_ext, times, xi, yi_local, t, halo,
                          grid.V, grid.F)
        alive = p["alive"]
        p = dict(p)
        p["x"] = torch.where(alive, p["x"] + uv[0] * dt, p["x"])
        p["y"] = torch.where(alive, p["y"] + uv[1] * dt, p["y"])
        return p

    def migrate(tiles):
        """Pack up to L leavers a tile by rank (the overflow stays put one
        exchange), show every tile every leaver buffer, claim into free
        slots.  As in the JAX package there is no acknowledgement here:
        an arrival that finds no free slot is dropped (the engine's
        decomposition acknowledges, ``tiled.py``)."""
        keys = [k for k in tiles[0] if k != "alive"]
        fkeys = sorted(k for k in keys if tiles[0][k].is_floating_point())
        ikeys = sorted(k for k in keys if not tiles[0][k].is_floating_point())
        packs, mats = [], []
        for d, p in enumerate(tiles):
            yi = (p["y"] - y0g) / dy
            dest = torch.clamp(torch.div(yi, rows, rounding_mode="floor")
                               .to(torch.int64), 0, n - 1)
            alive = p["alive"]
            leaving = alive & (dest != d)
            cap = alive.shape[0]
            rank = torch.cumsum(leaving.to(torch.int64), 0) - 1
            shipped = leaving & (rank < L)
            slot = torch.where(shipped, rank, L)
            fmat = torch.stack([p[k] for k in fkeys], dim=1)
            imat = torch.stack([p[k].to(torch.int64) for k in ikeys], dim=1)
            pf = torch.zeros((L + 1, len(fkeys)), dtype=fmat.dtype,
                             device=fmat.device)
            pi = torch.zeros((L + 1, len(ikeys)), dtype=torch.int64,
                             device=fmat.device)
            pd = torch.full((L + 1,), -1, dtype=torch.int64,
                            device=fmat.device)
            pf[slot[shipped]] = fmat[shipped]
            pi[slot[shipped]] = imat[shipped]
            pd[slot[shipped]] = dest[shipped]
            packs.append((pf[:L], pi[:L], pd[:L]))
            mats.append((fmat, imat, alive & ~shipped, cap))
        out = []
        for d, p in enumerate(tiles):
            fmat, imat, alive, cap = mats[d]
            dev = fmat.device
            all_f = torch.cat([pk[0].to(dev) for pk in packs])
            all_i = torch.cat([pk[1].to(dev) for pk in packs])
            mine = torch.cat([pk[2].to(dev) for pk in packs]) == d
            incoming_rank = torch.cumsum(mine.to(torch.int64), 0) - 1
            free = ~alive
            free_slots = torch.nonzero(free).squeeze(1)
            ok = mine & (incoming_rank < free_slots.shape[0])
            slot = free_slots[incoming_rank[ok]]
            fmat = fmat.clone()
            imat = imat.clone()
            fmat[slot] = all_f[ok]
            imat[slot] = all_i[ok]
            alive = alive.clone()
            alive[slot] = True
            q = {"alive": alive}
            for j, k in enumerate(fkeys):
                q[k] = fmat[:, j]
            for j, k in enumerate(ikeys):
                q[k] = imat[:, j].to(p[k].dtype)
            out.append(q)
        return out

    def advance(core_tiles, times, particles, t0):
        exts = halo_exchange(core_tiles, halo)
        tiles = [{k: v[d].to(devs[d]) for k, v in particles.items()}
                 for d in range(n)]
        t0 = np.float32(t0)
        for i in range(n_substeps):
            t = t0 + np.float32(i) * np.float32(dt)
            tiles = [local_step(d, exts[d], times, p, t)
                     for d, p in enumerate(tiles)]
            if (i + 1) % migrate_every == 0:
                tiles = migrate(tiles)
        if n_substeps % migrate_every != 0:
            tiles = migrate(tiles)      # leave the buffers correctly owned
        return {k: torch.stack([p[k].to(devs[0]) for p in tiles])
                for k in tiles[0]}

    return advance


def assign_particles_to_tiles(x, y, grid, cap=None):
    """Host-side initial binning of particles into per-tile buffers."""
    n = grid.n_tiles
    yi = (np.asarray(y) - grid.y0) / grid.dy
    dest = np.clip((yi // grid.rows).astype(int), 0, n - 1)
    if cap is None:
        cap = max(8, int(2 * len(x) / n + 8))
    out = {"x": np.zeros((n, cap), np.float32),
           "y": np.zeros((n, cap), np.float32),
           "pid": np.full((n, cap), -1, np.int32),
           "alive": np.zeros((n, cap), bool)}
    fill = np.zeros(n, int)
    for i in range(len(x)):
        d = dest[i]
        s = fill[d]
        if s >= cap:
            raise ValueError("tile buffer capacity exceeded at seeding")
        out["x"][d, s] = x[i]
        out["y"][d, s] = y[i]
        out["pid"][d, s] = i
        out["alive"][d, s] = True
        fill[d] += 1
    return out


def gather_particles(p):
    """Host-side: collect (pid -> x, y) from the tile buffers."""
    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    pid = host(p["pid"]).ravel()
    alive = host(p["alive"]).ravel()
    x = host(p["x"]).ravel()
    y = host(p["y"]).ravel()
    order = pid[alive]
    out_x = np.full(order.max() + 1 if len(order) else 0, np.nan)
    out_y = np.full_like(out_x, np.nan)
    out_x[order] = x[alive]
    out_y[order] = y[alive]
    return out_x, out_y
