"""Particle sharding over a mesh of tiles.

Port of ``opendrift_tpu/parallel/mesh.py``.  A Lagrangian step is
element-wise per particle, so the element axis splits over tiles with no
exchange at all: each tile runs the unchanged step program on its slice
of the state against its own copy of the forcing.  JAX expresses that
as one SPMD program over a 1D ``dp`` device mesh; here a mesh is a list
of torch devices, one tile each, and repeats are allowed (``["cpu"] * 8``
in the tests, ``["cuda:0"] * 4`` on one card, ``["cuda:0", ...,
"cuda:7"]`` on an 8-card host).  Across processes the tiles of every
rank of ``torch.distributed`` form the global mesh, rank-major
(``multihost``).

The random draws stay those of the unsharded run: each tile draws the
threefry counters of its global slots (``rng.element_partition``), as
JAX's partitionable threefry does over a sharded axis.  A few model steps
reduce over every element (OpenOil's mean droplet volume and slick
histogram, a wave field's "any wave at all" test); JAX's partitioner
makes those global.  Here each tile steps on a thread of its own, and
such a step calls :func:`gathered`, which joins the tiles' values (and,
across processes, the ranks') into the whole element axis before it
reduces, so a sharded run is bit-equal to the plain one.

Used by ``run()`` when the mesh has more than one tile and
``parallel:particle_sharding`` is on; the mesh is ``set_mesh(devices)``
or, by default, the visible CUDA cards.
"""

import contextlib
import logging
import threading

import numpy as np
import torch

from .. import rng
from ..elements import ElementState
from ..ops.interp import CompensatedTable, SplitTable

logger = logging.getLogger(__name__)


class Mesh:
    """The tiles of a run.  ``devices``: this process's tiles, one torch
    device each (repeats allowed); ``rank``/``world``: this process's
    place among the ``torch.distributed`` ranks, each holding as many
    tiles.  Global tile ``g`` lives on rank ``g // n_local``."""

    def __init__(self, devices, rank=0, world=1):
        self.devices = [torch.device(d) for d in devices]
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.n_local = len(self.devices)
        self.rank = int(rank)
        self.world = int(world)
        self.n_tiles = self.n_local * self.world
        self.first = self.rank * self.n_local
        self.tiles = list(range(self.first, self.first + self.n_local))

    def owner(self, g):
        return g // self.n_local

    def is_local(self, g):
        return self.first <= g < self.first + self.n_local

    def device_of(self, g):
        return self.devices[g - self.first]

    def __repr__(self):
        return (f"Mesh({self.n_tiles} tiles, rank {self.rank}/{self.world}:"
                f" {[str(d) for d in self.devices]})")


def particle_mesh(devices=None, default_device=None):
    """The mesh of ``devices`` (default: the visible CUDA cards when the
    run is on ``cuda``, else the run's one device), spanning every rank
    of a multi-process run."""
    from . import multihost
    if devices is None:
        dev = torch.device(default_device or "cuda")
        if dev.type == "cuda" and torch.cuda.is_available():
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
        else:
            devices = [dev]
    return Mesh(devices, multihost.process_index(),
                multihost.process_count())


def pad_to_multiple(n, k):
    return ((n + k - 1) // k) * k


def move(tree, device):
    """A device state (dicts, tuples, lists of tensors and table
    storages) on ``device``; tensors there already are not copied."""
    if torch.is_tensor(tree):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: move(v, device) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(move(v, device) for v in tree)
    if isinstance(tree, (CompensatedTable, SplitTable)):
        return tree.to(device)
    return tree


def replicate(tree, mesh):
    """One copy of ``tree`` per local tile, on the tile's device (tiles
    that share a device share the copy)."""
    copies = {}
    out = []
    for dev in mesh.devices:
        if dev not in copies:
            copies[dev] = move(tree, dev)
        out.append(copies[dev])
    return out


def shard_state(arrays, mesh):
    """Split host state arrays over the mesh along the element (last)
    axis: a list of one :class:`ElementState` per local tile.  The
    element count must be a multiple of the tile count (the engine pads
    with never-released elements)."""
    n = next(iter(arrays.values())).shape[-1]
    if n % mesh.n_tiles:
        raise ValueError(f"{n} elements do not split over "
                         f"{mesh.n_tiles} tiles")
    s = n // mesh.n_tiles
    out = []
    for g in mesh.tiles:
        dev = mesh.device_of(g)
        out.append(ElementState({
            k: torch.as_tensor(np.ascontiguousarray(
                np.asarray(v)[..., g * s:(g + 1) * s]), device=dev)
            for k, v in arrays.items()}))
    return out


def concat_tiles(tile_dicts):
    """Host arrays of per-tile dicts, joined along the element axis in
    tile order."""
    def host(v):
        return v.cpu().numpy() if torch.is_tensor(v) else np.asarray(v)
    return {k: np.concatenate([host(d[k]) for d in tile_dicts], axis=-1)
            for k in tile_dicts[0]}


def gather_tiles(tile_dicts):
    """Host arrays of every tile of every process, joined along the
    element axis in global tile order (snapshots, the final state)."""
    from . import multihost
    return concat_tiles(multihost.gather(
        [{k: v.cpu().numpy() for k, v in d.items()} for d in tile_dicts]))


_shard = threading.local()


def gathered(x):
    """The whole element axis of ``x`` (last axis), in a step of a
    particle-sharded run: every tile's part, joined in global order on
    ``x``'s device.  Outside such a step (a plain run, or a tile of a
    domain decomposition, whose reductions are the tile's own as in the
    JAX package's shard_map) it is ``x``."""
    ctx = getattr(_shard, "group", None)
    if ctx is None or not torch.is_tensor(x):
        return x
    group, j = ctx
    return group.gather(j, x)


class _ShardGroup:
    """One process's tile threads, run one at a time in turn: a thread
    holds the turn until it reaches :func:`gathered` or its end, then
    passes it on, so the tiles run in sequence as a plain loop over them
    would, and meet only where a step reduces over every element.  The
    last tile to reach a rendezvous joins every tile's part; each tile
    reads it when its turn comes back, before any tile can reach the next
    rendezvous."""

    def __init__(self, n):
        self.n = n
        self.cv = threading.Condition()
        self.turn = 0
        self.done = [False] * n
        self.slots = [None] * n
        self.arrived = 0
        self.full = None
        self.error = None

    def _wait_turn(self, j):
        """Block until it is tile j's turn (call with ``cv`` held)."""
        self.cv.wait_for(lambda: self.turn == j or self.error is not None)
        if self.error is not None:
            raise RuntimeError("a sibling tile failed") from self.error

    def _pass(self, j):
        """Hand the turn to the next tile still running (``cv`` held)."""
        for k in range(1, self.n + 1):
            nxt = (j + k) % self.n
            if not self.done[nxt]:
                self.turn = nxt
                break
        self.cv.notify_all()

    def start(self, j):
        with self.cv:
            self._wait_turn(j)

    def finish(self, j, error=None):
        with self.cv:
            self.done[j] = True
            if error is not None and self.error is None:
                self.error = error
            self._pass(j)

    def gather(self, j, x):
        from . import multihost
        with self.cv:
            self.slots[j] = x
            self.arrived += 1
            if j < self.n - 1:
                if any(self.done[j + 1:]):
                    raise RuntimeError(
                        "a tile ended before a rendezvous of its siblings")
                self._pass(j)
                self._wait_turn(j)
            else:
                if self.arrived != self.n:
                    raise RuntimeError(
                        "a tile ended before a rendezvous of its siblings")
                self.arrived = 0
                full = torch.cat([s.to(x.device) for s in self.slots], dim=-1)
                if multihost.is_multihost():
                    full = multihost.all_gather_last(full)
                self.full = full
                # every tile reads this rendezvous' result before the next
                self._pass(j)
                self._wait_turn(j)
                return full
            return self.full.to(x.device)


def _on_device(dev):
    """The tile's device as the current CUDA device (kernels launch on
    the current device's streams)."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class ShardedRun:
    """Runs the engine's per-interval callables once per tile of a
    particle-sharded state: each tile steps its own slice against its
    copy of the forcing, drawing the counters of its global slots."""

    def __init__(self, mesh, n_padded, n_real=None):
        self.mesh = mesh
        self.n_padded = int(n_padded)
        self.n_real = int(n_real if n_real is not None else n_padded)
        self.n_shard = self.n_padded // mesh.n_tiles

    def _partition(self, g):
        # the counters of the unpadded axis: row c of a (C, N) draw starts
        # at c * n_real, as in the plain run, whatever the padding (the
        # padding's draws repeat others' and are never used: it is never
        # released)
        return rng.element_partition(g * self.n_shard, self.n_shard,
                                     self.n_real)

    def _each_tile(self, fn):
        """``fn(j, g)`` for every local tile ``j`` (global ``g``), each on
        a thread of its own with the tile's draws and device; the first
        failure aborts the others' rendezvous and is raised."""
        n = self.mesh.n_local
        group = _ShardGroup(n)
        results = [None] * n
        errors = []

        def work(j, g):
            _shard.group = (group, j)
            error = None
            try:
                group.start(j)
                with self._partition(g), _on_device(self.mesh.device_of(g)):
                    results[j] = fn(j, g)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors.append(e)
                error = e
            finally:
                _shard.group = None
                group.finish(j, error)
        threads = [threading.Thread(target=work, args=(j, g),
                                    name=f"opendrift-tile-{g}")
                   for j, g in enumerate(self.mesh.tiles)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if errors:
            raise group.error or errors[0]
        return results

    def wrap_advance(self, advance):
        def call(states, dev_states, t0_rel, key):
            reps = replicate(dev_states, self.mesh)
            res = self._each_tile(
                lambda j, g: advance(states[j], reps[j], t0_rel, key))
            return [r[0] for r in res], [r[1] for r in res]
        return call

    def wrap_final(self, final_snapshot):
        def call(states, dev_states, t_rel):
            reps = replicate(dev_states, self.mesh)
            return self._each_tile(
                lambda j, g: final_snapshot(states[j], reps[j], t_rel))
        return call
