"""Runs over several processes: the ``torch.distributed`` entry path,
tile-to-tile messages and host gathers.

Port of ``opendrift_tpu/parallel/multihost.py``.  The JAX package runs
one controller per host over ``jax.distributed`` and global arrays; here
every process is a rank of ``torch.distributed`` holding the tiles of its
own devices, and the global mesh is the ranks' tiles, rank-major
(``mesh.Mesh``).  The pieces a multi-process run needs:

* :func:`initialize` — ``torch.distributed.init_process_group`` from
  arguments or the environment (``OPENDRIFT_COORDINATOR`` /
  ``OPENDRIFT_NUM_PROCESSES`` / ``OPENDRIFT_PROCESS_ID``).  The backend
  is NCCL for a run on ``cuda`` and gloo on the CPU unless the caller
  names one; it is chosen before the group starts, never by catching a
  failure.  NCCL refuses two ranks on one card, so several processes on
  one card use ``backend="gloo"``, whose messages are host tensors: the
  card's tensors are staged through host copies.
* :func:`exchange` — point-to-point messages between tiles: a copy
  between the tiles' devices inside a process, ``batch_isend_irecv``
  between processes.  Halo rows and migrating elements travel this way.
* :func:`gather` — every tile's host values on every process
  (``all_gather_object``), for snapshots and the final state: O(global)
  per process, right for small runs.  ``export:sharded`` output goes
  through :func:`local_rows` instead (O(local)) and
  ``tools/concat_shards.py``.

JAX's ``make_global``, ``put_replicated``, ``put_sharded`` and
``ensure_global`` build global arrays; torch has none, so here they
place this process's tiles: a list with one entry per local tile.

Everything is a no-op on a single process, so the engine calls these
helpers unconditionally.
"""

import logging
import os

import numpy as np
import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


def initialize(coordinator_address=None, num_processes=None,
               process_id=None, backend=None, device=None):
    """Join the process group of a multi-process run.

    Arguments default from the environment (``OPENDRIFT_COORDINATOR`` as
    ``host:port``, ``OPENDRIFT_NUM_PROCESSES``, ``OPENDRIFT_PROCESS_ID``).
    ``backend``: 'nccl' or 'gloo'; by default NCCL when ``device`` (the
    run's device, default ``cuda``) is a CUDA device and gloo otherwise.
    A single process returns without starting a group; a second call is
    a no-op.  Returns the backend in use, or None."""
    coordinator_address = coordinator_address or os.environ.get(
        "OPENDRIFT_COORDINATOR")
    if num_processes is None and "OPENDRIFT_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["OPENDRIFT_NUM_PROCESSES"])
    if process_id is None and "OPENDRIFT_PROCESS_ID" in os.environ:
        process_id = int(os.environ["OPENDRIFT_PROCESS_ID"])
    if num_processes in (None, 1) and coordinator_address is None:
        logger.debug("multihost.initialize: single process, nothing to do")
        return None
    if is_multihost():
        return dist.get_backend()
    if backend is None:
        dev = torch.device(device or "cuda")
        backend = "nccl" if dev.type == "cuda" else "gloo"
    address = coordinator_address
    if "://" not in address:
        address = f"tcp://{address}"
    dist.init_process_group(backend, init_method=address,
                            world_size=int(num_processes),
                            rank=int(process_id))
    logger.info("multihost: process %d/%d, backend %s", process_index(),
                process_count(), backend)
    return backend


def shutdown():
    """Leave the process group (no-op on a single process)."""
    if is_multihost():
        dist.destroy_process_group()


def process_count():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def process_index():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_primary():
    """True on the process that owns host-side side effects (output
    files, log summaries)."""
    return process_index() == 0


def is_multihost():
    return process_count() > 1


def global_mesh(devices=None, default_device=None):
    """The mesh of every rank's tiles (each rank passes its own local
    ``devices``, the same number on every rank)."""
    from .mesh import particle_mesh
    return particle_mesh(devices, default_device)


def make_global(source, mesh, axis=-1):
    """This process's tiles of an array split over the mesh along
    ``axis``: a list of one tensor per local tile.  ``source`` is a host
    array identical on every process (each process keeps only its
    parts) or a callable ``source(tile) -> array`` called once per local
    tile (a per-process read)."""
    out = []
    for g in mesh.tiles:
        if callable(source):
            part = np.asarray(source(g))
        else:
            arr = np.asarray(source)
            n = arr.shape[axis] // mesh.n_tiles
            part = np.take(arr, np.arange(g * n, (g + 1) * n), axis=axis)
        out.append(torch.as_tensor(np.ascontiguousarray(part),
                                   device=mesh.device_of(g)))
    return out


def put_replicated(tree, mesh):
    """A copy of ``tree`` on every local tile's device."""
    from .mesh import replicate
    return replicate(tree, mesh)


def put_sharded(tree, mesh):
    """Each leaf of a dict of host arrays split over the tiles along its
    last axis: a list of one dict per local tile."""
    parts = {k: make_global(v, mesh) for k, v in tree.items()}
    return [{k: parts[k][i] for k in tree} for i in range(mesh.n_local)]


def ensure_global(tree, mesh):
    """The identity: a process's tiles are already where they run."""
    return tree


def gather(values):
    """``values``: this process's per-tile host values, in tile order.
    Returns those of every tile of every process, in global tile order,
    on every process."""
    if not is_multihost():
        return list(values)
    everyone = [None] * process_count()
    dist.all_gather_object(everyone, list(values))
    return [v for part in everyone for v in part]


def all_counts(counts):
    """Per-tile integer counts of this process (a (n_local, k) int64
    host array) -> those of every tile of every process."""
    counts = np.asarray(counts, np.int64)
    if not is_multihost():
        return counts
    t = torch.as_tensor(counts)
    if dist.get_backend() == "nccl":
        t = t.cuda()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts).cpu().numpy()


def all_gather_last(x):
    """Every process's ``x`` (one shape on every process) joined along the
    last axis in rank order, on ``x``'s device."""
    if not is_multihost():
        return x
    t = x.contiguous()
    if dist.get_backend() == "gloo":
        t = t.cpu()
    parts = [torch.empty_like(t) for _ in range(process_count())]
    dist.all_gather(parts, t)
    return torch.cat(parts, dim=-1).to(x.device)


def sync(name="barrier"):
    """Cross-process barrier (no-op on a single process)."""
    if is_multihost():
        dist.barrier()


def _tag(mesh, key):
    src, dst = key[:2]
    k = key[2] if len(key) > 2 else 0
    return (k * mesh.n_tiles + src) * mesh.n_tiles + dst


def exchange(mesh, sends, expect):
    """Tile-to-tile messages.

    ``sends``: {(src, dst[, k]): tensor} for this process's source tiles
    (``k`` tells several messages of one pair apart); ``expect``: {(src,
    dst[, k]): (shape, dtype)} for this process's destination tiles.
    Returns {key: tensor on dst's device} for every expected message.
    Inside a process a message is a copy between the tiles' devices;
    between processes one ``batch_isend_irecv`` carries them all (host
    tensors under gloo).  Empty messages are not sent."""
    out = {}
    ops = []
    pending = []
    host_staged = is_multihost() and dist.get_backend() == "gloo"
    for key, t in sends.items():
        src, dst = key[:2]
        if mesh.is_local(dst):
            out[key] = t.to(mesh.device_of(dst))
        elif t.numel():
            buf = t.detach().contiguous()
            if host_staged:
                buf = buf.cpu()
            ops.append(dist.P2POp(dist.isend, buf, mesh.owner(dst),
                                  tag=_tag(mesh, key)))
    for key, (shape, dtype) in expect.items():
        src, dst = key[:2]
        if mesh.is_local(src):
            continue
        dev = mesh.device_of(dst)
        if int(np.prod(shape)) == 0:
            out[key] = torch.empty(shape, dtype=dtype, device=dev)
            continue
        buf = torch.empty(shape, dtype=dtype,
                          device="cpu" if host_staged else dev)
        ops.append(dist.P2POp(dist.irecv, buf, mesh.owner(src),
                              tag=_tag(mesh, key)))
        pending.append((key, buf, dev))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    for key, buf, dev in pending:
        out[key] = buf.to(dev)
    return out


def local_rows(tile_dicts, mesh):
    """Per-process LOCAL slots of a snapshot, the sharded-output
    counterpart of :func:`gather` (``mesh.gather_tiles``): O(local), this
    process's tiles only.
    ``tile_dicts``: one dict of per-slot tensors per local tile, all of
    one slot count.  Returns (host arrays joined in tile order, their
    global slot offsets)."""
    from .mesh import concat_tiles
    frame = concat_tiles(tile_dicts)
    per_tile = next(iter(tile_dicts[0].values())).shape[-1]
    first = mesh.first * per_tile
    return frame, np.arange(first, first + mesh.n_local * per_tile)
