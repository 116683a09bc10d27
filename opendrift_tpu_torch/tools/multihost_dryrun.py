"""Multi-process dry run of the parallel layer.

The port's counterpart of ``tools/multihost_dryrun.py``: ``--processes``
OS processes (default 2), each holding ``--tiles`` tiles (default 4) on
one device, join one ``torch.distributed`` group over gloo and run the
engine's scaling modes end to end through ``run()``:

  particle  — ``parallel:particle_sharding`` over the global mesh;
  domain    — ``parallel:domain_decomposition`` in Y bands: each process
              reads only its own forcing rows (``grid.packed_rows``),
              halo rows and migrating elements cross the process
              boundary, snapshots are gathered to every process;
  domain2d  — the same over an R x C (Y x X) tile grid whose Y axis
              crosses the processes.

Each mode also runs with ``export:sharded``: every process writes its own
slots, and the shards merged by ``tools/concat_shards.py`` must be the
plain file byte for byte.  The parent runs the same configurations in ONE
process holding every tile (the gold) and requires each mode's
trajectories to be bit-equal to it: the same mesh gives the same run
however many processes it is cut into.  Horizontal diffusion and Visser
mixing are on, so the draws are checked too.

NCCL refuses two ranks on one card, so on a single card the processes
talk over gloo and the card's tensors travel through host copies.

Usage (the default device is ``cuda``; the tests pass ``--device cpu``):

    python -m opendrift_tpu_torch.tools.multihost_dryrun [--device cpu]
        [--processes 2] [--tiles 4] [--number 64] [--timeout 600]

Exits non-zero if a child fails, times out or disagrees.
"""

import argparse
import glob
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

STEPS = 12


def _grid(n_tiles):
    """The Y x X grid of the 'domain2d' mode: two Y rows of tiles."""
    return f"2x{n_tiles // 2}"


def _simulation(device, mode, n_tiles, tiles, number, sharded_out):
    from datetime import datetime, timedelta

    import numpy as np
    from opendrift_tpu_torch.models import OceanDrift
    from opendrift_tpu_torch.fields import ArrayReader

    t0 = datetime(2021, 3, 1)
    ny, nx = 96, 32
    lon = np.linspace(2.0, 6.0, nx)
    lat = np.linspace(59.0, 60.2, ny)
    uu = np.full((2, ny, nx), 0.25, np.float32)
    vv = np.broadcast_to(
        np.linspace(0.2, 0.6, ny, dtype=np.float32)[None, :, None],
        (2, ny, nx)).copy()
    o = OceanDrift(loglevel=50, device=device)
    o.set_mesh([device] * tiles)
    o.set_config("environment:fallback:land_binary_mask", 0)
    o.set_config("drift:advection_scheme", "runge-kutta4")
    o.set_config("drift:vertical_advection", False)
    o.set_config("drift:stokes_drift", False)
    o.set_config("drift:horizontal_diffusivity", 5.0)
    o.set_config("drift:vertical_mixing", True)
    o.set_config("vertical_mixing:diffusivitymodel", "windspeed_Large1994")
    o.set_config("environment:fallback:x_wind", 6.0)
    o.set_config("environment:fallback:y_wind", 2.0)
    o.set_config("parallel:particle_sharding", mode == "particle")
    o.set_config("parallel:domain_decomposition", mode != "particle")
    if mode == "domain2d":
        o.set_config("parallel:tile_grid", _grid(n_tiles))
        o.set_config("parallel:tile_capacity_factor", 8.0)
    if sharded_out:
        o.set_config("export:sharded", True)
    o.add_reader(ArrayReader(
        {"x_sea_water_velocity": uu, "y_sea_water_velocity": vv},
        x=lon, y=lat, times=[t0, t0 + timedelta(hours=48)]))
    # seeded astride latitude 59.6, the boundary between the two
    # processes' bands under both tilings: northbound elements migrate
    # from the first process's tiles to the second's
    o.seed_elements(4.0, 59.58, number=number, radius=4000, time=t0,
                    z=-np.linspace(0.0, 10.0, number))
    return o


def run_modes(device, tiles, number, outdir, tag):
    """Every mode, plain output and (several processes) sharded output;
    the first process saves each plain result's arrays."""
    import numpy as np
    from opendrift_tpu_torch.parallel import multihost

    n_tiles = tiles * multihost.process_count()
    for mode in ("particle", "domain", "domain2d"):
        for sharded in ((False, True) if multihost.is_multihost()
                        else (False,)):
            o = _simulation(device, mode, n_tiles, tiles, number, sharded)
            suffix = "sharded" if sharded else "plain"
            o.run(steps=STEPS, time_step=900, outfile=os.path.join(
                outdir, f"{tag}_{mode}_{suffix}.nc"))
            if mode == "particle":
                assert o._sharding is not None \
                    and o._sharding.mesh.n_tiles == n_tiles
            else:
                assert o._dd is not None and o._dd.n_tiles == n_tiles
                assert o._dd.defer_pack == multihost.is_multihost()
            if not sharded and multihost.is_primary():
                np.savez(os.path.join(outdir, f"{tag}_{mode}.npz"),
                         **{v: np.asarray(o.result[v].values)
                            for v in ("lon", "lat", "z", "status")})
            moved = sum(o._dd.leavers) if o._dd is not None else 0
            print(f"MODE {tag} {mode} {suffix} leavers {moved}", flush=True)


def child_main(args):
    import torch
    from opendrift_tpu_torch.parallel import multihost
    torch.set_num_threads(1)
    backend = multihost.initialize(
        coordinator_address=f"127.0.0.1:{args.port}",
        num_processes=args.processes, process_id=args.process_id,
        backend="gloo")
    assert backend == "gloo" and multihost.process_count() == args.processes
    run_modes(args.device, args.tiles, args.number, args.outdir, "mh")
    multihost.sync("dryrun-done")
    multihost.shutdown()
    print("CHILD OK", flush=True)


def gold_main(args):
    import torch
    torch.set_num_threads(1)
    run_modes(args.device, args.tiles * args.processes, args.number,
              args.outdir, "gold")
    print("GOLD OK", flush=True)


def _spawn(argv, log):
    """A child process of this tool, its output into the file ``log``."""
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ)
    env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
    out = open(log, "w")
    p = subprocess.Popen(
        [sys.executable, "-m", "opendrift_tpu_torch.tools.multihost_dryrun"]
        + argv, stdout=out, stderr=subprocess.STDOUT, text=True, env=env)
    p.log = log
    out.close()
    return p


def _wait(procs, timeout):
    """(all ok, outputs): the children share ``timeout`` seconds; the
    first failure, or the timeout, kills every child still running."""
    deadline = time.monotonic() + timeout
    ok = True
    while any(p.poll() is None for p in procs):
        if time.monotonic() > deadline or any(
                p.returncode not in (None, 0) for p in procs):
            ok = False
            for p in procs:
                if p.poll() is None:
                    p.kill()
            break
        time.sleep(0.05)
    outs = []
    for p in procs:
        p.wait()
        ok = ok and p.returncode == 0
        with open(p.log) as f:
            outs.append(f.read())
    return ok, outs


def parent_main(args):
    import numpy as np
    from opendrift_tpu_torch.tools.concat_shards import concat_shards

    outdir = args.outdir or tempfile.mkdtemp(prefix="od_torch_dryrun_")
    os.makedirs(outdir, exist_ok=True)
    common = ["--device", args.device, "--processes", str(args.processes),
              "--tiles", str(args.tiles), "--number", str(args.number),
              "--outdir", outdir]
    t = time.perf_counter()
    ok, outs = _wait([_spawn(["--gold"] + common,
                             os.path.join(outdir, "gold.log"))],
                     args.timeout)
    gold_s = time.perf_counter() - t
    if not ok:
        sys.stderr.write(outs[0])
        raise SystemExit("gold run failed")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    t = time.perf_counter()
    procs = [_spawn(["--process-id", str(i), "--port", str(port)] + common,
                    os.path.join(outdir, f"process{i}.log"))
             for i in range(args.processes)]
    ok, outs = _wait(procs, args.timeout)
    mh_s = time.perf_counter() - t
    if not ok:
        for i, out in enumerate(outs):
            sys.stderr.write(f"--- process {i} ---\n{out}\n")
        raise SystemExit("multi-process child failed")
    report = {"device": args.device, "backend": "gloo",
              "processes": args.processes, "tiles_per_process": args.tiles,
              "elements": args.number, "steps": STEPS, "gold_s": gold_s,
              "multiprocess_s": mh_s, "modes": {}}
    for mode in ("particle", "domain", "domain2d"):
        gold = np.load(os.path.join(outdir, f"gold_{mode}.npz"))
        mh = np.load(os.path.join(outdir, f"mh_{mode}.npz"))
        for v in gold.files:
            if not np.array_equal(gold[v], mh[v], equal_nan=True):
                raise SystemExit(f"{mode}: {v} of {args.processes} processes"
                                 f" differs from the one-process run")
        shards = sorted(glob.glob(os.path.join(
            outdir, f"mh_{mode}_sharded.nc.p*.nc")))
        if len(shards) != args.processes:
            raise SystemExit(f"{mode}: expected {args.processes} shards, "
                             f"found {shards}")
        merged = os.path.join(outdir, f"merged_{mode}.nc")
        concat_shards(shards, merged)
        with open(merged, "rb") as f:
            merged_bytes = f.read()
        for other in ("mh", "gold"):
            with open(os.path.join(outdir, f"{other}_{mode}_plain.nc"),
                      "rb") as f:
                if f.read() != merged_bytes:
                    raise SystemExit(f"{mode}: concatenated shards differ "
                                     f"from the {other} plain file")
        report["modes"][mode] = {
            "bit_equal": True, "shards_bit_equal": True,
            "active_final": int((mh["status"][:, -1] == 0).sum())}
    print(json.dumps(report), flush=True)
    print(f"MULTIHOST DRYRUN OK ({args.processes} processes x {args.tiles} "
          f"tiles == 1 process x {args.processes * args.tiles} tiles, "
          f"sharded output == plain file)", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--tiles", type=int, default=4)
    ap.add_argument("--number", type=int, default=64)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--outdir", default=None)
    ap.add_argument("--gold", action="store_true")
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args(argv)
    if args.gold:
        gold_main(args)
    elif args.process_id is not None:
        child_main(args)
    else:
        parent_main(args)


if __name__ == "__main__":
    main()
