"""Merge per-process trajectory shards (export:sharded) into the
standard single-file layout.

The port's own copy of ``tools/concat_shards.py`` (numpy and scipy only),
so that the port needs nothing outside its package.

Each multi-host process writes ``<outfile>.pNNN.nc`` holding the RAW
frames of its addressable slots plus an ``ID`` variable mapping slots to
global elements at each output step (slots migrate between tiles under
domain decomposition).  This tool scatters every shard's slots by ID
into the global (trajectory, time) arrays, applies the exact
``valid_mask`` rule the single-process writer uses, and writes a file
bit-identical to what a single-process run with the same configuration
would have produced (tests/test_sharded_output.py proves the
bit-for-bit claim in-suite, tests/test_torch_sharded_output.py for this
copy; opendrift_tpu_torch/tools/multihost_dryrun.py re-proves it across a
real 2-process run).

The reference analogue: per-worker NetCDF files concatenated post-hoc
(reference examples/example_long_multiprocessing.py:16-50).

Usage: python -m opendrift_tpu_torch.tools.concat_shards OUT.nc \
           SHARD.p000.nc SHARD.p001.nc ...
       python -m opendrift_tpu_torch.tools.concat_shards OUT.nc SHARD_PREFIX
           (globs SHARD_PREFIX.p*.nc)
"""

import glob
import os
import sys

import numpy as np

SHARD_ONLY_ATTRS = {"n_total_elements", "shard_process", "shard_count"}


def _read_shard(path):
    from scipy.io import netcdf_file

    f = netcdf_file(path, "r", mmap=False)
    try:
        times = np.asarray(f.variables["time"][:], np.float64)
        data = {}
        var_attrs = {}
        for name, v in f.variables.items():
            if name == "time":
                continue
            data[name] = np.asarray(v[:])
            var_attrs[name] = {
                k: (val.decode() if isinstance(val, bytes) else val)
                for k, val in v._attributes.items()}
        attrs = {k: (v.decode("utf-8", "replace")
                     if isinstance(v, bytes) else v)
                 for k, v in f._attributes.items()}
        return times, data, var_attrs, attrs
    finally:
        f.close()


def concat_shards(shard_paths, out_path):
    from ..export.io_netcdf import EPOCH, valid_mask, write_result
    from ..utils.dataset import TrajectoryDataset, DataVar

    shards = [_read_shard(p) for p in sorted(shard_paths)]
    times0 = shards[0][0]
    for t, *_ in shards[1:]:
        if not np.array_equal(t, times0):
            raise ValueError("shards disagree on output times")
    attrs = dict(shards[0][3])
    n_total = int(attrs["n_total_elements"])
    n_time = len(times0)

    # ID doubles as the scatter key and (like any element variable) a
    # data variable of the merged file — the plain writer includes it
    # whenever export_variables is None or lists it
    names = list(shards[0][1])
    stacked = {}
    for name in names:
        if np.issubdtype(shards[0][1][name].dtype, np.floating):
            fill = np.nan
        elif name == "status":
            fill = -1            # NOT_RELEASED
        else:
            fill = 0
        stacked[name] = np.full((n_total, n_time), fill,
                                shards[0][1][name].dtype)
    for _, data, _, _ in shards:
        ids = data["ID"]               # (T, slots)
        for t in range(n_time):
            sel = (ids[t] > 0) & (ids[t] <= n_total)
            rows = ids[t][sel] - 1
            for name in names:
                stacked[name][rows, t] = data[name][t][sel]

    from ..elements.elements import ACTIVE
    valid = valid_mask(stacked["status"].astype(np.int64), ACTIVE)
    variables = {}
    for name in names:
        vals = stacked[name]
        if np.issubdtype(vals.dtype, np.floating):
            vals = np.where(valid, vals, np.nan)
        variables[name] = DataVar(("trajectory", "time"), vals,
                                  shards[0][2].get(name, {}))
    coords = {
        "trajectory": np.arange(1, n_total + 1),
        "time": (EPOCH + times0.astype("timedelta64[s]")
                 ).astype("datetime64[ns]"),
    }
    for k in SHARD_ONLY_ATTRS | {"featureType", "Conventions"}:
        attrs.pop(k, None)
    # the merged file IS the plain-layout artifact: normalise the one
    # config echo that necessarily differs between the two write paths
    if "config_export:sharded" in attrs:
        attrs["config_export:sharded"] = np.int32(0)
    result = TrajectoryDataset(variables, coords, attrs)
    write_result(result, out_path)
    return result


def main():
    if len(sys.argv) < 3:
        raise SystemExit(__doc__)
    out = sys.argv[1]
    paths = sys.argv[2:]
    if len(paths) == 1 and not os.path.exists(paths[0]):
        paths = glob.glob(paths[0] + ".p*.nc")
        if not paths:
            raise SystemExit(f"no shards match {sys.argv[2]}.p*.nc")
    res = concat_shards(paths, out)
    print(f"wrote {out}: {res.dims['trajectory']} trajectories x "
          f"{res.dims['time']} steps from {len(paths)} shard(s)")


if __name__ == "__main__":
    main()
