"""Parquet export/import of trajectory results.

The port's copy of ``opendrift_tpu/export/io_parquet.py``, the
counterpart of the reference's ``io_parquet`` (reference:
opendrift/export/io_parquet.py:1-66) on pyarrow, imported only when
called: the (trajectory, time) dataset is written in long form (one row
per element per output step, NaN rows dropped) for downstream analytics.
"""

import numpy as np


def write_result_parquet(result, filename):
    import pyarrow as pa
    import pyarrow.parquet as pq

    n_traj = result.dims["trajectory"]
    n_time = result.dims["time"]
    traj = np.repeat(np.asarray(result.coords["trajectory"]), n_time)
    time = np.tile(np.asarray(result.coords["time"]), n_traj)
    cols = {"trajectory": traj, "time": time}
    for name, var in result.variables.items():
        cols[name] = var.values.reshape(-1)
    valid = np.isfinite(cols.get("lon", np.zeros(len(traj))))
    table = pa.table({k: pa.array(v[valid]) for k, v in cols.items()})
    meta = {str(k): str(v) for k, v in result.attrs.items()}
    table = table.replace_schema_metadata(
        {**(table.schema.metadata or {}),
         **{k.encode(): v.encode() for k, v in meta.items()}})
    pq.write_table(table, filename)


def read_result_parquet(filename):
    """Read back into (dict of columns, attrs)."""
    import pyarrow.parquet as pq
    table = pq.read_table(filename)
    attrs = {k.decode(): v.decode()
             for k, v in (table.schema.metadata or {}).items()}
    return {c: table[c].to_numpy() for c in table.column_names}, attrs
