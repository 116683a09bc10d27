"""What decides ``correct``: the program's forecasts against the plain
reference, element by element, on a sample drawn from the seed.

Every forecast of the window keeps the trajectories of a sample of its
elements (lon, lat, z and status at every output frame).  Once the window
has closed, the configuration's reference (``reference/<name>.py``) follows
the same elements from the same seeded positions through the same forcing
arrays.  Over every (element, frame) pair after the first frame, pooled
over the forecasts, three numbers are read:

* ``status_mismatch_pct``: the share of pairs whose status differs, or
  whose position is finite on one side only (%);
* ``xy_p90_worst_frame_m``: the 90th percentile of the horizontal distance
  between the program's position and the reference's over the pairs of
  one output frame that agree and hold a position, at the frame where it
  is largest (m);
* ``z_p90_worst_frame_m``: the same of the depth difference (m).

So a fault in a few frames (the last one, the last window) shows in its
frame, and one in the statuses (an element that strands on one side only)
in the count of pairs.  Each number has its limit in the cell's file
``limits/<cell>.json``; ``correct`` holds where every number is at or
below its limit.
"""

import numpy as np

from . import forecast as fc

NUMBERS = ("status_mismatch_pct", "xy_p90_worst_frame_m",
           "z_p90_worst_frame_m")


def sample_indices(seed, index, n, size):
    """Forecast ``index``'s sample: ``size`` of its ``n`` slots, sorted."""
    r = fc.rng(seed, 3, index)
    return np.sort(r.choice(n, size=min(size, n), replace=False))


def keep_sample(o, idx):
    """The sampled trajectories of a finished forecast (host arrays)."""
    names = np.asarray(o.status_categories, dtype=object)
    out = {k: np.asarray(o.result[k].values)[idx]
           for k in ("lon", "lat", "z")}
    out["status"] = names[np.asarray(o.result["status"].values)[idx]]
    return out


def reference_run(cell, forcing, checked):
    """The reference's trajectories of each checked forecast of ``cell``.
    ``forcing``: {name: writer record}; ``checked``: [(positions, model
    seed, sample indices)].  The configuration's reference reads what it
    needs of the configuration and the traffic itself."""
    ref = cell.reference()
    prepared = ref.prepare(cell.config, forcing)
    return [ref.simulate(cell.config, cell.traffic, prepared, entry)
            for entry in checked]


def pairs(program, reference):
    """Per pair after the first frame, (E, T-1) each: whether the two
    sides agree (status and finiteness), whether the pair holds a
    position, the horizontal and the vertical gap (m)."""
    p, r = program, reference
    # a trajectory holds positions while active and at its first frame
    # after, as the program's result keeps them
    live = r["status"] == "active"
    valid = live.copy()
    valid[:, 1:] |= live[:, :-1]
    same = (p["status"] == r["status"]) & (np.isfinite(p["lon"]) == valid)
    dy = (p["lat"] - r["lat"]) * 111320.0
    dx = (p["lon"] - r["lon"]) * 111320.0 * np.cos(np.radians(r["lat"]))
    return (same[:, 1:], valid[:, 1:], np.hypot(dx, dy)[:, 1:],
            np.abs(p["z"] - r["z"])[:, 1:])


def _worst_frame_p90(gap, held):
    """The largest over frames of the 90th percentile of ``gap`` over the
    pairs ``held`` (inf where no frame holds a pair)."""
    worst = -np.inf
    for f in range(gap.shape[1]):
        g = gap[held[:, f], f]
        if g.size:
            worst = max(worst, float(np.quantile(g, 0.9)))
    return worst if np.isfinite(worst) else np.inf


def numbers(programs, references):
    """The compared numbers over all checked forecasts."""
    same, valid, xy, z = (np.concatenate(a) for a in zip(
        *(pairs(p, r) for p, r in zip(programs, references))))
    held = same & valid
    return {"status_mismatch_pct": float(100.0 * (~same).mean()),
            "xy_p90_worst_frame_m": _worst_frame_p90(xy, held),
            "z_p90_worst_frame_m": _worst_frame_p90(z, held)}


def coverage(references):
    """What the sample exercised, by the reference: the share of sampled
    elements that ended stranded, and that left the forcing (%)."""
    last = np.concatenate([r["status"][:, -1] for r in references])
    return {"stranded_pct": float(100.0 * (last == "stranded").mean()),
            "missing_data_pct": float(100.0
                                      * (last == "missing_data").mean())}


def verdict(limits, readings):
    """(correct, [(name, reading, limit)]) against the cell's limits; a
    number without a limit, or not finite, fails."""
    rows = [(k, readings[k], limits.get(k)) for k in NUMBERS]
    ok = all(lim is not None and np.isfinite(v) and v <= lim
             for _, v, lim in rows)
    return ok, rows
