#!/usr/bin/env python
"""Progressive-vector (hodograph) plot of the currents at a position
(reference: opendrift/scripts/hodograph.py).

    python -m opendrift_tpu_torch.scripts.hodograph SOURCE --lon LON
        --lat LAT [-z Z] [-o PNG] [--device cuda|cpu]

The currents are sampled at 50 times over the source's time span (24 h for
a source without one) with tensors on ``--device`` (default cuda).
"""

import argparse
from datetime import datetime, timedelta


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source", help="Forcing data source")
    p.add_argument("--lon", type=float, required=True)
    p.add_argument("--lat", type=float, required=True)
    p.add_argument("-z", type=float, default=0.0)
    p.add_argument("-o", "--output", default="hodograph.png")
    p.add_argument("--device", default="cuda",
                   help="Device the currents are sampled on (default cuda)")
    args = p.parse_args(argv)

    import numpy as np
    import torch
    from opendrift_tpu_torch.fields.factory import reader_from_url
    from opendrift_tpu_torch.interop import device_state_from_numpy, \
        resolve_device
    from opendrift_tpu_torch.utils.plotting import pyplot, use_agg

    device = resolve_device(args.device)
    use_agg()
    plt = pyplot()
    r = reader_from_url(args.source)
    # continuous/analytic sources carry no time bounds: a 24 h window
    start = r.start_time or getattr(r, "zero_time", None) \
        or datetime(2000, 1, 1)
    end = r.end_time or start + timedelta(hours=24)
    r.set_run_epoch(start)
    r.prepare(interval_seconds=(end - start).total_seconds())
    dev = device_state_from_numpy(r.device_state(start, end), device)
    total = (end - start).total_seconds()
    times = np.linspace(0, total, 50)
    want = [v for v in ("x_sea_water_velocity", "y_sea_water_velocity")
            if v in r.variables]
    pos = [torch.tensor([v], dtype=torch.float32, device=device)
           for v in (args.lon, args.lat, args.z)]
    zero = torch.zeros(1, device=device)
    us, vs = [], []
    for t in times:
        vals, _ = r.sample(dev, want, np.float32(t), *pos)
        us.append(float(vals.get("x_sea_water_velocity", zero)[0]))
        vs.append(float(vals.get("y_sea_water_velocity", zero)[0]))
    dt = times[1] - times[0]
    x = np.cumsum(np.asarray(us)) * dt / 1000.0
    y = np.cumsum(np.asarray(vs)) * dt / 1000.0
    plt.plot(x, y, "-o", ms=2)
    plt.xlabel("East displacement [km]")
    plt.ylabel("North displacement [km]")
    plt.title(f"Progressive vector at ({args.lon}, {args.lat}), "
              f"z={args.z} m")
    plt.axis("equal")
    plt.savefig(args.output, dpi=110, bbox_inches="tight")
    print(f"Wrote {args.output}")


if __name__ == "__main__":
    main()
