#!/usr/bin/env python
"""Plot a trajectory output file
(reference: opendrift/scripts/opendrift_plot.py:26-42).

    python -m opendrift_tpu_torch.scripts.opendrift_plot FILE [-o PNG]
        [-b BUFFER] [-c VARIABLE] [--device cuda|cpu]
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("filename", help="Trajectory NetCDF file")
    p.add_argument("-o", "--output", default=None,
                   help="Output image (default: <filename>.png)")
    p.add_argument("-b", "--buffer", type=float, default=0.1)
    p.add_argument("-c", "--linecolor", default=None,
                   help="Colour trajectories by this variable")
    p.add_argument("--device", default="cuda",
                   help="Device of the simulation object (default cuda)")
    args = p.parse_args(argv)

    import opendrift_tpu_torch
    o = opendrift_tpu_torch.open(args.filename, device=args.device)
    out = args.output or args.filename + ".png"
    o.plot(buffer=args.buffer, linecolor=args.linecolor, filename=out)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
