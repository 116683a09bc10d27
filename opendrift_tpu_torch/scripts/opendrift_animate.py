#!/usr/bin/env python
"""Animate a trajectory output file
(reference: opendrift/scripts/opendrift_animate.py).

    python -m opendrift_tpu_torch.scripts.opendrift_animate FILE
        [-o GIF_OR_MP4] [-b BUFFER] [-c VARIABLE] [--fps N]
        [--device cuda|cpu]
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("filename", help="Trajectory NetCDF file")
    p.add_argument("-o", "--output", default=None,
                   help="Output animation (.gif/.mp4)")
    p.add_argument("-b", "--buffer", type=float, default=0.1)
    p.add_argument("-c", "--color", default=None)
    p.add_argument("--fps", type=int, default=8)
    p.add_argument("--device", default="cuda",
                   help="Device of the simulation object (default cuda)")
    args = p.parse_args(argv)

    import opendrift_tpu_torch
    o = opendrift_tpu_torch.open(args.filename, device=args.device)
    out = args.output or args.filename + ".gif"
    o.animation(buffer=args.buffer, color=args.color, filename=out,
                fps=args.fps)
    print(f"Wrote {out}")


if __name__ == "__main__":
    main()
