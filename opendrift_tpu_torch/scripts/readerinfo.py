#!/usr/bin/env python
"""Inspect any forcing data source
(reference: opendrift/scripts/readerinfo.py).

    python -m opendrift_tpu_torch.scripts.readerinfo SOURCE [-p]
        [--device cuda|cpu]

Prints the reader; ``-p`` plots the first variable's first frame into
``readerinfo.png`` (needs matplotlib).  ``--device`` is the device the
reader's samplers are given (default cuda).
"""

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("source", help="Path or <scheme>://path of data source")
    p.add_argument("-p", "--plot", action="store_true",
                   help="Plot the first variable's first frame")
    p.add_argument("--device", default="cuda",
                   help="Device of the reader's samplers (default cuda)")
    args = p.parse_args(argv)

    from opendrift_tpu_torch.fields.factory import reader_from_url
    from opendrift_tpu_torch.interop import resolve_device
    device = resolve_device(args.device)
    r = reader_from_url(args.source)
    r.device = device
    print(r)
    if args.plot:
        from datetime import datetime
        import numpy as np
        from opendrift_tpu_torch.utils.plotting import pyplot, use_agg
        use_agg()
        plt = pyplot()
        r.set_run_epoch(r.start_time or datetime.now())
        var = r.variables[0]
        frame = r._load_frame(var, 0) if hasattr(r, "_load_frame") else None
        if frame is not None:
            plt.imshow(np.atleast_3d(frame.T)[..., 0].T, origin="lower")
            plt.colorbar(label=var)
            plt.title(f"{r.name}: {var}")
            out = "readerinfo.png"
            plt.savefig(out, dpi=110)
            print(f"Wrote {out}")


if __name__ == "__main__":
    main()
