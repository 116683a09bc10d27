"""The readings that the check's limits are set from, at a cell's size.

    python3 -m drift_bench.control --workload <cell> --seeds 1,2,3
        [--variant program|float16|no_stranding]

For each seed: the forcing files, then one forecast of the cell (its own
elements, length and steps), and the check's numbers against the plain
reference, with the shares of the sample that stranded or left the
forcing, one JSON line a seed.  ``program`` is the program as the
configuration states it (the lower readings); ``float16`` is the control,
the same program with every reader's packed fields held in float16 (the
readers' ``packed_dtype``, the nearest precision below the float32 the
configuration states), which the limits must refuse (the upper readings).
The benchmark's own runs never run this; it needs a CUDA card.
"""

import argparse
import copy
import json
import sys
import tempfile
import time

# each variant: (attributes set on every reader, configuration keys set)
VARIANTS = {"program": (None, {}),
            "float16": ({"packed_dtype": "float16"}, {}),
            "no_stranding": (None, {"general:coastline_action": "none"})}


def readings(cell, seed, card, variant, warm=True):
    """The check's numbers of one forecast of ``cell`` under ``variant``."""
    import shutil
    from . import check
    from . import run
    readers_kw, keys = VARIANTS[variant]
    if keys:
        cell = copy.copy(cell)
        cell.config = copy.deepcopy(cell.config)
        cell.config["config"].update(keys)
    tmp = tempfile.mkdtemp(prefix="drift_bench_control_")
    try:
        if warm:
            files = run.setup(cell, seed, tmp, card, readers_kw=readers_kw)
        else:
            from . import forecast as fc
            files = fc.write_forcing(cell, tmp, seed)
        t = time.perf_counter()
        _, _, failed, _, checked, kept = run.window(
            cell, seed, files, 0.0, card, readers_kw=readers_kw)
        secs = time.perf_counter() - t
        t = time.perf_counter()
        refs = check.reference_run(cell, {k: v[1] for k, v in files.items()},
                                   checked)
        return {"seed": seed, "variant": variant, "failed": failed,
                "forecast_s": secs, "reference_s": time.perf_counter() - t,
                **check.coverage(refs), **check.numbers(kept, refs)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--variant", choices=sorted(VARIANTS), default="program")
    args = p.parse_args(argv)
    from . import cells, run
    run.use_checkout_caches()
    cell = cells.load_cell(run.ROOT, args.workload)
    import torch
    if not torch.cuda.is_available():
        print("drift_bench.control needs a CUDA card", file=sys.stderr)
        return 2
    card = run.Card("cuda")
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(cell, seed, card, args.variant,
                                  warm=i == 0)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
