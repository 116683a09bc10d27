"""The benchmark of the PyTorch and CUDA port: whole forecasts, timed as
users wait for them.

    python3 -m drift_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout.  One run:

1. set-up (``setup_s``, from the process's start): import torch and start
   CUDA, write the cell's forcing files from the seed into the temporary
   directory, then one warm-up forecast of the cell's own shape cut to one
   output interval (which builds or loads the port's kernels);
2. the window: forecasts back to back until ``--seconds`` have passed;
   the one running then completes and counts.  A forecast is what a user
   does: construct the model, add the forcing files as readers, configure,
   seed, ``run()`` with the result left on the host;
3. with ``--trace 1`` a ``torch.profiler`` runs around the window and the
   per-layer metrics are read from it and from the program's timers and
   counters;
4. the check: the program's forecasts against the plain reference
   (``check.py``), each compared number beside its limit as the last lines
   on standard error and under ``check`` in the result;
5. the last line on standard output: one JSON object with ``correct``,
   ``attempted`` (forecasts), ``failed``, ``metrics`` and ``device``.

Without a CUDA card (or with fewer than the cell asks for) it prints no
result and exits with 2.  If JAX, flax or the JAX package is loaded once
the window has closed it exits with 3.
"""

import argparse
import gc
import json
import os
import shutil
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, ".drift_bench_cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "opendrift_tpu")


def process_age():
    """Seconds since this process started (from /proc, else since this
    module was imported)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = float(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED


_IMPORTED = time.perf_counter()


def use_checkout_caches():
    """Every build and kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(CACHE, sub)


def forbidden_modules():
    loaded = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(loaded & set(FORBIDDEN))


class Record:
    """What the per-layer metrics read of one run."""

    def __init__(self, cell):
        self.config = cell.config
        self.traffic = cell.traffic
        self.forecasts = []
        self.trace = None
        self.window_peak_bytes = None


def window(cell, seed, files, seconds, card, spans=False,
           readers_kw=None):
    """Forecasts back to back for ``seconds`` (at least one).  Returns
    (records of the forecasts that finished, forecasts attempted, failed,
    window seconds, checked forecasts: [(positions, model seed, sample
    indices)], their sampled trajectories)."""
    import numpy as np
    from . import check
    from . import forecast as fc
    traffic = cell.traffic
    n = int(traffic["elements"])
    size = int(cell.config["check"]["sample_per_forecast"])
    records, checked, kept = [], [], []
    failed = 0
    t0 = time.perf_counter()
    index = 0
    while True:
        positions = fc.seed_positions(traffic, seed, index)
        mseed = fc.model_seed(seed, index)
        t = time.perf_counter()
        try:
            o = fc.forecast(cell.config, traffic, files, positions, mseed,
                            card.device, readers_kw=readers_kw,
                            spans=spans)
            card.sync()
        except Exception:  # noqa: BLE001 -- a failed forecast counts
            print(f"forecast {index} failed:", file=sys.stderr)
            traceback.print_exc()
            failed += 1
        else:
            secs = time.perf_counter() - t
            timers = dict(o.timers)
            env = o.env
            print(f"forecast {index}: {secs!r} s, preparing "
                  f"{timers.get('preparing main loop')!r} s, main loop "
                  f"{timers.get('main loop')!r} s, its readers "
                  f"{timers.get('main loop:readers')!r} s, packing "
                  f"{env.pack_seconds!r} s", file=sys.stderr)
            lon = np.asarray(o.result["lon"].values)[:, -1]
            active = np.asarray(o.result["status"].values)[:, -1] == 0
            if not np.isfinite(lon[active]).all():
                failed += 1
            records.append({
                "seconds": secs, "elements": n,
                "steps": fc.steps(traffic), "timers": timers,
                "pack_seconds": env.pack_seconds,
                "prefetched_pack_seconds": env.prefetched_pack_seconds,
                "join_wait_seconds": env.join_wait_seconds})
            idx = check.sample_indices(seed, index, n, size)
            kept.append(check.keep_sample(o, idx))
            checked.append((positions, mseed, idx))
            del o
        gc.collect()
        index += 1
        if time.perf_counter() - t0 >= seconds:
            break
    return records, index, failed, time.perf_counter() - t0, checked, kept


def setup(cell, seed, directory, card, readers_kw=None):
    """Write the forcing files and make the warm-up forecast; returns the
    files {name: (path, record)}."""
    from . import forecast as fc
    files = fc.write_forcing(cell, directory, seed)
    traffic = cell.traffic
    warm = fc.forecast(cell.config, traffic, files,
                       fc.seed_positions(traffic, seed, 1 << 30),
                       fc.model_seed(seed, 1 << 30), card.device,
                       duration_h=traffic["output_step_s"] / 3600.0,
                       readers_kw=readers_kw)
    card.sync()
    del warm
    gc.collect()
    return files


def compare(cell, files, checked, kept):
    """(correct, [(name, reading, limit)], what the sample exercised) of
    the checked forecasts."""
    from . import check
    refs = check.reference_run(cell, {k: v[1] for k, v in files.items()},
                               checked)
    ok, rows = check.verdict(cell.limits, check.numbers(kept, refs))
    return ok, rows, check.coverage(refs)


class Card:
    """The device calls of a run: a CUDA card, or the CPU (for the tests
    of the harness, which never print a result)."""

    def __init__(self, device):
        import torch
        self.device = device
        self.cuda = device == "cuda"
        self.torch = torch

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def peak(self):
        return self.torch.cuda.max_memory_allocated() if self.cuda else 0

    def reset_peak(self):
        if self.cuda:
            self.torch.cuda.reset_peak_memory_stats()

    def release(self):
        if self.cuda:
            self.torch.cuda.empty_cache()

    def info(self, chips):
        return {"platform": "gpu" if self.cuda else "cpu",
                "kind": self.torch.cuda.get_device_name(0) if self.cuda
                else "cpu", "count": chips}


def execute(cell, seed, seconds, traced, device):
    """One run of ``cell`` on ``device``.  Returns (exit code, result,
    [(name, reading, limit)]); the result is None where the run must
    print none."""
    card = Card(device)
    tmp = tempfile.mkdtemp(prefix="drift_bench_")
    try:
        files = setup(cell, seed, tmp, card)
        setup_peak = card.peak()
        card.reset_peak()
        setup_s = process_age()
        record = Record(cell)
        prof = None
        if traced:
            from . import trace
            prof = trace.start(card.cuda)
        records, attempted, failed, window_s, checked, kept = window(
            cell, seed, files, seconds, card, spans=traced)
        if prof is not None:
            prof.stop()
        record.forecasts = records
        record.window_peak_bytes = card.peak()
        bad = forbidden_modules()
        if bad:
            print(f"drift_bench: modules loaded that the port must not "
                  f"load: {bad}", file=sys.stderr)
            return 3, None, []
        device_info = card.info(cell.chips)
        device_info["memory_peak_bytes"] = max(setup_peak,
                                               record.window_peak_bytes)
        metrics = {}
        breakdown = None
        if prof is not None:
            from . import trace
            record.trace = trace.Trace(prof, window_s)
            del prof
            device_info.update(busy_s=record.trace.busy_s,
                               window_s=record.trace.window_s)
            for m in cell.per_layer:
                value = cell.metric(m["name"]).read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            breakdown = {"device_ops": record.trace.top_kernels(),
                         "idle_gaps": record.trace.top_gaps()}
        else:
            work = sum(r["elements"] * r["steps"] for r in records)
            e2e = {"particle_steps_per_s": work / window_s,
                   "setup_s": setup_s}
            for m in cell.end_to_end:
                metrics[m["name"]] = {"value": e2e[m["name"]],
                                      "unit": m["unit"]}
        card.release()
        ok, rows, sample = compare(cell, files, checked, kept)
        result = {"correct": bool(ok and failed == 0 and records),
                  "attempted": attempted, "failed": failed,
                  "metrics": metrics, "device": device_info}
        if breakdown is not None:
            result["breakdown"] = breakdown
        result["sample"] = sample
        result["check"] = {name: {"value": value, "limit": limit}
                           for name, value, limit in rows}
        return 0, result, rows
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    use_checkout_caches()
    from . import cells
    cell = cells.load_cell(ROOT, args.workload)
    import torch
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell.chips:
        print(f"drift_bench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); this machine has {have}", file=sys.stderr)
        return 2
    torch.cuda.init()
    code, result, rows = execute(cell, args.seed, args.seconds,
                                 bool(args.trace), "cuda")
    if result is None:
        return code
    print(f"sample {json.dumps(result['sample'])}", file=sys.stderr)
    for name, value, limit in rows:
        print(f"check {name} {value!r} limit {limit!r}", file=sys.stderr)
    print(json.dumps(result))
    return code


if __name__ == "__main__":
    sys.exit(main())
