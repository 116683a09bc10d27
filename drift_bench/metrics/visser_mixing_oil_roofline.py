"""visser_mixing_oil_roofline: K3 (``ops/mixing.py``
``visser_mixing_oil``, ``csrc/visser_mixing.cu``, OpenOil's walk with the
droplets' rise and the wave entrainment) against its roofline: the least
time of its launches, from the operations and bytes of ``roofline.py`` for
the cell's elements and substeps, over their device time in the trace
(%)."""

from drift_bench import roofline

KERNELS = ("visser_mixing_oil_kernel",)


def read(record):
    if record.trace is None:
        return None
    secs, launches = record.trace.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    cfg = record.config["config"]
    ntimes = max(1, int(record.traffic["time_step_s"]
                        / cfg["vertical_mixing:timestep"]))
    ops, nbytes = roofline.visser_mixing_oil(
        int(record.traffic["elements"]), ntimes,
        cfg["vertical_mixing:diffusivitymodel"])
    return 100.0 * launches * roofline.least_seconds(ops, nbytes) / secs
