"""visser_mixing_roofline: K1 (``ops/mixing.py``
``visser_mixing``, ``csrc/visser_mixing.cu``) against its roofline: the
least time of its launches, from the operations and bytes of
``roofline.py`` for the cell's elements and substeps, over their device
time in the trace (%)."""

from drift_bench import roofline

KERNELS = ("visser_mixing_kernel",)


def read(record):
    if record.trace is None:
        return None
    secs, launches = record.trace.kernel_time(KERNELS)
    if not launches or secs <= 0:
        return None
    cfg = record.config["config"]
    ntimes = max(1, int(record.traffic["time_step_s"]
                        / cfg["vertical_mixing:timestep"]))
    ops, nbytes = roofline.visser_mixing(
        int(record.traffic["elements"]), ntimes,
        cfg["vertical_mixing:diffusivitymodel"])
    return 100.0 * launches * roofline.least_seconds(ops, nbytes) / secs
