"""The card's published peaks and the least time of the port's kernels.

The operations and bytes are computed from the shapes of a launch, never
read from the implementation, so a share of the roofline reads the same
work whatever implements it.  Frozen copies of ``chip_smoke.py``'s
arithmetic at commit 6f1980e1cee06c33f9f539f1b9a6d1e50f17f533
(``OPS_PER_SUBSTEP``, ``OIL_EXTRA_OPS`` and the byte counts of
``check_kernels`` and ``check_oil_kernel``), which counted the operations a
substep does per element from ``csrc/visser_mixing.cu``: each add,
multiply, divide, square root, compare, select, min/max and integer hash
operation as one.
"""

# NVIDIA H100 SXM data sheet: float32 outside the tensor cores, HBM3
FP32_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12

# 48 shared a substep (the SplitMix32 draw 14, the nearest level 4, the
# gradient 6, the Visser update 8, reflections, buoyancy and sticks 16);
# each windspeed model adds three diffusivity evaluations
OPS_PER_SUBSTEP = {"windspeed_Sundby1983": 48 + 3 * 4,
                   "windspeed_Large1994": 48 + 3 * 13,
                   "stepfunction": 48 + 3 * 3}
# the oil kernel's substep adds two hashed draws (12 each), the Tkalich
# rise velocity (10) and the entrainment (7)
OIL_EXTRA_OPS = 2 * 12 + 10 + 7


def least_seconds(ops, nbytes):
    """The larger of the compute bound and the memory bound."""
    return max(ops / FP32_OPS_PER_S, nbytes / HBM_BYTES_PER_S)


def visser_mixing(n, ntimes, model):
    """K1 on ``n`` elements: 7 float arrays and the IDs read once, z
    written once; (operations, bytes)."""
    return n * ntimes * OPS_PER_SUBSTEP[model], n * 8 * 4


def visser_mixing_oil(n, ntimes, model):
    """K3 on ``n`` elements: 12 float arrays and the IDs read once, z and
    the droplet diameter written once; (operations, bytes)."""
    return (n * ntimes * (OPS_PER_SUBSTEP[model] + OIL_EXTRA_OPS),
            n * (13 + 2) * 4)
