"""Visser vertical mixing: the CUDA kernels' wrappers and plain versions.

Port of ``opendrift_tpu/ops/pallas_mixing.py``.  Three kernels, written by
hand for Hopper in ``csrc/visser_mixing.cu`` (the source note there says
which Pallas kernel each replaces and what bounds it on an H100):

* :func:`visser_mixing` — windspeed-parameterised diffusivity
  (Sundby1983, Large1994, stepfunction), replacing the Pallas
  ``visser_mixing`` (pallas_mixing.py:313);
* :func:`visser_mixing_profile` — per-element level-major diffusivity
  profiles ('constant', and 'environment' with a reader-served
  diffusivity), replacing ``visser_mixing_profile`` (pallas_mixing.py:394);
* :func:`visser_mixing_oil` — OpenOil's inner loop: the windspeed walk with
  the Tkalich rise velocity of the carried droplet diameter and the wave
  entrainment of surface oil, replacing ``visser_mixing_oil``
  (pallas_mixing.py:472).

Each wrapper has the JAX signature.  A CUDA tensor launches the kernel on
the current stream; a CPU tensor takes the plain version beside it
(:func:`visser_mixing_plain`, :func:`visser_mixing_profile_plain`,
:func:`visser_mixing_oil_plain`), which is op for op the JAX
``_mix_loop``/``_mix_loop_prof``/``_mix_loop_oil`` in torch.  There is
no fallback: a kernel that fails to build or launch raises.  Each wrapper
counts its kernel launches in ``<wrapper>.launches``.

What bounds them on an H100: the rate at which an SM issues instructions
(128 thread-instructions a clock; no multiply-add is contracted, see
``NVCC_FLAGS``), not their bytes; the profile kernel's bytes, counted in
whole sectors (:func:`profile_bound_bytes`), take about as long as its
issue.  So the windspeed and oil kernels are written
to issue few instructions a substep while giving the plain versions' bits:
Large1994's three divisions by the mixed-layer depth go through one
reciprocal an element and a fused correction that lands on the correctly
rounded quotient (only for depths in :data:`RECIPROCAL_MLD_RANGE`, decided
once an element inside the kernel; any other depth is divided), and the
oil kernel's two possible rise velocities are computed before the loop.
The plain versions do none of this:
they stay the JAX loops and are what the kernels are held to, equal by
value on the card (``chip_smoke.py``; ``tools/sass.py`` counts a substep's
instructions).  That the quotient has the division's bits is not taken from
a sample: :func:`reciprocal_quotient_sweep` compares the two on the card for
every float32 depth of the range and every numerator of the walk.

The library is compiled with ``nvcc`` on first use into
``opendrift_tpu_torch/_build/`` (git-ignored) and loaded with ctypes.
"""

import ctypes
import struct
import threading

import torch

from . import physics as ph
from .cuda_build import ARCH_FLAGS, SHARED_FLAGS, build, check_launch
from .gather import SECTOR_BYTES

WINDSPEED_MODELS = ("windspeed_Sundby1983", "windspeed_Large1994",
                    "stepfunction")
_MODEL_CODE = {m: i for i, m in enumerate(WINDSPEED_MODELS)}

_M32 = 0xFFFFFFFF
# The mixed-layer depths (m) for which the kernels take Large1994's
# sigma = depth / mld through the reciprocal of mld (kReciprocalMin and
# kReciprocalMax of csrc/visser_mixing.cu); any other depth, and NaN, is
# divided.  The plain versions below always divide.
RECIPROCAL_MLD_RANGE = (2.0 ** -20, 2.0 ** 20)
# -fmad=false: no contracted multiply-adds, so a kernel rounds like its
# plain version
NVCC_FLAGS = [*ARCH_FLAGS, "-fmad=false", *SHARED_FLAGS]

_lib = None
_lib_lock = threading.Lock()
# the compiler's report (registers, spills) of the last build, or None
build_log = None


def build_library():
    """Compile ``csrc/visser_mixing.cu`` (once per source content) and
    return the path of the shared library."""
    global build_log
    so, report = build("visser_mixing.cu", NVCC_FLAGS)
    if report is not None:
        build_log = report
    return so


def load_library():
    """The loaded kernel library (building it on first use)."""
    global _lib
    with _lib_lock:
        if _lib is None:
            lib = ctypes.CDLL(build_library())
            p, i, f, u = (ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                          ctypes.c_uint32)
            lib.visser_mixing_launch.argtypes = [
                p, p, p, p, p, p, p, u, i, f, i, f, i, i, p, p]
            lib.visser_mixing_launch.restype = i
            lib.visser_mixing_profile_launch.argtypes = [
                p, p, p, p, p, p, p, u, i, f, f, i, i, i, p, p]
            lib.visser_mixing_profile_launch.restype = i
            lib.visser_mixing_oil_launch.argtypes = [
                *([p] * 13), u, i, f, i, f, i, i, i, p, p, p]
            lib.visser_mixing_oil_launch.restype = i
            lib.reciprocal_quotient_sweep_launch.argtypes = [u, u, p, p]
            lib.reciprocal_quotient_sweep_launch.restype = i
            _lib = lib
    return _lib


# ----------------------------------------------------------- helpers ------

def _mul32(x, c):
    """(x * c) mod 2^32 for an int64 tensor x of uint32 values and a
    uint32 constant c, without int64 overflow."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def splitmix32(x):
    """SplitMix32 avalanche hash on int64 tensors holding uint32 values
    (pallas_mixing.py:78-85)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7feb352d)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846ca68b)
    return x ^ (x >> 16)


def _element_base(elem, seed):
    """Per-element hash base: splitmix32(ID + seed * 0x9e3779b9)."""
    e = elem.to(torch.int64) & _M32
    return splitmix32((e + ((int(seed) & _M32) * 0x9e3779b9 & _M32)) & _M32)


def _substep_bits(base, i):
    """Substep ``i``'s hash of the per-element base."""
    return splitmix32((base + (i * 0x85ebca6b & _M32)) & _M32)


def _draw(base, i):
    """Substep ``i``'s draw: top 24 bits -> uniform in [-1, 1)."""
    return (_substep_bits(base, i) >> 8).to(torch.float32) \
        * (2.0 / 16777216.0) - 1.0


def _unit(bits):
    """Top 24 bits -> uniform in [0, 1), exact in float32."""
    return (bits >> 8).to(torch.float32) * (1.0 / 16777216.0)


def _finish(z, surface, mv, w, zmin, dt_mix, mixing_at_surface):
    """Reflections, buoyancy and the surface/bottom sticks of a substep."""
    z = torch.where(z >= 0.0, -z, z)                       # surface reflect
    z = torch.where((z < zmin) & (mv == 1.0),
                    2.0 * zmin - z, z)                     # seafloor reflect
    z = z + w * dt_mix * mv                                # buoyancy
    if not mixing_at_surface:
        z = torch.where(surface, 0.0, z)
    z = torch.clamp_max(z, 0.0)                            # surface stick
    return torch.maximum(z, zmin)                          # bottom stick


def _diffusivity(model, wind, mld, bg, depth):
    if model == "windspeed_Sundby1983":
        return ph.verticaldiffusivity_Sundby1983(wind, depth, mld, bg)
    if model == "windspeed_Large1994":
        return ph.verticaldiffusivity_Large1994(wind, depth, mld, bg)
    if model == "stepfunction":
        return ph.verticaldiffusivity_stepfunction(depth)
    raise ValueError(f"model {model} has no mixing kernel")


def _visser_step(z, moving, wind, mld, upper, bg, model, R, dt_mix, adt):
    """The random-walk displacement of a windspeed substep: 1-metre
    nearest levels, one-sided gradient at the surface."""
    lvl = torch.minimum(torch.clamp_min(torch.round(torch.abs(z)), 0.0),
                        upper)
    Kz = _diffusivity(model, wind, mld, bg, lvl)
    Kup = _diffusivity(model, wind, mld, bg, lvl + 1.0)
    dKdz = torch.where(
        lvl == 0.0, Kup - Kz,
        (Kup - _diffusivity(model, wind, mld, bg,
                            torch.clamp_min(lvl - 1.0, 0.0))) * 0.5)
    return z - moving * (dKdz * dt_mix - R * torch.sqrt(Kz * adt * 6.0))


def _vec(a, n, device, dtype=torch.float32):
    """A contiguous (n,) tensor of ``dtype`` on ``device`` (scalars are
    broadcast, as the JAX wrapper's ``prep`` does)."""
    a = torch.as_tensor(a, dtype=dtype, device=device)
    if a.ndim == 0:
        a = a.expand(n)
    if a.shape != (n,):
        raise ValueError(f"expected shape ({n},), got {tuple(a.shape)}")
    return a.contiguous()


def _on_card(dev):
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (the plain version); any other device has neither."""
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"the mixing kernels run on cuda or cpu, not {dev}")
    return dev.type == "cuda"


# ------------------------------------------------- windspeed models -------

def visser_mixing_plain(z, moving, w, wind, mld, zmin, elem, seed, *, ntimes,
                        dt_mix, model, bg, mixing_at_surface):
    """Plain torch version of the windspeed kernel: op for op the JAX
    ``_mix_loop`` (pallas_mixing.py:88)."""
    adt = abs(dt_mix)
    base = _element_base(elem, seed)
    upper = mld + 1.0
    for i in range(int(ntimes)):
        surface = z == 0.0
        z = _visser_step(z, moving, wind, mld, upper, bg, model,
                         _draw(base, i), dt_mix, adt)
        z = _finish(z, surface, moving, w, zmin, dt_mix, mixing_at_surface)
    return z


def visser_mixing(z, moving, w, wind, mld, zmin, seed, elem=None, *, ntimes,
                  dt_mix, model, bg, mixing_at_surface):
    """Run ``ntimes`` Visser substeps on every element.

    z, moving, w, wind, mld, zmin: float32 (N,) (scalars broadcast);
    seed: uint32 or int32 scalar; ``elem``: int32 (N,) element IDs keying
    the draws (default: the slot index).  Returns the final z, float32
    (N,), on z's device."""
    if model not in _MODEL_CODE:
        raise ValueError(f"model {model} has no mixing kernel")
    n = z.shape[0]
    dev = z.device
    z, moving, w, wind, mld, zmin = (_vec(a, n, dev) for a in
                                     (z, moving, w, wind, mld, zmin))
    elem = torch.arange(n, dtype=torch.int32, device=dev) if elem is None \
        else _vec(elem, n, dev, torch.int32)
    seed = int(seed) & _M32
    opts = dict(ntimes=int(ntimes), dt_mix=float(dt_mix), model=model,
                bg=float(bg), mixing_at_surface=bool(mixing_at_surface))
    if not _on_card(dev):
        return visser_mixing_plain(z, moving, w, wind, mld, zmin, elem,
                                   seed, **opts)
    out = torch.empty_like(z)
    rc = load_library().visser_mixing_launch(
        z.data_ptr(), moving.data_ptr(), w.data_ptr(), wind.data_ptr(),
        mld.data_ptr(), zmin.data_ptr(), elem.data_ptr(), seed,
        opts["ntimes"], opts["dt_mix"], _MODEL_CODE[model], opts["bg"],
        int(opts["mixing_at_surface"]), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "visser_mixing")
    visser_mixing.launches += 1
    return out


visser_mixing.launches = 0


def reciprocal_quotient_sweep(mld_lo, mld_hi, device="cuda"):
    """Hold the kernels' reciprocal quotient against the float32 division
    on the card, bit for bit, for EVERY float32 mixed-layer depth in
    [``mld_lo``, ``mld_hi``] (positive, normal) and every numerator the
    walk can divide by it: the integer levels 0 to floor(mld + 1) + 2, and
    mld, the clipped level mld + 1 and its two neighbours as the kernel
    rounds them.  Runs the device function the windspeed and oil kernels
    call, compiled with their flags; one launch a binade.

    Returns (quotients compared, quotients that differ, the first differing
    (mld, numerator) or None).  There is no version of it for the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("the quotient sweep runs the kernels' device "
                         f"function and needs a CUDA device, not {dev}")
    lo = torch.tensor(float(mld_lo), dtype=torch.float32)
    hi = torch.tensor(float(mld_hi), dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    if not (tiny <= float(lo) <= float(hi) < float("inf")):
        raise ValueError(f"not a range of positive normal float32: "
                         f"[{mld_lo}, {mld_hi}]")
    lo_bits = int(lo.view(torch.int32))
    hi_bits = int(hi.view(torch.int32))
    counts = torch.zeros(3, dtype=torch.int64, device=dev)
    lib = load_library()
    stream = torch.cuda.current_stream(dev).cuda_stream
    first = lo_bits
    while first <= hi_bits:
        last = min(first | 0x7FFFFF, hi_bits)       # to the binade's end
        rc = lib.reciprocal_quotient_sweep_launch(first, last,
                                                  counts.data_ptr(), stream)
        check_launch(rc, "reciprocal_quotient_sweep")
        first = last + 1
    compared, differing, packed = (int(v) for v in counts.cpu())
    where = None
    if differing:
        numerator, mld = struct.unpack("<ff", struct.pack("<Q", packed))
        where = (mld, numerator)
    return compared, differing, where


# ------------------------------------------------------ profile models ----

def visser_mixing_profile_plain(z, moving, w, Kprof, gradK, zmin, elem, seed,
                                *, ntimes, dt_mix, h, mixing_at_surface):
    """Plain torch version of the profile kernel: the JAX
    ``_mix_loop_prof`` (pallas_mixing.py:195) with a direct level lookup
    in place of its one-hot contraction (equal: one term is non-zero)."""
    adt = abs(dt_mix)
    base = _element_base(elem, seed)
    L = Kprof.shape[0]
    for i in range(int(ntimes)):
        surface = z == 0.0
        R = _draw(base, i)
        zi = torch.clip(torch.round(-z / h).to(torch.int64), 0, L - 1)[None]
        Kz = torch.gather(Kprof, 0, zi)[0]
        dKdz = torch.gather(gradK, 0, zi)[0]
        z = z - moving * (dKdz * dt_mix - R * torch.sqrt(Kz * adt * 6.0))
        z = _finish(z, surface, moving, w, zmin, dt_mix, mixing_at_surface)
    return z


def visser_mixing_profile(z, moving, w, Kprof, gradK, zmin, seed, elem=None,
                          *, ntimes, dt_mix, h, mixing_at_surface):
    """Visser substeps with per-element diffusivity profiles.

    z, moving, w, zmin: float32 (N,); Kprof, gradK: float32 (L, N)
    level-major (the engine's profile layout), level spacing ``h`` > 0;
    seed scalar.  Returns the final z."""
    n = z.shape[0]
    dev = z.device
    z, moving, w, zmin = (_vec(a, n, dev) for a in (z, moving, w, zmin))
    L = Kprof.shape[0]
    Kprof = torch.as_tensor(Kprof, dtype=torch.float32, device=dev)
    gradK = torch.as_tensor(gradK, dtype=torch.float32, device=dev)
    if Kprof.shape != (L, n) or gradK.shape != (L, n):
        raise ValueError(f"profiles must be ({L}, {n})")
    Kprof, gradK = Kprof.contiguous(), gradK.contiguous()
    elem = torch.arange(n, dtype=torch.int32, device=dev) if elem is None \
        else _vec(elem, n, dev, torch.int32)
    seed = int(seed) & _M32
    opts = dict(ntimes=int(ntimes), dt_mix=float(dt_mix), h=float(h),
                mixing_at_surface=bool(mixing_at_surface))
    if not _on_card(dev):
        return visser_mixing_profile_plain(z, moving, w, Kprof, gradK, zmin,
                                           elem, seed, **opts)
    out = torch.empty_like(z)
    rc = load_library().visser_mixing_profile_launch(
        z.data_ptr(), moving.data_ptr(), w.data_ptr(), Kprof.data_ptr(),
        gradK.data_ptr(), zmin.data_ptr(), elem.data_ptr(), seed,
        opts["ntimes"], opts["dt_mix"], opts["h"], L,
        int(opts["mixing_at_surface"]), n, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "visser_mixing_profile")
    visser_mixing_profile.launches += 1
    return out


visser_mixing_profile.launches = 0


def profile_bound_bytes(visited):
    """The bytes the profile kernel must move at least, from ``visited``
    (L, N) bool: the (level, element) pairs of Kprof and gradK its walk
    reads.  ``total`` counts 4 B of each array a visited pair and the 24 B
    an element of the per-element arrays (z, moving, w, zmin and the ID
    read, z written): 4 B a pair.  ``sector_total`` counts each
    32-byte sector of the level-major arrays that holds a visited pair
    once, in each of the two, which is what a load fetches: the pairs
    (level, element // 8) where N is a multiple of 8, else the sectors of
    the flat (L * N) array."""
    L, n = visited.shape
    flat = visited.reshape(-1)
    per = SECTOR_BYTES // 4
    pad = -flat.shape[0] % per
    flat = torch.nn.functional.pad(flat, (0, pad))
    sectors = int(flat.view(-1, per).any(1).sum())
    pairs = int(visited.sum())
    element_bytes = n * 6 * 4
    return {"pairs": pairs, "sectors": sectors,
            "element_bytes": element_bytes,
            "pair_bytes": pairs * 2 * 4,
            "sector_bytes": sectors * 2 * SECTOR_BYTES,
            "total": element_bytes + pairs * 2 * 4,
            "sector_total": element_bytes + sectors * 2 * SECTOR_BYTES}


# --------------------------------------------------------------- oil ------

def visser_mixing_oil_plain(z, diam, moving, wind, mld, zmin, p_ent, d_cand,
                            zb, kw, kw2, nu_w, elem, seed, *, ntimes, dt_mix,
                            model, bg, mixing_at_surface, keep_diam):
    """Plain torch version of the oil kernel: op for op the JAX
    ``_mix_loop_oil`` (pallas_mixing.py:133).  Its substep tail is its own:
    the surface stick comes before the entrainment and the bottom stick
    after it, so an element put back to the surface can be entrained in
    the same substep."""
    adt = abs(dt_mix)
    base = _element_base(elem, seed)
    upper = mld + 1.0
    for i in range(int(ntimes)):
        surface = z == 0.0
        # three chained draws: the walk, entrain or not, the intrusion depth
        bits = _substep_bits(base, i)
        bits1 = splitmix32((bits + 0xc2b2ae35) & _M32)
        bits2 = splitmix32((bits1 + 0x27d4eb2f) & _M32)
        R = _unit(bits) * 2.0 - 1.0
        # Tkalich rise velocity from the carried diameter
        r2 = diam * 0.5
        W = kw * r2 * r2
        Re = diam * torch.abs(W) / nu_w
        W2 = kw2 * torch.sqrt(r2)
        w = torch.where(Re > 50.0, W2, W)
        z = _visser_step(z, moving, wind, mld, upper, bg, model, R, dt_mix,
                         adt)
        z = torch.where(z >= 0.0, -z, z)                   # surface reflect
        z = torch.where((z < zmin) & (moving == 1.0),
                        2.0 * zmin - z, z)                 # seafloor reflect
        z = z + w * dt_mix * moving                        # buoyancy
        if not mixing_at_surface:
            z = torch.where(surface, 0.0, z)
        z = torch.clamp_max(z, 0.0)                        # surface stick
        # wave entrainment of surface oil (z >= 0 means z == 0 here)
        entrained = (z >= 0.0) & (_unit(bits1) < p_ent)
        z = torch.where(entrained, -_unit(bits2) * zb, z)
        if not keep_diam:
            diam = torch.where(entrained, d_cand, diam)
        z = torch.maximum(z, zmin)                         # bottom stick
    return z, diam


def visser_mixing_oil(z, diam, moving, wind, mld, zmin, p_ent, d_cand, zb,
                      kw, kw2, nu_w, seed, elem=None, *, ntimes, dt_mix,
                      model, bg, mixing_at_surface, keep_diam):
    """OpenOil's mixing inner loop: ``ntimes`` Visser substeps with the
    Tkalich rise velocity of the carried diameter and wave entrainment.

    All array arguments float32 (N,) (scalars broadcast) except ``elem``
    (int32 element IDs keying the draws; default: the slot index); seed a
    uint32 or int32 scalar.  Returns (z, diameter), float32 (N,) each."""
    if model not in _MODEL_CODE:
        raise ValueError(f"model {model} has no mixing kernel")
    n = z.shape[0]
    dev = z.device
    arrays = tuple(_vec(a, n, dev) for a in (
        z, diam, moving, wind, mld, zmin, p_ent, d_cand, zb, kw, kw2, nu_w))
    elem = torch.arange(n, dtype=torch.int32, device=dev) if elem is None \
        else _vec(elem, n, dev, torch.int32)
    seed = int(seed) & _M32
    opts = dict(ntimes=int(ntimes), dt_mix=float(dt_mix), model=model,
                bg=float(bg), mixing_at_surface=bool(mixing_at_surface),
                keep_diam=bool(keep_diam))
    if not _on_card(dev):
        return visser_mixing_oil_plain(*arrays, elem, seed, **opts)
    z_out = torch.empty_like(arrays[0])
    diam_out = torch.empty_like(arrays[0])
    rc = load_library().visser_mixing_oil_launch(
        *(a.data_ptr() for a in arrays), elem.data_ptr(), seed,
        opts["ntimes"], opts["dt_mix"], _MODEL_CODE[model], opts["bg"],
        int(opts["mixing_at_surface"]), int(opts["keep_diam"]), n,
        z_out.data_ptr(), diam_out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    check_launch(rc, "visser_mixing_oil")
    visser_mixing_oil.launches += 1
    return z_out, diam_out


visser_mixing_oil.launches = 0
