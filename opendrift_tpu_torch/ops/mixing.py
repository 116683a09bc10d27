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

The library is compiled with ``nvcc`` on first use into
``opendrift_tpu_torch/_build/`` (git-ignored) and loaded with ctypes.
"""

import ctypes
import threading

import torch

from . import physics as ph
from .cuda_build import ARCH_FLAGS, SHARED_FLAGS, build, check_launch

WINDSPEED_MODELS = ("windspeed_Sundby1983", "windspeed_Large1994",
                    "stepfunction")
_MODEL_CODE = {m: i for i, m in enumerate(WINDSPEED_MODELS)}

_M32 = 0xFFFFFFFF
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
