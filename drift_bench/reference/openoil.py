"""Plain reference of an OpenOil spill forecast on gridded file forcing.

What a forecast of the ``openoil_*`` configurations computes, written out
once in PyTorch for the whole population of elements: the mean droplet
size couples every element to every other (the median diameter of the
spectrum is one mean over the oil in the water), so a sample cannot be
followed alone.  It takes what the benchmark itself made: the forcing
arrays before they were written to the files, the seeded positions, the
model's seed.  It takes nothing the program derived.  It runs on the card
where there is one, else on the CPU.

One step of ``dt`` seconds, as OpenDrift defines OpenOil (upstream
``basemodel/__init__.py`` run loop, ``openoil.py``,
``noaa_oil_weathering.py``, ``physics_methods.py``):

1. release: an element seeded at time ``tau`` (the seeding spreads the
   elements evenly over the release, one after another) is released at
   the first step ``t`` with ``tau < t + dt``;
2. sample the environment at the position and depth, as ``oceandrift.py``
   does (bilinear in each file's projected grid, linear between depth
   levels and frames, grid-relative vectors turned east and north, the
   nearest-ocean fill): currents, temperature, salinity and the seafloor
   from the ocean file, wind from the wind file, the significant wave
   height, the mean period Tm02 and the Stokes drift from the wave file;
   then perturb the currents and the wind with normal noise of standard
   deviation ``drift:current_uncertainty`` (0.05 m/s) and
   ``drift:wind_uncertainty`` (0.5 m/s);
3. an element leaving the ocean file is ``missing_data``; one on its land
   cells strands at the first land point of three bisections of its last
   move; one below the seafloor is lifted to it;
4. (the output frame is the state here)
5. weathering (NOAA), each on the active elements: the emulsion's density
   and viscosity at the water's temperature; evaporation of the surface
   oil, pseudo-component by pseudo-component (the oil's ten); water
   uptake once the evaporated fraction passes the oil's Bullwinkle
   fraction; dispersion at Roy's constant from the wave height;
6. wave entrainment (Li 2017) and the Johansen (2015) droplet spectrum,
   whose median diameter is the mean over the active elements, each
   element's candidate diameter drawn from its lognormal;
7. the vertical walk: Visser (1997) in Large et al.'s (1994) diffusivity
   of the wind over 60 s substeps, with the Tkalich (2002) rise velocity
   of the carried diameter and the entrainment of surface oil to a depth
   uniform over 1.5 Hs, in the order of the oil kernel's plain version;
8. move: Euler in the currents, windage at the oil's
   ``wind_drift_factor`` decaying to nothing at 0.1 m depth, Stokes drift
   with the Phillips profile's decay, on the WGS84 ellipsoid.

Precision: every state and field is held in float32, as the configuration
states.  The sampling, the velocities and the move are float64 arithmetic
on those float32 values (as ``oceandrift.py``), rounded to float32 when
stored; the weathering, the spectrum, the entrainment and the walk are
float32 arithmetic.  The draws are ``draws.py``'s, made for the whole
population in ``torch_draws.py``.

Where it departs from upstream: the oil's properties are the bundled
database's GENERIC MEDIUM CRUDE (a frozen copy below: its density,
viscosity and its ten pseudo-components' boiling points and molecular
weights, the vapour pressure from the boiling points); the mixed layer is
50 m (upstream's fallback, as no file serves it); the walk's draws are the
program's hashed uniforms (upstream draws numpy normals); the geodesic
move is Vincenty's (upstream: pyproj's).  A frame before an element's
release is labelled ``status_categories[-1]`` ('sedimented'), as the
check labels the program's NOT_RELEASED (-1), which numpy reads as the
last category.
"""

import math

import numpy as np
import torch

from . import draws, proj, torch_draws
from .oceandrift import Grid

G = 9.81
GAS_CONSTANT = 8.314
# the oils this reference knows: frozen copies of the bundled database's
# records (NOAA ADIOS-derived; ten pseudo-components each)
OILS = {
    "GENERIC MEDIUM CRUDE": {
        "api": 29.68, "density_ref": 879.343, "density_ref_temp": 273.15,
        "kvis_ref": 0.00010460299999999999, "kvis_ref_temp": 273.15,
        "kvis_k": 5478.6, "mass_fraction": [0.1] * 10,
        "boiling_point": [361.9, 433.3, 493.3, 547.5, 598.2, 649.8, 704.5,
                          764.5, 833.9, 917.0],
        "molecular_weight": [0.093852, 0.13359, 0.174468, 0.217188,
                             0.262361, 0.313261, 0.372626, 0.444516,
                             0.536063, 0.657713],
        "bullwinkle_fraction": 0.1438, "bullwinkle_time": -999.0,
        "emulsion_water_fraction_max": 0.6877},
}
# Large et al. (1994), upstream physics_methods.py
RHO_AIR = 1.22
DRAG = 1.25e-3
MIXED_LAYER = 50.0
BACKGROUND_K = 1.2e-5
COAST_BISECTIONS = 3
WIND_DRIFT_DEPTH = 0.1
CURRENT_UNCERTAINTY = 0.05
WIND_UNCERTAINTY = 0.5
SD = math.log(10.0) * 0.4          # the droplet spectrum's log-width
WGS84_A = 6378137.0
WGS84_F = 1.0 / 298.257223563
STATUS = ("active", "stranded", "missing_data", "outside", "sedimented")
NOT_RELEASED = STATUS.index("sedimented")

WAVE_HS = "sea_surface_wave_significant_height"
WAVE_TM02 = ("sea_surface_wave_mean_period_from_variance_spectral_density_"
             "second_frequency_moment")
STOKES = ("sea_surface_wave_stokes_drift_x_velocity",
          "sea_surface_wave_stokes_drift_y_velocity")
CURRENT = ("x_sea_water_velocity", "y_sea_water_velocity")
WIND = ("x_wind", "y_wind")
SAMPLED = {"ocean": CURRENT + ("sea_water_temperature",
                               "sea_water_salinity"),
           "wind": WIND,
           "wave": (WAVE_HS, WAVE_TM02) + STOKES}
# what this reference follows, as the configuration states it
FOLLOWS = {"drift:vertical_mixing": True,
           "vertical_mixing:diffusivitymodel": "windspeed_Large1994",
           "processes:biodegradation": False,
           "processes:update_oilfilm_thickness": False,
           "wave_entrainment:droplet_size_distribution":
               "Johansen et al. (2015)"}


# --------------------------------------------------------------- the oil --

class Oil:
    """One oil's properties (float32 tensors on ``dev``)."""

    def __init__(self, name, dev):
        if name not in OILS:
            raise ValueError(f"this reference knows the oils {sorted(OILS)}, "
                             f"not {name!r}")
        rec = OILS[name]
        self.__dict__.update({k: v for k, v in rec.items()
                              if not isinstance(v, list)})

        def f32(key):
            return torch.tensor(rec[key], dtype=torch.float32, device=dev)
        self.mass_fraction = f32("mass_fraction")
        self.boiling_point = f32("boiling_point")
        self.molecular_weight = f32("molecular_weight")
        api = self.api if self.api > 0 else 30.0
        # oil-water interfacial tension from the API gravity (ADIOS)
        self.sigma = max(1e-3, 0.001 * (39.0 - 0.2571 * api))

    def density(self, T_K):
        """A thermal expansion of 8e-4 a kelvin about the reference."""
        return self.density_ref / (1.0 + 8.0e-4 * (T_K
                                                   - self.density_ref_temp))

    def kinematic_viscosity(self, T_K):
        arg = self.kvis_k * (1.0 / T_K - 1.0 / self.kvis_ref_temp)
        exp = torch.exp(arg) if torch.is_tensor(arg) else math.exp(arg)
        return self.kvis_ref * exp

    def vapour_pressure(self, T_K):
        """(C, N) Pa of each pseudo-component from its boiling point
        (Antoine-type estimate)."""
        bp = self.boiling_point[:, None]
        c2 = 0.19 * bp - 18.0
        ds = 8.75 + 1.987 * torch.log(bp)
        span = bp - c2
        ln_p = ds * (span * span) / (0.97 * 1.987 * bp) * (
            1.0 / (bp - c2) - 1.0 / (T_K[None, :] - c2))
        return torch.exp(ln_p) * 101325.0


# -------------------------------------------------------------- seawater --

def seawater_density(T, S):
    """UNESCO 1983 one-atmosphere equation of state (kg/m3)."""
    r1 = ((((6.536332e-09 * T - 1.120083e-06) * T + 1.001685e-04) * T
           - 9.095290e-03) * T + 6.793952e-02) * T - 28.263737
    r2 = (((5.3875e-09 * T - 8.2467e-07) * T + 7.6438e-05) * T
          - 4.0899e-03) * T + 8.24493e-01
    r3 = (-1.6546e-06 * T + 1.0227e-04) * T - 5.72466e-03
    sig = r1 + (4.8314e-04 * S + r3 * torch.sqrt(torch.clamp_min(S, 0.0))
                + r2) * S
    return sig + 28.106331 + 1000.0


def seawater_viscosity(T, S):
    """Dynamic viscosity (kg/m/s), Sharqawy et al. (2010)."""
    t65 = T + 64.993
    mu = 4.2844e-5 + 1.0 / (0.157 * (t65 * t65) - 91.296)
    a = 1.541 + 1.998e-2 * T - 9.52e-5 * (T * T)
    b = 7.974 - 7.561e-2 * T + 4.724e-4 * (T * T)
    s = S / 1000.0
    return mu * (1.0 + a * s + b * (s * s))


# ------------------------------------------------------------ weathering --

def emulsion(oil, T, S, s, active):
    """The emulsion's density and viscosity and the evaporated fraction at
    the water's temperature ``T`` and salinity ``S``, set on the active
    elements of the state ``s`` (a dict of float32 tensors)."""
    T_K = T + 273.15
    oil_visc = oil.kinematic_viscosity(T_K)
    wf = s["water_fraction"]
    density = wf * seawater_density(T, S) + (1.0 - wf) * oil.density(T_K)
    kv1 = torch.clip(torch.sqrt(oil_visc) * 1.5e3, 1.0, 10.0)
    total = s["mass_oil"] + s["mass_evaporated"]
    frac = torch.where(total > 0, s["mass_evaporated"] / total, 0.0)
    wf_rel = wf / 0.84
    viscosity = oil_visc * torch.exp(kv1 * frac) \
        * (1.0 + wf_rel / (1.187 - wf_rel)) ** 2.49
    for k, v in (("density", density), ("viscosity", viscosity),
                 ("fraction_evaporated", frac)):
        s[k] = torch.where(active, v, s[k])


def evaporate(oil, T, wind, s, active, dt):
    """NOAA evaporation of the surface oil younger than a day, each
    pseudo-component at its vapour pressure."""
    T_K = T + 273.15
    surface = active & (s["z"] == 0.0) & (s["age"] <= 86400.0)
    k = torch.where(wind >= 10.0, 0.06 * 0.0025 * (wind * wind),
                    0.0025 * wind ** 0.78)
    area = s["mass_oil"] / torch.clamp_min(s["density"], 1.0) \
        / torch.clamp_min(s["oil_film_thickness"], 1e-9)
    moles = torch.sum(s["components"] / oil.molecular_weight[:, None], 0)
    rate = -(area * k) / (GAS_CONSTANT * T_K * torch.clamp_min(moles,
                                                                 1e-12))
    left = s["components"] * torch.exp(rate[None, :]
                                       * oil.vapour_pressure(T_K) * dt)
    left = torch.where(surface[None, :], left, s["components"])
    s["mass_evaporated"] = s["mass_evaporated"] \
        + torch.sum(s["components"] - left, 0)
    s["mass_oil"] = torch.where(surface, torch.sum(left, 0), s["mass_oil"])
    s["components"] = left


def emulsify(oil, wind, s, active, dt):
    """Water uptake (mousse) of the elements past the Bullwinkle time or
    fraction, to the oil's largest water fraction."""
    t_b, f_b = oil.bullwinkle_time, oil.bullwinkle_fraction
    start = (((s["age"] >= t_b) & (t_b >= 0))
             | ((s["fraction_evaporated"] >= f_b) & (f_b > 0))) & active
    y_max = oil.emulsion_water_fraction_max
    if y_max <= 0:
        return
    d_min, d_max = 1.0e-6, 1.0e-5
    s_max = (6.0 / d_min) * (y_max / (1.0 - y_max))
    began = torch.where(s["bulltime"] > 0, s["bulltime"], s["age"])
    k = 6.0 * 2.024e-6 * (wind * wind) / d_max
    area = s["interfacial_area"] + k * abs(dt) * torch.exp(
        (-k / s_max) * (s["age"] - began))
    area = torch.where(start, torch.clamp_max(area, s_max),
                       s["interfacial_area"])
    wf = torch.clamp_max(area * d_max / (6.0 + area * d_max), y_max)
    s["interfacial_area"] = torch.where(active, area, s["interfacial_area"])
    s["water_fraction"] = torch.where(start, wf, s["water_fraction"])


def disperse(hs, wind, s, active, dt):
    """Natural dispersion at Roy's constant, the breaking share 0.02, on
    every active element."""
    hs = torch.where(hs == 0.0, 0.0246 * (wind * wind), hs)
    c_disp = (0.0034 * 1028.0 * 9.81 * (hs * hs)) ** 0.57 * 0.02
    c_roy = 2400.0 * torch.exp(-73.682 * torch.sqrt(s["viscosity"]
                                                    / s["density"]))
    q = c_roy * c_disp * 3.9e-8 / s["density"]
    frac = torch.where(active, torch.clip(q * abs(dt) * s["density"], 0.0,
                                          0.99), 0.0)
    lost = frac * s["mass_oil"]
    s["components"] = s["components"] * (1.0 - frac)[None, :]
    s["mass_oil"] = s["mass_oil"] - lost
    s["mass_dispersed"] = s["mass_dispersed"] + lost


# ------------------------------------------------- entrainment, droplets --

def breaking_fraction(wind, period):
    return torch.clamp_min(0.032 * (wind - 5.0) / period, 0.0)


def entrainment_rate(sigma, rho_w, density, viscosity, hs, wind, period):
    """Li et al. (2017) entrainment rate (1/s)."""
    d_o = 4.0 * torch.sqrt(sigma / (torch.clamp_min(rho_w - density, 1.0)
                                    * G))
    we = rho_w * G * hs * d_o / sigma
    oh = viscosity * density / torch.sqrt(density * sigma * d_o)
    return 4.604e-10 * we ** 1.805 * oh ** -1.023 \
        * breaking_fraction(wind, period)


def droplet_medians(scheme, sigma, rho_w, density, viscosity, film, hs):
    """Each element's volume median droplet diameter (m)."""
    hs = torch.clamp_min(hs, 0.01)
    if scheme == "Li et al. (2017)":
        d_o = 4.0 * torch.sqrt(sigma / (torch.clamp_min(rho_w - density,
                                                        1.0) * G))
        we = rho_w * G * hs * d_o / sigma
        oh = viscosity * density * (density * sigma * d_o) ** -0.5
        return d_o * 1.791 * (1.0 + 10.0 * oh) ** 0.460 * we ** -0.518
    h = torch.clamp_min(film, 1e-9)
    re = density * h * torch.sqrt(G * hs) / (viscosity * density)
    we = density * h * G * hs / sigma
    d_n = 2.251 * h * we ** -0.6 + 2.251 * 0.027 * h * re ** -0.6
    return torch.exp(torch.log(d_n) + 3.0 * SD ** 2)


def median_diameter(medians, active):
    """The spectrum's median: the mean over the oil in the water (the
    active elements), as upstream averages its element arrays; with none
    active, over all (NaN left out)."""
    use = active & ~torch.isnan(medians)
    if bool(use.any()):
        return medians[use].double().mean().float()
    return torch.nanmean(medians)


def candidate_diameters(median, draw):
    """Each element's diameter if entrained: lognormal about the median."""
    return torch.clip(torch.exp(torch.log(median) + SD * draw), 1e-6, 3e-3)


# --------------------------------------------------------------- the walk --

def large1994(wind, depth, mld, bg):
    """Large et al. (1994) diffusivity (float32)."""
    depth = torch.abs(depth)
    stress = wind * wind * DRAG * RHO_AIR
    sigma = depth / mld
    shape = sigma - 2.0 * (sigma * sigma) + sigma * sigma * sigma
    shape = torch.where(shape >= 1.0, 0.0, shape)
    k = mld * 0.2 * 0.4 * shape * stress + sigma * bg
    return torch.where(depth >= mld, bg, k)


def oil_walk(z, diam, wind, mld, zmin, p_ent, d_cand, zb, kw, kw2, nu_w,
             ids, seed, ntimes, dt_mix, bg=BACKGROUND_K):
    """``ntimes`` substeps of the walk with rise and entrainment (float32),
    every element moving, in the order of the oil kernel's plain version:
    three chained draws a substep (the walk, entrain or not, the depth),
    the rise velocity of the carried diameter, Visser's step on 1 m
    nearest levels (one-sided gradient at the surface), reflection at the
    surface and the seafloor, the rise, the surface element kept there,
    the surface stick, entrainment of surface oil, the bottom stick."""
    base = torch_draws.walk_base(ids, seed)
    adt = abs(dt_mix)
    upper = mld + 1.0
    for i in range(ntimes):
        surface = z == 0.0
        word = torch_draws.substep_bits(base, i)
        word1 = torch_draws.splitmix32((word + 0xc2b2ae35) & torch_draws.M32)
        word2 = torch_draws.splitmix32((word1 + 0x27d4eb2f)
                                       & torch_draws.M32)
        r = torch_draws.unit(word) * 2.0 - 1.0
        half = diam * 0.5
        w_stokes = kw * half * half
        w = torch.where(diam * torch.abs(w_stokes) / nu_w > 50.0,
                        kw2 * torch.sqrt(half), w_stokes)
        level = torch.minimum(torch.clamp_min(torch.round(torch.abs(z)),
                                              0.0), upper)
        k = large1994(wind, level, mld, bg)
        k_up = large1994(wind, level + 1.0, mld, bg)
        dkdz = torch.where(
            level == 0.0, k_up - k,
            (k_up - large1994(wind, torch.clamp_min(level - 1.0, 0.0), mld,
                              bg)) * 0.5)
        z = z - (dkdz * dt_mix - r * torch.sqrt(k * adt * 6.0))
        z = torch.where(z >= 0.0, -z, z)
        z = torch.where(z < zmin, 2.0 * zmin - z, z)
        z = z + w * dt_mix
        z = torch.where(surface, 0.0, z)
        z = torch.clamp_max(z, 0.0)
        entrained = (z >= 0.0) & (torch_draws.unit(word1) < p_ent)
        z = torch.where(entrained, -torch_draws.unit(word2) * zb, z)
        diam = torch.where(entrained, d_cand, diam)
        z = torch.maximum(z, zmin)
    return z, diam


# ------------------------------------------------------------- geodesy ----

def geodesic_direct(lat, lon, azimuth_deg, distance):
    """Vincenty's direct solution on WGS84 (float64 tensors, iterated to
    convergence): the point ``distance`` metres from (lat, lon) along the
    initial ``azimuth_deg``."""
    a, f = WGS84_A, WGS84_F
    b = a * (1.0 - f)
    alpha1 = torch.deg2rad(azimuth_deg)
    sa1, ca1 = torch.sin(alpha1), torch.cos(alpha1)
    tan_u1 = (1.0 - f) * torch.tan(torch.deg2rad(lat))
    cos_u1 = 1.0 / torch.sqrt(1.0 + tan_u1 ** 2)
    sin_u1 = tan_u1 * cos_u1
    sigma1 = torch.atan2(tan_u1, ca1)
    sin_alpha = cos_u1 * sa1
    cos2_alpha = 1.0 - sin_alpha ** 2
    u2 = cos2_alpha * (a * a - b * b) / (b * b)
    A = 1.0 + u2 / 16384.0 * (4096.0 + u2 * (-768.0 + u2 * (
        320.0 - 175.0 * u2)))
    B = u2 / 1024.0 * (256.0 + u2 * (-128.0 + u2 * (74.0 - 47.0 * u2)))
    sigma = distance / (b * A)
    for _ in range(8):
        c2sm = torch.cos(2.0 * sigma1 + sigma)
        ss, cs = torch.sin(sigma), torch.cos(sigma)
        dsigma = B * ss * (c2sm + B / 4.0 * (
            cs * (-1.0 + 2.0 * c2sm ** 2)
            - B / 6.0 * c2sm * (-3.0 + 4.0 * ss ** 2)
            * (-3.0 + 4.0 * c2sm ** 2)))
        sigma = distance / (b * A) + dsigma
    ss, cs = torch.sin(sigma), torch.cos(sigma)
    c2sm = torch.cos(2.0 * sigma1 + sigma)
    tmp = sin_u1 * ss - cos_u1 * cs * ca1
    phi2 = torch.atan2(sin_u1 * cs + cos_u1 * ss * ca1,
                       (1.0 - f) * torch.sqrt(sin_alpha ** 2 + tmp ** 2))
    lam = torch.atan2(ss * sa1, cos_u1 * cs - sin_u1 * ss * ca1)
    C = f / 16.0 * cos2_alpha * (4.0 + f * (4.0 - 3.0 * cos2_alpha))
    L = lam - (1.0 - C) * f * sin_alpha * (sigma + C * ss * (
        c2sm + C * cs * (-1.0 + 2.0 * c2sm ** 2)))
    return torch.rad2deg(phi2), lon + torch.rad2deg(L)


def move(lat, lon, u, v, seconds):
    """(lat, lon) after moving with east/north velocity (u, v) m/s."""
    az = torch.rad2deg(torch.atan2(u, v))
    return geodesic_direct(lat, lon, az, torch.hypot(u, v) * seconds)


def to32(a):
    return a.float().double()


# -------------------------------------------------------------- fields ----

class Projected:
    """A file's map projection (``proj.py``'s, in torch float64)."""

    def __init__(self, p):
        self.p = p

    def _dlon(self, lon):
        d = torch.deg2rad(lon - self.p["lon_0"])
        return torch.atan2(torch.sin(d), torch.cos(d))

    def fwd(self, lon, lat):
        p = self.p
        phi = torch.deg2rad(lat)
        d = self._dlon(lon)
        if p["proj"] == "stere":
            k = 0.5 * (1.0 + math.sin(math.radians(p["lat_ts"])))
            rho = 2.0 * p["R"] * k * torch.tan(math.pi / 4 - phi / 2)
            return rho * torch.sin(d), -rho * torch.cos(d)
        n, F, rho0 = (float(c) for c in proj._lcc_constants(p))
        rho = p["R"] * F / torch.tan(math.pi / 4 + phi / 2) ** n
        return rho * torch.sin(n * d), rho0 - rho * torch.cos(n * d)

    def to_east_north(self, lon, ux, uy):
        g = self._dlon(lon)
        if self.p["proj"] != "stere":
            g = float(proj._lcc_constants(self.p)[0]) * g
        c, s = torch.cos(g), torch.sin(g)
        return ux * c + uy * s, -ux * s + uy * c


class Fields:
    """One forcing file's decoded and filled fields (``oceandrift.py``'s
    ``Grid``) on the device, sampled in float64."""

    def __init__(self, record, wanted, dev):
        grid = Grid(record, wanted)
        self.proj = Projected(grid.proj)
        self.x0, self.y0, self.dx, self.dy = grid.x0, grid.y0, grid.dx, \
            grid.dy
        self.nx, self.ny = grid.nx, grid.ny
        self.times = grid.times
        self.depths = None if grid.depths is None else torch.as_tensor(
            np.asarray(grid.depths, np.float64), device=dev)
        self.fields = {k: torch.as_tensor(v, device=dev)
                       for k, v in grid.fields.items()}
        self.land = None if grid.land is None else torch.as_tensor(
            grid.land, device=dev)

    def at(self, lon, lat):
        """The grid coordinates of positions: (x0, fx, y0, fy, inside)."""
        x, y = self.proj.fwd(lon, lat)
        xi = (x - self.x0) / self.dx
        yi = (y - self.y0) / self.dy
        eps = 1e-2
        inside = (xi >= -eps) & (xi <= self.nx - 1 + eps) \
            & (yi >= -eps) & (yi <= self.ny - 1 + eps)

        def cell(i, n):
            i0 = torch.clip(torch.floor(i), 0, n - 2)
            return i0.long(), torch.clip(i - i0, 0.0, 1.0)
        x0, fx = cell(xi, self.nx)
        y0, fy = cell(yi, self.ny)
        return x0, fx, y0, fy, inside

    def _frames(self, t):
        ti = int(np.clip(np.searchsorted(self.times, t, side="right") - 1,
                         0, len(self.times) - 2))
        tw = float(np.clip((t - self.times[ti])
                           / (self.times[ti + 1] - self.times[ti]), 0, 1))
        return ((ti, 1.0 - tw), (ti + 1, tw))

    def _levels(self, depth):
        d = self.depths
        z0 = torch.clip(torch.searchsorted(d, depth, right=True) - 1, 0,
                        len(d) - 2)
        fz = torch.clip((depth - d[z0]) / (d[z0 + 1] - d[z0]), 0.0, 1.0)
        return ((z0, 1.0 - fz), (z0 + 1, fz))

    def sample(self, std, where, t=None, depth=None):
        """A static (y, x), a (time, y, x) or a (time, level, y, x) field at
        the grid coordinates ``where`` (float64)."""
        x0, fx, y0, fy, _ = where
        f = self.fields[std]
        planes = [((), 1.0)]
        if f.ndim >= 3:
            planes = [((tt,), wt) for tt, wt in self._frames(t)]
        if f.ndim == 4:
            planes = [(p + (zz,), w * wz) for p, w in planes
                      for zz, wz in self._levels(depth)]
        out = 0.0
        for plane, w in planes:
            def corner(yy, xx):
                return f[plane + (yy, xx)].double()
            out = out + w * ((corner(y0, x0) * (1 - fx)
                              + corner(y0, x0 + 1) * fx) * (1 - fy)
                             + (corner(y0 + 1, x0) * (1 - fx)
                                + corner(y0 + 1, x0 + 1) * fx) * fy)
        return out

    def vector(self, names, lon, where, t, depth=None):
        """East and north components of a grid-relative vector field."""
        return self.proj.to_east_north(
            lon, self.sample(names[0], where, t, depth),
            self.sample(names[1], where, t, depth))

    def on_land(self, lon, lat):
        """The land mask at the nearest grid point of the cell."""
        x0, fx, y0, fy, _ = self.at(lon, lat)
        return self.land[y0 + (fy > 0.5).long(), x0 + (fx > 0.5).long()]


def stokes_phillips(su, sv, hs, period, z):
    """Stokes drift at depth ``z`` under the Phillips spectrum's profile
    (Breivik et al. 2016), from the surface drift, Hs and the period."""
    speed = torch.sqrt(su * su + sv * sv)
    transport = (2.0 * math.pi / period) * (hs * hs) / 16.0
    km = speed * (1.0 - 2.0 / 3.0) / (2.0 * torch.clamp_min(transport,
                                                             1e-12))
    kz = km * torch.abs(z)
    decay = torch.exp(2.0 * km * z) - torch.sqrt(2.0 * math.pi * kz) \
        * torch.special.erfc(torch.sqrt(2.0 * kz))
    still = speed == 0
    return (torch.where(still, 0.0, su * decay),
            torch.where(still, 0.0, sv * decay))


# ------------------------------------------------------------ forecast --

def prepare(config, forcing):
    """The fields the forecast samples, from the writers' records, by the
    role the configuration gives each forcing file ('ocean', 'wind',
    'wave'), on the card where there is one."""
    stated = {k: config["config"].get(k) for k in FOLLOWS}
    if config["model"] != "OpenOil" or stated != FOLLOWS:
        raise ValueError(f"this reference follows OpenOil with "
                         f"{FOLLOWS}, not {config['model']} with {stated}")
    dev = "cuda" if torch.cuda.is_available() else "cpu"
    return {spec["role"]: Fields(forcing[spec["name"]],
                                 SAMPLED[spec["role"]], dev)
            for spec in config["forcing"]}


def _initial_state(oil, config, traffic, lon, lat, z, dev):
    """Every element's state before the first step (float32), as OpenOil
    seeds it: the oil's density and viscosity at 15 C, the volume of the
    release (``m3_per_hour`` over ``release.over_h``) shared evenly, each
    pseudo-component its fraction of the mass."""
    n = len(lon)
    hours = float(traffic["release"].get("over_h", 0.0)) or 1.0
    density = oil.density(288.15)
    mass = config["seed_kw"].get("m3_per_hour", 1.0) * hours / n * density

    def full(v):
        return torch.full((n,), float(np.float32(v)), dtype=torch.float32,
                          device=dev)
    s = {"lon": torch.as_tensor(lon, device=dev).double(),
         "lat": torch.as_tensor(lat, device=dev).double(),
         "z": torch.as_tensor(z, device=dev).float(),
         "mass_oil": full(mass), "density": full(density),
         "viscosity": full(oil.kinematic_viscosity(288.15)),
         "oil_film_thickness": full(0.001), "wind_drift_factor": full(0.03),
         "diameter": full(0.0), "age": full(0.0), "bulltime": full(0.0)}
    for k in ("mass_evaporated", "mass_dispersed", "water_fraction",
              "interfacial_area", "fraction_evaporated"):
        s[k] = full(0.0)
    s["components"] = oil.mass_fraction[:, None] * s["mass_oil"][None, :]
    return s


def release_seconds(traffic, n):
    """Each element's release time after the start (float32 s): the
    seeding's even spread over ``release.over_h``, one after another."""
    over = float(traffic["release"].get("over_h", 0.0)) * 3600.0
    if over <= 0:
        return np.zeros(n, np.float32)
    usec = np.round(np.linspace(0.0, 1.0, n) * over * 1e6)
    return (usec / 1e6).astype(np.float32)


def _environment(grids, s, t, ukey):
    """The environment at the state's positions and depths at time ``t``
    (float32 values as float64 tensors), the currents and the wind
    perturbed with the keyed noise, and the ocean file's coverage."""
    ocean, wind, wave = grids["ocean"], grids["wind"], grids["wave"]
    n, dev = s["lon"].shape[0], s["lon"].device
    lon, lat = s["lon"], s["lat"]
    depth = torch.clamp_min(-s["z"].double(), 0.0)
    where = ocean.at(lon, lat)
    env = {"covered": where[4]}
    env["u"], env["v"] = (to32(a) for a in ocean.vector(CURRENT, lon, where,
                                                         t, depth))
    for k in ("sea_water_temperature", "sea_water_salinity"):
        env[k] = to32(ocean.sample(k, where, t, depth))
    env["seafloor"] = to32(ocean.sample("sea_floor_depth_below_sea_level",
                                        where))
    where = wind.at(lon, lat)
    env["xw"], env["yw"] = (to32(a) for a in wind.vector(WIND, lon, where,
                                                         t))
    where = wave.at(lon, lat)
    env["su"], env["sv"] = (to32(a) for a in wave.vector(STOKES, lon, where,
                                                         t))
    env["hs"] = to32(wave.sample(WAVE_HS, where, t))
    env["period"] = to32(wave.sample(WAVE_TM02, where, t))
    for pair, (a, b), std in ((0, ("u", "v"), CURRENT_UNCERTAINTY),
                              (1, ("xw", "yw"), WIND_UNCERTAINTY)):
        sub = draws.fold_in(ukey, pair)
        for j, k in enumerate((a, b)):
            noise = std * torch_draws.normal(draws.fold_in(sub, j), n, dev)
            env[k] = (env[k].float() + noise).double()
    return env


def _strand(ocean, s, prev, strand):
    """Move the elements ``strand`` back to the first land point that
    three bisections of their last move find."""
    lon, lat = s["lon"], s["lat"]
    lo = torch.zeros_like(lon)
    hi = torch.ones_like(lon)
    for _ in range(COAST_BISECTIONS):
        mid = 0.5 * (lo + hi)
        hit = ocean.on_land(prev[0] + mid * (lon - prev[0]),
                            prev[1] + mid * (lat - prev[1])) > 0.5
        hi = torch.where(hit, mid, hi)
        lo = torch.where(hit, lo, mid)
    s["lon"] = torch.where(strand, to32(prev[0] + hi * (lon - prev[0])),
                           lon)
    s["lat"] = torch.where(strand, to32(prev[1] + hi * (lat - prev[1])),
                           lat)


EXPORTED = ("mass_oil", "mass_evaporated", "mass_dispersed",
            "water_fraction", "viscosity", "density", "diameter")


def simulate(config, traffic, grids, checked):
    """Follow one forecast's elements, all of them.  ``checked``: (the
    seeded (lon, lat, z) of all elements, the model's seed, the sample's
    0-based slots).  The elements are released evenly over
    ``release.over_h`` from the start and stepped ``duration_h`` hours by
    ``time_step_s``, with output every ``output_step_s``.  Returns, for the
    sample at every output frame, {lon, lat, z: float64 (S, T), status:
    names (S, T)} and the oil's columns (:data:`EXPORTED`, float64)."""
    (lon_all, lat_all, z_all), model_seed, idx = checked
    cfg = config["config"]
    dev = grids["ocean"].fields["x_sea_water_velocity"].device
    oil = Oil(config["seed_kw"].get("oil_type", "GENERIC MEDIUM CRUDE"),
              dev)
    n = len(lon_all)
    dt = float(traffic["time_step_s"])
    steps = int(round(traffic["duration_h"] * 3600.0 / dt))
    per_output = int(round(traffic["output_step_s"] / dt))
    dt_mix = float(cfg["vertical_mixing:timestep"])
    ntimes = max(1, abs(int(dt / dt_mix)))
    ocean = grids["ocean"]
    s = _initial_state(oil, config, traffic, lon_all, lat_all, z_all, dev)
    status = torch.full((n,), NOT_RELEASED, dtype=torch.int64, device=dev)
    release = torch.as_tensor(release_seconds(traffic, n), device=dev)
    ids = torch.arange(1, n + 1, dtype=torch.int64, device=dev)
    sample = torch.as_tensor(np.asarray(idx), device=dev)
    frames = {k: [] for k in ("lon", "lat", "z", "status") + EXPORTED}
    key0 = draws.prng_key(model_seed)
    prev = (s["lon"], s["lat"])
    for step in range(steps + 1):
        t = step * dt
        key = draws.fold_in(draws.fold_in(key0, step // per_output),
                            step % per_output)
        # the last frame's fetch has a key of its own
        ukey = draws.prng_key(0) if step == steps \
            else draws.fold_in(key, 987654)
        # 1. release
        status = torch.where((status == NOT_RELEASED)
                             & (release < np.float32(t + dt)), 0, status)
        # 2. the environment
        env = _environment(grids, s, t, ukey)
        # 3. the ocean file's edge, bad positions, the coast, the seafloor
        active = status == 0
        status = torch.where(active & ~env["covered"],
                             STATUS.index("missing_data"), status)
        bad = ~torch.isfinite(s["lon"]) | ~torch.isfinite(s["lat"]) \
            | (torch.abs(s["lat"]) > 90)
        status = torch.where((status == 0) & bad, STATUS.index("outside"),
                             status)
        strand = (status == 0) & (ocean.on_land(s["lon"], s["lat"]) > 0.5)
        if bool(strand.any()):
            _strand(ocean, s, prev, strand)
            status = torch.where(strand, STATUS.index("stranded"), status)
        active = status == 0
        floor = env["seafloor"].float()
        s["z"] = torch.where(active & (s["z"] < -floor), -floor, s["z"])
        # 4. the output frame
        if step % per_output == 0:
            for k in frames:
                v = status[sample] if k == "status" \
                    else s[k][sample].double()
                frames[k].append(v.cpu().numpy())
        if step == steps:
            break
        # 5. weathering
        s["age"] = torch.where(active, s["age"] + abs(dt), s["age"])
        prev = (s["lon"], s["lat"])
        T = env["sea_water_temperature"].float()
        S = env["sea_water_salinity"].float()
        xw, yw = env["xw"].float(), env["yw"].float()
        wind = torch.sqrt(xw * xw + yw * yw)
        hs = env["hs"].float()
        if not bool((hs.max() > 0).item()):
            hs = 0.0246 * (wind * wind)
        period = env["period"].float()
        emulsion(oil, T, S, s, active)
        if cfg.get("processes:evaporation", True):
            evaporate(oil, T, wind, s, active, dt)
        if cfg.get("processes:emulsification", True):
            emulsify(oil, wind, s, active, dt)
        if cfg.get("processes:dispersion", True):
            disperse(hs, wind, s, active, dt)
        # 6. entrainment and the droplet spectrum
        rho_w = seawater_density(T, S)
        rate = entrainment_rate(oil.sigma, rho_w, s["density"],
                                s["viscosity"], hs, wind, period)
        p_ent = 1.0 - torch.exp(-rate * dt_mix)
        median = median_diameter(droplet_medians(
            cfg["wave_entrainment:droplet_size_distribution"], oil.sigma,
            rho_w, s["density"], s["viscosity"], s["oil_film_thickness"],
            hs), active)
        d_cand = candidate_diameters(
            median, torch_draws.normal(draws.fold_in(key, 1), n, dev))
        # 7. the walk, with the Tkalich rise of the carried diameter
        nu_w = seawater_viscosity(T, S) / rho_w
        ratio = s["density"] / rho_w
        kw = 2.0 * G * (1.0 - ratio) / (9.0 * nu_w)
        kw2 = torch.sqrt(torch.abs(16.0 * G * (1.0 - ratio) / 3.0)) \
            * torch.sign(1.0 - ratio)
        z, diam = oil_walk(
            s["z"], s["diameter"], wind,
            torch.full_like(wind, MIXED_LAYER), -floor, p_ent, d_cand,
            1.5 * hs, kw, kw2, nu_w, ids,
            draws.scalar_bits(draws.fold_in(key, 3)), ntimes, dt_mix)
        s["z"] = torch.where(active, z, s["z"])
        s["diameter"] = torch.where(active, diam, s["diameter"])
        # 8. the move: currents, windage, Stokes drift
        zf = s["z"].double()
        wdf = s["wind_drift_factor"].double()
        windage = torch.where(zf > 0, wdf, wdf * (WIND_DRIFT_DEPTH + zf)
                              / WIND_DRIFT_DEPTH)
        windage = torch.where(zf >= -WIND_DRIFT_DEPTH, windage, 0.0)
        hs_s = torch.where(env["hs"] <= 0.0, 1.0, env["hs"])
        period_s = torch.where(env["period"] <= 0.0, 8.0, env["period"])
        su, sv = stokes_phillips(env["su"], env["sv"], hs_s, period_s, zf)
        vel_u = env["u"] + env["xw"] * windage + su
        vel_v = env["v"] + env["yw"] * windage + sv
        lat_n, lon_n = move(s["lat"], s["lon"], vel_u, vel_v, dt)
        s["lon"] = torch.where(active, to32(lon_n), s["lon"])
        s["lat"] = torch.where(active, to32(lat_n), s["lat"])
    out = {k: np.stack(v, axis=1) for k, v in frames.items()}
    out["status"] = np.asarray(STATUS, dtype=object)[out["status"]]
    return out
