"""Physics parameterisations as elementwise torch functions.

The port of the part of ``opendrift_tpu/ops/physics.py`` this slice
reaches (reference: opendrift/models/physics_methods.py:120-560): wave
height and period from wind, the Stokes drift profiles and the vertical
diffusivity parameterisations.  Each expression keeps the JAX version's
operation order (``x ** 2`` as ``x * x``, ``x ** 3`` as ``x * x * x``, as
XLA lowers integer powers), so both packages round alike.  With OpenOil
came the wave breaking and energy terms and the sea-water density and
viscosity; with the model zoo the fetch-tabulated Stokes drift and wave
height, the wind drag law and its inverse, the LADiM viscosity and the
solar geometry; and ``plot_stokes_profile``, a host-side matplotlib
diagnostic that imports matplotlib when called.
"""

import math

import numpy as np
import torch

G = 9.81


def rdiv(a, t):
    """``a / t`` for a Python number ``a`` as one float32 division, as XLA
    divides (torch evaluates ``a / tensor`` as a reciprocal and a product,
    two roundings)."""
    return torch.tensor(a, dtype=t.dtype, device=t.device) / t


# --------------------------------------------------------------- waves ----

def significant_wave_height_from_wind(wind_speed):
    """Neumann & Pierson (1966): Hs = 0.0246 U^2
    (reference physics_methods.py:180)."""
    return 0.0246 * (wind_speed * wind_speed)


def wave_frequency_from_wind(wind_speed):
    """Pierson-Moskowitz peak angular frequency; 5 rad/s where calm
    (reference physics_methods.py:194-202)."""
    return torch.where(wind_speed > 0,
                       0.877 * G / (1.17 * torch.clamp_min(wind_speed, 1e-12)),
                       5.0)


def wave_period_from_wind(wind_speed):
    return 2.0 * math.pi / wave_frequency_from_wind(wind_speed)


def wave_breaking_fraction(wind_speed, wave_period):
    """Fraction of breaking waves (reference physics_methods.py:185)."""
    f = 0.032 * (wind_speed - 5.0) / wave_period
    return torch.clamp_min(f, 0.0)


def wave_energy(hs, rho=1028.0):
    return G * rho * (hs * hs) / 16.0


def wave_energy_dissipation(hs, rho):
    """Delvigne & Sweeney (reference physics_methods.py:950)."""
    return 0.0034 * rho * G * (hs * hs)


def wind_drag_coefficient(windspeed):
    """Large & Pond (1981) (reference physics_methods.py:981)."""
    return torch.where(windspeed > 11.0, 0.001 * (0.49 + 0.065 * windspeed),
                       0.0012)


# ------------------------------------------------------- stokes drift -----

def stokes_transport_monochromatic(mean_wave_period, significant_wave_height):
    """(reference physics_methods.py:328-330)."""
    omega = 2.0 * math.pi / mean_wave_period
    return omega * (significant_wave_height * significant_wave_height) / 16.0


def _masked(su, sv, speed0, unit):
    zero = speed0 == 0
    return (torch.where(zero, 0.0, su * unit),
            torch.where(zero, 0.0, sv * unit), speed0 * unit)


def stokes_drift_profile_monochromatic(su, sv, hs, tp, z):
    """Breivik et al. (2014) monochromatic profile
    (reference physics_methods.py:332-357)."""
    speed0 = torch.sqrt(su * su + sv * sv)
    transport = stokes_transport_monochromatic(tp, hs)
    km = speed0 / (2.0 * torch.clamp_min(transport, 1e-12))
    return _masked(su, sv, speed0, torch.exp(2.0 * km * z))


def stokes_drift_profile_exponential(su, sv, hs, tp, z):
    """Breivik et al. (2014) combined exp profile
    (reference physics_methods.py:359-386)."""
    speed0 = torch.sqrt(su * su + sv * sv)
    transport = stokes_transport_monochromatic(tp, hs)
    km = speed0 / (2.0 * torch.clamp_min(transport, 1e-12))
    ke = km / 3.0
    unit = torch.exp(2.0 * ke * z) / (1.0 - 8.0 * ke * z)
    return _masked(su, sv, speed0, unit)


def stokes_drift_profile_phillips(su, sv, hs, tp, z):
    """Breivik et al. (2016) Phillips-spectrum profile
    (reference physics_methods.py:388-416)."""
    speed0 = torch.sqrt(su * su + sv * sv)
    beta = 1.0
    transport = stokes_transport_monochromatic(tp, hs)
    km = speed0 * (1.0 - 2.0 * beta / 3.0) / (
        2.0 * torch.clamp_min(transport, 1e-12))
    kz = km * torch.abs(z)
    unit = (torch.exp(2.0 * km * z)
            - beta * torch.sqrt(2.0 * math.pi * kz)
            * torch.special.erfc(torch.sqrt(2.0 * kz)))
    return _masked(su, sv, speed0, unit)


def stokes_drift_profile_windsea_swell(su, sv, swell_dir_to, swell_period,
                                       swell_height, windsea_dir_to,
                                       windsea_period, windsea_height, z):
    """Breivik & Christensen (2020) combined swell + wind-sea profile
    (reference physics_methods.py:418-455)."""
    th_ws_N = torch.cos(torch.deg2rad(windsea_dir_to))
    th_ws_E = torch.sin(torch.deg2rad(windsea_dir_to))
    th_sw_N = torch.cos(torch.deg2rad(swell_dir_to))
    th_sw_E = torch.sin(torch.deg2rad(swell_dir_to))
    denom = th_sw_E * th_ws_N - th_sw_N * th_ws_E
    swell_speed0 = (su * th_ws_N - sv * th_ws_E) / denom
    swell_u0 = swell_speed0 * th_sw_E
    swell_v0 = swell_speed0 * th_sw_N
    sw_u, sw_v, _ = stokes_drift_profile_monochromatic(
        swell_u0, swell_v0, swell_height, swell_period, z)
    ws_u, ws_v, _ = stokes_drift_profile_phillips(
        su - swell_u0, sv - swell_v0, windsea_height, windsea_period, z)
    u = sw_u + ws_u
    v = sw_v + ws_v
    return u, v, torch.sqrt(u * u + v * v)


# ---------------------------------------------- fetch-tabulated waves -----
# Stokes-drift factor and Hs against 10 m wind speed (0..29 m/s) for three
# fetch lengths (reference physics_methods.py:488-568), evaluated through
# a polynomial fitted in float64 on the host, as the reference does.

_STOKES_WF = {
    "5000": (0.0173, 0.0160, 0.0152, 0.0145, 0.0139, 0.0135,
             0.0132, 0.0129, 0.0126, 0.0124, 0.0122, 0.0121,
             0.0119, 0.0118, 0.0117, 0.0116, 0.0114, 0.0113,
             0.0112, 0.0112, 0.0111, 0.0110, 0.0109, 0.0109,
             0.0108, 0.0107, 0.0106, 0.0106, 0.0106, 0.0105),
    "25000": (0.0173, 0.0197, 0.0201, 0.0185, 0.0181, 0.0176,
              0.0171, 0.0167, 0.0164, 0.0160, 0.0158, 0.0155,
              0.0153, 0.0151, 0.0149, 0.0147, 0.0146, 0.0144,
              0.0143, 0.0142, 0.0140, 0.0139, 0.0138, 0.0137,
              0.0136, 0.0135, 0.0135, 0.0134, 0.0133, 0.0132),
    "50000": (0.0173, 0.0197, 0.0210, 0.0216, 0.0201, 0.0194,
              0.0190, 0.0186, 0.0183, 0.0179, 0.0176, 0.0173,
              0.0171, 0.0168, 0.0166, 0.0164, 0.0162, 0.0160,
              0.0159, 0.0157, 0.0156, 0.0155, 0.0153, 0.0152,
              0.0151, 0.0150, 0.0149, 0.0148, 0.0147, 0.0146),
}

_HS_TABLE = {
    "5000": (0.030, 0.077, 0.124, 0.170, 0.216, 0.263,
             0.311, 0.360, 0.409, 0.459, 0.509, 0.560,
             0.612, 0.664, 0.716, 0.771, 0.823, 0.876,
             0.932, 0.987, 1.041, 1.095, 1.152, 1.210,
             1.265, 1.319, 1.375, 1.434, 1.494, 1.552),
    "25000": (0.030, 0.122, 0.251, 0.336, 0.442, 0.546,
              0.650, 0.753, 0.856, 0.959, 1.063, 1.168,
              1.273, 1.379, 1.486, 1.593, 1.702, 1.811,
              1.920, 2.030, 2.142, 2.254, 2.366, 2.478,
              2.592, 2.707, 2.822, 2.936, 3.051, 3.166),
    "50000": (0.030, 0.122, 0.274, 0.474, 0.591, 0.724,
              0.873, 1.021, 1.168, 1.314, 1.460, 1.606,
              1.752, 1.898, 2.045, 2.192, 2.340, 2.489,
              2.639, 2.789, 2.940, 3.092, 3.244, 3.397,
              3.551, 3.706, 3.862, 4.017, 4.173, 4.330),
}

_STOKES_POLY_ORDER = {"5000": 3, "25000": 6, "50000": 6}
_HS_POLY_ORDER = {"5000": 1, "25000": 1, "50000": 1}
_poly_cache = {}


def _table_poly(table, order, tag):
    """Polynomial fit of a wind-indexed table, once, in float64 on the
    host (reference physics_methods.py:514-520, 560-566)."""
    if tag not in _poly_cache:
        _poly_cache[tag] = np.polyfit(np.arange(len(table)), table, order)
    return _poly_cache[tag]


def _polyval(coef, x):
    """Horner's rule on the float32 coefficients, as ``jnp.polyval``
    evaluates them: each step ``y * x + c`` is one fused multiply-add
    under XLA, reproduced by a float64 step rounded once to float32 (the
    float32 product is exact in float64)."""
    xd = x.double()
    y = torch.zeros_like(xd)
    for c in np.asarray(coef, np.float32):
        y = (y * xd + float(c)).float().double()
    return y.float()


def _capped_windspeed(x_wind, y_wind):
    return torch.clamp_max(torch.sqrt(x_wind * x_wind + y_wind * y_wind),
                           30.0)


def wave_stokes_drift_parameterised(x_wind, y_wind, fetch="25000"):
    """Surface Stokes drift parameterised from wind and fetch
    (reference physics_methods.py:488-528)."""
    fetch = str(fetch)
    coef = _table_poly(_STOKES_WF[fetch], _STOKES_POLY_ORDER[fetch],
                       ("wf", fetch))
    wf = _polyval(coef, _capped_windspeed(x_wind, y_wind))
    return x_wind * wf, y_wind * wf


def wave_significant_height_parameterised(x_wind, y_wind, fetch="25000"):
    """Hs parameterised from wind and fetch
    (reference physics_methods.py:530-568)."""
    fetch = str(fetch)
    coef = _table_poly(_HS_TABLE[fetch], _HS_POLY_ORDER[fetch],
                       ("hs", fetch))
    return _polyval(coef, _capped_windspeed(x_wind, y_wind))


# ------------------------------------------------- vertical diffusivity ---
# These three are also the plain versions of the diffusivity inside the
# mixing kernels (ops/mixing.py, csrc/visser_mixing.cu), which evaluate
# the same expressions in the same order.

def verticaldiffusivity_Sundby1983(windspeed, depth, mixedlayerdepth=50.0,
                                   background_diffusivity=0.0):
    """Sundby (1983) (reference physics_methods.py:203-216).
    ``depth`` positive downward."""
    K = 76.1e-4 + 2.26e-4 * (windspeed * windspeed) + torch.zeros_like(depth)
    K = torch.where(depth > mixedlayerdepth - 1.0,
                    (K + background_diffusivity) / 2.0, K)
    return torch.where(depth >= mixedlayerdepth, background_diffusivity, K)


def verticaldiffusivity_Large1994(windspeed, depth, mixedlayerdepth=50.0,
                                  background_diffusivity=0.0):
    """Large et al. (1994) (reference physics_methods.py:217-249)."""
    depth = torch.abs(depth)
    MLD = mixedlayerdepth
    rhoa = 1.22
    cd = 1.25e-3
    windstress = windspeed * windspeed * cd * rhoa
    sigma = depth / MLD
    Gshape = sigma - 2.0 * (sigma * sigma) + sigma * sigma * sigma
    Gshape = torch.where(Gshape >= 1.0, 0.0, Gshape)
    K = MLD * 0.2 * 0.4 * Gshape * windstress + sigma * background_diffusivity
    return torch.where(depth >= MLD, background_diffusivity, K)


def verticaldiffusivity_stepfunction(depth, MLD=20.0, k_above=0.1,
                                     k_below=0.02):
    """(reference physics_methods.py:251-257)."""
    return torch.where(torch.abs(depth) > MLD, k_below, k_above)


# ------------------------------------------------------------ seawater ----
# T and S may be float32 tensors or Python floats; a tensor in gives a
# float32 tensor out (Python constants never promote it to float64).

def _sqrt(x):
    return torch.sqrt(x) if torch.is_tensor(x) else math.sqrt(x)


def _clamp_min(x, lo):
    return torch.clamp_min(x, lo) if torch.is_tensor(x) else max(x, lo)


def sea_water_density(T=10.0, S=35.0):
    """UNESCO 1983 (Fofonoff & Millard) one-atmosphere equation of state
    (reference physics_methods.py:574-608)."""
    R4 = 4.8314e-04
    DR350 = 28.106331
    R1 = ((((6.536332e-09 * T - 1.120083e-06) * T + 1.001685e-04) * T
           - 9.095290e-03) * T + 6.793952e-02) * T - 28.263737
    R2 = (((5.3875e-09 * T - 8.2467e-07) * T + 7.6438e-05) * T
          - 4.0899e-03) * T + 8.24493e-01
    R3 = (-1.6546e-06 * T + 1.0227e-04) * T - 5.72466e-03
    sig = R1 + (R4 * S + R3 * _sqrt(_clamp_min(S, 0.0)) + R2) * S
    return sig + DR350 + 1000.0


def sea_water_dynamic_viscosity(T=10.0, S=35.0):
    """Sharqawy et al. (2010) correlation, as used by LADiM/reference
    (reference physics_methods.py:139-178).  Returns mu [kg/m/s]."""
    t65 = T + 64.993
    mu_w = 4.2844e-5 + 1.0 / (0.157 * (t65 * t65) - 91.296)
    A = 1.541 + 1.998e-2 * T - 9.52e-5 * (T * T)
    B = 7.974 - 7.561e-2 * T + 4.724e-4 * (T * T)
    Sr = S / 1000.0
    return mu_w * (1.0 + A * Sr + B * (Sr * Sr))


def sea_water_kinematic_viscosity(T=10.0, S=35.0):
    return sea_water_dynamic_viscosity(T, S) / sea_water_density(T, S)


def seawater_dynamic_viscosity_ladim(T=10.0, S=35.0):
    """LADiM variant (reference physics_methods.py:147-156):
    mu = 0.001 (1.7915 - 0.0538 T + 0.0007 T^2 + 0.0023 S)."""
    return 0.001 * (1.7915 - 0.0538 * T + 0.0007 * (T * T) + 0.0023 * S)


# --------------------------------------------------- wind stress / solar ----

def windspeed_from_stress(wind_stress, rho_air=1.225):
    """Invert the Large & Pond (1981) drag law tau = Cd(U) rho U^2 for U
    (reference physics_methods.py:987-994 fits a cubic): sqrt(tau / (0.0012
    rho)) in the low regime (U <= 11), else six Newton steps on the
    monotone cubic from the low-regime estimate."""
    tau = torch.clamp_min(torch.as_tensor(wind_stress, dtype=torch.float32),
                          0.0)
    u_low = torch.sqrt(tau / (0.0012 * rho_air))

    def f(u):
        return 0.001 * (0.49 + 0.065 * u) * rho_air * (u * u) - tau

    def df(u):
        return 0.001 * rho_air * (2.0 * 0.49 * u + 3.0 * 0.065 * (u * u))

    u = torch.clamp_min(u_low, 11.0)
    for _ in range(6):
        u = u - f(u) / torch.clamp_min(df(u), 1e-12)
    return torch.where(u_low <= 11.0, u_low, u)


def _f32(x, device=None):
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def solar_declination(day_of_year):
    """Solar declination [deg] (reference physics_methods.py:997-1011)."""
    d = _f32(day_of_year)
    tilt = float(np.float32(-23.44) * np.float32(math.pi / 180.0))
    return torch.rad2deg(torch.arcsin(
        tilt * torch.cos(torch.deg2rad(
            (360.0 / 365.24) * (d + 10.0) + (360.0 / math.pi) * 0.0167
            * torch.sin(torch.deg2rad((360.0 / 365.24) * (d - 2.0)))))))


def equation_of_time(day_of_year, hour_utc=12.0):
    """Equation of time [minutes] (reference physics_methods.py:1013)."""
    d = _f32(day_of_year)
    gamma = 2.0 * math.pi / 365.0 * (d - 1.0 + (hour_utc - 12.0) / 24.0)
    return 229.18 * (0.000075 + 0.001868 * torch.cos(gamma)
                     - 0.032077 * torch.sin(gamma)
                     - 0.014615 * torch.cos(2 * gamma)
                     - 0.040849 * torch.sin(2 * gamma))


def hour_angle(day_of_year, minutes_utc, longitude):
    """Solar hour angle [deg] (reference physics_methods.py:1026)."""
    hour = _f32(minutes_utc) / 60.0
    eqt = equation_of_time(day_of_year, hour)
    true_solar_minutes = minutes_utc + eqt + 4.0 * longitude
    return true_solar_minutes / 4.0 - 180.0


def solar_elevation(day_of_year, minutes_utc, longitude, latitude):
    """Solar elevation angle [deg] at UTC time of day ``minutes_utc`` on
    ``day_of_year`` (reference physics_methods.py:1036-1044); convert
    datetimes with :func:`solar_elevation_time`."""
    d_rad = torch.deg2rad(solar_declination(day_of_year))
    h = torch.deg2rad(hour_angle(day_of_year, minutes_utc, longitude))
    lat = torch.deg2rad(_f32(latitude))
    return torch.rad2deg(torch.arcsin(
        torch.sin(lat) * torch.sin(d_rad)
        + torch.cos(lat) * torch.cos(d_rad) * torch.cos(h)))


def solar_elevation_time(time, longitude, latitude, device=None):
    """:func:`solar_elevation` of datetimes (host conversion)."""
    times = np.atleast_1d(time)
    doy = _f32([t.timetuple().tm_yday for t in times], device)
    mins = _f32([t.hour * 60.0 + t.minute + t.second / 60.0 for t in times],
                device)
    return solar_elevation(doy, mins, _f32(longitude, device),
                           _f32(latitude, device))


def plot_stokes_profile(profiles, view=("vertical",), filename=None):
    """Plot Stokes-drift profiles: a list of dicts with keys ``u``, ``v``,
    ``z`` (host arrays or tensors) and optional ``kwargs`` (reference
    physics_methods.py:259-325).  Host-side matplotlib diagnostic."""
    from ..utils.plotting import pyplot
    plt = pyplot()

    def host(a):
        return a.cpu().numpy() if torch.is_tensor(a) else np.asarray(a)
    fig, axes = plt.subplots(1, len(view), squeeze=False)
    for ax, kind in zip(axes[0], view):
        for p in profiles:
            u, v, z = host(p["u"]), host(p["v"]), host(p["z"])
            kw = p.get("kwargs", {})
            if kind == "vertical":
                ax.plot(np.hypot(u, v), z, **kw)
                ax.set_xlabel("Stokes speed [m/s]")
                ax.set_ylabel("z [m]")
            elif kind == "birdseye":
                ax.plot(u, v, **kw)
                ax.set_xlabel("u [m/s]")
                ax.set_ylabel("v [m/s]")
            elif kind == "u":
                ax.plot(u, z, **kw)
                ax.set_xlabel("u [m/s]")
                ax.set_ylabel("z [m]")
            elif kind == "v":
                ax.plot(v, z, **kw)
                ax.set_xlabel("v [m/s]")
                ax.set_ylabel("z [m]")
        ax.grid(True)
    if filename is not None:
        fig.savefig(filename, dpi=110, bbox_inches="tight")
        plt.close(fig)
    return fig
