"""Physics parameterisations as elementwise torch functions.

The port of the part of ``opendrift_tpu/ops/physics.py`` this slice
reaches (reference: opendrift/models/physics_methods.py:120-560): wave
height and period from wind, the Stokes drift profiles and the vertical
diffusivity parameterisations.  Each expression keeps the JAX version's
operation order (``x ** 2`` as ``x * x``, ``x ** 3`` as ``x * x * x``, as
XLA lowers integer powers), so both packages round alike.  With OpenOil
came the wave breaking and energy terms and the sea-water density and
viscosity.  The parameterisations that need other state (fetch-tabulated
Stokes drift, solar geometry) come with the models that use them
(ROADMAP A.12).
"""

import math

import torch

G = 9.81


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
