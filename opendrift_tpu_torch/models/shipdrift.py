"""ShipDrift: drifting ships under wind and wave forcing.

Port of ``opendrift_tpu/models/shipdrift.py`` (reference:
opendrift/models/shipdrift.py:30-343): wind drag on the dry hull area plus
a wave drift force integrated over a Pierson-Moskowitz-type spectrum, with
wave damping and form drag resolved by fixed-point iteration.  The force
and damping tables (the port's copy of ``shipdrift_wforce.json``) are
sampled trilinearly in (omega, draft/length, beam/length).

The JAX package evaluates the 100 spectral bins as (100, N) arrays, which
XLA fuses on the TPU; in eager PyTorch each would be materialised (800 MB
apiece at N = 2M).  The port walks the bins one at a time and accumulates
the trapezoid sums, keeping the JAX package's pairing of each bin with
the one before it (``fpair``, ``dpair``) and its per-bin arithmetic; the
bins' omegas and table weights are host constants.
"""

import json
import math
import os

import numpy as np
import torch

from ..config import CONFIG_LEVEL_ESSENTIAL
from ..elements import LagrangianArray
from ..ops.physics import rdiv
from ..parallel.mesh import gathered
from .base import OpenDriftSimulation

G = 9.81
RHO_AIR = 1.25
RHO_WATER = 1025.0
NSPEC = 100
OMMIN2, OMMIN3, OMMAX = 2.25, 7.0, 12.0


def _load_wforce():
    path = os.path.join(os.path.dirname(__file__), "shipdrift_wforce.json")
    with open(path) as f:
        d = json.load(f)
    return (np.asarray(d["omega"], np.float32),
            np.asarray(d["beam_over_length"], np.float32),
            np.asarray(d["draft_over_length"], np.float32),
            np.asarray(d["F"], np.float32),   # (omega, DL, BL)
            np.asarray(d["D"], np.float32))


def _pow4(x):
    x2 = x * x
    return x2 * x2


def _axis_weights(axis, values):
    """Lower index and clipped weight of ``values`` on a sorted axis, as
    the JAX package's ``_interp3`` takes them."""
    i = torch.clamp(torch.searchsorted(axis, values, right=True) - 1, 0,
                    len(axis) - 2)
    w = torch.clamp((values - axis[i]) / (axis[i + 1] - axis[i]), 0.0, 1.0)
    return i, w


class ShipObject(LagrangianArray):
    """(reference shipdrift.py:30-76)."""

    variables = LagrangianArray.add_variables([
        ("orientation", {"dtype": np.float32, "units": "1", "default": 1.0}),
        ("length", {"dtype": np.float32, "units": "m", "default": 80.0,
                    "min": 1, "max": 500, "description": "Length of ship"}),
        ("height", {"dtype": np.float32, "units": "m", "default": 8.0,
                    "min": 1, "max": 100,
                    "description": "Total height of ship"}),
        ("draft", {"dtype": np.float32, "units": "m", "default": 4.0,
                   "min": 1, "max": 30,
                   "description": "Draft of ship (below waterline)"}),
        ("beam", {"dtype": np.float32, "units": "m", "default": 10.0,
                  "min": 1, "max": 70, "description": "Beam of ship"}),
        ("wind_drag_coeff", {"dtype": np.float32, "units": "1",
                             "seed": False, "default": 1.0}),
        ("water_drag_coeff", {"dtype": np.float32, "units": "1",
                              "seed": False, "default": 1.0}),
        ("jibeProbability", {"dtype": np.float32, "units": "1/h",
                             "default": 0.04}),
    ])


class ShipDrift(OpenDriftSimulation):
    """Ship drift model (reference shipdrift.py:80)."""

    ElementType = ShipObject

    required_variables = {
        "x_wind": {"fallback": None},
        "y_wind": {"fallback": None},
        "land_binary_mask": {"fallback": None},
        "x_sea_water_velocity": {"fallback": None},
        "y_sea_water_velocity": {"fallback": None},
        "horizontal_diffusivity": {"fallback": 100},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_surface_wave_mean_period_from_variance_spectral_density_"
        "second_frequency_moment": {"fallback": 0},
    }

    winwav_angle = 20.0  # degrees

    def __init__(self, *args, **kwargs):
        (self._omega_ax, self._bl_ax, self._dl_ax,
         self._F_table, self._D_table) = _load_wforce()
        super().__init__(*args, **kwargs)
        self._add_config({
            "seed:orientation": {
                "type": "enum", "enum": ["left", "right", "random"],
                "default": "random", "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Ship orientation relative to downwind"},
        })
        self._set_config_default("drift:max_speed", 2)
        self._tables = None

    # --------------------------------------------------------- seeding ----
    def seed_elements(self, *args, **kwargs):
        """Derive drag coefficients from ship dimensions
        (reference shipdrift.py:156-211)."""
        num = kwargs.get("number")
        if num is None:
            num = int(self.get_config("seed:number"))
        for var in ["length", "height", "draft", "beam"]:
            if var not in kwargs:
                kwargs[var] = self.get_config(f"seed:{var}")
            kwargs[var] = np.atleast_1d(np.asarray(kwargs[var], float))
            if len(kwargs[var]) == 1:
                kwargs[var] = kwargs[var] * np.ones(num)
        dl = np.clip(kwargs["draft"] / kwargs["length"], 0.025, 0.07)
        exposed = kwargs["height"] - kwargs["draft"]
        Cf = np.where(exposed > 37.2, 1.4,
                      1.045 + 0.016 * (exposed - 15.0))
        Cf = np.where(exposed <= 15, 0.700 + 0.023 * exposed, Cf)
        kwargs["wind_drag_coeff"] = Cf
        beta = 2.0 * dl
        Cd = np.where(beta > 0.12, 1.27,
                      1.32 + (1.27 - 1.32) / 0.02 * (beta - 0.10))
        Cd = np.where(beta <= 0.10,
                      1.38 + (1.32 - 1.38) / 0.02 * (beta - 0.08), Cd)
        Cd = np.where(beta <= 0.08,
                      1.44 + (1.38 - 1.44) / 0.02 * (beta - 0.06), Cd)
        Cd = np.where(beta <= 0.06,
                      1.50 + (1.44 - 1.50) / 0.01 * (beta - 0.05), Cd)
        kwargs["water_drag_coeff"] = Cd
        if "orientation" not in kwargs:
            oc = self.get_config("seed:orientation")
            if oc == "left":
                kwargs["orientation"] = np.zeros(num)
            elif oc == "right":
                kwargs["orientation"] = np.ones(num)
            else:
                kwargs["orientation"] = (np.arange(num) % 2).astype(float)
        return super().seed_elements(*args, **kwargs)

    # ---------------------------------------------------------- physics ---
    def _spectrum_tables(self, device):
        """The bins' omegas and their omega-axis lookups (host constants:
        every element shares them), and the tables on ``device``."""
        if self._tables is None or self._tables["device"] != device:
            dom = (OMMAX - OMMIN2) / (NSPEC - 1)
            om = torch.arange(NSPEC, dtype=torch.float32)
            om = OMMIN2 + dom * om
            oi, ow = _axis_weights(torch.as_tensor(self._omega_ax), om)

            def dev(a):
                return torch.as_tensor(a, device=device)
            self._tables = {
                "device": device, "dom": dom, "om": om.tolist(),
                "oi": oi.tolist(), "ow": ow.tolist(),
                "F": dev(self._F_table), "D": dev(self._D_table),
                "dl_ax": dev(self._dl_ax), "bl_ax": dev(self._bl_ax)}
        return self._tables

    def _wave_force(self, length, dl, bl, Tm, Hs):
        """Wave drift force and damping summed over the spectrum
        (reference shipdrift.py:232-276), one bin at a time."""
        tb = self._spectrum_tables(length.device)
        dom = tb["dom"]
        scale1 = torch.sqrt(rdiv(G, length))
        tmp = _pow4(rdiv(2.0 * math.pi, torch.clamp_min(Tm, 0.1)))
        dcoef = tmp * Hs * Hs / (4.0 * math.pi)
        bcoef = tmp / math.pi
        # (draft/length, beam/length) corners: shared by every bin
        di, dw = _axis_weights(tb["dl_ax"], dl)
        bi, bw = _axis_weights(tb["bl_ax"], bl)
        nb = tb["F"].shape[2]
        corners = []
        for dd, wd in ((0, 1.0 - dw), (1, dw)):
            for db, wb in ((0, 1.0 - bw), (1, bw)):
                corners.append(((di + dd) * nb + (bi + db), wd, wb))
        F_wave = beta2 = None
        f32 = np.float32
        f_prev = d_prev = f32(0.0)
        for k in range(NSPEC):
            om = tb["om"][k]
            omi = om * scale1
            p4 = _pow4(omi)
            s = dcoef * torch.exp(-bcoef / p4) / (omi * p4)
            if om < OMMIN3:
                oi, ow = tb["oi"][k], tb["ow"][k]
                fv = dv = 0.0
                for do, wo in ((0, 1.0 - ow), (1, ow)):
                    F_o = tb["F"][oi + do].reshape(-1)
                    D_o = tb["D"][oi + do].reshape(-1)
                    for flat, wd, wb in corners:
                        fv = fv + F_o[flat] * wo * wd * wb
                        dv = dv + D_o[flat] * wo * wd * wb
            else:
                # float32 scalars, so the pair rounds as the JAX arrays do
                fv, dv = f32(0.5), f32(4.0) * f32(om) * f32(0.5)
            s2 = s * s
            f_term = 0.5 * (f_prev + fv) * dom * scale1 * s2
            d_term = 0.5 * (d_prev + dv) * dom * scale1 * s2
            F_wave = f_term if F_wave is None else F_wave + f_term
            beta2 = d_term if beta2 is None else beta2 + d_term
            f_prev, d_prev = fv, dv
        return F_wave * RHO_WATER * G * length, \
            beta2 * RHO_WATER * torch.sqrt(G * length)

    def update(self, ctx):
        """(reference shipdrift.py:213-330)."""
        d = ctx.state.data
        env = ctx.environment
        Tm = ctx.wave_period()
        Hs = ctx.significant_wave_height()
        bl = torch.clamp(d["beam"] / d["length"], 0.121, 0.179)
        dl = torch.clamp(d["draft"] / d["length"], 0.0251, 0.069)

        ctx.update_positions(env["x_sea_water_velocity"],
                             env["y_sea_water_velocity"])

        wind_speed = ctx.wind_speed()
        area_dry = d["length"] * (d["height"] - d["draft"])
        area_wet = d["length"] * d["draft"]
        F_wind = 0.5 * RHO_AIR * d["wind_drag_coeff"] * area_dry \
            * (wind_speed * wind_speed)
        calm = wind_speed == 0
        safe_ws = torch.where(calm, 1.0, wind_speed)
        F_wind_x = torch.where(calm, 0.0, F_wind * env["x_wind"] / safe_ws)
        F_wind_y = torch.where(calm, 0.0, F_wind * env["y_wind"] / safe_ws)

        F_wave, beta2 = self._wave_force(d["length"], dl, bl, Tm, Hs)

        # period-dependent reduction (reference shipdrift.py:278-288)
        long_period = Tm > 8.55
        F_wave = torch.where(long_period, F_wave * 0.66, F_wave)
        beta2 = torch.where(long_period, beta2 * 0.60, beta2)
        med = (Tm >= 5.7) & (Tm <= 8.55)
        F_wave = torch.where(med, F_wave * (1.0 - 0.34 * (Tm - 5.7) / 2.85),
                             F_wave)
        beta2 = torch.where(med, beta2 * (1.0 - 0.4 * (Tm - 5.7) / 2.85),
                            beta2)

        beta1 = 0.5 * RHO_WATER * d["water_drag_coeff"] * area_wet

        offset = -self.winwav_angle * 2.0 * (d["orientation"] - 0.5)
        su = env["sea_surface_wave_stokes_drift_x_velocity"]
        sv = env["sea_surface_wave_stokes_drift_y_velocity"]
        have_stokes = (torch.abs(gathered(su)).max()
                       + torch.abs(gathered(sv)).max()) > 0
        wave_dir = torch.deg2rad(offset) + torch.where(
            have_stokes, torch.atan2(sv, su),
            torch.atan2(env["y_wind"], env["x_wind"]))
        cos_dir = torch.cos(wave_dir)
        sin_dir = torch.sin(wave_dir)
        F_wave_x = F_wave * cos_dir
        F_wave_y = F_wave * sin_dir
        fx = F_wind_x + F_wave_x
        fy = F_wind_y + F_wave_y
        F_total = torch.sqrt(fx * fx + fy * fy)

        # fixed-point iteration for damping and form drag
        # (reference shipdrift.py:292-311)
        uw_tot = torch.zeros_like(F_total)
        uw_dir = torch.zeros_like(F_total)
        safe_beta1 = torch.clamp_min(beta1, 1e-12)
        for _ in range(4):
            f2x = beta2 * uw_tot * cos_dir
            f2y = beta2 * uw_tot * sin_dir
            uw_dir = torch.atan2(fy - f2y, fx - f2x)
            bet2c = beta2 * torch.cos(wave_dir - uw_dir)
            uw_tot = (-bet2c / (2.0 * safe_beta1)
                      + torch.sqrt(bet2c * bet2c + 4.0 * safe_beta1 * F_total)
                      / (2.0 * safe_beta1))

        ctx.update_positions(uw_tot * torch.cos(uw_dir),
                             uw_tot * torch.sin(uw_dir))
        # horizontal diffusion and stranding are applied by the base step
