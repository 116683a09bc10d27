"""OpenBerg: iceberg drift with full force balance, melting and rollover.

Port of ``opendrift_tpu/models/openberg.py`` (reference:
opendrift/models/openberg.py:45-630).  The momentum ODE dV/dt = (F_ocean +
F_wind + F_wave + F_coriolis + F_slope + F_ice)/m, which the reference
integrates each step with scipy ``solve_ivp`` (openberg.py:540-552), is
integrated on the device with 20 fixed RK2 (midpoint) substeps, as the JAX
package's ``fori_loop`` does; melting (wave erosion, lateral, basal),
grounding and the Wagner rollover criterion are elementwise.  In eager
PyTorch the force balance is a Python loop of some 600 small operations a
step.
"""

import math

import numpy as np
import torch

from ..config import CONFIG_LEVEL_BASIC
from ..elements import LagrangianArray
from .base import OpenDriftSimulation

RHO_WATER = 1027.0
RHO_AIR = 1.293
RHO_ICE = 917.0
RHO_ICEB = 900.0
G = 9.81
OMEGA = 7.2921e-5
CSI = 1.0
N_SUBSTEPS = 20


class IcebergObj(LagrangianArray):
    """(reference openberg.py:45-100)."""

    variables = LagrangianArray.add_variables([
        ("sail", {"dtype": np.float32, "units": "m", "default": 10.0,
                  "description": "Height above waterline"}),
        ("draft", {"dtype": np.float32, "units": "m", "default": 90.0,
                   "description": "Depth below waterline"}),
        ("length", {"dtype": np.float32, "units": "m", "default": 100.0}),
        ("width", {"dtype": np.float32, "units": "m", "default": 30.0}),
        ("weight_coef", {"dtype": np.float32, "units": "1", "default": 1.0}),
        ("water_form_drag_coef", {"dtype": np.float32, "units": "1",
                                  "default": 0.25}),
        ("water_skin_drag_coef", {"dtype": np.float32, "units": "1",
                                  "default": 0.0055}),
        ("wind_form_drag_coef", {"dtype": np.float32, "units": "1",
                                 "default": 0.8}),
        ("wind_skin_drag_coef", {"dtype": np.float32, "units": "1",
                                 "default": 0.0022}),
        ("wave_drag_coef", {"dtype": np.float32, "units": "1",
                            "default": 0.3}),
        ("iceb_x_velocity", {"dtype": np.float32, "units": "m/s",
                             "seed": False, "default": 0.0}),
        ("iceb_y_velocity", {"dtype": np.float32, "units": "m/s",
                             "seed": False, "default": 0.0}),
    ])


class OpenBerg(OpenDriftSimulation):
    """Iceberg drift model (reference openberg.py:293)."""

    ElementType = IcebergObj

    required_variables = {
        "x_sea_water_velocity": {"fallback": None, "profiles": True},
        "y_sea_water_velocity": {"fallback": None, "profiles": True},
        "sea_floor_depth_below_sea_level": {"fallback": 10000},
        "sea_surface_height": {"fallback": 0},
        "sea_surface_x_slope": {"fallback": 0},
        "sea_surface_y_slope": {"fallback": 0},
        "x_wind": {"fallback": None},
        "y_wind": {"fallback": None},
        "horizontal_diffusivity": {"fallback": 100},
        "sea_surface_wave_significant_height": {"fallback": 0},
        "sea_surface_wave_from_direction": {"fallback": 0},
        "sea_surface_wave_stokes_drift_x_velocity": {"fallback": 0},
        "sea_surface_wave_stokes_drift_y_velocity": {"fallback": 0},
        "sea_water_temperature": {"fallback": 2, "profiles": True},
        "sea_water_salinity": {"fallback": 35, "profiles": True},
        "sea_ice_area_fraction": {"fallback": 0},
        "sea_ice_thickness": {"fallback": 0},
        "sea_ice_x_velocity": {"fallback": 0},
        "sea_ice_y_velocity": {"fallback": 0},
        "land_binary_mask": {"fallback": None},
    }

    def add_config(self):
        self._add_config({
            "drift:wave_rad": {"type": "bool", "default": True,
                               "level": CONFIG_LEVEL_BASIC,
                               "description": "Add wave radiation force"},
            "drift:stokes_drift": {"type": "bool", "default": False,
                                   "level": CONFIG_LEVEL_BASIC,
                                   "description": "Add Stokes drift to the "
                                   "water velocity"},
            "drift:coriolis": {"type": "bool", "default": True,
                               "level": CONFIG_LEVEL_BASIC,
                               "description": "Add Coriolis force"},
            "drift:sea_surface_slope": {"type": "bool", "default": False,
                                        "level": CONFIG_LEVEL_BASIC,
                                        "description": "Add sea-surface "
                                        "slope force"},
            "drift:vertical_profile": {"type": "bool", "default": False,
                                       "level": CONFIG_LEVEL_BASIC,
                                       "description": "Use depth-integrated "
                                       "currents over the draft"},
            "processes:grounding": {"type": "bool", "default": True,
                                    "level": CONFIG_LEVEL_BASIC,
                                    "description": "Ground icebergs whose "
                                    "draft exceeds the water depth"},
            "processes:roll_over": {"type": "bool", "default": True,
                                    "level": CONFIG_LEVEL_BASIC,
                                    "description": "Wagner (2017) rollover "
                                    "stability criterion"},
            "processes:melting": {"type": "bool", "default": False,
                                  "level": CONFIG_LEVEL_BASIC,
                                  "description": "Enable melting"},
            "melting:wave": {"type": "bool", "default": True,
                             "level": CONFIG_LEVEL_BASIC,
                             "description": "Wave-erosion melting"},
            "melting:lateral": {"type": "bool", "default": True,
                                "level": CONFIG_LEVEL_BASIC,
                                "description": "Lateral melting"},
            "melting:basal": {"type": "bool", "default": True,
                              "level": CONFIG_LEVEL_BASIC,
                              "description": "Basal (forced convection) "
                              "melting"},
        })

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.register_status("melted")
        self.register_status("grounded")

    required_profiles_z_range = [-300.0, 0.0]

    # ------------------------------------------------------------ update --
    def update(self, ctx):
        """(reference openberg.py:625-630)."""
        self.roll_over(ctx)
        self.melt(ctx)
        self.advect_iceberg(ctx)

    # ------------------------------------------------------------ physics -
    def advect_iceberg(self, ctx):
        """Force-balance advection (reference openberg.py:429-560)."""
        d = ctx.state.data
        env = ctx.environment
        dt = ctx.params["dt"]

        sail, draft = d["sail"], d["draft"]
        length, width = d["length"], d["width"]
        Avo = length * draft
        Aho = width * length
        Ava = length * sail
        Aha = width * length
        Ai = env["sea_ice_thickness"] * length
        mass = width * (Ava + Avo) * RHO_ICEB * d["weight_coef"]
        mass = torch.clamp_min(mass, 1.0)

        if self.get_config("drift:vertical_profile") and ctx.profiles:
            # depth-integrated mean current over the draft
            zlev = torch.as_tensor(ctx.zlevels, device=draft.device)
            within = (-zlev)[:, None] < draft[None, :]
            w = within.to(torch.float32)
            denom = torch.clamp_min(w.sum(dim=0), 1.0)
            wu = (ctx.profiles["x_sea_water_velocity"] * w).sum(dim=0) / denom
            wv = (ctx.profiles["y_sea_water_velocity"] * w).sum(dim=0) / denom
        else:
            wu = env["x_sea_water_velocity"]
            wv = env["y_sea_water_velocity"]
        if self.get_config("drift:stokes_drift"):
            wu = wu + env["sea_surface_wave_stokes_drift_x_velocity"]
            wv = wv + env["sea_surface_wave_stokes_drift_y_velocity"]
        ax_wind = env["x_wind"]
        ay_wind = env["y_wind"]
        ice_u = env["sea_ice_x_velocity"]
        ice_v = env["sea_ice_y_velocity"]
        ice_conc = env["sea_ice_area_fraction"]
        hs = env["sea_surface_wave_significant_height"]
        # no wave field: the direction follows the wind (reference
        # physics_methods.py:869-875)
        wave_dir_to = torch.remainder(ctx.wave_from_direction() + 180.0,
                                      360.0)

        drag_ocean = 0.5 * RHO_WATER * d["water_form_drag_coef"] * Avo \
            + RHO_WATER * d["water_skin_drag_coef"] * Aho
        drag_wind = 0.5 * RHO_AIR * d["wind_form_drag_coef"] * Ava \
            + RHO_AIR * d["wind_skin_drag_coef"] * Aha
        f_cor = 2.0 * OMEGA * torch.sin(torch.deg2rad(d["lat"]))
        half_hs = hs / 2.0
        wave_on = 1.0 if self.get_config("drift:wave_rad") else 0.0
        wave_rad = 0.25 * RHO_WATER * d["wave_drag_coef"] * G * length \
            * (half_hs * half_hs)
        wave_rad_x = wave_rad * torch.sin(torch.deg2rad(wave_dir_to)) \
            * wave_on
        wave_rad_y = wave_rad * torch.cos(torch.deg2rad(wave_dir_to)) \
            * wave_on
        use_cor = self.get_config("drift:coriolis")
        slope_on = 1.0 if self.get_config("drift:sea_surface_slope") else 0.0
        slope_fx = -mass * G * env["sea_surface_x_slope"] * slope_on
        slope_fy = mass * G * env["sea_surface_y_slope"] * slope_on
        no_ice = ice_conc <= 0.15
        locked = ice_conc >= 0.9

        def accel(vx, vy):
            ru = wu - vx
            rv = wv - vy
            rn = torch.sqrt(ru * ru + rv * rv)
            fx = drag_ocean * rn * ru
            fy = drag_ocean * rn * rv
            au = ax_wind - vx
            av = ay_wind - vy
            an = torch.sqrt(au * au + av * av)
            fx = fx + drag_wind * an * au
            fy = fy + drag_wind * an * av
            fx = fx + wave_rad_x + slope_fx
            fy = fy + wave_rad_y + slope_fy
            if use_cor:
                fx = fx + mass * f_cor * vy
                fy = fy - mass * f_cor * vx
            # sea-ice force (reference openberg.py:185-210)
            iu = ice_u - vx
            iv = ice_v - vy
            inorm = torch.sqrt(iu * iu + iv * iv)
            f_ice_x = 0.5 * RHO_ICE * CSI * Ai * inorm * iu
            f_ice_y = 0.5 * RHO_ICE * CSI * Ai * inorm * iv
            f_ice_x = torch.where(no_ice, 0.0, f_ice_x)
            f_ice_y = torch.where(no_ice, 0.0, f_ice_y)
            # locked in at >= 90% concentration: the ice cancels the rest
            f_ice_x = torch.where(locked, -fx, f_ice_x)
            f_ice_y = torch.where(locked, -fy, f_ice_y)
            return (fx + f_ice_x) / mass, (fy + f_ice_y) / mass

        # initial velocity: the no-acceleration analytic solution
        # (reference openberg.py:165-182)
        k = (RHO_AIR * d["wind_form_drag_coef"] * Ava) / torch.clamp_min(
            RHO_WATER * d["water_form_drag_coef"] * Avo, 1e-9)
        fwd = torch.sqrt(k) / (1.0 + torch.sqrt(k))
        v0x = (1.0 - fwd) * wu + fwd * ax_wind
        v0y = (1.0 - fwd) * wv + fwd * ay_wind
        vx = torch.where(locked, ice_u, v0x)
        vy = torch.where(locked, ice_v, v0y)

        # grounding / degrounding (reference openberg.py:525-545)
        if self.get_config("processes:grounding"):
            depth_eff = env["sea_floor_depth_below_sea_level"] \
                + env["sea_surface_height"]
            grounded = draft >= depth_eff
            moving = torch.where(grounded, 0.0, torch.where(
                d["moving"] == 0.0, 1.0, d["moving"]))
            ctx.set_var("moving", moving)
        else:
            grounded = torch.zeros_like(vx, dtype=torch.bool)

        # dV/dt by fixed-substep RK2 (midpoint)
        h = dt / N_SUBSTEPS
        for _ in range(N_SUBSTEPS):
            ax1, ay1 = accel(vx, vy)
            ax2, ay2 = accel(vx + 0.5 * h * ax1, vy + 0.5 * h * ay1)
            vx, vy = vx + h * ax2, vy + h * ay2
        vx = torch.where(grounded, 0.0, vx)
        vy = torch.where(grounded, 0.0, vy)
        ctx.set_var("iceb_x_velocity", vx)
        ctx.set_var("iceb_y_velocity", vy)
        ctx.update_positions(vx, vy)

    def melt(self, ctx):
        """Wave-erosion, lateral and basal melting
        (reference openberg.py:240-290, 562-600)."""
        if not self.get_config("processes:melting"):
            return
        d = ctx.state.data
        env = ctx.environment
        dt = abs(ctx.params["dt"])
        length, width = d["length"], d["width"]
        sail, draft = d["sail"], d["draft"]
        T0 = env["sea_water_temperature"]
        S0 = env["sea_water_salinity"]
        ice_conc = env["sea_ice_area_fraction"]

        def freezing_point():
            TfS = -0.036 - 0.0499 * S0 - 0.000112 * (S0 * S0)
            return TfS * torch.exp(-0.19 * (T0 - TfS))

        if self.get_config("melting:wave"):
            wind = ctx.wind_speed()
            Ss = -5.0 + torch.sqrt(32.0 + 2.0 * wind)
            Vsst = (1.0 / 6.0) * (T0 + 2.0) * Ss
            Vwe = Vsst * 0.5 * (1.0 + torch.cos(
                math.pi * (ice_conc * (ice_conc * ice_conc)))) / 86400.0
            new_len = torch.clamp_min(length - Vwe * dt, 0.0)
            width = torch.where(length > 0, width / torch.clamp_min(
                length, 1e-6) * new_len, 0.0)
            length = new_len
        if self.get_config("melting:lateral"):
            deltaT = T0 - freezing_point()
            sumVb = 2.78 * deltaT + 0.47 * (deltaT * deltaT)
            dx = sumVb / 365.0 / 86400.0 * dt
            new_len = torch.clamp_min(length - 2.0 * dx, 0.0)
            width = torch.where(length > 0, width / torch.clamp_min(
                length, 1e-6) * new_len, 0.0)
            length = new_len
        if self.get_config("melting:basal"):
            du = env["x_sea_water_velocity"] - d["iceb_x_velocity"]
            dv = env["y_sea_water_velocity"] - d["iceb_y_velocity"]
            absv = torch.sqrt(du * du + dv * dv)
            Vf = 0.58 * torch.pow(absv, 0.8) * (T0 - freezing_point()) \
                / torch.pow(torch.clamp_min(length, 1e-6), 0.2) / 86400.0
            draft = torch.clamp_min(torch.abs(draft) - Vf * dt, 0.0)

        ctx.set_var("length", length)
        ctx.set_var("width", width)
        ctx.set_var("draft", draft)
        ctx.set_var("sail", sail)
        melted = (draft < 1.0) | (length < 1.0) | (width < 1.0) \
            | (sail < 1.0)
        ctx.deactivate_elements(melted, "melted")

    def roll_over(self, ctx):
        """Wagner et al. (2017) stability (reference openberg.py:601-624)."""
        if not self.get_config("processes:roll_over"):
            return
        d = ctx.state.data
        L0, W0 = d["length"], d["width"]
        H = d["draft"] + d["sail"]
        alpha = RHO_ICEB / RHO_WATER
        crit = float(np.sqrt(6.0 * alpha * (1.0 - alpha)))
        W = torch.minimum(L0, W0)
        L = torch.maximum(L0, W0)
        unstable = (W / torch.clamp_min(H, 1e-6)) < crit
        L2 = torch.where(unstable, torch.maximum(L, H), L)
        H2 = torch.where(unstable, W, H)
        W2 = torch.where(unstable, torch.minimum(L, H), W)
        draft = H2 * alpha
        ctx.set_var("length", L2)
        ctx.set_var("width", W2)
        ctx.set_var("sail", H2 - draft)
        ctx.set_var("draft", draft)
