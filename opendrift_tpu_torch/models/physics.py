"""Physics methods operating on the step context.

Port of ``opendrift_tpu/models/physics.py`` (reference:
opendrift/models/physics_methods.py:570-848): a mixin of ``StepContext``
whose methods transform the element state with torch.  The RK stage
refetches sample the same device field providers at displaced positions
and times, or, with ``drift:advection_single_fetch``, re-evaluate one
corner block gathered once a step.
"""

import numpy as np
import torch

from ..ops import physics as ph
from ..parallel.mesh import gathered
from ..utils.geodesic import geodesic_step_fast
from ..utils.xp import tnp


class PhysicsContext:
    """Mixin for StepContext — see models/base.py for the attribute set."""

    # ------------------------------------------------------- advection ----
    def advect_ocean_current(self, factor=1.0):
        """Euler / RK2 / RK4 current advection
        (reference physics_methods.py:611-691).

        NB: the reference's 'runge-kutta4' displaces stage 4 by only
        speed3*dt/2 while sampling at t+dt (physics_methods.py:662-666);
        that quirk is reproduced verbatim for trajectory parity.
        """
        d = self.state.data
        scheme = self.sim.get_config("drift:advection_scheme")
        dt = self.params["dt"]
        if "current_drift_factor" in d:
            factor = factor * d["current_drift_factor"]
        u = self.environment["x_sea_water_velocity"]
        v = self.environment["y_sea_water_velocity"]
        if scheme == "euler":
            self.update_positions(factor * u, factor * v)
            return
        # single-fetch RK (opt-in): gather the u/v corner block once and
        # evaluate every stage against it.  Stage displacements are
        # normally well under one grid cell (|u| dt/2 << dx), where this is
        # exact; beyond one cell the block evaluation clamps.
        block_ctx = None
        if self.sim.get_config("drift:advection_single_fetch",
                               default=False):
            # prefer the block already gathered for the step's env fetch
            # (models/base.py pre_update): it was gathered at the
            # pre-coastline positions; for the few relocated elements the
            # stage evaluation clamps to that cell
            block_ctx = self.uv_block_ctx
            if block_ctx is None:
                idx = self.sim.env.uv_block_plan_index()
                if idx is not None:
                    reader = self.sim.env._plan[idx][0]
                    dev_state = self.dev_states[idx]
                    member = d["ID"] if getattr(
                        reader, "ensemble_size", 1) > 1 else None
                    block, covers0 = reader.uv_corner_block(
                        dev_state, d["lon"], d["lat"], d["z"], member=member)
                    block_ctx = (reader, dev_state, block, covers0)

        def stage(uvel, vvel, dist_frac, t_frac):
            lat_s, lon_s = geodesic_step_fast(tnp, d["lat"], d["lon"], uvel,
                                              vvel, dt * dist_frac)
            t_s = np.float32(self.t_rel) + dt * t_frac
            if block_ctx is not None:
                reader, dev_state, block, covers0 = block_ctx
                u_s, v_s = reader.uv_from_block(dev_state, block, t_s, lon_s,
                                                lat_s)
                # outside the primary reader: hold the priority-merged
                # start velocities (fallback semantics)
                return (torch.where(covers0, u_s, uvel),
                        torch.where(covers0, v_s, vvel))
            env = self.get_environment(
                ["x_sea_water_velocity", "y_sea_water_velocity"], t_s, lon_s,
                lat_s, d["z"])
            return env["x_sea_water_velocity"], env["y_sea_water_velocity"]

        u2, v2 = stage(u, v, 0.5, 0.5)
        if scheme == "runge-kutta":
            self.update_positions(factor * u2, factor * v2)
            return
        if scheme == "runge-kutta4":
            u3, v3 = stage(u2, v2, 0.5, 0.5)
            u4, v4 = stage(u3, v3, 0.5, 1.0)
            uu = (u + 2.0 * u2 + 2.0 * u3 + u4) / 6.0
            vv = (v + 2.0 * v2 + 2.0 * v3 + v4) / 6.0
            self.update_positions(factor * uu, factor * vv)
            return
        raise ValueError(f"Unknown advection scheme: {scheme}")

    def advect_wind(self, factor=1.0):
        """Windage with linear decay to ``drift:wind_drift_depth``
        (reference physics_methods.py:712-791)."""
        d = self.state.data
        if "x_wind" not in self.environment:
            return
        wdf = d.get("wind_drift_factor", torch.zeros_like(d["lon"]))
        z = d["z"]
        depth = self.sim.get_config("drift:wind_drift_depth", default=0.0)
        if depth in (None, 0.0) or depth == 0:
            wdf_eff = torch.where(z >= 0.0, wdf, 0.0)
        else:
            depth = abs(float(depth))
            decayed = wdf * (depth + z) / depth
            wdf_eff = torch.where(z > 0.0, wdf, decayed)
            wdf_eff = torch.where(z >= -depth, wdf_eff, 0.0)
        x_wind = self.environment["x_wind"]
        y_wind = self.environment["y_wind"]
        if self.sim.get_config("drift:relative_wind", default=False):
            x_wind = x_wind - self.environment["x_sea_water_velocity"]
            y_wind = y_wind - self.environment["y_sea_water_velocity"]
        self.update_positions(x_wind * wdf_eff * factor,
                              y_wind * wdf_eff * factor)

    def advect_with_sea_ice(self, factor=1.0):
        """Advect with sea-ice velocity, or the Nordam rule-of-thumb
        (current + 0.015*wind) when ice velocity is unavailable
        (reference physics_methods.py:693-710)."""
        if "sea_ice_x_velocity" in self.environment:
            self.update_positions(
                factor * self.environment["sea_ice_x_velocity"],
                factor * self.environment["sea_ice_y_velocity"])
        elif "x_sea_water_velocity" in self.environment:
            u = self.environment["x_sea_water_velocity"] + \
                0.015 * self.environment.get("x_wind", 0.0)
            v = self.environment["y_sea_water_velocity"] + \
                0.015 * self.environment.get("y_wind", 0.0)
            self.update_positions(factor * u, factor * v)

    def stokes_drift(self, factor=1.0):
        """Stokes drift with configurable vertical profile
        (reference physics_methods.py:793-848)."""
        if not self.sim.get_config("drift:stokes_drift", default=False):
            return
        if "sea_surface_wave_stokes_drift_x_velocity" not in self.environment:
            return
        su = self.environment["sea_surface_wave_stokes_drift_x_velocity"]
        sv = self.environment["sea_surface_wave_stokes_drift_y_velocity"]
        # fetch-tabulated Stokes drift from wind where no wave model data
        # (reference environment.py:844-863)
        if self.sim.get_config("drift:use_tabularised_stokes_drift",
                               default=False):
            fetch = self.sim.get_config(
                "drift:tabularised_stokes_drift_fetch", default="25000")
            wx = self.environment.get("x_wind", torch.zeros_like(su))
            wy = self.environment.get("y_wind", torch.zeros_like(sv))
            pu, pv = ph.wave_stokes_drift_parameterised(wx, wy, fetch)
            missing = (su == 0.0) & (sv == 0.0)
            su = torch.where(missing, pu, su)
            sv = torch.where(missing, pv, sv)
            # the reference's environment hook also injects the tabulated
            # Hs where no wave model serves it (environment.py:858-864), so
            # the profile's decay scale comes from the same table
            env_hs = self.environment.get(
                "sea_surface_wave_significant_height", torch.zeros_like(su))
            hs_param = ph.wave_significant_height_parameterised(wx, wy, fetch)
            self.environment["sea_surface_wave_significant_height"] = \
                torch.where(env_hs == 0.0, hs_param, env_hs)
        hs = self.significant_wave_height()
        tp = self.wave_period()
        hs = torch.where(hs <= 0.0, 1.0, hs)
        tp = torch.where(tp <= 0.0, 8.0, tp)
        z = self.state.data["z"]
        profile = self.sim.get_config("drift:stokes_drift_profile",
                                      default="monochromatic")
        if profile == "monochromatic":
            u, v, _ = ph.stokes_drift_profile_monochromatic(su, sv, hs, tp, z)
        elif profile == "exponential":
            u, v, _ = ph.stokes_drift_profile_exponential(su, sv, hs, tp, z)
        elif profile == "Phillips":
            u, v, _ = ph.stokes_drift_profile_phillips(su, sv, hs, tp, z)
        elif profile == "windsea_swell":
            e = self.environment
            u, v, _ = ph.stokes_drift_profile_windsea_swell(
                su, sv,
                e["sea_surface_swell_wave_to_direction"],
                e["sea_surface_swell_wave_peak_period_from_variance_spectral_density"],
                e["sea_surface_swell_wave_significant_height"],
                e["sea_surface_wind_wave_to_direction"],
                e["sea_surface_wind_wave_mean_period"],
                e["sea_surface_wind_wave_significant_height"], z)
        else:
            raise ValueError(f"Unknown Stokes profile: {profile}")
        self.update_positions(u * factor, v * factor)

    # ------------------------------------------------------ derived env ---
    def wind_speed(self):
        if "x_wind" not in self.environment:
            return torch.zeros_like(self.state.data["lon"])
        xw = self.environment["x_wind"]
        yw = self.environment["y_wind"]
        return torch.sqrt(xw * xw + yw * yw)

    def current_speed(self):
        u = self.environment["x_sea_water_velocity"]
        v = self.environment["y_sea_water_velocity"]
        return torch.sqrt(u * u + v * v)

    def significant_wave_height(self):
        """(reference physics_methods.py:893-906)."""
        hs = self.environment.get("sea_surface_wave_significant_height")
        wind_hs = ph.significant_wave_height_from_wind(self.wind_speed())
        if hs is None:
            return wind_hs
        return torch.where(gathered(hs).max() > 0, hs, wind_hs)

    def wave_from_direction(self):
        """Wave FROM direction [deg]; with no wave field (an all-zero
        sample, i.e. fallback-only forcing) the wind's direction
        (reference physics_methods.py:869-875)."""
        wd = self.environment.get("sea_surface_wave_from_direction")
        wind_to = torch.rad2deg(torch.atan2(self.environment["x_wind"],
                                            self.environment["y_wind"]))
        wind_from = torch.remainder(wind_to + 180.0, 360.0)
        if wd is None:
            return wind_from
        return torch.where(torch.abs(gathered(wd)).max() > 0, wd, wind_from)

    def wave_period(self):
        """(reference physics_methods.py:918-944): prefer Tm02, then Tp,
        else Pierson-Moskowitz from wind."""
        e = self.environment
        tm02 = e.get("sea_surface_wave_mean_period_from_variance_spectral_"
                     "density_second_frequency_moment")
        tp = e.get("sea_surface_wave_period_at_variance_spectral_density_"
                   "maximum")
        T = ph.wave_period_from_wind(self.wind_speed())
        if tp is not None:
            T = torch.where(gathered(tp).max() > 0, tp, T)
        if tm02 is not None:
            T = torch.where(gathered(tm02).max() > 0, tm02, T)
        return T

    def sea_water_density(self):
        T = self.environment.get("sea_water_temperature", 10.0)
        S = self.environment.get("sea_water_salinity", 34.0)
        return ph.sea_water_density(T, S)

    def sea_surface_height(self):
        return self.environment.get(
            "sea_surface_height", torch.zeros_like(self.state.data["lon"]))
