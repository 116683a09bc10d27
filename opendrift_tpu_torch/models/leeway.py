"""Leeway: search-and-rescue drift of 85 object classes.

Port of ``opendrift_tpu/models/leeway.py`` (reference:
opendrift/models/leeway.py:50-615): objects drift downwind and crosswind
of the 10 m wind by empirical slope/offset coefficients (Allen & Plourde,
USCG; the port's copy of ``leeway_objects.json``), with per-element
gaussian coefficient perturbations drawn on the host at seeding (the same
``self._np_random`` draws, in the same order, as the JAX package), random
left/right orientation, a Markov jibing process and optional irreversible
capsizing (two threefry uniform draws a step, ``rng.uniform``).
"""

import json
import os

import numpy as np
import torch

from .. import rng
from ..config import CONFIG_LEVEL_ESSENTIAL, CONFIG_LEVEL_BASIC, \
    CONFIG_LEVEL_ADVANCED
from ..elements import LagrangianArray
from ..utils.plotting import pyplot
from .base import OpenDriftSimulation

RIGHT = 0
LEFT = 1


def load_object_classes():
    path = os.path.join(os.path.dirname(__file__), "leeway_objects.json")
    with open(path) as f:
        return json.load(f)["objects"]


class LeewayObj(LagrangianArray):
    """(reference leeway.py:50-131)."""

    variables = LagrangianArray.add_variables([
        ("object_type", {"dtype": np.int32, "units": "1", "seed": False,
                         "default": 0}),
        ("orientation", {"dtype": np.float32, "units": "1", "seed": False,
                         "default": 1.0,
                         "description": "0/1 is right/left of downwind"}),
        ("jibe_probability", {"dtype": np.float32, "units": "1/h",
                              "default": 0.04,
                              "description": "Probability per hour that "
                              "an object changes orientation (jibing)"}),
        ("capsized", {"dtype": np.float32, "units": "1", "default": 0.0}),
        ("downwind_slope", {"dtype": np.float32, "units": "%",
                            "seed": False, "default": 1.0}),
        ("crosswind_slope", {"dtype": np.float32, "units": "1",
                             "seed": False, "default": 1.0}),
        ("downwind_offset", {"dtype": np.float32, "units": "cm/s",
                             "seed": False, "default": 0.0}),
        ("crosswind_offset", {"dtype": np.float32, "units": "cm/s",
                              "seed": False, "default": 0.0}),
        ("downwind_eps", {"dtype": np.float32, "units": "cm/s",
                          "seed": False, "default": 0.0}),
        ("crosswind_eps", {"dtype": np.float32, "units": "cm/s",
                           "seed": False, "default": 0.0}),
        ("current_drift_factor", {"dtype": np.float32, "units": "1",
                                  "default": 1.0}),
    ])


class Leeway(OpenDriftSimulation):
    """Search-and-rescue leeway drift model (reference leeway.py:134)."""

    ElementType = LeewayObj

    required_variables = {
        "x_wind": {"fallback": None},
        "y_wind": {"fallback": None},
        "x_sea_water_velocity": {"fallback": None},
        "y_sea_water_velocity": {"fallback": None},
        "sea_surface_wave_stokes_drift_x_velocity": {
            "fallback": 0, "skip_if": ["drift:stokes_drift", "is", False]},
        "sea_surface_wave_stokes_drift_y_velocity": {
            "fallback": 0, "skip_if": ["drift:stokes_drift", "is", False]},
        "land_binary_mask": {"fallback": None},
    }

    def __init__(self, *args, **kwargs):
        self.leewayprop = {i + 1: obj for i, obj in
                           enumerate(load_object_classes())}
        super().__init__(*args, **kwargs)
        descriptions = [p["description"] for p in self.leewayprop.values()]
        self._add_config({
            "seed:object_type": {
                "type": "enum", "enum": descriptions,
                "default": descriptions[0],
                "level": CONFIG_LEVEL_ESSENTIAL,
                "description": "Leeway object category for this simulation"},
            "processes:capsizing": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_BASIC,
                "description": "Allow capsizing in high winds"},
            "capsizing:leeway_fraction": {
                "type": "float", "default": 0.4, "min": 0, "max": 1,
                "level": CONFIG_LEVEL_BASIC,
                "description": "Leeway coefficient multiplier after "
                "capsizing"},
            "capsizing:wind_threshold": {
                "type": "float", "default": 30.0, "min": 0, "max": 50,
                "units": "m/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Capsize probability per hour is "
                "0.5+0.5*tanh((U-threshold)/sigma)"},
            "capsizing:wind_threshold_sigma": {
                "type": "float", "default": 5.0, "min": 0, "max": 20,
                "units": "m/s", "level": CONFIG_LEVEL_BASIC,
                "description": "Sigma of the capsize probability curve"},
            "drift:stokes_drift": {
                "type": "bool", "default": False,
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Add explicit Stokes drift (classically "
                "considered implicit in leeway coefficients)"},
            "drift:stokes_drift_profile": {
                "type": "enum", "default": "monochromatic",
                "enum": ["monochromatic", "exponential", "Phillips",
                         "windsea_swell"],
                "level": CONFIG_LEVEL_ADVANCED,
                "description": "Stokes drift depth profile"},
        })
        self._set_config_default("general:time_step_minutes", 10)
        self._set_config_default("general:time_step_output_minutes", 60)
        self._set_config_default("drift:max_speed", 5)

    def object_type_by_name(self, name):
        for i, p in self.leewayprop.items():
            if p["key"] == name or p["description"] == name:
                return i
        raise ValueError(f"Leeway object '{name}' not available")

    def list_object_categories(self, substr=None):
        """(reference leeway.py:404-415)."""
        for i, p in self.leewayprop.items():
            if substr is not None and substr.lower() not in (
                    p["description"] + p["key"]).lower():
                continue
            print(f"{i} {p['key']} {p['description']}")

    # --------------------------------------------------------- seeding ----
    def seed_elements(self, lon, lat, object_type=None, **kwargs):
        """Seed leeway objects: per-element coefficient perturbations and
        alternating left/right orientation (reference leeway.py:293-400)."""
        lon = np.atleast_1d(lon).ravel()
        lat = np.atleast_1d(lat).ravel()
        number = kwargs.get("number")
        if number is None:
            number = len(lon) if len(lon) > 1 else \
                int(self.get_config("seed:number"))
        kwargs["number"] = number

        if object_type is None:
            object_type = self.object_type_by_name(
                self.get_config("seed:object_type"))
        props = self.leewayprop[int(object_type)]

        # odd elements drift left, even right (reference leeway.py:327-329)
        orientation = np.arange(number) % 2
        ones = np.ones(number)

        dw = props["downwind"]
        downwind_slope = ones * dw["slope"]
        downwind_offset = ones * dw["offset"]
        # rejection-sample perturbations: net downwind slope must be >= 0
        eps = self._np_random.randn(number) * dw["std"]
        for _ in range(100):
            bad = downwind_slope + eps / 20.0 < 0.0
            if not bad.any():
                break
            eps[bad] = self._np_random.randn(bad.sum()) * dw["std"]

        cwr, cwl = props["crosswind_right"], props["crosswind_left"]
        rcw = self._np_random.randn(number)
        right = orientation == RIGHT
        crosswind_slope = np.where(right, cwr["slope"], cwl["slope"])
        crosswind_offset = np.where(right, cwr["offset"], cwl["offset"])
        crosswind_eps = np.where(right, rcw * cwr["std"], rcw * cwl["std"])

        return super().seed_elements(
            lon, lat,
            orientation=orientation.astype(np.float32),
            object_type=np.full(number, object_type, dtype=np.int32),
            downwind_slope=downwind_slope,
            crosswind_slope=crosswind_slope,
            downwind_offset=downwind_offset,
            crosswind_offset=crosswind_offset,
            downwind_eps=eps,
            crosswind_eps=crosswind_eps,
            **kwargs)

    # ---------------------------------------------------------- physics ---
    def plot_capsize_probability(self, filename=None):
        """Capsize probability against wind speed (reference
        leeway.py:415), evaluated in float32 on the CPU."""
        plt = pyplot()
        U = np.linspace(0, 35, 100)
        thr = self.get_config("capsizing:wind_threshold")
        sigma = self.get_config("capsizing:wind_threshold_sigma")
        p = self.capsize_probability(
            torch.as_tensor(U, dtype=torch.float32), thr, sigma).numpy()
        fig, ax = plt.subplots()
        ax.plot(U, p)
        ax.set_title(f"p(u) = 0.5 + 0.5*tanh((u - {thr}) / {sigma})")
        ax.set_xlabel("Wind speed [m/s]")
        ax.set_ylabel("Probability of capsizing per hour")
        if filename:
            fig.savefig(filename, dpi=100)
            plt.close(fig)
        else:
            return fig

    @staticmethod
    def capsize_probability(wind, threshold, sigma):
        return 0.5 + 0.5 * torch.tanh((wind - threshold) / sigma)

    def update(self, ctx):
        """(reference leeway.py:430-494)."""
        d = ctx.state.data
        dt = ctx.params["dt"]
        x_wind = ctx.environment["x_wind"]
        y_wind = ctx.environment["y_wind"]
        windspeed = torch.sqrt(x_wind * x_wind + y_wind * y_wind)
        winddir = torch.atan2(x_wind, y_wind)
        shape = tuple(windspeed.shape)

        # capsizing (irreversible forward; reversed for backward runs)
        if self.get_config("processes:capsizing"):
            thr = self.get_config("capsizing:wind_threshold")
            sig = self.get_config("capsizing:wind_threshold_sigma")
            prob = self.capsize_probability(windspeed, thr, sig) \
                * abs(dt) / 3600.0
            draw = rng.uniform(ctx.next_key(), shape,
                               device=windspeed.device)
            if dt > 0:
                can = d["capsized"] == 0.0
            else:
                can = d["capsized"] == 1.0
            flip = can & (draw < prob)
            ctx.set_var("capsized", torch.where(flip, 1.0 - d["capsized"],
                                                d["capsized"]))
            d = ctx.state.data

        downwind = ((d["downwind_slope"] + d["downwind_eps"] / 20.0)
                    * windspeed + d["downwind_offset"]
                    + d["downwind_eps"] / 2.0) * 0.01
        crosswind = ((d["crosswind_slope"] + d["crosswind_eps"] / 20.0)
                     * windspeed + d["crosswind_offset"]
                     + d["crosswind_eps"] / 2.0) * 0.01
        sinth = torch.sin(winddir)
        costh = torch.cos(winddir)
        y_leeway = downwind * costh + crosswind * sinth
        x_leeway = -downwind * sinth + crosswind * costh
        frac = self.get_config("capsizing:leeway_fraction")
        reduce = torch.where(d["capsized"] == 1.0, frac, 1.0)
        ctx.update_positions(-x_leeway * reduce, y_leeway * reduce)

        # ambient current
        ctx.update_positions(ctx.environment["x_sea_water_velocity"],
                             ctx.environment["y_sea_water_velocity"])

        # jibing: Markov orientation flips (reference leeway.py:478-487)
        jibe_rate = -torch.log(1.0 - d["jibe_probability"]) / 3600.0
        p_step = 1.0 - torch.exp(-jibe_rate * abs(dt))
        jib = rng.uniform(ctx.next_key(), tuple(p_step.shape),
                          device=p_step.device) < p_step
        ctx.set_var("crosswind_slope", torch.where(
            jib, -d["crosswind_slope"], d["crosswind_slope"]))
        ctx.set_var("orientation", torch.where(
            jib, 1.0 - d["orientation"], d["orientation"]))

        ctx.stokes_drift()

    # ------------------------------------------------------------- export -
    def export_ascii(self, filename):
        """ASCII export in the original LEEWAY model format
        (reference leeway.py:496-560)."""
        ds = self.result
        lons = ds["lon"].values
        lats = ds["lat"].values
        times = ds.coords["time"]
        with open(filename, "w") as f:
            f.write("# Leeway simulation output (opendrift_tpu)\n")
            f.write(f"simulationStart: {str(times[0])[:19]}\n")
            f.write(f"numberOfParticles: {lons.shape[0]}\n")
            f.write(f"numberOfTimes: {lons.shape[1]}\n")
            for ti in range(lons.shape[1]):
                f.write(f"\nTime step {ti}: {str(times[ti])[:19]}\n")
                f.write("# lon lat status\n")
                status = ds["status"].values[:, ti]
                for i in range(lons.shape[0]):
                    f.write(f"{lons[i, ti]:10.5f} {lats[i, ti]:9.5f} "
                            f"{status[i]:3d}\n")
