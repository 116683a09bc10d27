"""Plotting and animation of trajectory results.

Port of ``opendrift_tpu/models/plot.py`` (reference:
opendrift/models/basemodel/__init__.py:2537-4050) without cartopy: maps are
drawn on plain lon/lat axes with an aspect correction and, when a landmask
provider is registered, a shaded land background sampled from it on the
model's device.  Every figure is savable headlessly (Agg backend);
``animation`` writes GIF/MP4 through matplotlib's writers.  matplotlib is
imported inside each plot (``utils/plotting.py``), so the port imports and
runs without it and a plot then raises an ``ImportError`` naming it.
"""

import logging
from datetime import datetime

import numpy as np
import torch

from ..interop import device_state_from_numpy
from ..utils import plotting

logger = logging.getLogger(__name__)


def _save_animation(anim, filename, fps):
    """GIF through Pillow; anything else through ffmpeg, or a GIF beside
    it where ffmpeg is missing."""
    manim = plotting.animation()
    if str(filename).endswith(".gif"):
        anim.save(filename, writer=manim.PillowWriter(fps=fps))
        return
    try:
        anim.save(filename, writer=manim.FFMpegWriter(fps=fps))
    except Exception:
        gif = str(filename).rsplit(".", 1)[0] + ".gif"
        logger.warning("ffmpeg unavailable; writing %s", gif)
        anim.save(gif, writer=manim.PillowWriter(fps=fps))


class PlottingMixin:
    """Mixed into OpenDriftSimulation (requires ``self.result``)."""

    def _axes_with_land(self, buffer=0.1, hide_landmask=False, ax=None):
        plotting.use_agg()
        plt = plotting.pyplot()
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        lonmin = np.nanmin(lon) - buffer
        lonmax = np.nanmax(lon) + buffer
        latmin = np.nanmin(lat) - buffer
        latmax = np.nanmax(lat) + buffer
        if ax is None:
            fig, ax = plt.subplots(figsize=(10, 8))
        else:
            fig = ax.figure
        ax.set_xlim(lonmin, lonmax)
        ax.set_ylim(latmin, latmax)
        meanlat = np.clip((latmin + latmax) / 2, -89, 89)
        ax.set_aspect(1.0 / np.cos(np.radians(meanlat)))
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Latitude")
        if not hide_landmask:
            self._shade_land(ax, lonmin, lonmax, latmin, latmax)
        return fig, ax

    def _shade_land(self, ax, lonmin, lonmax, latmin, latmax, n=300):
        """Sample a registered landmask provider onto the plot grid, on the
        model's device, and shade its land."""
        provider = None
        for reader in self.env.readers.values():
            if "land_binary_mask" in (reader.variables or []):
                provider = reader
                break
        if provider is None:
            return
        try:
            lons = np.linspace(lonmin, lonmax, n)
            lats = np.linspace(latmin, latmax, n)
            LO, LA = np.meshgrid(lons, lats)
            provider.set_run_epoch(getattr(self, "start_time", None)
                                   or datetime.now())
            dev = device_state_from_numpy(provider.device_state(),
                                          self.device)
            pos = [torch.as_tensor(a.ravel().astype(np.float32),
                                   device=self.device)
                   for a in (LO, LA, np.zeros_like(LO))]
            vals, cov = provider.sample(dev, ["land_binary_mask"],
                                        np.float32(0.0), *pos)
            land = vals["land_binary_mask"].cpu().numpy().reshape(LO.shape)
            land = np.where(cov.cpu().numpy().reshape(LO.shape), land, 0.0)
            ax.contourf(LO, LA, land, levels=[0.5, 1.5],
                        colors=["#c0b296"], zorder=0)
        except Exception as e:  # plotting must never break a run
            logger.debug("Could not shade landmask: %s", e)

    def plot(self, buffer=0.1, filename=None, show=False, linecolor=None,
             hide_landmask=False, markersize=4, ax=None, compare=None,
             **kwargs):
        """Trajectory plot (reference basemodel/__init__.py:3482).

        ``compare``: another simulation object, an output filename, a dict
        with ``lon``/``lat`` arrays (an observed drifter track, say), or a
        list of these, overlaid in distinct colours (reference comparison
        plots :3438-3480)."""
        plt = plotting.pyplot()
        fig, ax = self._axes_with_land(buffer, hide_landmask, ax=ax)
        if compare is not None:
            if not isinstance(compare, list):
                compare = [compare]
            colors = ["tab:red", "tab:orange", "tab:purple", "tab:brown"]
            for cn, comp in enumerate(compare):
                if isinstance(comp, str):
                    from .. import open as open_result
                    comp = open_result(comp, device=self.device)
                if isinstance(comp, dict):
                    clon = np.atleast_2d(np.asarray(comp["lon"]))
                    clat = np.atleast_2d(np.asarray(comp["lat"]))
                else:
                    clon = np.atleast_2d(np.asarray(comp.result["lon"]))
                    clat = np.atleast_2d(np.asarray(comp.result["lat"]))
                ax.plot(clon.T, clat.T, color=colors[cn % len(colors)],
                        lw=1.0, alpha=0.8, zorder=4)
                ax.plot([], [], color=colors[cn % len(colors)],
                        label=f"compare {cn}")
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        if linecolor is not None and linecolor in self.result:
            vals = self.result[linecolor].values
            # one scatter over all trajectories, so that the colorbar spans
            # every value (per-trajectory scatters would each renormalise)
            good = (np.isfinite(lon) & np.isfinite(lat)
                    & np.isfinite(vals))
            sc = ax.scatter(lon[good], lat[good], c=vals[good],
                            s=markersize,
                            cmap=kwargs.get("cmap", "viridis"))
            fig.colorbar(sc, ax=ax, label=linecolor)
        else:
            ax.plot(lon.T, lat.T, color="gray", lw=0.4, alpha=0.6,
                    zorder=2)
        # green start, blue active end, red deactivated (the reference's
        # convention)
        ax.scatter(lon[:, 0], lat[:, 0], c="green", s=markersize,
                   zorder=3, label="start")
        status = self.result["status"].values
        final_active = status[:, -1] == 0
        ax.scatter(lon[final_active, -1], lat[final_active, -1], c="blue",
                   s=markersize, zorder=3, label="active")
        dead = ~final_active
        if dead.any():
            # a deactivated element's last finite position
            last_lon = np.array([row[np.isfinite(row)][-1] if
                                 np.isfinite(row).any() else np.nan
                                 for row in lon[dead]])
            last_lat = np.array([row[np.isfinite(row)][-1] if
                                 np.isfinite(row).any() else np.nan
                                 for row in lat[dead]])
            ax.scatter(last_lon, last_lat, c="red", s=markersize, zorder=3,
                       label="deactivated")
        ax.legend(loc="best", fontsize=8)
        ax.set_title(f"{type(self).__name__}  "
                     f"{self.result.coords['time'][0]} - "
                     f"{self.result.coords['time'][-1]}")
        if filename is not None:
            fig.savefig(filename, dpi=120, bbox_inches="tight")
            plt.close(fig)
        elif show:
            plt.show()
        return fig, ax

    def animation(self, buffer=0.1, filename=None, fps=8,
                  hide_landmask=False, color=None, markersize=6,
                  **kwargs):
        """Trajectory animation (reference basemodel/__init__.py:2742);
        writes GIF (Pillow) or MP4 (ffmpeg, where available)."""
        plt = plotting.pyplot()
        manim = plotting.animation()
        fig, ax = self._axes_with_land(buffer, hide_landmask)
        lon = self.result["lon"].values
        lat = self.result["lat"].values
        times = self.result.coords["time"]
        cvals = self.result[color].values if color and color in \
            self.result else None
        if cvals is not None:
            scat = ax.scatter([], [], s=markersize, c=[],
                              cmap=kwargs.get("cmap", "viridis"), zorder=3)
        else:
            scat = ax.scatter([], [], s=markersize, c="blue", zorder=3)
        title = ax.set_title("")

        def update(ti):
            pts = np.column_stack([lon[:, ti], lat[:, ti]])
            ok = np.isfinite(pts).all(axis=1)
            scat.set_offsets(pts[ok])
            if cvals is not None:
                scat.set_array(cvals[ok, ti])
            title.set_text(str(times[ti])[:19])
            return scat, title

        anim = manim.FuncAnimation(fig, update, frames=lon.shape[1],
                                   interval=1000 / fps, blit=False)
        if filename is not None:
            _save_animation(anim, filename, fps)
            plt.close(fig)
        return anim

    def animation_profile(self, filename=None, fps=8, markersize=6,
                          color=None, vmin=None, vmax=None, legend=None,
                          cmap="viridis", legend_loc="best"):
        """Vertical-section animation (reference basemodel/__init__.py:
        3255).  ``color`` names a result variable to colour markers by
        (e.g. 'specie'); with ``legend`` a list of labels, integer colour
        values get a categorical legend like the reference's radionuclide
        GUI profile."""
        plt = plotting.pyplot()
        manim = plotting.animation()
        lon = self.result["lon"].values
        z = self.result["z"].values
        cvals = self.result[color].values if color else None
        if cvals is not None:
            if vmin is None:
                vmin = np.nanmin(cvals)
            if vmax is None:
                vmax = np.nanmax(cvals)
        fig, ax = plt.subplots(figsize=(10, 5))
        ax.set_xlim(np.nanmin(lon) - 0.02, np.nanmax(lon) + 0.02)
        ax.set_ylim(min(np.nanmin(z) * 1.1, -1), 1)
        ax.set_xlabel("Longitude")
        ax.set_ylabel("Depth [m]")
        scat = ax.scatter([], [], s=markersize,
                          **({"c": [], "cmap": cmap, "vmin": vmin,
                              "vmax": vmax} if cvals is not None
                             else {"c": "blue"}))
        if legend and cvals is not None:
            cm = plt.get_cmap(cmap)
            span = max(float(vmax) - float(vmin), 1e-9)
            handles = [plt.Line2D(
                [], [], marker="o", linestyle="",
                color=cm((i - float(vmin)) / span), label=lab)
                for i, lab in enumerate(legend)]
            ax.legend(handles=handles, loc=legend_loc)
        title = ax.set_title("")
        times = self.result.coords["time"]

        def update(ti):
            pts = np.column_stack([lon[:, ti], z[:, ti]])
            ok = np.isfinite(pts).all(axis=1)
            scat.set_offsets(pts[ok])
            if cvals is not None:
                scat.set_array(cvals[ok, ti])
            title.set_text(str(times[ti])[:19])
            return scat, title

        anim = manim.FuncAnimation(fig, update, frames=lon.shape[1],
                                   interval=1000 / fps, blit=False)
        if filename is not None:
            anim.save(filename, writer=manim.PillowWriter(fps=fps))
            plt.close(fig)
        return anim

    def plot_environment(self, filename=None, ax=None, show=False):
        """Time series of the element-mean wind and current speed
        (reference basemodel/__init__.py:4532-4560)."""
        plt = plotting.pyplot()
        res = self.result
        wind = None
        if "x_wind" in res:
            wind = np.hypot(np.asarray(res["x_wind"].values),
                            np.asarray(res["y_wind"].values))
        curr = np.hypot(np.asarray(res["x_sea_water_velocity"].values),
                        np.asarray(res["y_sea_water_velocity"].values)) \
            if "x_sea_water_velocity" in res else None
        times = np.asarray(res.coords["time"]).astype("datetime64[s]")
        hours = (times - times[0]) / np.timedelta64(1, "h")
        if ax is None:
            _, ax = plt.subplots()
        if curr is not None:
            ax.plot(hours, np.nanmean(curr, axis=0), label="current [m/s]")
        if wind is not None:
            ax2 = ax.twinx()
            ax2.plot(hours, np.nanmean(wind, axis=0), "r",
                     label="wind [m/s]")
            ax2.set_ylabel("wind speed [m/s]", color="r")
        ax.set_xlabel("time [hours]")
        ax.set_ylabel("current speed [m/s]")
        ax.grid(True)
        if filename:
            plt.savefig(filename, dpi=120)
            plt.close()
        elif show:
            plt.show()
        return ax

    def plot_vertical_distribution(self, time_index=-1, bins=50,
                                   maxdepth=None, filename=None, ax=None):
        """Histogram of element depths at one output time (reference
        basemodel/__init__.py:3990-4055, the interactive slider version;
        here one static frame a call)."""
        plt = plotting.pyplot()
        z = np.asarray(self.result["z"].values)[:, time_index]
        z = z[np.isfinite(z)]
        if maxdepth is None:
            maxdepth = min(float(np.nanmin(z)) if len(z) else -10.0, -1.0)
        if ax is None:
            _, ax = plt.subplots(figsize=(4, 6))
        ax.hist(z, bins=bins, range=(maxdepth, 0),
                orientation="horizontal", color="royalblue")
        ax.set_ylim(maxdepth, 0)
        ax.set_ylabel("Depth [m]")
        ax.set_xlabel("Number of elements")
        ax.grid(True)
        if filename is not None:
            plt.savefig(filename, dpi=110, bbox_inches="tight")
            plt.close()
        return ax

    def plot_memory_usage(self, filename=None, ax=None):
        """The host's peak RSS sampled once an output interval by run()
        (reference basemodel/__init__.py:4671-4685)."""
        plt = plotting.pyplot()
        mem = np.asarray(getattr(self, "memory_usage", []) or [])
        if ax is None:
            _, ax = plt.subplots()
        ax.plot(np.arange(len(mem)), mem)
        ax.set_xlabel("Output interval")
        ax.set_ylabel("Host memory [MB]")
        ax.grid(True)
        if filename is not None:
            plt.savefig(filename, dpi=110, bbox_inches="tight")
            plt.close()
        return ax

    def plot_property(self, prop, filename=None, mean=False):
        """Time series of an element property (reference
        basemodel/__init__.py:4000-4030)."""
        plt = plotting.pyplot()
        vals = self.result[prop].values
        fig, ax = plt.subplots()
        times = self.result.coords["time"]
        if mean:
            ax.plot(times, np.nanmean(vals, axis=0))
        else:
            ax.plot(times, vals.T, lw=0.5, alpha=0.6)
        ax.set_xlabel("Time")
        ax.set_ylabel(prop)
        fig.autofmt_xdate()
        if filename is not None:
            fig.savefig(filename, dpi=110, bbox_inches="tight")
            plt.close(fig)
        return fig, ax
