"""Trajectory analysis utilities (host-side, numpy).

The port's copy of ``opendrift_tpu/utils/trajectory.py``.  Counterpart
of the observation-fitting helpers in the reference's physics library
(reference: opendrift/models/physics_methods.py:28-113
``wind_drift_factor_from_trajectory`` and the polar-histogram plot
``plot_wind_drift_factor``, which imports matplotlib when called).  Geodesic steps
use the package's own Vincenty implementation instead of pyproj.
"""

import numpy as np

from . import geodesic
from .plotting import pyplot


def wind_drift_factor_from_trajectory(trajectory_dict, min_period=None):
    """Fit a wind_drift_factor per trajectory segment.

    For each consecutive observation pair: advance from the first
    position with the ambient current, then find the residual drift that
    the wind must explain.  Returns ``(wind_drift_factor,
    azimuth_offset_deg)``, each of length N-1 (reference:
    physics_methods.py:28-93).

    trajectory_dict needs equal-length arrays: ``time`` (datetimes),
    ``lon``, ``lat``, ``x_wind``, ``y_wind``, ``x_sea_water_velocity``,
    ``y_sea_water_velocity``.
    """
    time = list(trajectory_dict["time"])
    ind = np.arange(len(time))
    if min_period is not None:
        step = (time[1] - time[0]).total_seconds()
        s = max(int(round(min_period.total_seconds() / step)), 1)
        base = np.arange(0, len(time), s)
        ind = np.sort(np.concatenate(
            [base + i for i in range(s)]))
        ind = ind[ind < len(time)]
        time = [time[i] for i in ind]
    cu = np.asarray(trajectory_dict["x_sea_water_velocity"])[ind]
    cv = np.asarray(trajectory_dict["y_sea_water_velocity"])[ind]
    wu = np.asarray(trajectory_dict["x_wind"])[ind]
    wv = np.asarray(trajectory_dict["y_wind"])[ind]
    lon = np.asarray(trajectory_dict["lon"], dtype=np.float64)[ind]
    lat = np.asarray(trajectory_dict["lat"], dtype=np.float64)[ind]
    time_step = (time[1] - time[0]).total_seconds()

    # advance with current only
    latf, lonf = geodesic.geodesic_step(
        np, lat[:-1], lon[:-1], cu[:-1], cv[:-1], time_step)
    # residual vector to the next observed position
    az_fwd, _, dist = geodesic.geodesic_inverse(
        np, latf, lonf, lat[1:], lon[1:])
    wind_speed = np.sqrt(wu ** 2 + wv ** 2)
    wdf = dist / (time_step * np.maximum(wind_speed[:-1], 1e-12))
    wind_azimuth = np.degrees(np.arctan2(wu, wv))
    azimuth_offset = (az_fwd - wind_azimuth[:-1]) % 360.0
    azimuth_offset = np.where(azimuth_offset > 180.0,
                              azimuth_offset - 360.0, azimuth_offset)
    return wdf, azimuth_offset


def plot_wind_drift_factor(wdf, azimuth, wmax_plot=None, show=True):
    """Polar histogram of fitted wind drift factors vs azimuthal offset
    (reference: physics_methods.py:96-113)."""
    plt = pyplot()
    wmax = float(np.max(wdf))
    wbins = np.arange(0, wmax + 0.005, 0.005)
    abins = np.linspace(-180, 180, 30)
    hist, _, _ = np.histogram2d(azimuth, wdf, bins=(abins, wbins))
    A, W = np.meshgrid(abins, wbins)
    fig, ax = plt.subplots(subplot_kw=dict(projection="polar"))
    ax.set_theta_zero_location("N", offset=0)
    ax.set_theta_direction(-1)
    ax.pcolormesh(np.radians(A), W, hist.T, cmap="viridis")
    ax.grid(True)
    if wmax_plot is not None:
        ax.set_ylim([0, wmax_plot])
    if show:
        plt.show()
    return fig, ax


def distance_between_trajectories(lon1, lat1, lon2, lat2):
    """Pointwise geodesic distance [m] between two equal-length
    trajectories."""
    lon1, lat1, lon2, lat2 = map(np.asarray, (lon1, lat1, lon2, lat2))
    _, _, d = geodesic.geodesic_inverse(np, lat1, lon1, lat2, lon2)
    return d


def trajectory_length(lon, lat):
    """Cumulative along-track length [m] of a trajectory."""
    lon, lat = np.asarray(lon), np.asarray(lat)
    _, _, seg = geodesic.geodesic_inverse(np, lat[:-1], lon[:-1],
                                          lat[1:], lon[1:])
    return np.concatenate([[0.0], np.cumsum(seg)])


def skillscore_liu_weissberg(lon_obs, lat_obs, lon_model, lat_model,
                             tolerance_threshold=1.0):
    """Liu & Weisberg (2011) trajectory skill score.

    ss = 1 - s/n (clipped at 0), where s is the cumulative separation
    distance normalised by the cumulative observed trajectory length n.
    This is the standard drifter-validation metric in the reference
    ecosystem (provided there by the trajan dependency).
    """
    lon_obs = np.asarray(lon_obs, dtype=np.float64)
    lat_obs = np.asarray(lat_obs, dtype=np.float64)
    lon_model = np.asarray(lon_model, dtype=np.float64)
    lat_model = np.asarray(lat_model, dtype=np.float64)
    d = distance_between_trajectories(lon_obs, lat_obs,
                                      lon_model, lat_model)
    length = trajectory_length(lon_obs, lat_obs)
    s = np.sum(d[1:])
    n = np.sum(length[1:])
    if n == 0:
        return 0.0
    index = s / (n * tolerance_threshold)
    return float(max(0.0, 1.0 - index))
