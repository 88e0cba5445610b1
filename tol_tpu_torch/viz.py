"""Post-processing plots (port of ``tol_tpu/viz.py``): the MATLAB
``plotSNOPT`` class equivalent.

The same views as the JAX package's render with matplotlib from a
``snopt_results.json`` document or a stitched trajectory JSON;
headless-safe (Agg).  matplotlib is imported inside each function, so the
module imports without it.  Wind comes from
:mod:`tol_tpu_torch.models.wind`, evaluated in one batched call over the
grid or the trajectory's nodes, on ``device`` (CUDA unless the caller
names another device), in float64.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


def _mpl():
    import matplotlib
    matplotlib.use("Agg", force=False)
    import matplotlib.pyplot as plt
    return plt


STATE_KEYS = ["Va", "gam", "chi", "phi", "CL", "dphi", "dCL", "T"]


def plot_results(doc: dict, path: str, title: Optional[str] = None) -> None:
    """Trajectory + state history figure (matlab/@plotSNOPT/plot.m analog)."""
    plt = _mpl()
    tr = doc["trajectory"]
    t = np.asarray(tr["time"])
    x, y, z = (np.asarray(tr[k]) for k in ["x", "y", "z"])

    fig = plt.figure(figsize=(14, 9))
    ax = fig.add_subplot(3, 3, (1, 4), projection="3d")
    ax.plot(y, x, -z)  # ENU-ish view: east, north, up
    ax.scatter([y[0]], [x[0]], [-z[0]], marker="o")
    if "args" in doc:
        ax.scatter([doc["args"]["yg"]], [doc["args"]["xg"]],
                   [-doc["args"]["zg"]], marker="*", s=80)
    ax.set_xlabel("east [m]"); ax.set_ylabel("north [m]"); ax.set_zlabel("up [m]")
    ax.set_title(title or f"{doc.get('problem', '?')}  f={doc.get('FinalCost', float('nan')):.4g}")

    slots = [2, 3, 5, 6, 7, 8, 9]
    for k, slot in zip(STATE_KEYS, slots + [None]):
        if slot is None:
            break
        axs = fig.add_subplot(3, 3, slot)
        axs.plot(t, np.asarray(tr[k]))
        axs.set_ylabel(k)
        axs.grid(True, alpha=0.3)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _wind_ned_at(wind_cfg, points: np.ndarray, device) -> np.ndarray:
    """NED wind at the (N, 3) local NED ``points``, one batched call."""
    from tol_tpu_torch.models.wind import wind_ned
    from tol_tpu_torch.problems.base import resolve_device

    p = torch.as_tensor(np.asarray(points, np.float64),
                        device=resolve_device(device))
    return wind_ned(wind_cfg, p).cpu().numpy()


def wind_field_grid(wind_cfg, extent=(-300, 300), n: int = 25,
                    altitude: float = 50.0, device=None):
    """The horizontal wind field behind :func:`plot_wind_field`:
    ``(xs, U, V)`` with ``U[i, j]`` the east and ``V[i, j]`` the north
    component at north ``xs[i]``, east ``xs[j]``, ``altitude`` m up."""
    xs = np.linspace(extent[0], extent[1], n)
    N, E = np.meshgrid(xs, xs, indexing="ij")
    P = np.stack([N, E, np.full_like(N, -altitude)], axis=-1).reshape(-1, 3)
    W = _wind_ned_at(wind_cfg, P, device).reshape(n, n, 3)
    return xs, W[..., 1], W[..., 0]


def plot_wind_field(wind_cfg, path: str, extent=(-300, 300), n: int = 25,
                    altitude: float = 50.0, device=None) -> None:
    """Horizontal wind-field quiver (matlab/@plotSNOPT/plotstorm.m analog)."""
    plt = _mpl()
    xs, U, V = wind_field_grid(wind_cfg, extent, n, altitude, device)
    fig, ax = plt.subplots(figsize=(7, 7))
    E, N = np.meshgrid(xs, xs)
    ax.quiver(E, N, U, V)
    ax.set_xlabel("east [m]"); ax.set_ylabel("north [m]")
    ax.set_title(f"wind model {wind_cfg.model} @ {altitude:.0f} m AGL")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def animate_trajectory(doc: dict, path: str, stride: int = 2,
                       fps: int = 12) -> None:
    """Animated trajectory with an oriented aircraft glyph
    (matlab/@plotSNOPT/movie.m + drawAircraft_Solid*.m analog).

    Writes an animated GIF (pillow writer).  The glyph is a wireframe
    arrow (body x-axis along the course/climb direction, wing line along
    the bank-rotated body y-axis) — the same pose information the MATLAB
    solid-body renderer visualizes.
    """
    import matplotlib.animation as manim

    plt = _mpl()
    tr = doc["trajectory"]
    x, y, z = (np.asarray(tr[k]) for k in ["x", "y", "z"])
    chi = np.asarray(tr["chi"]); gam = np.asarray(tr["gam"])
    phi = np.asarray(tr["phi"])
    e, n, u = y, x, -z

    span = max(float(np.ptp(e)), float(np.ptp(n)), 1.0)
    glyph = 0.08 * span

    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.plot(e, n, u, alpha=0.35)
    ax.set_xlabel("east [m]"); ax.set_ylabel("north [m]"); ax.set_zlabel("up [m]")
    body_line, = ax.plot([], [], [], lw=2)
    wing_line, = ax.plot([], [], [], lw=2)
    dot, = ax.plot([], [], [], marker="o")

    def frame(k):
        i = min(k * stride, len(e) - 1)
        cx, cg, cp = chi[i], gam[i], phi[i]
        # body x in ENU: (sin chi cos gam, cos chi cos gam, sin gam) * L
        bx = np.array([np.sin(cx) * np.cos(cg), np.cos(cx) * np.cos(cg),
                       np.sin(cg)]) * glyph
        # wing (body y) banked by phi about body x
        wy0 = np.array([np.cos(cx), -np.sin(cx), 0.0])
        up_v = np.cross(bx / glyph, wy0)
        wy = (np.cos(cp) * wy0 + np.sin(cp) * up_v) * 0.6 * glyph
        p = np.array([e[i], n[i], u[i]])
        body_line.set_data_3d(*zip(p - bx, p + bx))
        wing_line.set_data_3d(*zip(p - wy, p + wy))
        dot.set_data_3d([p[0]], [p[1]], [p[2]])
        return body_line, wing_line, dot

    nframes = (len(e) + stride - 1) // stride
    ani = manim.FuncAnimation(fig, frame, frames=nframes, blit=False)
    ani.save(path, writer=manim.PillowWriter(fps=fps))
    plt.close(fig)


def plot_solver_trace(trace, path: str, tol: float | None = None) -> None:
    """Per-iteration solver analytics (the ReadLog.m analog: the reference
    parses SNOPT's print file for iteration counts/optimality,
    matlab/@plotSNOPT/private/ReadLog.m; here ALMResult.trace carries the
    same signals natively).

    ``trace`` is the ALMOptions(trace=True) tuple
    (kkt, mu, gamma, delta_w, viol[, f]); batched traces plot the median
    band and extremes.
    """
    plt = _mpl()
    arrs = [np.asarray(a, np.float64) for a in trace]
    names = ["KKT error", "mu", "gamma", "delta_w", "|c|_inf", "f"]
    fig, axes = plt.subplots(2, 3, figsize=(13, 7))
    for ax, a, name in zip(axes.ravel(), arrs, names):
        if a.ndim == 1:
            a = a[None, :]
        it = np.arange(a.shape[1])
        med = np.median(a, axis=0)
        if name == "f":
            ax.plot(it, med)
        else:
            pos = np.where(a > 0, a, np.nan)
            ax.semilogy(it, np.nanmedian(pos, axis=0))
            if a.shape[0] > 1:
                ax.fill_between(it, np.nanmin(pos, axis=0),
                                np.nanmax(pos, axis=0), alpha=0.2)
            if name == "KKT error" and tol:
                ax.axhline(tol, ls="--", alpha=0.6)
        ax.set_title(name)
        ax.grid(True, alpha=0.3)
    for ax in axes.ravel()[len(arrs):]:
        ax.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def interpolate_wind_along(doc: dict, wind_cfg, path: str | None = None,
                           device=None):
    """Wind re-interpolated along a solved trajectory
    (matlab/@plotSNOPT/interpolatewind.m analog).

    Returns numpy (t, W) with ``W`` (N, 3) NED wind at every node;
    optionally writes a component plot.
    """
    tr = doc["trajectory"]
    t = np.asarray(tr["time"])
    P = np.stack([np.asarray(tr[k], np.float64) for k in ("x", "y", "z")],
                 axis=1)
    W = _wind_ned_at(wind_cfg, P, device)
    if path is not None:
        plt = _mpl()
        fig, ax = plt.subplots(figsize=(8, 4))
        for k, lbl in enumerate(["Wx (north)", "Wy (east)", "Wz (down)"]):
            ax.plot(t, W[:, k], label=lbl)
        ax.legend(); ax.grid(True, alpha=0.3)
        ax.set_xlabel("t [s]"); ax.set_ylabel("wind [m/s]")
        fig.tight_layout()
        fig.savefig(path, dpi=110)
        plt.close(fig)
    return t, W
