"""Storm-field import (port of ``tol_tpu/io/storm.py``): netCDF ->
``TOLWGRID`` binary cache (``tol_tpu_torch/io/native.py``) -> WindGrid.

Reads NetCDF-3 classic files through ``scipy.io.netcdf_file``; other
inputs can be passed as arrays to :func:`grid_from_arrays`.
"""

from __future__ import annotations

import numpy as np
import torch

# Sentinel of a missing sample in the reference's storm database; such
# samples become calm air.
SENTINEL = -32768.0


def grid_from_arrays(u, v, w, origin, spacing, sentinel: float = SENTINEL,
                     live=(0.0, 1.0, 0.0), dtype=torch.float64, device=None):
    """WindGrid on ``device`` (default: CUDA; raises without a GPU) from raw
    (nx, ny, nz) component arrays.

    Samples at or below ``sentinel`` (and NaNs) become calm air; the field
    is stored in float32, ``origin`` and ``spacing`` in ``dtype`` (float32
    for a float32 solve, so that ``(p - origin) / spacing`` rounds as the
    JAX package's does with x64 off).  ``live`` defaults to the v
    component only, the reference's model-3 behaviour; pass (1, 1, 1) for
    all three."""
    from tol_tpu_torch.models.wind import WindGrid
    from tol_tpu_torch.problems.base import resolve_device

    device = resolve_device(device)

    def clean(a):
        a = np.asarray(a, dtype=np.float32)
        return np.where(a <= sentinel, 0.0, np.nan_to_num(a)).astype(np.float32)

    u, v, w = clean(u), clean(v), clean(w)
    if not (u.shape == v.shape == w.shape) or u.ndim != 3:
        raise ValueError(f"component shapes differ or not 3-D: "
                         f"{u.shape} {v.shape} {w.shape}")
    vec = lambda x, dt: torch.as_tensor(np.asarray(x, dtype=np.float64),
                                        dtype=dt, device=device)
    field = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)
    return WindGrid(origin=vec(origin, dtype), spacing=vec(spacing, dtype),
                    u=field(u), v=field(v), w=field(w),
                    live=vec(live, torch.float32))


def _uniform_spacing(coord, name):
    coord = np.asarray(coord, dtype=np.float64)
    if coord.size < 2:
        return 1.0
    d = np.diff(coord)
    if not np.allclose(d, d[0], rtol=1e-4):
        raise ValueError(f"{name} coordinate not uniformly spaced")
    return float(d[0])


def import_netcdf_storm(path: str, out_path: str | None = None,
                        u_var: str = "u", v_var: str = "v", w_var: str = "w",
                        x_var: str = "x", y_var: str = "y", z_var: str = "z",
                        time_index: int = 0, sentinel: float = SENTINEL,
                        live=(0.0, 1.0, 0.0), dtype=torch.float64,
                        device=None):
    """Import a NetCDF-3 storm snapshot as a WindGrid; with ``out_path``
    also write it as a ``TOLWGRID`` file.

    Variables may be (nx, ny, nz) or (t, nx, ny, nz) (``time_index`` picks
    the snapshot); the coordinate variables give the uniform origin and
    spacing."""
    from scipy.io import netcdf_file

    with netcdf_file(path, "r", mmap=False) as nc:
        def take(name):
            a = np.asarray(nc.variables[name].data)
            if a.ndim == 4:
                a = a[time_index]
            return a

        u, v, w = take(u_var), take(v_var), take(w_var)
        xs = np.asarray(nc.variables[x_var].data, dtype=np.float64)
        ys = np.asarray(nc.variables[y_var].data, dtype=np.float64)
        zs = np.asarray(nc.variables[z_var].data, dtype=np.float64)

    origin = (float(xs[0]), float(ys[0]), float(zs[0]))
    spacing = (_uniform_spacing(xs, x_var), _uniform_spacing(ys, y_var),
               _uniform_spacing(zs, z_var))
    grid = grid_from_arrays(u, v, w, origin, spacing, sentinel=sentinel,
                            live=live, dtype=dtype, device=device)
    if out_path is not None:
        from tol_tpu_torch.io.native import write_wind_grid
        host = lambda x: x.detach().cpu().numpy()
        write_wind_grid(out_path, host(grid.origin), host(grid.spacing),
                        host(grid.u), host(grid.v), host(grid.w))
    return grid


def make_demo_storm_grid(nx: int = 8, ny: int = 8, nz: int = 6,
                         spacing: float = 150.0,
                         origin=(17000.0, 25500.0, 0.0),
                         up0: float = 200.0,
                         shear: float = 2.4, shear_href: float = 10.0,
                         shear_sat: float = 50.0,
                         vortex_center=(17400.0, 25700.0),
                         vortex_v: float = 2.5, vortex_r0: float = 200.0,
                         thermal_center=(17350.0, 25650.0),
                         thermal_w: float = 2.0, thermal_r0: float = 150.0,
                         dtype=torch.float64, device=None):
    """A nonuniform demo storm sampled onto a WindGrid at 150 m spacing,
    all three components live: a saturating boundary-layer shear (tanh in
    altitude, slope ``-shear/shear_href`` at the ``up0`` datum), a
    Rankine-style horizontal vortex and a Gaussian thermal updraft.  No
    component is trilinear, so solves against it exercise the
    interpolation and its derivatives; ``tests/golden_storm_ts100.npy`` is
    the solution of the S10 storm problem on this grid with ``order=2``.
    The samples are computed in numpy, so both packages build the same
    field."""
    xs = origin[0] + spacing * np.arange(nx)
    ys = origin[1] + spacing * np.arange(ny)
    zs = origin[2] + spacing * np.arange(nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")

    v = -shear * shear_sat / shear_href * np.tanh((Z - up0) / shear_sat)

    dx = X - vortex_center[0]
    dy = Y - vortex_center[1]
    r = np.sqrt(dx * dx + dy * dy)
    vt = vortex_v * (r / vortex_r0) * np.exp(1.0 - r / vortex_r0)
    safe_r = np.where(r > 0, r, 1.0)
    u = np.where(r > 0, -vt * dy / safe_r, 0.0)
    v = v + np.where(r > 0, vt * dx / safe_r, 0.0)

    r2t = ((X - thermal_center[0]) ** 2 + (Y - thermal_center[1]) ** 2)
    w = thermal_w * np.exp(-r2t / (thermal_r0 * thermal_r0))

    return grid_from_arrays(u, v, w, origin, (spacing, spacing, spacing),
                            live=(1.0, 1.0, 1.0), dtype=dtype, device=device)
