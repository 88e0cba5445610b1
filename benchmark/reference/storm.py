"""Plain float64 reference of the S10 NLP in the gridded storm field (wind
model 3).

It is ``collocation.py`` (loaded by its path and left as it is) with the
wind of its ``Problem`` replaced: the field's samples are rebuilt here in
numpy from the published demo-field formulas and the configuration's
``wind.grid.args``, and the wind and its gradient at a position are the
direct tensor-product sum over the stencil's nodes (27 for the quadratic
B-spline, 8 for trilinear), with the shape functions' analytic
derivatives.  Everything is a torch operation of the position, so the
reference's own Jacobian and KKT certificate differentiate through it.
It imports nothing of the system under test.

The field model, as the configuration states it:

- node ``[i, j, k]`` sits at ENU ``origin + spacing * (i, j, k)``; the
  samples are stored as float32 (a missing sample, at or below -32768 or
  NaN, is calm air);
- a position's local NED ``(x, y, z)`` is the field's ENU
  ``(y + east0, x + north0, up0 - z)``, and the NED wind is the ENU
  ``(v, u, -w)``;
- order 2: the uniform quadratic B-spline about the nearest node ``j``,
  nodes ``j - 1, j, j + 1``, weights ``(1/2 - f)^2 / 2``, ``3/4 - f^2``,
  ``(1/2 + f)^2 / 2`` of the offset ``f``; order 1: trilinear about the
  node below;
- the stencil's node is clamped to the grid's interior, so a position
  outside the grid extrapolates from the edge cells' polynomials.

Departures from the upstream's model 3 (lingaqing/tol ``src/problem.cpp``
371-469, 544-695): the demo field in place of the Straka storm database
(``straka.t000000_f5700``), which is not in the repository; order 2 where
the upstream is trilinear (trilinear's cell-face kinks leave the NLP
without pointwise stationarity); all three components live where the
upstream interpolates v alone, unless the configuration's ``live`` masks
them (a leg of the mission layer reads its field from a TOLWGRID file,
v alone live, as the upstream does); one fixed grid a solve where the
upstream caches a box of nodes around the aircraft.
"""

from __future__ import annotations

import importlib.util
import os

import numpy as np
import torch

_spec = importlib.util.spec_from_file_location(
    "bench_reference_collocation_of_storm",
    os.path.join(os.path.dirname(os.path.abspath(__file__)), "collocation.py"))
_col = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_col)

# collocation.py's module API, which the batch kind's judge calls
F64 = _col.F64
Scaling = _col.Scaling
split = _col.split
judge_scaled = _col.judge_scaled
golden_cost = _col.golden_cost
certificate = _col.certificate
# collocation.py's judges in physical units, which the mission kind calls
judge_physical = _col.judge_physical
certificate_physical = _col.certificate_physical

DEMO_BUILDER = "tol_tpu_torch.io.storm:make_demo_storm_grid"
SENTINEL = -32768.0
DATUM = dict(east0=17400.0, north0=25800.0, up0=200.0)   # the field's datum
# The NED <-> ENU map is a swap of the first two axes and a sign on the
# third: NED component i is ENU component PERM[i] times SIGN[i].
PERM, SIGN = [1, 0, 2], torch.tensor([1.0, 1.0, -1.0], dtype=F64)


def demo_field(nx=8, ny=8, nz=6, spacing=150.0, origin=(17000.0, 25500.0, 0.0),
               up0=200.0, shear=2.4, shear_href=10.0, shear_sat=50.0,
               vortex_center=(17400.0, 25700.0), vortex_v=2.5, vortex_r0=200.0,
               thermal_center=(17350.0, 25650.0), thermal_w=2.0,
               thermal_r0=150.0) -> dict:
    """The demo storm's samples, every component live: a saturating
    boundary-layer shear in v (tanh in altitude, slope ``-shear /
    shear_href`` at ``up0``), a Rankine-style horizontal vortex of peak
    speed ``vortex_v`` at radius ``vortex_r0`` and a Gaussian thermal of
    ``thermal_w`` and radius ``thermal_r0``.  Returns ``u``, ``v``, ``w``
    (nx, ny, nz) float32, ``origin`` and ``spacing`` (3,) float64."""
    xs = origin[0] + spacing * np.arange(nx)
    ys = origin[1] + spacing * np.arange(ny)
    zs = origin[2] + spacing * np.arange(nz)
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    v = -shear * shear_sat / shear_href * np.tanh((Z - up0) / shear_sat)
    dx, dy = X - vortex_center[0], Y - vortex_center[1]
    r = np.sqrt(dx * dx + dy * dy)
    vt = vortex_v * (r / vortex_r0) * np.exp(1.0 - r / vortex_r0)
    safe_r = np.where(r > 0, r, 1.0)
    u = np.where(r > 0, -vt * dy / safe_r, 0.0)
    v = v + np.where(r > 0, vt * dx / safe_r, 0.0)
    r2t = (X - thermal_center[0]) ** 2 + (Y - thermal_center[1]) ** 2
    w = thermal_w * np.exp(-r2t / (thermal_r0 * thermal_r0))

    def stored(a):
        a = np.asarray(a, dtype=np.float32)
        return np.where(a <= SENTINEL, 0.0, np.nan_to_num(a)).astype(np.float32)

    return dict(u=stored(u), v=stored(v), w=stored(w),
                origin=np.asarray(origin, np.float64),
                spacing=np.full(3, spacing, np.float64))


class StormWind:
    """Wind model 3 from a configuration's ``wind``: ``order`` 1 or 2, the
    datum ``east0``, ``north0``, ``up0``, ``grid`` naming the demo
    field's builder and its ``args``, and ``live``, a mask over the
    components (u, v, w), all three by default: a masked component and
    its gradient are zero.  ``interp`` names one of the program's
    lowerings; this reference uses none of them."""

    def __init__(self, wind: dict):
        w = dict(wind)
        if w.pop("model") != 3:
            raise NotImplementedError(f"wind {wind}: this reference knows model 3")
        grid = w.pop("grid")
        if grid["builder"] != DEMO_BUILDER or set(grid) - {"builder", "args"}:
            raise NotImplementedError(f"grid {grid}: this reference knows "
                                      f"the demo field alone")
        self.order = int(w.pop("order", 1))
        if self.order not in (1, 2):
            raise ValueError(f"unsupported interpolation order {self.order}")
        w.pop("interp", None)
        live = torch.as_tensor(w.pop("live", (1.0, 1.0, 1.0)), dtype=F64)
        if live.shape != (3,):
            raise ValueError(f"live {live.tolist()}: one entry a component")
        datum = {**DATUM, **w}
        if set(datum) != set(DATUM):
            raise NotImplementedError(f"wind keys {sorted(set(datum) - set(DATUM))}")
        self.east0, self.north0, self.up0 = (float(datum[k]) for k in
                                             ("east0", "north0", "up0"))
        f = demo_field(**grid.get("args", {}))
        self.samples = torch.as_tensor(np.stack([f["u"], f["v"], f["w"]]),
                                       dtype=F64) * live[:, None, None, None]
        self.origin = torch.as_tensor(f["origin"])
        self.spacing = torch.as_tensor(f["spacing"])

    def _weights(self, rel):
        """Per-axis stencil: first node (..., 3) int64, weights and their
        derivatives in ``rel`` (..., 3, k)."""
        n = torch.tensor(self.samples.shape[1:], dtype=F64, device=rel.device)
        if self.order == 1:
            j = torch.minimum(torch.maximum(torch.floor(rel), torch.zeros_like(n)),
                              n - 2)
            f = rel - j
            one = torch.ones_like(f)
            return (j.to(torch.int64), torch.stack([1.0 - f, f], -1),
                    torch.stack([-one, one], -1))
        j = torch.minimum(torch.maximum(torch.round(rel), torch.ones_like(n)), n - 2)
        f = rel - j
        w = torch.stack([0.5 * (0.5 - f) ** 2, 0.75 - f * f, 0.5 * (0.5 + f) ** 2], -1)
        dw = torch.stack([f - 0.5, -2.0 * f, 0.5 + f], -1)
        return (j - 1).to(torch.int64), w, dw

    def enu(self, p_enu):
        """ENU wind (..., 3) and its gradient ``[..., c, k] = dW_c /
        dp_k`` (..., 3, 3) at field-ENU positions (..., 3)."""
        dev = p_enu.device
        origin, spacing = self.origin.to(dev), self.spacing.to(dev)
        rel = (p_enu - origin) / spacing
        first, w, dw = self._weights(rel)
        k = w.shape[-1]
        _, ny, nz = self.samples.shape[1:]
        node = first[..., None] + torch.arange(k, device=dev)    # (..., 3, k)
        flat = ((node[..., 0, :, None, None] * ny + node[..., 1, None, :, None]) * nz
                + node[..., 2, None, None, :])                   # (..., k, k, k)
        field = self.samples.to(dev).reshape(3, -1)
        corners = field.index_select(1, flat.reshape(-1)).reshape(
            3, *flat.shape).movedim(0, -1)                       # (..., k, k, k, 3)

        def total(a, b, c):
            return (corners * a[..., :, None, None, None] * b[..., None, :, None, None]
                    * c[..., None, None, :, None]).sum((-4, -3, -2))

        wx, wy, wz = w.unbind(-2)
        dx, dy, dz = (dw / spacing[:, None]).unbind(-2)
        W = total(wx, wy, wz)
        G = torch.stack([total(dx, wy, wz), total(wx, dy, wz), total(wx, wy, dz)], -1)
        return W, G

    def ned(self, p):
        """NED wind (..., 3) and its gradient ``[..., i, j] = dW_i / dp_j``
        (..., 3, 3) at aircraft-local NED positions (..., 3)."""
        p_enu = torch.stack([p[..., 1] + self.east0, p[..., 0] + self.north0,
                             -p[..., 2] + self.up0], -1)
        W, G = self.enu(p_enu)
        s = SIGN.to(p.device)
        G = G[..., PERM, :][..., PERM]
        return W[..., PERM] * s, G * s[:, None] * s


class Problem(_col.Problem):
    """``collocation.Problem`` in the storm field: the same NLP with the
    configuration's wind model 3 (``wind``, required)."""

    def __init__(self, mission_name: str, airframe: str, goal=None,
                 stitch=None, ts=None, wind=None):
        super().__init__(mission_name, airframe, goal=goal, stitch=stitch, ts=ts)
        self.storm = StormWind(wind)

    def wind(self, p):
        return self.storm.ned(p)
