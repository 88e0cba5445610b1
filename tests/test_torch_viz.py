"""The port's plots (``tol_tpu_torch/viz.py``) against tol_tpu's: the
figures render (the size checks of tests/test_aux.py) and the wind behind
them equals the JAX package's ``wind_ned`` (float64, CPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

pytest.importorskip("matplotlib")

from tol_tpu.models.wind import WindConfig as JWind  # noqa: E402
from tol_tpu.models.wind import wind_ned as jwind_ned  # noqa: E402
from tol_tpu_torch import viz  # noqa: E402
from tol_tpu_torch.models.wind import WindConfig as TWind  # noqa: E402

N = 9


def _doc(seed=0):
    """A leg document with the snopt_results.json schema: a noisy loiter
    arc from a seeded numpy generator."""
    rng = np.random.default_rng(seed)
    th = np.linspace(0.5 * np.pi, 2.5 * np.pi, N)
    pos = {"x": 100.0 * np.sin(th) - 100.0, "y": -100.0 * np.cos(th),
           "z": -50.0 + rng.standard_normal(N)}
    states = {k: rng.uniform(lo, hi, N) for k, lo, hi in [
        ("Va", 12.0, 18.0), ("gam", -0.1, 0.1), ("chi", -3.0, 3.0),
        ("phi", -0.4, 0.4), ("CL", 0.3, 0.8), ("dphi", -0.1, 0.1),
        ("dCL", -0.1, 0.1), ("T", 2.0, 8.0)]}
    tr = {"time": list(0.5 * np.arange(N)),
          **{k: list(v) for k, v in {**pos, **states}.items()}}
    return {"trajectory": tr, "problem": "S10", "FinalCost": 1.0,
            "args": {"xg": -100.0, "yg": 0.0, "zg": 0.0}}


def test_figures_render(tmp_path):
    doc = _doc()
    p = tmp_path / "traj.png"
    viz.plot_results(doc, str(p))
    assert p.stat().st_size > 10000
    p = tmp_path / "wind.png"
    viz.plot_wind_field(TWind(model=1), str(p), n=8, device="cpu")
    assert p.stat().st_size > 5000
    p = tmp_path / "movie.gif"
    viz.animate_trajectory(doc, str(p), stride=3)
    assert p.stat().st_size > 5000
    it = np.arange(30, dtype=float)
    mk = lambda s: np.exp(-s * it)[None, :].repeat(4, axis=0)
    p = tmp_path / "trace.png"
    viz.plot_solver_trace((mk(0.3), mk(0.1), mk(0.05), mk(0.4), mk(0.2),
                           1.0 + mk(0.3)), str(p), tol=1e-3)
    assert p.stat().st_size > 10000
    p = tmp_path / "wind_along.png"
    t, W = viz.interpolate_wind_along(doc, TWind(model=1), str(p),
                                      device="cpu")
    assert W.shape == (N, 3) and p.stat().st_size > 5000


@pytest.mark.parametrize("model", [1, 2])
def test_wind_along_and_wind_grid_match_jax(model):
    """One batched port call over the trajectory's nodes and over the
    plot's n x n grid gives the JAX package's wind_ned at every point."""
    doc = _doc(seed=model)
    t, W = viz.interpolate_wind_along(doc, TWind(model=model), device="cpu")
    assert isinstance(t, np.ndarray) and isinstance(W, np.ndarray)
    tr = doc["trajectory"]
    want = np.stack([np.asarray(jwind_ned(JWind(model=model), jnp.array(
        [tr["x"][i], tr["y"][i], tr["z"][i]]))) for i in range(N)])
    np.testing.assert_allclose(W, want, rtol=0, atol=1e-12)

    n, alt = 7, 35.0
    xs, U, V = viz.wind_field_grid(TWind(model=model), (-250, 250), n, alt,
                                   device="cpu")
    for i, xn in enumerate(xs):
        for j, ye in enumerate(xs):
            w = np.asarray(jwind_ned(JWind(model=model),
                                     jnp.array([xn, ye, -alt])))
            assert abs(V[i, j] - w[0]) <= 1e-12
            assert abs(U[i, j] - w[1]) <= 1e-12
