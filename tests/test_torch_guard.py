"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, its entry points never fall back to the CPU on their own, and
chip_smoke.py refuses to report a result without a GPU."""

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(ROOT, "tol_tpu_torch")
SMOKE = os.path.join(ROOT, "chip_smoke.py")
# the JAX package's root scripts -> their ports
ROOT_SCRIPTS = {"bench.py": "bench_torch.py",
                "bench_scaling.py": "bench_scaling_torch.py",
                "__graft_entry__.py": "graft_entry_torch.py"}


def _port_sources():
    out = [SMOKE] + [os.path.join(ROOT, f) for f in ROOT_SCRIPTS.values()]
    for d, _, files in os.walk(PORT):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def _imported_roots(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_port_sources_import_no_jax_and_no_tol_tpu():
    files = _port_sources()
    assert len(files) > 15
    bad = {(os.path.relpath(f, ROOT), m) for f in files
           for m in _imported_roots(f) if m in ("jax", "jaxlib", "tol_tpu")}
    assert not bad, sorted(bad)


def test_importing_the_port_loads_no_jax():
    mods = sorted(
        os.path.relpath(f, ROOT)[:-3].replace(os.sep, ".")
        for f in _port_sources() if f != SMOKE)
    code = ("import sys\n"
            + "".join(f"import {m.removesuffix('.__init__')}\n" for m in mods)
            + "bad = [m for m in sys.modules if m.split('.')[0] in "
              "('jax', 'jaxlib', 'tol_tpu')]\n"
              "assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                   timeout=300)


def test_entry_points_need_a_gpu_unless_told_otherwise(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from tol_tpu_torch.api import make_problem
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_problem("S10", "tempest", ts=8)
    nlp = make_problem("S10", "tempest", ts=8, device="cpu")
    assert nlp.inst0.z_lo.device.type == "cpu"

    import bench_scaling_torch
    import bench_torch
    import graft_entry_torch
    import torch.distributed as dist
    from tol_tpu_torch.parallel import init_multihost, make_mesh
    assert not dist.is_initialized()
    for call in (make_mesh,
                 lambda: init_multihost("127.0.0.1:1", 1, 0),
                 graft_entry_torch.entry,
                 lambda: graft_entry_torch.dryrun_multichip(1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    monkeypatch.setenv("SCALING_PLATFORM", "gpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_scaling_torch.main()
    # the bench runs on the CPU only when BENCH_DEVICE=cpu says so
    monkeypatch.delenv("BENCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_torch.main()
    # none of them fell back to a world over gloo
    assert not dist.is_initialized()


def test_every_jax_module_has_its_port():
    """Every .py of tol_tpu/ has its counterpart at the same place under
    tol_tpu_torch/, and each root script of the JAX package its port."""
    jax_pkg = os.path.join(ROOT, "tol_tpu")
    missing = [os.path.relpath(os.path.join(d, f), jax_pkg)
               for d, _, files in os.walk(jax_pkg) for f in files
               if f.endswith(".py") and not os.path.exists(os.path.join(
                   PORT, os.path.relpath(os.path.join(d, f), jax_pkg)))]
    assert not missing, missing
    for script, port in ROOT_SCRIPTS.items():
        assert os.path.exists(os.path.join(ROOT, script))
        assert os.path.exists(os.path.join(ROOT, port)), port


@pytest.mark.parametrize("args", [
    ["0", "0", "0", "0", "-100", "0", "100", "tempest", "S10", "--ts", "8"],
    ["mission", "--goal", "400,0,70,100", "--ts", "8"]])
def test_the_cli_needs_a_gpu_unless_told_otherwise(args, tmp_path):
    """python -m tol_tpu_torch raises before any solve when no CUDA device
    is present and --device is not given."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "-m", "tol_tpu_torch", *args],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": ROOT})
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr
    assert "Solving" not in out.stdout
    from tol_tpu_torch.io.storm import make_demo_storm_grid
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_demo_storm_grid()


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """A wrapper takes its plain twin only for a CPU tensor; the launch
    checks refuse anything else that is not on the card
    (tests/test_torch_cuda.py checks the card's side)."""
    from tol_tpu_torch.ops import chainkern as ch
    from tol_tpu_torch.ops import crkern as ck
    with pytest.raises(ValueError, match="CUDA"):
        ck._check_shapes("k", [(torch.zeros(11, 11, 4), (11, 11, 4))])
    with pytest.raises(ValueError, match="CUDA"):
        ch._check("k", [(torch.zeros(3, 11, 11, 4), (3, 11, 11, 4))])
    # a tensor that is neither on the CPU nor on the card goes to the launch
    # checks and is refused there; no wrapper takes its twin for it
    z = lambda *s: torch.zeros(*s, device="meta")
    slab = z(11, 11, 4)
    for call in (
            lambda: ck.crp_factor_pass(z(4, 8, 11, 11), z(4, 8, 11, 11)),
            lambda: ck.crp_factor_fwd_pass(z(4, 8, 11, 11), z(4, 8, 11, 11),
                                           z(4, 8, 11, 12)),
            lambda: ck.crp_bwd_pass([(slab, slab, slab)], [z(11, 12, 4)],
                                    z(11, 12, 2)),
            lambda: ck.crp_fwd_pass([(slab, slab, slab)], z(11, 11, 4),
                                    z(4, 2, 11, 1)),
            lambda: ch._factor_eliminate_batched(z(3, 11, 11, 4),
                                                 z(3, 11, 11, 4),
                                                 z(3, 11, 14, 4)),
            lambda: ch._rhs_forward_batched(z(3, 11, 11, 4), z(3, 11, 11, 4),
                                            z(3, 11, 14, 4), z(3, 11, 1, 4)),
            lambda: ch._back_substitute_batched(z(3, 11, 15, 4),
                                                z(3, 11, 11, 4), z(15, 1, 4))):
        with pytest.raises(ValueError, match="CUDA"):
            call()
    assert all(k.launches == 0 for k in ck.KERNELS + ch.KERNELS)


@pytest.mark.parametrize("kernel", ["chain_factor", "chain_rhs_forward",
                                    "chain_back_sub"])
def test_chain_wrappers_take_the_twin_for_cpu_tensors_only(kernel):
    """A CPU tensor (any float type) runs the plain twin and counts no
    launch."""
    from tol_tpu_torch.ops import chainkern as ch
    gen = torch.Generator().manual_seed(0)
    t = lambda *s: 0.1 * torch.rand(*s, generator=gen, dtype=torch.float64)
    spd = t(3, 11, 11, 2) + 4.0 * torch.eye(
        11, dtype=torch.float64)[None, :, :, None]
    before = [k.launches for k in ch.KERNELS]
    out = {
        "chain_factor": lambda: ch._factor_eliminate_batched(
            spd, t(3, 11, 11, 2), t(3, 11, 14, 2)),
        "chain_rhs_forward": lambda: ch._rhs_forward_batched(
            spd, t(3, 11, 11, 2), t(3, 11, 14, 2), t(3, 11, 1, 2)),
        "chain_back_sub": lambda: ch._back_substitute_batched(
            t(3, 11, 15, 2), spd, t(15, 1, 2)),
    }[kernel]()
    out = out if isinstance(out, tuple) else (out,)
    assert all(o.device.type == "cpu" and torch.isfinite(o).all() for o in out)
    assert [k.launches for k in ch.KERNELS] == before


def test_chip_smoke_fails_without_a_gpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for cwd, script in [(ROOT, SMOKE),
                        (tmp_path, shutil.copy(SMOKE, tmp_path))]:
        out = subprocess.run([sys.executable, str(script)], cwd=cwd,
                             capture_output=True, text=True, timeout=300)
        assert out.returncode != 0
        assert '"ok"' not in out.stdout
