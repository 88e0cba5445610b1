"""Write bench.py's lane noise as .npy files for the PyTorch port's bench.

bench.py perturbs each configuration's seed lanes by
``0.01 * jax.random.normal(PRNGKey(k), (N, n), dtype)`` with float32 as its
dtype (x64 off):

    s10    k = 0, 1024 x 1112  (bench.py:226, config 1)
    sweep  k = 2, 1024 x 1112  (bench.py:309, config 3)
    g7     k = 1,  256 x 1114  (bench.py:378, config 2)
    storm  k = 3,  256 x 1112  (bench.py:538, config 5)

``bench_torch.py`` reads these draws (it imports no JAX) and applies
``seeds_for``'s clip and fix itself.  ``seeds.json`` records the JAX
version and its ``jax_threefry_partitionable`` setting: the files are the
draws this JAX makes on the CPU.  Whether they equal the draws of a JAX
before 0.5 (another threefry default) or of a TPU run is not checked.

    JAX_PLATFORMS=cpu python tests/make_bench_seeds.py

``tests/test_torch_bench.py`` regenerates each draw and compares the bits.
"""

import json
import os

import numpy as np

OUT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "bench_seeds")
# name -> (PRNGKey, lanes, variables, where bench.py draws it)
DRAWS = {
    "s10": (0, 1024, 1112, "bench.py:226"),
    "sweep": (2, 1024, 1112, "bench.py:309"),
    "g7": (1, 256, 1114, "bench.py:378"),
    "storm": (3, 256, 1112, "bench.py:538"),
}


def draw(name: str) -> np.ndarray:
    """bench.py's float32 draw ``name`` with this process's JAX."""
    import jax
    import jax.numpy as jnp

    k, lanes, n, _ = DRAWS[name]
    return np.asarray(0.01 * jax.random.normal(jax.random.PRNGKey(k),
                                               (lanes, n), dtype=jnp.float32))


def note() -> dict:
    import jax

    return {
        "jax_version": jax.__version__,
        "jax_threefry_partitionable": bool(
            jax.config.jax_threefry_partitionable),
        "platform": "cpu",
        "expression": "0.01 * jax.random.normal(PRNGKey(k), (N, n), float32)",
        "draws": {name: {"key": k, "shape": [lanes, n], "where": where}
                  for name, (k, lanes, n, where) in DRAWS.items()},
        "caveat": ("the draws this JAX makes on the CPU; equality with the "
                   "draws of another JAX version or a TPU run is unverified"),
    }


def main() -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", False)   # bench.py's float32 run
    os.makedirs(OUT, exist_ok=True)
    for name in DRAWS:
        np.save(os.path.join(OUT, f"{name}.npy"), draw(name))
    with open(os.path.join(OUT, "seeds.json"), "w") as f:
        json.dump(note(), f, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
