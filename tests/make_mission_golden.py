"""Write the JAX package's own run of the default mission as the limit for
the PyTorch port's run on the card.

``Mission(MissionConfig()).run(GOAL)`` with ``FakeAutopilot``, float32 (the
card's solve type; x64 off) on the CPU: ts=100, one lane per leg on chain
"cr", warm starts with a cold retry, 400 iterations a leg.  It writes
``golden_mission_ts100.json``: per leg the mission type, the flags and the
iterations, and the mission's log.

    JAX_PLATFORMS=cpu python tests/make_mission_golden.py

``chip_smoke.py``'s ``paths`` phase runs the same mission through the port
and holds its legs' types and converged flags to these.
"""

import json
import os
import sys
import time

import jax

jax.config.update("jax_platforms", "cpu")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
# east, north, up of the loiter ring's centre and its radius, as
# chip_smoke.MISSION_GOAL; FakeAutopilot starts about (96, 170) m from the
# datum
GOAL = (275.0, 170.0, 0.0, 100.0)


def main():
    from tol_tpu.mission.autopilot import FakeAutopilot
    from tol_tpu.mission.mission import Mission, MissionConfig

    cfg = MissionConfig()
    mission = Mission(cfg, FakeAutopilot())
    types = []
    solve_leg = mission.solve_leg

    def leg(mission_type, goal, stitch=None, v0=None):
        types.append(mission_type)
        return solve_leg(mission_type, goal, stitch=stitch, v0=v0)

    mission.solve_leg = leg
    t0 = time.time()
    mission.run(GOAL)
    out = {
        "config": "MissionConfig() defaults", "goal": list(GOAL),
        "autopilot": "FakeAutopilot()", "dtype": "float32",
        "platform": "cpu", "jax_version": jax.__version__,
        "seconds": round(time.time() - t0, 1),
        "legs": [dict(mission=t, converged=bool(d["converged"]),
                      iterations=int(d["iterations"]),
                      used_warm=bool(d["used_warm"]),
                      cold_retry=bool(d["cold_retry"]))
                 for t, d in zip(types, mission.legs)],
        "log": mission.log,
    }
    with open(os.path.join(HERE, "golden_mission_ts100.json"), "w") as fh:
        json.dump(out, fh, indent=1)
        fh.write("\n")
    print(json.dumps(out["legs"]))


if __name__ == "__main__":
    main()
