"""Operator console (port of ``tol_tpu/mission/console.py``; host code,
the reference's own).

Same options as the reference menu (msl/msl.py:83-88): optimize to the next
goal, send the trajectory, set the aircraft address, set the datum, and an
auto mode driven by a scripted stack (msl/msl.py:55 ``autostack``).  I/O is
injected (``input_fn``/``print_fn``) so the whole loop is unit-testable —
the reference console could only be exercised live against SITL.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

from tol_tpu_torch.mission.autopilot import FakeAutopilot
from tol_tpu_torch.mission.mission import Mission, MissionConfig

BANNER = r"""
%*=+--+=#=+--   tol_tpu Trajectory Optimization Layer (PyTorch/CUDA)--+=#*%
%  A from-scratch re-design of the EA-DDDAS TOL mission console.          %
%*=+--+=#=+--                 --+=#=+--+=#=+--                   --+=#*%
"""

MENU = """Options:
1. Optimize to next available goal point
2. Send current trajectory
3. Set aircraft address
4. Set datum location
5. Auto Mode
q. Quit
"""

# The reference fakes its planner goals in place of "Otte's code"
# (msl/msl.py:101-109); same defaults here.
DEFAULT_GOALS = [(400.0, 0.0, 70.0, 0.0), (400.0, 400.0, 70.0, 0.0),
                 (800.0, 400.0, 70.0, 100.0)]


class Console:
    def __init__(self, mission: Optional[Mission] = None,
                 goals: Optional[Sequence] = None,
                 input_fn: Callable[[str], str] = input,
                 print_fn: Callable[[str], None] = print,
                 autostack: Optional[List[int]] = None):
        self.mission = mission or Mission(MissionConfig(), FakeAutopilot())
        self.goals = list(goals or DEFAULT_GOALS)
        self.goal_index = 0
        self.input = input_fn
        self.print = print_fn
        # Read right-to-left like the reference's pop stack (msl/msl.py:55).
        self.autostack = autostack if autostack is not None else [2, 1, 2, 1, 2, 1]
        self.auto = False

    def next_goal(self):
        g = self.goals[min(self.goal_index, len(self.goals) - 1)]
        self.goal_index += 1
        return g

    def step(self, choice: str) -> bool:
        """Execute one menu choice; returns False to quit."""
        if choice == "q":
            return False
        if choice == "1":
            goal = self.next_goal()
            self.print(f"Optimizing to goal {goal} ...")
            self.mission.run(goal)
            for line in self.mission.log[-3:]:
                self.print(line)
            self.mission.trajectory.write_to_json("trajectory_backup.json")
        elif choice == "2":
            if self.mission.connected and len(self.mission.trajectory):
                n = self.mission.upload()
                self.print(f"waypoint count: {n}")
            else:
                self.print("Not connected or no trajectory!")
        elif choice == "3":
            addr = self.input("New sUAS address: ")
            self.print(f"aircraft address set to {addr}")
        elif choice == "4":
            lat = float(self.input("New datum latitude: "))
            lon = float(self.input("New datum longitude: "))
            alt = float(self.input("New datum altitude: "))
            self.mission.cfg.datum_lat = lat
            self.mission.cfg.datum_lon = lon
            self.mission.cfg.datum_alt = alt
            self.mission.trajectory.datum_lat = lat
            self.mission.trajectory.datum_lon = lon
            self.mission.trajectory.datum_alt = alt
        elif choice == "5":
            self.auto = True
        return True

    def run(self):
        self.print(BANNER)
        running = True
        while running:
            self.print(MENU)
            if self.auto:
                if self.autostack:
                    choice = str(self.autostack.pop())
                else:
                    self.auto = False
                    choice = "q"
            else:
                choice = self.input("> ").strip()
            running = self.step(choice)


def main():
    Console().run()


if __name__ == "__main__":
    main()
