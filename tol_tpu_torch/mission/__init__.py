"""Port of ``tol_tpu.mission``."""

from tol_tpu_torch.mission.trajectory import Trajectory
from tol_tpu_torch.mission.autopilot import Autopilot, FakeAutopilot
from tol_tpu_torch.mission.mission import Mission, MissionConfig

__all__ = ["Trajectory", "Autopilot", "FakeAutopilot", "Mission", "MissionConfig"]
