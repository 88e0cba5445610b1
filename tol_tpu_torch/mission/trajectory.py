"""Stitched-trajectory container and exports (port of
``tol_tpu/mission/trajectory.py``; host code, the reference's own).

Python-3 redesign of ``msl/trajectory.py``: the same stitched arrays
(t/east/north/up/Va/gam/chi/phi/CL/dphi/dCL/T, msl/trajectory.py:14-26),
JSON round-trip (:142-164) and KML export (:166-198), with the waypoint
uplink moved behind the :mod:`tol_tpu_torch.mission.autopilot` interface so the
mission loop is testable without a real/SITL MAVLink endpoint (the
reference hard-requires pymavlink and even sleeps "artifical delay for
SITL, REMOVE IN FIELD!!!", msl/trajectory.py:129).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import List

FIELDS = ["t", "east", "north", "up", "Va", "gam", "chi", "phi",
          "CL", "dphi", "dCL", "T"]

M_PER_DEG = 111111.0  # flat-earth deg<->m (msl/trajectory.py:81-83)


@dataclasses.dataclass
class Trajectory:
    """Stitched mission trajectory in datum-relative ENU coordinates."""

    datum_lat: float = 0.0
    datum_lon: float = 0.0
    datum_alt: float = 0.0

    def __post_init__(self):
        for f in FIELDS:
            setattr(self, f, [])
        self.last_sent_index = 0

    def __len__(self):
        return len(self.t)

    def append_leg(self, doc: dict, t0: float, origin_enu) -> None:
        """Stitch a solved leg (``snopt_results.json`` document) onto the end.

        NED -> ENU conversion and origin offset exactly as
        msl/mission.py:215-226: east += y, north += x, up += -z.
        """
        tr = doc["trajectory"]
        dt = doc["dt"]
        n = len(tr["x"])
        e0, n0, u0 = origin_enu
        self.t += [t0 + k * dt for k in range(n)]
        self.east += [y + e0 for y in tr["y"]]
        self.north += [x + n0 for x in tr["x"]]
        self.up += [-z + u0 for z in tr["z"]]
        for f in ["Va", "gam", "chi", "phi", "CL", "dphi", "dCL", "T"]:
            getattr(self, f).extend(tr[f])

    def end_state(self):
        """Terminal sample as the next leg's initial state (ENU position +
        full state), mirroring msl/mission.py:228-240."""
        return {
            "east": self.east[-1], "north": self.north[-1], "up": self.up[-1],
            "Va": self.Va[-1], "gam": self.gam[-1], "chi": self.chi[-1],
            "phi": self.phi[-1], "CL": self.CL[-1],
            "dphi": self.dphi[-1], "dCL": self.dCL[-1], "T": self.T[-1],
        }

    # ---- waypoint generation (msl/trajectory.py:78-118) ----

    def waypoints(self, every: int = 20) -> List[dict]:
        """Every Nth sample as (lat, lon, alt, speed) waypoints."""
        wps = []
        for i in range(self.last_sent_index, len(self.north)):
            if (i - self.last_sent_index) % every != 0:
                continue
            lat = self.datum_lat + self.north[i] / M_PER_DEG
            lon = self.datum_lon + self.east[i] / (
                M_PER_DEG * math.cos(math.radians(lat)))
            wps.append({"lat": lat, "lon": lon, "alt": self.up[i],
                        "speed": self.Va[i]})
        return wps

    def mark_sent(self):
        self.last_sent_index = max(0, len(self.north) - 1)

    # ---- serialization (msl/trajectory.py:142-164) ----

    def to_json(self) -> dict:
        return {f: list(getattr(self, f)) for f in FIELDS}

    def write_to_json(self, path: str) -> None:
        with open(path, "w") as fp:
            json.dump(self.to_json(), fp)

    def read_from_json(self, path: str) -> None:
        with open(path) as fp:
            data = json.load(fp)
        for f in FIELDS:
            setattr(self, f, list(data[f]))

    # ---- KML export (msl/trajectory.py:166-198) ----

    def write_to_kml(self, path: str, name: str = "tol_tpu Stitched Trajectory") -> None:
        coords = []
        for i in range(len(self.east)):
            lat = self.datum_lat + self.north[i] / M_PER_DEG
            lon = self.datum_lon + self.east[i] / (
                M_PER_DEG * math.cos(math.radians(lat)))
            alt = self.datum_alt + self.up[i]
            coords.append(f"{lon},{lat},{alt}")
        kml = f"""<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
<Document><name>{name}</name>
<Style id="yellowLineGreenPoly">
<LineStyle><color>7f00ff00</color><width>4</width></LineStyle>
<PolyStyle><color>7f00ff00</color></PolyStyle>
</Style>
<Placemark><name>Stitched Trajectory</name>
<styleUrl>#yellowLineGreenPoly</styleUrl>
<LineString><extrude>1</extrude><tessellate>1</tessellate>
<altitudeMode>absolute</altitudeMode>
<coordinates>{' '.join(coords)}</coordinates>
</LineString></Placemark></Document></kml>
"""
        with open(path, "w") as fp:
            fp.write(kml)
