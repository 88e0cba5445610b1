"""Ground-control-station telemetry thread (port of
``tol_tpu/mission/gcs.py``; host code, the reference's own).

Equivalent of ``msl/ge_interface.py``: a daemon thread that polls the
autopilot position, converts GPS -> datum ENU, and regenerates a Google
Earth KML file per update.  Poison-pill shutdown like the reference
(msl/ge_interface.py:20-24); the MAVLink socket is replaced by the
``Autopilot`` interface.
"""

from __future__ import annotations

import threading
import time

from tol_tpu_torch.mission.autopilot import Autopilot, haversine_enu


class GCSInterface(threading.Thread):
    def __init__(self, autopilot: Autopilot, datum_lat: float, datum_lon: float,
                 datum_alt: float, kml_path: str = "TOL_GCS.kml",
                 period_s: float = 1.0):
        super().__init__(daemon=True)
        self.ap = autopilot
        self.datum = (datum_lat, datum_lon, datum_alt)
        self.kml_path = kml_path
        self.period_s = period_s
        self.poison = False
        self.east = self.north = self.up = 0.0
        self.updates = 0

    def run(self):
        while not self.poison:
            lat, lon, alt = self.ap.global_position()
            self.east, self.north, self.up = haversine_enu(
                self.datum[0], self.datum[1], self.datum[2], lat, lon, alt)
            self._write_kml(lat, lon, alt)
            self.updates += 1
            time.sleep(self.period_s)

    def _write_kml(self, lat, lon, alt):
        """Aircraft + ground-station placemarks (msl/ge_interface.py:50-90)."""
        kml = f"""<?xml version="1.0" encoding="UTF-8"?>
<kml xmlns="http://www.opengis.net/kml/2.2">
<Document><name>tol_tpu GCS</name>
<Placemark><name>Aircraft</name>
<Point><altitudeMode>absolute</altitudeMode>
<coordinates>{lon},{lat},{alt}</coordinates></Point></Placemark>
<Placemark><name>Ground Station</name>
<Point><coordinates>{self.datum[1]},{self.datum[0]},{self.datum[2]}</coordinates></Point>
</Placemark></Document></kml>
"""
        try:
            with open(self.kml_path, "w") as f:
                f.write(kml)
        except OSError:
            pass

    def stop(self):
        self.poison = True
