"""Native MAVLink v1 codec + UDP autopilot implementation (port of
``tol_tpu/mission/mavlink.py``; host code, the reference's own).

The reference drives the aircraft through pymavlink: heartbeat wait and
GLOBAL_POSITION_INT polling (msl/mission.py:51-120), and the waypoint
upload handshake MISSION_CLEAR_ALL -> MISSION_COUNT -> (MISSION_REQUEST ->
MISSION_ITEM)* -> MISSION_ACK, then MISSION_SET_CURRENT / MISSION_CURRENT
(msl/trajectory.py:121-140).  pymavlink is not available in this
environment, so the wire protocol is implemented directly: MAVLink v1
framing (0xFE magic, X.25/MCRF4XX checksum seeded with the per-message
CRC_EXTRA byte) and the handful of common-dialect messages the mission
layer needs.  :class:`MavlinkAutopilot` satisfies the
:class:`tol_tpu_torch.mission.autopilot.Autopilot` protocol over a UDP socket.
"""

from __future__ import annotations

import socket
import struct
import time
from typing import Dict, List, Optional, Tuple

MAGIC_V1 = 0xFE

# Common-dialect message ids and X.25 CRC_EXTRA seeds.
HEARTBEAT = 0
GLOBAL_POSITION_INT = 33
MISSION_ITEM = 39
MISSION_REQUEST = 40
MISSION_SET_CURRENT = 41
MISSION_CURRENT = 42
MISSION_COUNT = 44
MISSION_CLEAR_ALL = 45
MISSION_ACK = 47

CRC_EXTRA = {
    HEARTBEAT: 50,
    GLOBAL_POSITION_INT: 104,
    MISSION_ITEM: 254,
    MISSION_REQUEST: 230,
    MISSION_SET_CURRENT: 28,
    MISSION_CURRENT: 28,
    MISSION_COUNT: 221,
    MISSION_CLEAR_ALL: 232,
    MISSION_ACK: 153,
}

# Wire formats (fields sorted largest-first per MAVLink XML ordering).
_FMT = {
    HEARTBEAT: "<IBBBBB",            # custom_mode, type, autopilot,
                                     # base_mode, system_status, version
    GLOBAL_POSITION_INT: "<IiiiihhhH",  # ms, lat1e7, lon1e7, alt_mm,
                                        # rel_alt_mm, vx, vy, vz, hdg
    MISSION_ITEM: "<fffffffHHBBBBB",  # p1..p4, x, y, z, seq, command,
                                      # tsys, tcomp, frame, current, autoc
    MISSION_REQUEST: "<HBB",          # seq, tsys, tcomp
    MISSION_SET_CURRENT: "<HBB",
    MISSION_CURRENT: "<H",
    MISSION_COUNT: "<HBB",
    MISSION_CLEAR_ALL: "<BB",
    MISSION_ACK: "<BBB",
}

MAV_CMD_NAV_WAYPOINT = 16
MAV_CMD_DO_CHANGE_SPEED = 178
MAV_FRAME_GLOBAL_RELATIVE_ALT = 3


def x25_crc(data: bytes, crc: int = 0xFFFF) -> int:
    """MCRF4XX / X.25 checksum as used by MAVLink (crc_accumulate)."""
    for b in data:
        tmp = (b ^ (crc & 0xFF)) & 0xFF
        tmp = (tmp ^ ((tmp << 4) & 0xFF)) & 0xFF
        crc = ((crc >> 8) ^ (tmp << 8) ^ (tmp << 3) ^ (tmp >> 4)) & 0xFFFF
    return crc


def pack(msgid: int, values: tuple, seq: int = 0, sysid: int = 255,
         compid: int = 190) -> bytes:
    """Frame one MAVLink v1 message."""
    payload = struct.pack(_FMT[msgid], *values)
    head = struct.pack("<BBBBBB", MAGIC_V1, len(payload), seq & 0xFF,
                       sysid, compid, msgid)
    crc = x25_crc(head[1:] + payload)
    crc = x25_crc(bytes([CRC_EXTRA[msgid]]), crc)
    return head + payload + struct.pack("<H", crc)


class Parser:
    """Incremental MAVLink v1 frame parser (unknown msgids are skipped)."""

    def __init__(self):
        self._buf = bytearray()

    def push(self, data: bytes) -> List[Tuple[int, Optional[tuple]]]:
        self._buf.extend(data)
        out = []
        while True:
            # resync to magic
            while self._buf and self._buf[0] != MAGIC_V1:
                del self._buf[0]
            if len(self._buf) < 8:
                return out
            plen = self._buf[1]
            need = 6 + plen + 2
            if len(self._buf) < need:
                return out
            frame = bytes(self._buf[:need])
            del self._buf[:need]
            msgid = frame[5]
            payload = frame[6:6 + plen]
            got_crc = struct.unpack("<H", frame[-2:])[0]
            if msgid in CRC_EXTRA:
                crc = x25_crc(frame[1:-2])
                crc = x25_crc(bytes([CRC_EXTRA[msgid]]), crc)
                if crc != got_crc:
                    continue                      # corrupt; resync
                fmt = _FMT[msgid]
                if len(payload) < struct.calcsize(fmt):
                    payload = payload + bytes(struct.calcsize(fmt)
                                              - len(payload))
                out.append((msgid, struct.unpack(fmt, payload)))
            # unknown msgid: frame dropped (cannot verify CRC_EXTRA)


class MavlinkAutopilot:
    """UDP MAVLink implementation of the Autopilot protocol.

    ``conn`` is "host:port" of the autopilot endpoint (the reference's
    SITL default is udp:localhost:14550, msl/msl.py:48).  ``listen`` binds
    a local port; pass 0 for ephemeral.
    """

    def __init__(self, conn: str = "127.0.0.1:14550", listen: int = 0,
                 sysid: int = 255, target_system: int = 1,
                 target_component: int = 1):
        host, port = conn.rsplit(":", 1)
        self.addr = (host, int(port))
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", listen))
        self.sock.settimeout(0.2)
        self.sysid = sysid
        self.tsys = target_system
        self.tcomp = target_component
        self._seq = 0
        self._parser = Parser()
        self._last: Dict[int, tuple] = {}

    # ---- plumbing ----

    def _send(self, msgid: int, values: tuple) -> None:
        self.sock.sendto(pack(msgid, values, seq=self._seq,
                              sysid=self.sysid), self.addr)
        self._seq = (self._seq + 1) & 0xFF

    def _recv(self, want: int, timeout_s: float) -> Optional[tuple]:
        """Pump the socket until a ``want`` message arrives (or timeout)."""
        deadline = time.time() + timeout_s
        while time.time() < deadline:
            try:
                data, _ = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            for msgid, vals in self._parser.push(data):
                self._last[msgid] = vals
                if msgid == want:
                    return vals
        return None

    # ---- Autopilot protocol ----

    def connect(self, timeout_s: float = 5.0) -> bool:
        """Wait for a heartbeat (msl/mission.py:56-76)."""
        self._send(HEARTBEAT, (0, 6, 8, 0, 4, 3))   # GCS heartbeat
        return self._recv(HEARTBEAT, timeout_s) is not None

    def global_position(self) -> Tuple[float, float, float]:
        """(lat, lon, alt_m) from GLOBAL_POSITION_INT (msl/mission.py:85-90)."""
        vals = self._recv(GLOBAL_POSITION_INT, 5.0)
        if vals is None:
            if GLOBAL_POSITION_INT in self._last:
                vals = self._last[GLOBAL_POSITION_INT]
            else:
                raise TimeoutError("no GLOBAL_POSITION_INT received")
        _, lat, lon, alt_mm, *_ = vals
        return lat / 1e7, lon / 1e7, alt_mm / 1000.0

    def upload_mission(self, waypoints: List[dict],
                       timeout_s: float = 10.0) -> int:
        """Waypoint handshake (msl/trajectory.py:78-140).

        Each trajectory sample becomes a NAV_WAYPOINT + DO_CHANGE_SPEED
        pair exactly like the reference's MAVWPLoader construction
        (msl/trajectory.py:100-117).
        """
        items = []
        for wp in waypoints:
            seq = len(items)
            items.append((0.0, 0.0, 0.0, 0.0,
                          float(wp["lat"]), float(wp["lon"]),
                          float(wp["alt"]), seq, MAV_CMD_NAV_WAYPOINT,
                          self.tsys, self.tcomp,
                          MAV_FRAME_GLOBAL_RELATIVE_ALT, 0, 1))
            seq = len(items)
            items.append((1.0, float(wp.get("speed", 0.0)), -1.0, 0.0,
                          0.0, 0.0, 0.0, seq, MAV_CMD_DO_CHANGE_SPEED,
                          self.tsys, self.tcomp,
                          MAV_FRAME_GLOBAL_RELATIVE_ALT, 0, 1))

        self._send(MISSION_CLEAR_ALL, (self.tsys, self.tcomp))
        self._send(MISSION_COUNT, (len(items), self.tsys, self.tcomp))
        deadline = time.time() + timeout_s
        sent = 0
        while sent < len(items) and time.time() < deadline:
            req = self._recv(MISSION_REQUEST, 1.0)
            if req is None:
                continue
            seq = req[0]
            if seq < len(items):
                self._send(MISSION_ITEM, items[seq])
                sent = max(sent, seq + 1)
        ack = self._recv(MISSION_ACK, 2.0)
        if sent < len(items) or ack is None:
            raise TimeoutError(
                f"waypoint handshake incomplete ({sent}/{len(items)})")
        # select the first real waypoint (msl/trajectory.py:136-137)
        self._send(MISSION_SET_CURRENT, (1, self.tsys, self.tcomp))
        self._recv(MISSION_CURRENT, 2.0)
        return len(waypoints)

    def close(self) -> None:
        self.sock.close()
