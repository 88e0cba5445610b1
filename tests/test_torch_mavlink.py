"""The port's MAVLink codec and UDP autopilot against tol_tpu's: the
checksum, the framing and the parser give byte-identical output, and the
scripted aircraft endpoint of tests/test_mavlink.py runs against the
port's autopilot."""

import socket
import threading

import numpy as np
import pytest

from tol_tpu.mission import mavlink as jmv
from tol_tpu_torch.mission import mavlink as mv

MESSAGES = [
    (mv.HEARTBEAT, (0, 2, 3, 81, 4, 3)),
    (mv.GLOBAL_POSITION_INT,
     (1234, 401451000, -1052408000, 1676000, 105000, 1, -2, 3, 90)),
    (mv.MISSION_ITEM, (0.0, 0.0, 0.0, 0.0, 40.1451, -105.2408, 70.0, 3,
                       mv.MAV_CMD_NAV_WAYPOINT, 1, 1,
                       mv.MAV_FRAME_GLOBAL_RELATIVE_ALT, 0, 1)),
    (mv.MISSION_REQUEST, (7, 255, 190)),
    (mv.MISSION_SET_CURRENT, (1, 1, 1)),
    (mv.MISSION_CURRENT, (3,)),
    (mv.MISSION_COUNT, (12, 1, 1)),
    (mv.MISSION_CLEAR_ALL, (1, 1)),
    (mv.MISSION_ACK, (255, 190, 0)),
]


def test_constants_match():
    assert mv.CRC_EXTRA == jmv.CRC_EXTRA
    assert mv._FMT == jmv._FMT
    assert mv.MAGIC_V1 == jmv.MAGIC_V1


def test_x25_crc_matches():
    assert mv.x25_crc(b"123456789") == 0x6F91
    rng = np.random.default_rng(0)
    for n in (0, 1, 7, 64, 263):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0xFFFF, 0x1234):
            assert mv.x25_crc(data, seed) == jmv.x25_crc(data, seed)


@pytest.mark.parametrize("msgid,values", MESSAGES)
def test_pack_is_byte_identical(msgid, values):
    for seq, sysid, compid in ((0, 255, 190), (300, 1, 1)):
        assert mv.pack(msgid, values, seq=seq, sysid=sysid, compid=compid) \
            == jmv.pack(msgid, values, seq=seq, sysid=sysid, compid=compid)


def test_parser_matches_on_a_noisy_stream():
    """Frames with junk between them, one corrupted frame and one frame of
    an unknown id, pushed in uneven pieces: the same messages out of
    both parsers."""
    rng = np.random.default_rng(1)
    stream = bytearray()
    for k, (msgid, values) in enumerate(MESSAGES):
        frame = bytearray(mv.pack(msgid, values, seq=k))
        if k == 4:
            frame[7] ^= 0xFF
        stream += rng.integers(0, 256, k % 3, dtype=np.uint8).tobytes()
        stream += frame
    unknown = bytearray(mv.pack(mv.MISSION_ACK, (1, 2, 3)))
    unknown[5] = 200
    stream += unknown + mv.pack(mv.MISSION_CURRENT, (9,))
    outs = []
    for mod in (jmv, mv):
        p, out, i = mod.Parser(), [], 0
        for step in (5, 1, 17, 3, 40):
            out.extend(p.push(bytes(stream[i:i + step])))
            i += step
        out.extend(p.push(bytes(stream[i:])))
        outs.append(out)
    assert outs[1] == outs[0]
    assert (mv.MISSION_CURRENT, (9,)) in outs[0]


class ScriptedAircraft(threading.Thread):
    """Aircraft-side endpoint: heartbeat reply, GPS stream, mission
    request/ack handshake recording every uploaded item."""

    def __init__(self):
        super().__init__(daemon=True)
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("127.0.0.1", 0))
        self.sock.settimeout(0.1)
        self.port = self.sock.getsockname()[1]
        self.items = []
        self.cleared = False
        self.current = None
        self.stop = threading.Event()
        self.parser = mv.Parser()

    def run(self):
        peer = None
        expected = 0
        while not self.stop.is_set():
            try:
                data, addr = self.sock.recvfrom(4096)
            except socket.timeout:
                continue
            peer = addr
            for msgid, vals in self.parser.push(data):
                if msgid == mv.HEARTBEAT:
                    self.sock.sendto(mv.pack(mv.HEARTBEAT, (0, 1, 3, 81, 4, 3),
                                             sysid=1), peer)
                    self.sock.sendto(mv.pack(
                        mv.GLOBAL_POSITION_INT,
                        (1, 401466300, -1052396740, 1781000, 105000,
                         0, 0, 0, 0), sysid=1), peer)
                elif msgid == mv.MISSION_CLEAR_ALL:
                    self.cleared = True
                    self.items = []
                elif msgid == mv.MISSION_COUNT:
                    expected = vals[0]
                    self.sock.sendto(mv.pack(mv.MISSION_REQUEST,
                                             (0, 255, 190), sysid=1), peer)
                elif msgid == mv.MISSION_ITEM:
                    self.items.append(vals)
                    nxt = len(self.items)
                    if nxt < expected:
                        self.sock.sendto(mv.pack(mv.MISSION_REQUEST,
                                                 (nxt, 255, 190), sysid=1),
                                         peer)
                    else:
                        self.sock.sendto(mv.pack(mv.MISSION_ACK,
                                                 (255, 190, 0), sysid=1),
                                         peer)
                elif msgid == mv.MISSION_SET_CURRENT:
                    self.current = vals[0]
                    self.sock.sendto(mv.pack(mv.MISSION_CURRENT, (vals[0],),
                                             sysid=1), peer)


def test_autopilot_against_scripted_endpoint():
    """tests/test_mavlink.py's scripted aircraft, on the port's codec,
    against the port's MavlinkAutopilot."""
    ac = ScriptedAircraft()
    ac.start()
    ap = mv.MavlinkAutopilot(conn=f"127.0.0.1:{ac.port}")
    try:
        assert ap.connect(timeout_s=3.0)
        lat, lon, alt = ap.global_position()
        assert lat == pytest.approx(40.14663) and alt == pytest.approx(1781.0)
        wps = [{"lat": 40.1451 + 1e-4 * k, "lon": -105.2408, "alt": 70.0,
                "speed": 15.0} for k in range(3)]
        assert ap.upload_mission(wps) == 3
        assert ac.cleared
        assert len(ac.items) == 6          # waypoint + speed pair each
        cmds = [it[8] for it in ac.items]
        assert cmds[0::2] == [mv.MAV_CMD_NAV_WAYPOINT] * 3
        assert cmds[1::2] == [mv.MAV_CMD_DO_CHANGE_SPEED] * 3
        assert ac.items[1][1] == pytest.approx(15.0)   # speed param2
        assert ac.current == 1
    finally:
        ac.stop.set()
        ap.close()
