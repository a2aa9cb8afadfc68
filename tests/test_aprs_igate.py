"""APRS-IS igate client hardening (round-4 verdict #5).

A fake igate (threaded TCP server) validates the reference connection
discipline (reference auto_rx/autorx/aprs.py:415-560): one persistent
connection with a single login + filters, frames over the held socket,
and retry-with-reconnect when the server drops the connection.
"""

import socket
import socketserver
import threading
import time

import pytest

from radiosonde_auto_rx_jax.exporters.aprs import APRSUploader


class _FakeIgate:
    """Minimal APRS-IS server: responds to logins, records frames,
    and can be told to drop every live client connection."""

    def __init__(self):
        self.logins = []
        self.frames = []
        self.conns = []
        self.lock = threading.Lock()
        fake = self

        class Handler(socketserver.StreamRequestHandler):
            timeout = 5.0

            def handle(self):
                with fake.lock:
                    fake.conns.append(self.connection)
                try:
                    while True:
                        line = self.rfile.readline()
                        if not line:
                            return
                        text = line.decode("ascii", "replace").strip()
                        if text.startswith("user "):
                            with fake.lock:
                                fake.logins.append(text)
                            self.wfile.write(b"# logresp verified\r\n")
                        elif text.startswith("#"):
                            continue            # filter commands
                        elif text:
                            with fake.lock:
                                fake.frames.append(text)
                except OSError:
                    return

        class Server(socketserver.ThreadingTCPServer):
            allow_reuse_address = True
            daemon_threads = True

        self.server = Server(("127.0.0.1", 0), Handler)
        self.port = self.server.server_address[1]
        self._thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._thread.start()

    def drop_clients(self):
        with self.lock:
            for c in self.conns:
                try:
                    c.shutdown(socket.SHUT_RDWR)
                    c.close()
                except OSError:
                    pass
            self.conns.clear()

    def wait_frames(self, n, timeout=5.0):
        t0 = time.time()
        while time.time() - t0 < timeout:
            with self.lock:
                if len(self.frames) >= n:
                    return list(self.frames)
            time.sleep(0.02)
        with self.lock:
            return list(self.frames)

    def close(self):
        self.server.shutdown()
        self.server.server_close()


@pytest.fixture
def igate():
    g = _FakeIgate()
    yield g
    g.close()


def _uploader(igate, **kw):
    return APRSUploader(aprs_callsign="N0CALL", aprs_passcode="12345",
                        server="127.0.0.1", port=igate.port,
                        start_thread=False, timeout=2.0, **kw)


def test_persistent_connection_single_login(igate):
    up = _uploader(igate)
    assert up.connect()
    assert up.upload_packet(";TEST     *000000h0000.00N/00000.00EO000/000/A=000000 x !ww!")
    assert up.upload_packet(";TEST2    *000001h0000.00N/00000.00EO000/000/A=000000 x !ww!")
    frames = igate.wait_frames(2)
    assert len(frames) == 2
    # ONE login for the two frames (held connection, reference :415-463)
    time.sleep(0.1)
    assert len(igate.logins) == 1
    assert igate.logins[0].startswith("user N0CALL pass 12345")
    # igate path framing (reference aprsis_upload :500-516)
    assert frames[0].startswith("N0CALL>APRARX,SONDEGATE,TCPIP,qAR,N0CALL:;TEST")
    up.close()


def test_retry_reconnects_after_drop(igate):
    up = _uploader(igate)
    assert up.connect()
    assert up.upload_packet("PKT-ONE")
    igate.wait_frames(1)
    # igate drops us (restart / idle timeout): the next upload must
    # reconnect and deliver within the retry budget
    igate.drop_clients()
    time.sleep(0.1)
    delivered = up.upload_packet("PKT-TWO") or up.upload_packet("PKT-TWO")
    assert delivered, "upload did not survive a dropped connection"
    frames = igate.wait_frames(2)
    assert any(f.endswith("PKT-TWO") for f in frames)
    assert len(igate.logins) >= 2, "no re-login after reconnect"
    up.close()


def test_upload_fails_cleanly_when_server_gone(igate):
    up = _uploader(igate)
    assert up.connect()
    igate.close()
    igate.drop_clients()
    time.sleep(0.1)
    t0 = time.time()
    ok = up.upload_packet("PKT-LOST")
    assert not ok
    assert time.time() - t0 < 20.0, "retry loop took too long"
    up.close()


def test_source_callsign_for_position_reports(igate):
    up = _uploader(igate)
    assert up.connect()
    assert up.upload_packet("!payload", source="S1234567")
    frames = igate.wait_frames(1)
    assert frames[0].startswith("S1234567>APRARX,SONDEGATE,TCPIP,qAR,N0CALL:")
    up.close()


def test_cold_start_first_upload_delivers(igate):
    """A fresh uploader (no explicit connect()) must deliver its FIRST
    packet on attempt 1: the connection opens lazily before the attempt
    loop, so even retries=1 delivers (round-5 review finding — the old
    code burned attempt 1 on 'not connected' and with retries=1 could
    never deliver anything)."""
    up = _uploader(igate, retries=1)
    assert up.upload_packet("COLD-START-PKT")
    frames = igate.wait_frames(1)
    assert any(f.endswith("COLD-START-PKT") for f in frames)
    time.sleep(0.1)
    assert len(igate.logins) == 1
    up.close()


def test_first_beacon_not_rate_limited_by_missing_fix(igate):
    """A mobile station waiting for its first gpsd fix must beacon the
    moment the fix arrives — the 0,0 guard must not stamp the beacon
    rate limiter (round-5 review finding)."""
    up = _uploader(igate, station_beacon=True, station_beacon_rate=30,
                   station_beacon_position=(0.0, 0.0, 0.0))
    up.beacon_station_position()      # no fix yet: refused, no stamp
    assert not igate.wait_frames(1, timeout=0.3)
    up.station_beacon["position"] = (-34.9, 138.6, 50.0)
    up.beacon_station_position()      # fix arrived: beacon NOW
    frames = igate.wait_frames(1)
    assert frames, "first beacon was rate-limited by the missing fix"
    up.close()
