"""Live play WebSocket server: RFC 6455 handshake + frame protocol.

Drives the server end-to-end with a raw-socket client (no websocket deps):
handshake, init message, streamed frames, pause/step control, and a manual
action applied to the live sim (reference live-play parity —
renderer/live_server.py docstring)."""

from __future__ import annotations

import base64
import json
import os
import socket
import struct
import time

import numpy as np
import pytest

from metta_tpu.builder.envs import make_navigation
from metta_tpu.engine.env import MettaGridEnv
from metta_tpu.policy.policy import RandomPolicy
from metta_tpu.renderer.live_server import (
    LivePlaySession,
    make_server,
    serve_play,
    ws_accept_key,
)


class _Client:
    """Raw socket + leftover buffer (the 101 response may overshoot into
    the first frame bytes)."""

    def __init__(self, sock, buf=b""):
        self.sock = sock
        self.buf = buf

    def readn(self, n):
        while len(self.buf) < n:
            c = self.sock.recv(n - len(self.buf))
            if not c:
                return None
            self.buf += c
        out, self.buf = self.buf[:n], self.buf[n:]
        return out

    def settimeout(self, t):
        self.sock.settimeout(t)

    def close(self):
        self.sock.close()


def _client_recv_text(cl):
    readn = cl.readn

    head = readn(2)
    if head is None:
        return None
    b0, b1 = head
    ln = b1 & 0x7F
    if ln == 126:
        ln = struct.unpack("!H", readn(2))[0]
    elif ln == 127:
        ln = struct.unpack("!Q", readn(8))[0]
    data = readn(ln) if ln else b""
    return data.decode()


def _client_send_text(cl, text):
    payload = text.encode()
    mask = os.urandom(4)
    masked = bytes(b ^ mask[i % 4] for i, b in enumerate(payload))
    assert len(payload) < 126
    cl.sock.sendall(struct.pack("!BB", 0x81, 0x80 | len(payload)) + mask + masked)


@pytest.fixture()
def live():
    env_cfg = make_navigation(num_agents=2, width=10, height=10)
    env_cfg.game.map_builder.seed = 3
    env = MettaGridEnv(env_cfg, num_envs=1, desync_episodes=False)
    # compile the step before the server starts: the protocol tests wait at
    # most 5 s for a frame, which a cold compile on a loaded CPU can exceed
    env.reset(seed=0)
    env.step(np.zeros(env.num_agents, np.int32))
    policy = RandomPolicy(env.compiled.n_actions, seed=0)
    session, server, thread = serve_play(
        env, policy, fps=20.0, max_steps=500, port=0, block=False)
    yield session, server
    session.stop()
    server.shutdown()


def _connect(server):
    port = server.server_address[1]
    s = socket.create_connection(("127.0.0.1", port), timeout=5)
    key = base64.b64encode(os.urandom(16)).decode()
    s.sendall((
        "GET /ws HTTP/1.1\r\nHost: localhost\r\nUpgrade: websocket\r\n"
        "Connection: Upgrade\r\nSec-WebSocket-Key: " + key +
        "\r\nSec-WebSocket-Version: 13\r\n\r\n"
    ).encode())
    resp = b""
    while b"\r\n\r\n" not in resp:
        resp += s.recv(4096)
    head_bytes, _, rest = resp.partition(b"\r\n\r\n")
    head = head_bytes.decode()
    assert "101" in head.splitlines()[0]
    assert ws_accept_key(key) in head
    return _Client(s, rest)


def test_handshake_init_and_frames(live):
    session, server = live
    s = _connect(server)
    init = json.loads(_client_recv_text(s))
    assert init["type"] == "init"
    assert init["num_agents"] == 2
    assert "move_north" in init["action_names"]
    # frames stream while running
    msg = json.loads(_client_recv_text(s))
    while msg["type"] != "frame":
        msg = json.loads(_client_recv_text(s))
    assert msg["step"] >= 1
    assert any(o["type_name"] == "agent" for o in msg["objects"])
    assert any(o["type_name"] == "wall" for o in msg["objects"])
    s.close()


def test_pause_and_single_step(live):
    session, server = live
    s = _connect(server)
    _client_recv_text(s)                      # init
    _client_send_text(s, json.dumps({"type": "pause"}))
    # wait for TWO idle passes of the (single-threaded) run loop after the
    # pause: the first proves the pause was observed, the second that any
    # step in flight when it was observed has landed — deterministic, no
    # sleep-and-hope window
    idle0 = session.idle_passes
    t0 = time.time()
    while session.idle_passes < idle0 + 2 and time.time() - t0 < 20:
        time.sleep(0.05)
    assert session.idle_passes >= idle0 + 2, "pause never took effect"
    step0 = session.step_idx
    time.sleep(0.3)
    assert session.step_idx == step0          # paused: no stepping
    s.settimeout(0.5)
    try:
        while True:
            _client_recv_text(s)              # drain queued frames
    except (socket.timeout, TypeError):
        pass
    s.settimeout(5)
    _client_send_text(s, json.dumps({"type": "step"}))
    t0 = time.time()
    while session.step_idx == step0 and time.time() - t0 < 10:
        time.sleep(0.05)
    # wait for two more idle passes so a hypothetical second step would have
    # had the chance to land before we assert it didn't
    idle1 = session.idle_passes
    t0 = time.time()
    while session.idle_passes < idle1 + 2 and time.time() - t0 < 10:
        time.sleep(0.05)
    assert session.step_idx == step0 + 1      # exactly one step
    s.close()


def test_manual_action_applied():
    env_cfg = make_navigation(num_agents=1, width=10, height=10)
    env_cfg.game.map_builder.seed = 3
    env = MettaGridEnv(env_cfg, num_envs=1, desync_episodes=False)

    class NoopPolicy:
        def step_batch(self, obs):
            return np.zeros((obs.shape[0],), np.int32)

    session = LivePlaySession(env, NoopPolicy(), fps=100, max_steps=50)
    r0 = int(np.asarray(env.state.env.agent_r[0, 0]))
    south = env.compiled.action_names.index("move_south")
    north = env.compiled.action_names.index("move_north")
    session.manual[0] = south
    session._one_step()
    r1 = int(np.asarray(env.state.env.agent_r[0, 0]))
    if r1 == r0:          # blocked by a wall: go the other way
        session.manual[0] = north
        session._one_step()
        r1 = int(np.asarray(env.state.env.agent_r[0, 0]))
    assert r1 != r0, "manual action did not move the agent"
    assert session.last_frame["type"] == "frame"
