"""The port's copies of the viewer's plain-Python layer
(``inferbiomechanics_tpu_torch/viz/{ws,mesh,viewer,live}.py``,
``review_file_cmd.SegmentReviewSession``, ``utils/geometry.py``) against the
JAX package's originals: the files themselves, RFC 6455 framing, OBJ / PLY
parsing and decimation, body-mesh matching, the live session's transport,
the segment loop, and a ``LiveViewerServer`` end to end on a loopback port
with a client built from ``ws.encode_client_frame``. No test reaches the
network.
"""

import json
import socket
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from inferbiomechanics_tpu.cli import review_file_cmd as jax_review
from inferbiomechanics_tpu.utils import geometry as jax_geometry
from inferbiomechanics_tpu.viz import live as jax_live
from inferbiomechanics_tpu.viz import mesh as jax_mesh
from inferbiomechanics_tpu.viz import viewer as jax_viewer
from inferbiomechanics_tpu.viz import ws as jax_ws
from inferbiomechanics_tpu_torch.cli.review_file_cmd import (
    SegmentReviewSession, find_suspicious_segments, serve_segment_review,
)
from inferbiomechanics_tpu_torch.data.dataset import WindowDataset
from inferbiomechanics_tpu_torch.data.synthetic import write_synthetic_subject
from inferbiomechanics_tpu_torch.utils import geometry
from inferbiomechanics_tpu_torch.viz import live, mesh, viewer, ws
from inferbiomechanics_tpu_torch.viz.live import LiveSession, LiveViewerServer
from inferbiomechanics_tpu_torch.viz.live_model import build_live_session

OBJ = """# tiny tetra
v 0 0 0
v 1 0 0
v 0 1 0
v 0 0 1
f 1 2 3
f 1 2 4
f 1/1 3/2 4/3
"""

PLY = """ply
format ascii 1.0
element vertex 3
property float x
property float y
property float z
element face 1
property list uchar int vertex_indices
end_header
0 0 0
1 0 0
0 1 0
3 0 1 2
"""


@pytest.fixture(scope='module', autouse=True)
def _one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# -- the copies ---------------------------------------------------------------

@pytest.mark.parametrize('port, original', [(ws, jax_ws), (mesh, jax_mesh), (viewer, jax_viewer),
                                            (geometry, jax_geometry)])
def test_copies_are_the_originals(port, original):
    assert Path(port.__file__).read_text() == Path(original.__file__).read_text()


def test_live_copy_differs_only_in_its_imports():
    got = Path(live.__file__).read_text()
    want = Path(jax_live.__file__).read_text()
    assert got.replace('inferbiomechanics_tpu_torch.viz', 'inferbiomechanics_tpu.viz') == want
    assert got.count('inferbiomechanics_tpu_torch.viz') == 2


def test_templates_and_camera_js_are_the_jax_text():
    assert live._PAGE == jax_live._PAGE
    assert viewer._TEMPLATE == jax_viewer._TEMPLATE
    assert viewer.CAMERA_JS == jax_viewer.CAMERA_JS and 'function frameCamera' in viewer.CAMERA_JS
    assert viewer.STANDARD_BONES == jax_viewer.STANDARD_BONES
    assert 'frameCamera(framePoints' in live._PAGE and "'s'" in live._PAGE


# -- RFC 6455 framing ---------------------------------------------------------

def test_accept_key_rfc_vector():
    # the worked example from RFC 6455 §1.3
    assert ws.accept_key('dGhlIHNhbXBsZSBub25jZQ==') == 's3pPLMBiTxaQ9kYGzzhZRbK+xOo='
    assert ws.handshake_response('abc') == jax_ws.handshake_response('abc')


@pytest.mark.parametrize('n', [0, 1, 125, 126, 300, 70000])
def test_frame_roundtrip_sizes(n):
    payload = bytes(i % 251 for i in range(n))
    server_frame = ws.encode_frame(payload)
    assert server_frame == jax_ws.encode_frame(payload)
    assert ws.decode_frames(server_frame) == ([(ws.OP_TEXT, payload)], b'')
    client_frame = ws.encode_client_frame(payload)
    assert client_frame == jax_ws.encode_client_frame(payload)
    assert ws.decode_frames(client_frame) == ([(ws.OP_TEXT, payload)], b'')


def test_partial_and_concatenated_frames():
    a = ws.encode_client_frame(b'first')
    b = ws.encode_client_frame(b'second', opcode=ws.OP_PING)
    msgs, rest = ws.decode_frames(a + b[:3])
    assert msgs == [(ws.OP_TEXT, b'first')] and rest == b[:3]
    assert ws.decode_frames(rest + b[3:]) == ([(ws.OP_PING, b'second')], b'')


def _frame(fin, opcode, payload, mask=b'\x01\x02\x03\x04'):
    head = bytes([(0x80 if fin else 0) | opcode, 0x80 | len(payload)])
    return head + mask + bytes(c ^ mask[i % 4] for i, c in enumerate(payload))


def test_fragmented_message_reassembly():
    a = _frame(False, ws.OP_TEXT, b'hello ')
    b = _frame(True, ws.OP_CONT, b'world')
    assert ws.decode_frames(a + b) == ([(ws.OP_TEXT, b'hello world')], b'')
    assert ws.decode_frames(a) == ([], a)
    assert ws.decode_frames(a + b) == jax_ws.decode_frames(a + b)
    parts = (_frame(False, ws.OP_TEXT, b'a') + _frame(False, ws.OP_CONT, b'b')
             + _frame(True, ws.OP_CONT, b'c'))
    assert ws.decode_frames(parts) == ([(ws.OP_TEXT, b'abc')], b'')
    # a control frame between a fragment's start and its end: withheld with
    # the fragment, then delivered once
    start, ping = _frame(False, ws.OP_TEXT, b'par'), _frame(True, ws.OP_PING, b'hb')
    msgs, rest = ws.decode_frames(start + ping)
    assert msgs == []
    assert ws.decode_frames(rest + _frame(True, ws.OP_CONT, b'tial')) == (
        [(ws.OP_PING, b'hb'), (ws.OP_TEXT, b'partial')], b'')


# -- meshes -------------------------------------------------------------------

def test_obj_and_ply_parsing_and_decimate(tmp_path):
    (tmp_path / 'm.obj').write_text(OBJ)
    (tmp_path / 'm.ply').write_text(PLY)
    for fn, name, n_v, n_e in ((mesh.parse_obj, 'm.obj', 4, 6), (mesh.parse_ply_ascii, 'm.ply', 3, 3)):
        verts, edges = fn(str(tmp_path / name))
        jverts, jedges = getattr(jax_mesh, fn.__name__)(str(tmp_path / name))
        assert verts.shape == (n_v, 3) and len(edges) == n_e
        assert np.array_equal(verts, jverts) and np.array_equal(edges, jedges)
    verts = np.arange(30, dtype=np.float32).reshape(10, 3)
    edges = np.array([[0, 9], [1, 8], [2, 7], [3, 6]], np.int32)
    v2, e2 = mesh.decimate((verts, edges), max_edges=2)
    jv2, je2 = jax_mesh.decimate((verts, edges), max_edges=2)
    assert len(e2) == 2 and len(v2) == len(np.unique(e2))
    assert np.array_equal(v2, jv2) and np.array_equal(e2, je2)
    (tmp_path / 'bad.ply').write_text('not a ply\n')
    assert mesh.load_mesh(str(tmp_path / 'bad.ply')) is None
    assert mesh.load_mesh(str(tmp_path / 'm.stl')) is None


def test_load_body_meshes_name_matching(tmp_path):
    (tmp_path / 'pelvis.obj').write_text(OBJ)
    (tmp_path / 'femur.obj').write_text(OBJ)
    (tmp_path / 'tibia_l.ply').write_text(PLY)
    names = ['pelvis', 'femur_l', 'femur_r', 'tibia_l', 'missing']
    meshes = mesh.load_body_meshes(str(tmp_path), names)
    jmeshes = jax_mesh.load_body_meshes(str(tmp_path), names)
    assert set(meshes) == set(jmeshes) == {'pelvis', 'femur_l', 'femur_r', 'tibia_l'}
    for k in meshes:
        assert all(np.array_equal(a, b) for a, b in zip(meshes[k], jmeshes[k]))
    # a left body on a shared mesh is mirrored in z; its own file is not
    assert np.allclose(meshes['femur_l'][0][:, 2], -meshes['femur_r'][0][:, 2])
    assert mesh.load_body_meshes(str(tmp_path / 'nowhere'), names) == {}


# -- sessions -----------------------------------------------------------------

def test_session_transport():
    seen = []
    s = LiveSession(20, lambda f: {'f': f}, on_report=lambda: seen.append(1))
    assert s.tick()['frame'] == 0 and s.frame == 1   # playing advances
    s.key(' ')
    assert not s.playing
    assert s.tick()['frame'] == 1 and s.frame == 1   # paused holds
    s.key('e')
    assert s.frame == 2
    s.key('a')
    assert s.frame == 1
    s.key('r')
    assert seen == [1]
    s.frame = 14                                     # wrap at num_frames - 5
    s.key('e')
    assert s.frame == 0
    s.key('a')
    assert s.frame == 14


def test_session_subject_cycling():
    s = LiveSession(30, lambda f: {'f': f}, jump_points=[0, 10, 22])
    s.key(' ')
    for want in (10, 22, 0):
        s.key('s')
        assert s.frame == want
    s.frame = 15
    s.key('s')
    assert s.frame == 22
    s2 = LiveSession(10, lambda f: {'f': f})
    s2.key(' ')
    s2.key('s')
    assert s2.frame == 0


@pytest.mark.parametrize('keys', ['', ' eee', ' a', 'n', 'nn e', ' eeeeea'])
def test_segment_review_session_matches_the_jax_one(keys):
    segs = [(0, 10, 14, 'WIP'), (1, 50, 52, 'BAD')]
    sessions = [cls(segs, lambda t, f: {'t': t, 'f': f})
                for cls in (SegmentReviewSession, jax_review.SegmentReviewSession)]
    packets = []
    for s in sessions:
        out = [s.tick()]
        for k in keys:
            s.key(k)
            out.append((s.frame, s.segment_index, s.playing, s.num_frames))
        out.append(s.tick())
        packets.append(out)
    assert packets[0] == packets[1]
    assert 'state=' in packets[0][-1]['hud']
    with pytest.raises(ValueError, match='no suspicious segments'):
        SegmentReviewSession([], lambda t, f: {})


def test_find_suspicious_segments_matches_the_jax_one():
    rng = np.random.default_rng(0)
    for loss in (rng.gamma(1.0, size=200), np.zeros(0), np.r_[np.ones(5), 9.0, 9.0]):
        for ratio in (1.25, 3.0):
            assert (find_suspicious_segments(loss, ratio)
                    == jax_review.find_suspicious_segments(loss, ratio))


# -- servers end to end -------------------------------------------------------

def _ws_client(port):
    """A stdlib WebSocket client: the handshake, then the framed socket."""
    c = socket.create_connection(('127.0.0.1', port), timeout=10)
    c.sendall(b'GET /ws HTTP/1.1\r\nHost: x\r\nUpgrade: websocket\r\n'
              b'Connection: Upgrade\r\nSec-WebSocket-Key: dGhlIHNhbXBsZSBub25jZQ==\r\n'
              b'Sec-WebSocket-Version: 13\r\n\r\n')
    buf = b''
    while b'\r\n\r\n' not in buf:
        buf += c.recv(4096)
    head, buf = buf.split(b'\r\n\r\n', 1)
    assert b'101' in head.split(b'\r\n')[0]
    assert b's3pPLMBiTxaQ9kYGzzhZRbK+xOo=' in head
    return c, buf


def _recv_messages(c, buf, n, timeout=15):
    msgs = []
    deadline = time.time() + timeout
    while len(msgs) < n and time.time() < deadline:
        got, buf = ws.decode_frames(buf)
        msgs.extend(json.loads(p) for op, p in got if op == ws.OP_TEXT)
        if len(msgs) >= n:
            break
        try:
            chunk = c.recv(65536)
        except socket.timeout:
            continue
        if not chunk:
            break
        buf += chunk
    assert len(msgs) >= n, f'got {len(msgs)} messages'
    return msgs, buf


@pytest.fixture(scope='module')
def subject(tmp_path_factory):
    d = tmp_path_factory.mktemp('torch_viz')
    write_synthetic_subject(str(d / 's.b3d'), num_trials=1, trial_length=60, seed=0)
    geom = d / 'Geometry'
    geom.mkdir()
    (geom / 'pelvis.obj').write_text(OBJ)
    return d, geom


def _wait(cond, seconds=5.0):
    deadline = time.time() + seconds
    while not cond() and time.time() < deadline:
        time.sleep(0.02)
    return cond()


def test_live_server_end_to_end(subject):
    d, geom = subject
    ds = WindowDataset(str(d), window_size=20, stride=5)
    session, init = build_live_session(ds, geometry_folder=str(geom), device='cpu')
    server = LiveViewerServer(session, init, title='test', port=0, tick_interval=0.02)
    port = server.start()
    try:
        h = socket.create_connection(('127.0.0.1', port), timeout=10)
        h.sendall(b'GET / HTTP/1.1\r\nHost: x\r\n\r\n')
        page = b''
        while b'</html>' not in page:
            chunk = h.recv(65536)
            if not chunk:
                break
            page += chunk
        h.close()
        assert b'WebSocket' in page and b'function frameCamera' in page

        c, buf = _ws_client(port)
        msgs, buf = _recv_messages(c, buf, 3)
        assert msgs[0]['type'] == 'init' and msgs[0]['title'] == 'test'
        assert set(msgs[0]['meshes']) == {'pelvis'} and msgs[0]['bones']
        frames = [m for m in msgs if m['type'] == 'frame']
        assert frames
        f = frames[0]
        assert len(f['joints']) == 12 and len(f['label_forces']) == 2
        assert len(f['bodies']['pelvis']['R']) == 9 and f['total'] == len(ds)

        c.sendall(ws.encode_client_frame(json.dumps({'type': 'key', 'key': ' '}).encode()))
        assert _wait(lambda: not session.playing)
        c.sendall(ws.encode_client_frame(b'ping!', opcode=ws.OP_PING))
        deadline = time.time() + 5
        pong = False
        while not pong and time.time() < deadline:
            got, buf = ws.decode_frames(buf)
            pong = (ws.OP_PONG, b'ping!') in got
            if not pong:
                buf += c.recv(65536)
        assert pong
        c.sendall(ws.encode_client_frame(b'', opcode=ws.OP_CLOSE))
        assert _wait(lambda: not server._clients)
        c.close()
    finally:
        server.stop()


def test_segment_review_server_end_to_end(subject):
    d, _ = subject
    ds = WindowDataset(str(d), window_size=20, stride=5)
    server = serve_segment_review(ds, [(0, 5, 15, 'WIP'), (0, 30, 40, 'GOOD')], port=0,
                                  block=False, device='cpu')
    try:
        c, buf = _ws_client(server.port)
        msgs, buf = _recv_messages(c, buf, 3)
        assert msgs[0]['type'] == 'init' and msgs[0]['title'].endswith('(review)')
        frames = [m for m in msgs if m['type'] == 'frame']
        assert frames and 5 <= frames[0]['frame'] < 15
        assert 'segment 1/2' in frames[0]['hud'] and len(frames[0]['label_forces']) == 2
        c.sendall(ws.encode_client_frame(json.dumps({'type': 'key', 'key': 'n'}).encode()))
        assert _wait(lambda: server.session.segment_index == 1)
        c.close()
    finally:
        server.stop()
