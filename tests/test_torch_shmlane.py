"""The same-host shared-memory lane in both packages: the thirteen cases
of ``tests/test_shmlane.py`` as the JAX package's suite writes them (ring
arithmetic, the wrap marker and tail skip, refusal and corruption,
``MXNET_KVSTORE_SHM`` parsing, frame fuzz through a real segment in both
codecs, the dead flag, the wedge plan and the stall watchdog), each run
once against the JAX package and once against the port; then a lane
shared across the packages: a follower of one package and a leader of
the other exchange frames through one segment, and the records are the
same bytes either package would write."""
import struct

import numpy as np
import pytest

from torch_both import both_packages
import mxnet_tpu as _jpkg
import mxnet_tpu_torch as _tpkg
import torch_threads  # noqa: F401  a worker's share of the cores

import mxnet_tpu as mx
import mxnet_tpu.shmlane  # noqa: F401  a submodule neither package imports
import mxnet_tpu.kvstore_server  # noqa: F401
import mxnet_tpu_torch as mt
import mxnet_tpu_torch.shmlane  # noqa: F401


def _bind(p):
    return dict(faultinject=p.faultinject, shmlane=p.shmlane,
                wc=p.wirecodec, MXNetError=p.base.MXNetError,
                _HEADER=p.shmlane._HEADER, _REQ_DESC=p.shmlane._REQ_DESC,
                _Ring=p.shmlane._Ring)


pkg = both_packages(globals(), _bind)


@pytest.fixture(autouse=True)
def _clean_slate():
    """Each case leaves both packages' flight recorders clean and no fault
    plan armed (a lane's fallback notes channel trouble, which a later
    test file in the same worker would read as a CRITICAL verdict)."""
    yield
    for p in (_jpkg, _tpkg):
        p.health.reset()
        p.faultinject.reset()


# ---------------------------------------------------------------------------
# ring units (over a plain bytearray — no shared segment needed)
# ---------------------------------------------------------------------------
def _ring(cap=64):
    buf = bytearray(_HEADER + cap)
    _Ring.format(buf, _REQ_DESC, _HEADER, cap)
    return _Ring(buf, _REQ_DESC)


def test_ring_push_pop_fifo():
    r = _ring()
    assert r.try_pop() is None
    for i in range(3):
        assert r.try_push([b"rec%d" % i], 4)
    assert [r.try_pop() for _ in range(3)] == [b"rec0", b"rec1", b"rec2"]
    assert r.try_pop() is None


def test_ring_wraps_and_keeps_order():
    r = _ring(cap=32)
    # records are 4B header + 10B payload = 14B; the third forces a
    # wrap marker / tail skip every few pushes — order must survive
    # dozens of laps (free-running indices exercise the mod-2^32 math)
    for lap in range(50):
        payload = b"%010d" % lap
        assert r.try_push([payload], 10), lap
        assert r.try_pop() == payload
    # interleave at depth 2 where it fits
    a, b = b"aaaa", b"bbbb"
    assert r.try_push([a], 4) and r.try_push([b], 4)
    assert r.try_pop() == a and r.try_pop() == b


def test_ring_refuses_what_cannot_fit():
    r = _ring(cap=32)
    assert not r.try_push([b"x" * 40], 40)      # bigger than the ring
    assert r.try_push([b"y" * 20], 20)
    assert not r.try_push([b"z" * 20], 20)      # no free space NOW
    assert r.try_pop() == b"y" * 20
    assert r.try_push([b"z" * 20], 20)          # fits after the drain


def test_ring_multi_part_record_concatenates():
    r = _ring()
    parts = [b"head", memoryview(b"-mid-"), np.arange(3, dtype=np.uint8)]
    assert r.try_push(parts, 4 + 5 + 3)
    assert r.try_pop() == b"head-mid-" + bytes([0, 1, 2])


def test_ring_detects_corrupt_length():
    r = _ring(cap=32)
    assert r.try_push([b"abcd"], 4)
    # scribble a absurd length over the record header
    struct.pack_into("<I", r._buf, r._data, 0x7FFFFFFF)
    with pytest.raises(MXNetError, match="corruption"):
        r.try_pop()


# ---------------------------------------------------------------------------
# gating
# ---------------------------------------------------------------------------
def test_mode_parsing(monkeypatch):
    for raw, want in [("1", "on"), ("on", "on"), ("true", "on"),
                      ("0", "off"), ("off", "off"), ("no", "off"),
                      ("auto", "auto"), ("", "auto"), ("bogus", "auto")]:
        monkeypatch.setenv("MXNET_KVSTORE_SHM", raw)
        assert shmlane.mode() == want, raw


def test_client_enabled_auto_is_local_only(monkeypatch):
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "auto")
    assert shmlane.client_enabled("127.0.0.1")
    assert shmlane.client_enabled("localhost")
    assert not shmlane.client_enabled("203.0.113.7")   # TEST-NET
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "off")
    assert not shmlane.client_enabled("127.0.0.1")
    monkeypatch.setenv("MXNET_KVSTORE_SHM", "on")
    assert shmlane.client_enabled("203.0.113.7")


# ---------------------------------------------------------------------------
# lane over a real segment: frame fuzz, both codecs, frame_len agrees
# ---------------------------------------------------------------------------
def _lane_pair():
    follower = shmlane.ShmLane.create(nbytes=256 * 1024)
    leader = shmlane.ShmLane.attach(follower.name)
    return follower, leader


def test_lane_fuzz_round_trip_binary_and_pickle():
    """Envelopes through a REAL shared segment, alternating the binary
    v2 codec and the pickle fallback: decoded objects are bit-identical
    and every ring record is exactly one wire frame by frame_len."""
    rng = np.random.default_rng(0x5713)
    follower, leader = _lane_pair()
    try:
        for trial in range(40):
            arr = np.asarray(
                rng.random((int(rng.integers(1, 6)),
                            int(rng.integers(1, 6)))) * 64,
                dtype=[np.float32, np.float16, np.int64][trial % 3])
            inner = ("mesh_push", trial, [("w", arr)])
            msg = ("req", (1, "n%d" % trial), trial, inner)
            binary = trial % 2 == 0
            assert follower.send_request(msg, binary_ok=binary)
            got = leader.recv_request()
            assert got[0] == "req" and got[2] == trial
            g = dict(got[3][2])["w"]
            assert g.dtype == arr.dtype and np.array_equal(g, arr)
            reply = ("ok", {"w": arr * 2})
            assert leader.send_reply(reply, binary_ok=binary)
            back = follower.recv_reply()
            assert back[0] == "ok"
            assert np.array_equal(back[1]["w"], arr * 2)
        assert leader.recv_request() is None
        assert follower.recv_reply() is None
    finally:
        leader.close()
        follower.destroy()


def test_frame_len_names_both_framings():
    head, bufs = wc.encode_frame(("ok", np.arange(4, dtype=np.float32)))
    frame = bytes(head) + b"".join(bytes(b) for b in bufs)
    assert wc.frame_len(frame[:13]) == len(frame)
    import pickle
    skel = pickle.dumps(("ok", None), protocol=pickle.HIGHEST_PROTOCOL)
    pframe = struct.pack(">QI", 4 + len(skel), len(skel)) + skel
    assert wc.frame_len(pframe[:13]) == len(pframe)
    with pytest.raises(ValueError):
        wc.frame_len(b"\xb1\x00\x00")   # too short to name a length


def test_oversized_frame_reports_unsent():
    follower, leader = _lane_pair()
    try:
        big = ("req", (1, "n"), 0,
               ("mesh_push", 0, [("w", np.zeros(1 << 20,
                                               dtype=np.float64))]))
        assert not follower.send_request(big)    # rides TCP that round
        assert leader.recv_request() is None
    finally:
        leader.close()
        follower.destroy()


def test_dead_flag_is_shared_and_send_refuses():
    follower, leader = _lane_pair()
    try:
        assert not follower.dead() and not leader.dead()
        leader.mark_dead()
        assert follower.dead()
        assert not follower.send_request(("req", (1, "n"), 0,
                                          ("command", "flush")))
    finally:
        leader.close()
        follower.destroy()


# ---------------------------------------------------------------------------
# wedge gate + stall watchdog
# ---------------------------------------------------------------------------
def test_wedge_gate_stops_drain_after_n_frames():
    faultinject.reset()
    follower, leader = _lane_pair()
    try:
        with faultinject.shm_wedge_after_frames(2):
            for seq in range(4):
                assert follower.send_request(
                    ("req", (1, "n%d" % seq), seq, ("command", "x")))
            got = [leader.recv_request() for _ in range(6)]
            served = [g for g in got if g is not None]
            assert len(served) == 2, got       # then the drain wedges
            assert faultinject.stats()["shm_frames_wedged"] > 0
            assert follower.request_backlog() > 0
    finally:
        faultinject.reset()
        leader.close()
        follower.destroy()


def test_drain_stalled_fires_only_without_progress(monkeypatch):
    import time
    follower, leader = _lane_pair()
    try:
        assert not follower.drain_stalled(0.05)   # empty ring: never
        assert follower.send_request(("req", (1, "n"), 0,
                                      ("command", "x")))
        assert not follower.drain_stalled(0.05)   # first sight arms it
        time.sleep(0.08)
        assert follower.drain_stalled(0.05)       # no progress past budget
        assert leader.recv_request() is not None  # progress …
        assert not follower.drain_stalled(0.05)   # … clears the clock
    finally:
        leader.close()
        follower.destroy()


# ---------------------------------------------------------------------------
# one lane across the packages
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("follower_pkg", ["jax", "port"])
def test_lane_shared_across_packages(follower_pkg):
    """A follower of one package creates the segment, a leader of the
    other attaches it: the header checks pass, every request and reply
    decodes to the same arrays in both codecs, and a record's bytes are
    the frame the other package's lane writes for the same message."""
    fp, lp = (mx, mt) if follower_pkg == "jax" else (mt, mx)
    follower = fp.shmlane.ShmLane.create(nbytes=64 * 1024)
    leader = lp.shmlane.ShmLane.attach(follower.name)
    try:
        rng = np.random.default_rng(7)
        for trial in range(6):
            arr = np.asarray(rng.random((3, 5)) * 8, np.float32)
            msg = ("req", (1, "n%d" % trial), trial,
                   ("mesh_push", trial, [("w", arr)]))
            binary = trial % 2 == 0
            assert follower.send_request(msg, binary_ok=binary)
            got = leader.recv_request()
            assert got[2] == trial
            np.testing.assert_array_equal(dict(got[3][2])["w"], arr)
            assert leader.send_reply(("ok", {"w": arr * 2}),
                                     binary_ok=binary)
            back = follower.recv_reply()
            np.testing.assert_array_equal(back[1]["w"], arr * 2)
            # the record the follower's package wrote is the other
            # package's frame, byte for byte
            for pk in (mx, mt):
                parts, n, _, _ = pk.kvstore_server._frame_parts(msg, binary)
                frame = b"".join(bytes(memoryview(p).cast("B"))
                                 for p in parts)
                assert len(frame) == n
                ring = pk.shmlane._Ring(bytearray(
                    pk.shmlane._HEADER + 4096), pk.shmlane._REQ_DESC)
                pk.shmlane._Ring.format(ring._buf, pk.shmlane._REQ_DESC,
                                        pk.shmlane._HEADER, 4096)
                ring = pk.shmlane._Ring(ring._buf, pk.shmlane._REQ_DESC)
                assert ring.try_push(parts, n)
                assert ring.try_pop() == frame
            ref = mx.kvstore_server._frame_parts(msg, binary)[0]
            ours = mt.kvstore_server._frame_parts(msg, binary)[0]
            assert b"".join(bytes(memoryview(p).cast("B")) for p in ref) \
                == b"".join(bytes(memoryview(p).cast("B")) for p in ours)
    finally:
        leader.close()
        follower.destroy()


def test_lane_header_is_the_jax_packages():
    """The segment's first 48 bytes (magic, version, flags and the two
    ring descriptors) are the JAX package's for the same size."""
    a = mx.shmlane.ShmLane.create(nbytes=16 * 1024)
    b = mt.shmlane.ShmLane.create(nbytes=16 * 1024)
    try:
        assert bytes(a._buf[:48]) == bytes(b._buf[:48])
        assert struct.unpack_from("<II", b._buf, 0) == (0x4D58534C, 1)
    finally:
        a.destroy()
        b.destroy()
