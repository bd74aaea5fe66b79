"""The port's copy of the binary wire codec and frame layer against the
JAX package's: the cases of ``tests/test_wirecodec.py`` through the
port, and every frame the fuzz builds compared with the JAX package's
frame of the same message, byte for byte (binary v2 and pickle
framings, dense, compressed and row-sparse payloads, replies).  Both
decoders refuse the same hostile frames."""
import pickle
import socket
import struct
import time

import numpy as np
import pytest

import mxnet_tpu.compression as jcomp
import mxnet_tpu.kvstore_server as jsrv
import mxnet_tpu.wirecodec as jwc
import mxnet_tpu_torch as mt
from mxnet_tpu_torch import profiler as prof
from mxnet_tpu_torch import wirecodec as wc
from mxnet_tpu_torch.compression import RowSparsePayload, WirePayload
from mxnet_tpu_torch.kvstore_server import (_frame_parts, _pack, _recv_msg,
                                            _restricted_loads, _send_msg,
                                            _send_vec, _unpack)
from torch_dist import cluster, nd, pulled, zeros
import torch_threads  # noqa: F401,E402  a worker's share of the cores

SHAPE = (4, 4)


class _RecordingSock:
    def __init__(self):
        self.parts = []

    def sendall(self, data):
        self.parts.append(bytes(data))


class _RecordingVecSock(_RecordingSock):
    def __init__(self):
        super().__init__()
        self.calls = 0

    def sendmsg(self, buffers):
        self.calls += 1
        chunk = [bytes(b) for b in buffers]
        self.parts.extend(chunk)
        return sum(len(b) for b in chunk)


def _to_jax(obj):
    """The same message built from the JAX package's payload classes."""
    if isinstance(obj, WirePayload):
        return jcomp.WirePayload(obj.kind, obj.shape, obj.threshold,
                                 _to_jax(obj.data))
    if isinstance(obj, RowSparsePayload):
        return jcomp.RowSparsePayload(obj.indices, obj.nrows,
                                      _to_jax(obj.data))
    if isinstance(obj, tuple):
        return tuple(_to_jax(x) for x in obj)
    if isinstance(obj, list):
        return [_to_jax(x) for x in obj]
    if isinstance(obj, dict):
        return {k: _to_jax(v) for k, v in obj.items()}
    return obj


def _same_frames(msg):
    """The port's frame of ``msg`` equals the JAX package's, byte for
    byte, in both framings."""
    for binary in (True, False):
        port = b"".join(bytes(p) for p in _frame_parts(msg, binary)[0])
        jax = b"".join(bytes(p) for p in
                       jsrv._frame_parts(_to_jax(msg), binary)[0])
        assert port == jax, (binary, msg)


def test_pickle_frame_header_arithmetic_is_unchanged():
    """``>QI``(total, skel_len), the skeleton, the buffers; the header
    its own 12-byte buffer; the skeleton decodes through the allowlist."""
    sock = _RecordingSock()
    arr = np.arange(12, dtype=np.float32).reshape(3, 4)
    _send_msg(sock, ("push", "w", arr))
    assert len(sock.parts[0]) == 12
    total, skel_len = struct.unpack(">QI", sock.parts[0])
    assert len(sock.parts[1]) == skel_len
    assert total == 4 + skel_len + arr.nbytes
    assert sock.parts[2] == arr.tobytes()
    op, key, _buf = _restricted_loads(sock.parts[1])
    assert (op, key) == ("push", "w")
    _same_frames(("push", "w", arr))


def test_binary_frame_same_arithmetic_behind_magic():
    sock = _RecordingVecSock()
    wc.register(sock, 1)
    arr = np.ones((2, 5), dtype=np.float16)
    _send_msg(sock, ("ok", arr))
    head = sock.parts[0]
    assert head[0] == wc.FRAME_MAGIC == jwc.FRAME_MAGIC
    total, desc_len = struct.unpack(">QI", head[1:13])
    assert len(head) == 13 + desc_len
    assert total == 4 + desc_len + arr.nbytes
    out = wc.decode_frame(head[13:], sock.parts[1])
    np.testing.assert_array_equal(out[1], arr)


def test_send_vec_chunks_at_iov_max_and_resumes_partials(monkeypatch):
    import mxnet_tpu_torch.kvstore_server as srv_mod

    class _Stingy:
        def __init__(self):
            self.out = b""
            self.calls = 0

        def sendmsg(self, buffers):
            self.calls += 1
            take = b"".join(bytes(b) for b in buffers)[:3]
            self.out += take
            return len(take)

    monkeypatch.setattr(srv_mod, "_IOV_MAX", 2)
    s = _Stingy()
    n = _send_vec(s, [b"abcd", b"", b"ef", b"ghij"])
    assert s.out == b"abcdefghij" and n == s.calls >= 4
    plain = _RecordingSock()
    assert _send_vec(plain, [b"ab", b"", b"cd"]) == 2
    assert plain.parts == [b"ab", b"cd"]


def _via_pickle(obj):
    bufs = []
    skel = pickle.loads(pickle.dumps(_pack(obj, bufs)))
    body = b"".join(np.ascontiguousarray(a).tobytes() for a in bufs)
    offsets, off = {}, 0
    for i, a in enumerate(bufs):
        offsets[i] = off
        off += a.nbytes
    return _unpack(skel, body, offsets)


def _via_codec(obj):
    head, bufs = wc.encode_frame(obj)
    body = b"".join(np.ascontiguousarray(a).tobytes() for a in bufs)
    return wc.decode_frame(bytes(head[13:]), body)


def _assert_identical(a, b):
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    elif isinstance(a, (tuple, list)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _assert_identical(x, y)
    elif isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _assert_identical(a[k], b[k])
    elif isinstance(a, WirePayload):
        _assert_identical(a.data, b.data)
        assert (a.kind, a.threshold, tuple(a.shape)) == \
            (b.kind, b.threshold, tuple(b.shape))
    elif isinstance(a, RowSparsePayload):
        assert a.nrows == b.nrows
        _assert_identical(a.indices, b.indices)
        _assert_identical(a.data, b.data)
    else:
        assert type(a) is type(b) and a == b


def _rand_rsp(rng, fp16=False, width=None, empty=False):
    nrows = int(rng.integers(4, 40))
    width = int(rng.integers(0, 5)) if width is None else width
    ids = np.zeros(0, np.int64) if empty else np.sort(rng.choice(
        nrows, size=int(rng.integers(1, nrows + 1)),
        replace=False)).astype(np.int64)
    rows = np.asarray(rng.random((ids.size, width)), dtype=np.float32)
    data = WirePayload("fp16", rows.shape, 0.0, rows.astype(np.float16)) \
        if fp16 else rows
    return RowSparsePayload(ids, nrows, data)


def test_codec_round_trip_fuzz_matches_pickle_path_and_the_jax_frames():
    """Randomized hot envelopes and replies (every dtype, 0-d, empty key
    lists, 255-byte keys, compressed and row-sparse payloads): the
    binary decode is bit-identical to the pickle path's, ``frame_len``
    names each emitted frame's length, and every frame is the JAX
    package's byte for byte."""
    rng = np.random.default_rng(0xC0DEC)
    dtypes = [np.float32, np.float64, np.float16, np.int32, np.int64,
              np.uint8, np.bool_]
    shapes = [(), (0,), (1,), (7,), (3, 4), (2, 3, 4), (1, 1, 1, 1)]

    def rand_arr():
        return np.asarray(rng.random(shapes[rng.integers(len(shapes))])
                          * 100, dtype=dtypes[rng.integers(len(dtypes))])
    max_key = "k" * 255
    for trial in range(60):
        kind = trial % 8
        if kind == 0:
            inner = ("push", max_key, rand_arr())
        elif kind == 1:
            inner = ("push_multi", [(f"w{i}", rand_arr())
                                    for i in range(int(rng.integers(0, 5)))])
        elif kind == 2:
            inner = ("pull", int(rng.integers(0, 1000)))
        elif kind == 3:
            inner = ("pull_rowsparse", "emb",
                     np.arange(int(rng.integers(0, 4)), dtype=np.int64))
        elif kind == 4:
            inner = ("predict", {"data": rand_arr(), "mask": rand_arr()})
        elif kind == 5:
            inner = ("push", "w", WirePayload(
                "2bit", (4, 4), 0.5,
                np.asarray(rng.integers(0, 255, 4), np.uint8)))
        elif kind == 6:
            inner = ("push", max_key, _rand_rsp(rng, fp16=bool(trial % 3)))
        else:
            inner = ("push_multi", [("e", _rand_rsp(rng, empty=True)),
                                    ("w", _rand_rsp(rng, width=0))])
        msg = ("req", (int(rng.integers(0, 8)), "nonce%d" % trial), trial,
               inner)
        assert wc.is_hot(msg)
        _assert_identical(_via_codec(msg), _via_pickle(msg))
        reply = ("ok", inner[-1] if kind != 2 else rand_arr())
        _assert_identical(_via_codec(reply), _via_pickle(reply))
        _same_frames(msg)
        _same_frames(reply)
        for version in (1, 0):
            sock = _RecordingVecSock()
            wc.register(sock, version)
            _send_msg(sock, msg)
            frame = b"".join(sock.parts)
            assert wc.frame_len(frame[:13]) == len(frame)


def test_codec_falls_back_to_pickle_outside_vocabulary():
    class Custom:
        pass
    assert wc.encode_frame(("ok", Custom())) is None
    assert wc.encode_frame(("ok", 1 << 70)) is None
    assert wc.encode_frame(("ok", np.array([object()], dtype=object))) \
        is None
    sock = _RecordingSock()
    wc.register(sock, 1)
    _send_msg(sock, ("ok", {1, 2}))
    assert sock.parts[0][0] != wc.FRAME_MAGIC


def test_hot_gating_matches_the_jax_package():
    assert wc.HOT_OPS == jwc.HOT_OPS
    assert wc.CODEC_VERSION == jwc.CODEC_VERSION
    assert wc.CODEC_TABLE_FINGERPRINT == jwc.CODEC_TABLE_FINGERPRINT
    for op in sorted(wc.HOT_OPS):
        assert wc.is_hot(("req", (0, "n"), 1, (op, "x")))
    for op in ("stats", "roster_beat", "handoff", "barrier"):
        assert not wc.is_hot(("req", (0, "n"), 1, (op,)))
    assert wc.is_hot(("ok", None)) and wc.is_hot(("err", "boom"))
    assert not wc.is_hot(("ping", 0))
    assert wc.hello_msg() == jwc.hello_msg()


def _frame_of(obj):
    head, bufs = wc.encode_frame(obj)
    return bytes(head[13:]), b"".join(
        memoryview(np.ascontiguousarray(a)).cast("B") for a in bufs)


def _rsp(ids, nrows, rows):
    return RowSparsePayload(np.asarray(ids), nrows,
                            np.asarray(rows, dtype=np.float32))


HOSTILE = [
    ("truncated_desc", lambda d, b: (d[:-1], b)),
    ("trailing_desc", lambda d, b: (d + b"\x00", b)),
    ("trailing_body", lambda d, b: (d, b + b"\x00")),
    ("truncated_body", lambda d, b: (d, b[:-1])),
    ("huge_tuple", lambda d, b: (b"\x07\xff\xff\xff\xff" + d, b)),
    ("unknown_tag", lambda d, b: (b"\xfe" + d, b)),
    ("object_dtype", lambda d, b: (bytes([0x0A, 3]) + b"|O8" + bytes([1])
                                   + struct.pack(">q", 1), b"\x00" * 8)),
    ("overrun", lambda d, b: (bytes([0x0A, 3]) + b"<f8" + bytes([1])
                              + struct.pack(">q", 10), b"\x00" * 8)),
    ("negative_dim", lambda d, b: (bytes([0x0A, 3]) + b"<f8" + bytes([1])
                                   + struct.pack(">q", -1), b"")),
] + [(f"rowsparse_{name}", (lambda p: lambda d, b: _frame_of(("ok", p)))(p))
     for name, p in (
         ("negative_id", _rsp(np.array([-1], np.int64), 8, np.ones((1, 2)))),
         ("duplicate", _rsp(np.array([3, 3], np.int64), 8, np.ones((2, 2)))),
         ("unsorted", _rsp(np.array([5, 3], np.int64), 8, np.ones((2, 2)))),
         ("past_nrows", _rsp(np.array([9], np.int64), 8, np.ones((1, 2)))),
         ("mismatch", _rsp(np.array([1, 2], np.int64), 8, np.ones((3, 2)))),
         ("negative_nrows", _rsp(np.array([1], np.int64), -1,
                                 np.ones((1, 2)))),
         ("float_ids", _rsp(np.array([1.0], np.float32), 8,
                            np.ones((1, 2)))),
         ("2d_ids", _rsp(np.array([[1]], np.int64), 8, np.ones((1, 2)))))]


@pytest.mark.parametrize("mutate", [m for _n, m in HOSTILE],
                         ids=[n for n, _m in HOSTILE])
def test_decode_rejects_malformed_frames(mutate):
    """Both packages' decoders refuse the same hostile descriptors."""
    desc, body = mutate(*_frame_of(("ok", np.arange(6, dtype=np.float64))))
    with pytest.raises(ValueError):
        wc.decode_frame(desc, body)
    with pytest.raises(ValueError):
        jwc.decode_frame(desc, body)


@pytest.mark.parametrize("frame", ["tuple_claim", "duplicate_rows"])
def test_wire_rejects_hostile_binary_frame(monkeypatch, frame):
    """A malformed binary frame drops its connection with no side
    effect; the server keeps serving well-formed clients."""
    with cluster(mt, monkeypatch) as (srv,):
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        if frame == "tuple_claim":
            desc = b"\x07\xff\xff\xff\xff"
            s.sendall(bytes([wc.FRAME_MAGIC])
                      + struct.pack(">QI", 4 + len(desc), len(desc)) + desc)
        else:
            bad = RowSparsePayload(np.array([3, 3], np.int64), 8,
                                   np.ones((2, 2), np.float32))
            head, bufs = wc.encode_frame(("req", (0, "h0"), 1,
                                          ("push", "emb", bad)))
            s.sendall(bytes(head) + b"".join(
                np.ascontiguousarray(a).tobytes() for a in bufs))
        with pytest.raises((ConnectionError, OSError)):
            _recv_msg(s)
        s.close()
        kv = mt.kv.create('dist_async')
        kv.init('ok', nd(mt, np.ones(SHAPE)))
        np.testing.assert_array_equal(pulled(mt, kv, 'ok', SHAPE), 1.0)
        kv.close(stop_servers=True)


def test_hello_negotiates_and_pickle_mode_pins_version_zero(monkeypatch):
    with cluster(mt, monkeypatch) as (srv,):
        for mode, want in (("auto", wc.CODEC_VERSION), ("pickle", 0)):
            monkeypatch.setenv("MXNET_KVSTORE_CODEC", mode)
            s = socket.create_connection(("127.0.0.1", srv.port),
                                         timeout=5)
            _send_msg(s, wc.hello_msg())
            assert _recv_msg(s) == ("ok", want)
            s.close()


def test_client_hello_reads_old_peer_acks_as_version_zero():
    class _S:
        pass
    got = []
    for reply in [("ok", None), ("err", "ValueError: unknown op"),
                  ("ok", True), ("ok", 1)]:
        sock = _S()
        got.append(wc.client_hello(sock, lambda s, m, byte_kind: None,
                                   lambda s, byte_kind: reply))
        assert wc.sock_binary(sock) == (got[-1] >= 1)
    assert got == [0, 0, 0, 1]


def test_pickle_pin_keeps_wire_correct_and_codec_silent(monkeypatch):
    with cluster(mt, monkeypatch, MXNET_KVSTORE_CODEC="pickle"):
        kv = mt.kv.create('dist_async')
        kv.init('w', zeros(mt, SHAPE))
        prof.reset_serialization()
        for i in range(4):
            kv.push('w', nd(mt, np.ones(SHAPE) * (i + 1)))
        np.testing.assert_array_equal(pulled(mt, kv, 'w', SHAPE), 4.0)
        counts = prof.serialization_counts()
        assert counts.get("codec_bytes", 0) == 0, counts
        assert counts.get("pickle_bytes", 0) > 0, counts
        kv.close(stop_servers=True)


def test_heartbeat_bytes_count_as_control_and_steady_state_is_binary(
        monkeypatch):
    """Idle heartbeats move only the control family; a warmed-up
    push / pull stream pickles nothing while heartbeats beat."""
    with cluster(mt, monkeypatch, MXNET_KVSTORE_HEARTBEAT_INTERVAL=0.05):
        kv = mt.kv.create('dist_async')
        kv.init('w', zeros(mt, SHAPE))
        kv.push('w', nd(mt, np.ones(SHAPE)))
        pulled(mt, kv, 'w', SHAPE)
        time.sleep(0.3)
        prof.reset_channel_bytes()
        time.sleep(0.4)
        assert prof.control_bytes_total() > 0
        assert prof.wire_bytes_total() == 0, prof.channel_bytes()
        prof.reset_serialization()
        for i in range(10):
            kv.push('w', nd(mt, np.ones(SHAPE) * (i + 2)))
            out = pulled(mt, kv, 'w', SHAPE)
        time.sleep(0.2)
        counts = prof.serialization_counts()
        assert counts.get("pickle_bytes", 0) == 0, counts
        assert counts.get("codec_bytes", 0) > 0, counts
        np.testing.assert_array_equal(out, 11.0)
        kv.close(stop_servers=True)
