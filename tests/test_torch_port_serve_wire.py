"""The port's serving wire (``disco_tpu_torch.serve.protocol``, the session
checkpoints of ``serve.session``) against the JAX package's: frames are
byte for byte the reference's and each package decodes the other's;
malformed frames raise ``ProtocolError`` in both; a checkpoint the port
writes passes the reference's integrity probe and decodes to the
reference's config and envelope for the same session, and the reverse;
``SessionConfig`` accepts and rejects what the reference's does."""
import hashlib

import numpy as np
import pytest

from disco_tpu.enhance import streaming as jstream
from disco_tpu.serve import protocol as jproto
from disco_tpu.serve import session as jsession
from disco_tpu_torch.enhance import streaming as tstream
from disco_tpu_torch.nn.serialization import unpackb
from disco_tpu_torch.serve import protocol as tproto
from disco_tpu_torch.serve import session as tsession

K, C, F, U, BLOCK = 4, 2, 257, 4, 8


def _frames():
    rng = np.random.default_rng(5)
    Y = (rng.standard_normal((K, C, F, BLOCK))
         + 1j * rng.standard_normal((K, C, F, BLOCK))).astype(np.complex64)
    m = rng.uniform(0.05, 0.95, size=(K, F, BLOCK)).astype(np.float32)
    arrays = {dt: rng.standard_normal(6).astype(dt) for dt in
              ("<f4", "<f8", "<c8", "<c16", "<i4", "<i8", "<u1", "<u2", "<i2", "?")}
    return [
        {"type": "block", "seq": 3, "Y": Y, "mask_z": m, "mask_w": m,
         "trace": {"trace": "0123456789abcdef", "span": "fedcba9876543210"}},
        {"type": "open", "config": tsession.SessionConfig(
            n_nodes=K, mics_per_node=C, n_freq=F, block_frames=BLOCK, mu=1.2).to_dict(),
         "z_mask": np.array([1, 0, 1, 1], np.float32), "resume": None, "have": 7,
         "priority": True},
        {"type": "enhanced", "session": "s000001", "seq": 0, "yf": Y[:, 0]},
        {"type": "error", "code": "parked", "message": "é" * 40, "retry_after_s": 1.5,
         "resume": "s1"},
        {"type": "status_ok", "counters": {f"c{i}": i * 1000 for i in range(20)},
         "neg": [-1, -33, -200, -40000, -2 ** 33], "big": [200, 70000, 2 ** 40],
         "nested": {"a": [{"b": (1, 2.5, None, False)}], "e": [], "f": {}},
         "scalars": [np.float32(0.25), np.int64(-9), np.bool_(True)],
         "scalar_array": np.float64(3.0) * np.ones(()), "bin": b"\x00\xff" * 150, **{
             f"arr_{k}": a for k, a in arrays.items()}},
    ]


@pytest.mark.parametrize("i", range(5))
def test_frames_byte_identical_and_cross_decoded(i):
    frame = _frames()[i]
    port, ref = tproto.pack_frame(frame), jproto.pack_frame(frame)
    assert port == ref
    n = tproto.frame_header_size()
    a, b = tproto.unpack_payload(ref[n:]), jproto.unpack_payload(port[n:])
    assert set(a) == set(b) == set(frame)
    for k in frame:
        va, vb = a[k], b[k]
        if isinstance(va, np.ndarray):
            assert va.dtype == vb.dtype and np.array_equal(va, vb)
        else:
            assert va == vb


@pytest.mark.parametrize("payload", [
    b"\x81",                       # a map with its entry missing
    b"\x91\x01",                   # a list, not a map
    b"\xc1",                       # a never-used msgpack byte
    b"\x80",                       # a map without 'type'
    b"\x81\xa4type\xa1b\x00",      # trailing bytes
    tproto.pack_frame({"type": "block", "Y": {"__nd__": 1, "dtype": "<f4", "shape": [3],
                                              "data": b"\x00" * 8}})[4:],   # short array
    tproto.pack_frame({"type": "block", "Y": {"__nd__": 1, "dtype": "<c8", "shape": [2],
                                              "data": b"\x00" * 8}})[4:],   # no imag half
    tproto.pack_frame({"type": "block", "Y": {"__nd__": 1, "dtype": "zz", "shape": [1],
                                              "data": b""}})[4:],           # bad dtype
])
def test_malformed_frames_raise_protocol_error_in_both(payload):
    for mod in (tproto, jproto):
        with pytest.raises(mod.ProtocolError):
            mod.unpack_payload(payload)


def test_frame_size_bound_is_the_reference_bound():
    assert tproto.MAX_FRAME_BYTES == jproto.MAX_FRAME_BYTES == 64 << 20
    big = {"type": "block", "Y": np.zeros((tproto.MAX_FRAME_BYTES // 4 + 1,), np.float32)}
    with pytest.raises(tproto.ProtocolError):
        tproto.pack_frame(big)


def _host_state(seed):
    """A continuation state as the JAX package's streaming_tango leaves it
    after a block, as numpy (sorted keys, tuples)."""
    rng = np.random.default_rng(seed)
    Y = (rng.standard_normal((K, C, F, BLOCK))
         + 1j * rng.standard_normal((K, C, F, BLOCK))).astype(np.complex64) * 1e-3
    m = rng.uniform(0.05, 0.95, size=(K, F, BLOCK)).astype(np.float32)
    import jax

    out = jstream.streaming_tango(Y, m, m, update_every=U, policy="local",
                                  z_avail=np.ones((K, BLOCK // U), np.float32),
                                  state=jstream.initial_stream_state(K, C, F, update_every=U))
    return jax.tree_util.tree_map(np.asarray, out["state"])


def test_port_checkpoint_passes_the_reference_probe(tmp_path):
    cfg = tsession.SessionConfig(n_nodes=K, mics_per_node=C, n_freq=F, block_frames=BLOCK,
                                 update_every=U, mu=1.2, solver="fused")
    state = _host_state(1)
    sess = tsession.Session("s7", cfg, z_avail=np.array([[1, 0], [1, 1], [0, 1], [1, 1]],
                                                        np.float32),
                            state=tstream.state_from_numpy(state, "cpu"), blocks_done=5)
    path = tsession.save_session_state(tmp_path / "port.msgpack", sess)
    assert jsession.probe_session_state(path)
    js = jsession.load_session_state(path)
    assert js.id == "s7" and js.blocks_done == 5
    assert js.config == jsession.SessionConfig(**cfg.to_dict())
    np.testing.assert_array_equal(js.z_avail, sess.z_avail)
    for a, b in zip(tstream.state_leaves(js.state), tstream.state_leaves(state)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    # the envelope decodes to the reference's for the same session
    ref = jsession.Session("s7", js.config, z_avail=sess.z_avail, state=state, blocks_done=5)
    jpath = jsession.save_session_state(tmp_path / "ref.msgpack", ref)
    ep, er = unpackb(path.read_bytes()), unpackb(jpath.read_bytes())
    assert {k: v for k, v in ep.items() if k not in ("state", "state_sha256")} == \
        {k: v for k, v in er.items() if k not in ("state", "state_sha256")}
    assert hashlib.sha256(ep["state"]).hexdigest() == ep["state_sha256"]
    assert path.read_bytes() == jpath.read_bytes()


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    cfg = jsession.SessionConfig(n_nodes=K, mics_per_node=C, n_freq=F, block_frames=BLOCK,
                                 update_every=U)
    state = _host_state(2)
    path = jsession.save_session_state(tmp_path / "ref.msgpack",
                                       jsession.Session("r1", cfg, state=state, blocks_done=3))
    assert tsession.probe_session_state(path)
    ts = tsession.load_session_state(path)
    assert ts.config == tsession.SessionConfig(**cfg.to_dict()) and ts.blocks_done == 3
    for a, b in zip(tstream.state_leaves(ts.state), tstream.state_leaves(state)):
        assert np.array_equal(a, b)
    # a truncated or tampered checkpoint fails both probes
    raw = bytearray(path.read_bytes())
    at = bytes(raw).find(unpackb(bytes(raw))["state"]) + 1000   # inside the state payload
    (tmp_path / "cut.msgpack").write_bytes(bytes(raw[:-10]))
    raw[at] ^= 1
    (tmp_path / "bad.msgpack").write_bytes(bytes(raw))
    for p in ("cut.msgpack", "bad.msgpack"):
        assert not tsession.probe_session_state(tmp_path / p)
        assert not jsession.probe_session_state(tmp_path / p)


def test_fetch_state_host_reads_a_state_back_in_one_copy():
    from disco_tpu_torch.obs.accounting import device_get_count

    state = tstream.state_from_numpy(_host_state(3), "cpu")
    before = device_get_count()
    host = tsession.fetch_state_host({"a": state, "b": state})
    assert device_get_count() - before == 1
    for a, b in zip(tstream.state_leaves(host["a"]), tstream.state_leaves(state)):
        assert isinstance(a, np.ndarray) and a.dtype == b.numpy().dtype
        assert np.array_equal(a, b.numpy())
    assert tsession.fetch_state_host(host) is host


_CONFIGS = [
    {},
    {"n_nodes": 1},
    {"n_nodes": 0},
    {"mics_per_node": 2.0},
    {"block_frames": 6},
    {"ref_mic": 2},
    {"policy": "use_oracle_zs"},
    {"masks": "model"},
    {"masks": "nope"},
    {"domain": "time", "masks": "model"},
    {"domain": "time", "n_freq": 1},
    {"domain": "wav"},
    {"lambda_cor": 1.0},
    {"lambda_cor": "x"},
    {"mu": 1},
    {"solver": "fused-mosaic"},
    {"solver": "fused:4"},
    {"solver": "jacobi-pallas"},
    {"solver": "power:0"},
]


@pytest.mark.parametrize("kw", _CONFIGS)
def test_session_config_accepts_and_rejects_as_the_reference(kw):
    base = {"n_nodes": K, "mics_per_node": C, "n_freq": F, "block_frames": BLOCK}
    d = {**base, **kw}
    outcomes = []
    for mod in (jsession, tsession):
        try:
            cfg = mod.SessionConfig(**d)
            outcomes.append(("ok", cfg.to_dict(), cfg.block_shape, cfg.mask_shape))
        except ValueError as e:
            outcomes.append(("error", str(e)))
    assert outcomes[0] == outcomes[1]
    with pytest.raises(ValueError):
        tsession.SessionConfig.from_dict({**base, "bogus": 1})
