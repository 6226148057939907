"""raft_tpu_torch.core.serialize against raft_tpu.core.serialize: the same
values give the same bytes, and each reads what the other wrote."""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu.core import serialize as jser
from raft_tpu_torch.core import RaftError
from raft_tpu_torch.core import serialize as tser

SCALARS = [True, False, 0, -7, 2**40, np.int32(5), np.int64(-3), 2.5, np.float32(1.5),
           float("inf"), "raft_tpu/13", "", "ivf_pq"]


def _bytes(write, *args):
    buf = io.BytesIO()
    write(buf, *args)
    return buf.getvalue()


@pytest.mark.parametrize("value", SCALARS, ids=[repr(v) for v in SCALARS])
def test_scalars_byte_identical(value):
    raw = _bytes(jser.serialize_scalar, value)
    assert _bytes(tser.serialize_scalar, value) == raw
    back = tser.deserialize_scalar(io.BytesIO(raw))
    assert back == value and type(back) is type(jser.deserialize_scalar(io.BytesIO(raw)))


def _arrays():
    rng = np.random.default_rng(0)
    return {
        "f32": rng.normal(size=(5, 7)).astype(np.float32),
        "u8": rng.integers(0, 256, (3, 4, 6), dtype=np.uint8),
        "i32": rng.integers(-9, 9, (11,), dtype=np.int32),
        "i64": rng.integers(-9, 9, (2, 2), dtype=np.int64),
        "f64": rng.normal(size=(4,)),
        "bool": rng.random(6) < 0.5,
        "empty2": np.zeros((4, 0), np.float32),
        "empty3": np.zeros((4, 0, 0), np.uint8),
        "empty1": np.zeros((0,), np.float32),
    }


@pytest.mark.parametrize("name", list(_arrays()))
def test_mdspan_byte_identical(name):
    a = _arrays()[name]
    # 64-bit arrays go to the JAX side as numpy: jnp.asarray would narrow them
    raw = _bytes(jser.serialize_mdspan, a if a.dtype.itemsize == 8 else jnp.asarray(a))
    assert _bytes(tser.serialize_mdspan, torch.from_numpy(a)) == raw
    assert _bytes(tser.serialize_mdspan, a) == raw            # numpy in, same bytes
    back = tser.deserialize_mdspan(io.BytesIO(raw))
    assert back.dtype == torch.from_numpy(a).dtype
    np.testing.assert_array_equal(back.numpy(), a)


def test_bf16_marker_round_trips_both_ways():
    rng = np.random.default_rng(1)
    vals = np.concatenate([rng.normal(size=37) * 1e3, [0.0, -0.0, np.inf, -np.inf]])
    ja = jnp.asarray(vals.astype(np.float32)).astype(jnp.bfloat16)
    ta = torch.from_numpy(vals.astype(np.float32)).to(torch.bfloat16)
    raw = _bytes(jser.serialize_mdspan, ja)
    assert raw[:1] == b"B"
    assert _bytes(tser.serialize_mdspan, ta) == raw
    back = tser.deserialize_mdspan(io.BytesIO(raw))
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.view(torch.int16), ta.view(torch.int16))
    jback = jser.deserialize_mdspan(io.BytesIO(_bytes(tser.serialize_mdspan, ta)))
    np.testing.assert_array_equal(np.asarray(jback).view(np.uint16),
                                  np.asarray(ja).view(np.uint16))
    with pytest.raises(ValueError, match="marker"):
        tser.deserialize_mdspan(io.BytesIO(b"X" + raw[1:]))


def test_header_tuned_and_json_match():
    raw = _bytes(jser.serialize_header, "ivf_pq")
    assert _bytes(tser.serialize_header, "ivf_pq") == raw
    assert tser.check_header(io.BytesIO(raw), "ivf_pq") == "raft_tpu/13"
    with pytest.raises(RaftError, match="not a cagra"):
        tser.check_header(io.BytesIO(raw), "cagra")
    old = _bytes(jser.serialize_scalar, "ivf_pq") + _bytes(jser.serialize_scalar, "raft_tpu/2")
    with pytest.raises(RaftError, match="unsupported ivf_pq index file format"):
        tser.check_header(io.BytesIO(old), "ivf_pq")
    assert tser._READ_COMPATIBLE == jser._READ_COMPATIBLE
    assert tser.SERIALIZATION_VERSION == jser.SERIALIZATION_VERSION
    for tuned in (None, {"n_probes": 8, "note": "pinned"}):
        raw = _bytes(jser.serialize_tuned, tuned)
        assert _bytes(tser.serialize_tuned, tuned) == raw
        assert tser.deserialize_tuned(io.BytesIO(raw), "raft_tpu/13") == tuned
    assert tser.deserialize_tuned(io.BytesIO(b""), "raft_tpu/8") is None
    assert [tser.version_number(v) for v in ("raft_tpu/9", "raft_tpu/13")] == [9, 13]
    with pytest.raises(ValueError):
        tser.version_number("v13")


def test_atomic_write_keeps_the_old_file_on_failure(tmp_path):
    path = str(tmp_path / "index.bin")
    with tser.atomic_write(path) as f:
        f.write(b"first")
    with pytest.raises(RuntimeError):
        with tser.atomic_write(path) as f:
            f.write(b"second, half written")
            raise RuntimeError("crash mid-write")
    assert open(path, "rb").read() == b"first"
    assert [p.name for p in tmp_path.iterdir()] == ["index.bin"]
