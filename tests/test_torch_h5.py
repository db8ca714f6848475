"""The port's HDF5 codec (`densecap_tpu_torch/utils/h5.py`) against h5py,
which is its oracle here (the card's machine has no h5py):

  * h5py writes, the codec reads: every dtype of the port's and the JAX
    package's schema (u1 4-D images, i4, i8, f4, f8, h5py's bool, vlen
    UTF-8 paths with non-ASCII names), an empty (0, 4) dataset, a created
    but never-written one, a scalar, more than 8 datasets in the root
    group (several SNOD leaves), a header with a continuation block;
    names, shapes, dtypes and values exactly equal; reads by int and
    slice (anything else refused); reads from many threads at once, and
    a close that waits for the reads in flight;
  * the codec writes, h5py reads, the same schema, exactly equal; and a
    hypothesis property over shapes and dtypes in both directions;
  * refusals: chunked, gzip, big-endian, a newer superblock: ValueError;
  * the JAX preprocess's h5 read through the codec equal to h5py; the JAX
    loader (through h5py) gives the same batches over the port-written h5
    as over the JAX-written one, and the port's loader over the JAX h5
    gives the JAX loader's batches.
"""

import sys
import threading

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from densecap_tpu.data import preprocess as jax_pp
from densecap_tpu.data.loader import DenseCapLoader as JaxLoader
from densecap_tpu_torch.data import preprocess as pp
from densecap_tpu_torch.data.loader import DenseCapLoader
from densecap_tpu_torch.utils import h5
from test_torch_preprocess import _run, mini_vg  # noqa: F401 (a fixture)

PATHS = ["images/1.jpg", "café.jpg", "Åsa/смотри 看.png", ""]
BATCH_KEYS = ("image", "height", "width", "gt_boxes", "gt_labels",
              "gt_valid")


def schema(rng):
    """name -> array: every dtype and shape the port's files hold."""
    return {
        "images": rng.integers(0, 256, (5, 3, 16, 16), dtype=np.uint8),
        "image_heights": rng.integers(1, 16, 5).astype(np.int32),
        "labels": rng.integers(0, 40, (11, 6)).astype(np.int32),
        "box_ids": rng.integers(-2**40, 2**40, 11),  # int64
        "feats": rng.standard_normal((4, 3, 7)).astype(np.float32),
        "scores": rng.standard_normal(9),  # float64
        "valid": rng.random((4, 3)) > 0.5,
        "paths": np.asarray(PATHS, dtype=h5py.string_dtype()),
        "boxes_empty": np.zeros((0, 4), np.int32),
        "small_u2": np.arange(7, dtype=np.uint16),
        "small_u4": np.arange(7, dtype=np.uint32) * 3_000_000_000 // 7,
        "small_i1": np.arange(-3, 4, dtype=np.int8),
        "small_i2": np.arange(-3, 4, dtype=np.int16) * 1000,
        "small_u8": np.arange(3, dtype=np.uint64) * 2**62,
    }


@pytest.fixture(scope="module")
def h5py_file(tmp_path_factory):
    path = tmp_path_factory.mktemp("h5") / "h5py.h5"
    arrays = schema(np.random.default_rng(0))
    with h5py.File(path, "w") as f:
        for k, v in arrays.items():
            f.create_dataset(k, data=v)
        f.create_dataset("never_written", (3, 5), dtype=np.float32)
        f.create_dataset("scalar", data=np.int64(-7))
        # 40 attributes outgrow the header: HDF5 adds a continuation block
        for i in range(40):
            f["labels"].attrs[f"note{i}"] = np.arange(8) + i
    return path


def test_reader_names_shapes_dtypes(h5py_file):
    with h5py.File(h5py_file, "r") as ref, h5.File(h5py_file) as got:
        assert len(got) == len(ref) > 8
        assert list(got) == got.keys() == sorted(ref)
        for k in ref:
            assert k in got
            assert got[k].shape == ref[k].shape, k
            assert got[k].dtype == ref[k].dtype, k
        assert "missing" not in got
        with pytest.raises(KeyError):
            got["missing"]


@pytest.mark.parametrize("name", sorted(schema(np.random.default_rng(0)))
                         + ["never_written", "scalar"])
def test_reader_values_equal_h5py(h5py_file, name):
    with h5py.File(h5py_file, "r") as ref, h5.File(h5py_file) as got:
        want, have = ref[name][()], got[name][()]
        assert type(have) is type(want)
        if isinstance(want, np.ndarray):
            assert have.dtype == want.dtype and have.shape == want.shape
            np.testing.assert_array_equal(have, want)
        else:
            assert have == want


def test_reader_several_snod_leaves_and_a_continuation(h5py_file):
    raw = h5py_file.read_bytes()
    assert raw.count(b"SNOD") >= 2  # 16 names, 8 to a leaf
    with h5.File(h5py_file) as f:
        msgs = f._messages(f._links["labels"])  # its header's address
        types = [m[0] for m in msgs]
        assert h5.MSG_CONTINUATION in types
        assert types.count(0x0C) == 40  # every attribute message reached
        np.testing.assert_array_equal(f["labels"][:],
                                      schema(np.random.default_rng(0))
                                      ["labels"])


def test_reader_two_level_btree(tmp_path):
    """300 names: h5py's group B-tree grows a level above its leaves."""
    path = tmp_path / "many.h5"
    with h5py.File(path, "w") as f:
        for i in range(300):
            f.create_dataset(f"d{i:03d}", data=np.arange(3) + i)
    with h5.File(path) as f:
        assert f.keys() == [f"d{i:03d}" for i in range(300)]
        assert [int(f[k][0]) for k in f] == list(range(300))


def test_reader_indexing(h5py_file):
    """Whole rows by int, slice (step 1), `[:]`, `[()]` and `[...]`,
    as h5py reads them; any other index raises ValueError."""
    keys = [0, -1, 3, np.int64(2), slice(1, 4), slice(None), slice(3, 3),
            slice(-2, None), slice(2, 99), (), Ellipsis]
    with h5py.File(h5py_file, "r") as ref, h5.File(h5py_file) as got:
        for name in ("images", "labels", "valid", "feats"):
            for key in keys:
                want, have = ref[name][key], got[name][key]
                np.testing.assert_array_equal(have, want, err_msg=f"{name}"
                                              f"[{key}]")
                assert np.asarray(have).dtype == np.asarray(want).dtype
        assert got["paths"][1] == ref["paths"][1] == "café.jpg".encode()
        assert list(got["paths"][1:3]) == list(ref["paths"][1:3])
        assert got["scalar"][()] == -7
        with pytest.raises(IndexError):
            got["images"][5]
        for key in (slice(None, None, 2), slice(None, None, -1), (1, 2),
                    (Ellipsis, 1), np.array([0, 1]), True):
            with pytest.raises(ValueError, match="whole rows"):
                got["images"][key]
        with pytest.raises(ValueError, match="whole rows"):
            got["scalar"][0]
        assert got["images"].shape == (5, 3, 16, 16)


def test_reader_threads(h5py_file):
    """16 threads read random rows of one handle (and a second handle)
    at once, with a short switch interval; every row as h5py reads it."""
    with h5py.File(h5py_file, "r") as ref:
        want = {k: ref[k][()] for k in ("images", "labels", "paths")}
    errors = []
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with h5.File(h5py_file) as a, h5.File(h5py_file) as b:
            def work(seed):
                rng = np.random.default_rng(seed)
                f = (a, b)[seed % 2]
                try:
                    for _ in range(200):
                        k = ("images", "labels", "paths")[rng.integers(3)]
                        i = int(rng.integers(len(want[k])))
                        got = f[k][i]
                        if not np.array_equal(got, want[k][i]):
                            errors.append((k, i))
                except Exception as e:  # reported by the assert below
                    errors.append(repr(e))

            threads = [threading.Thread(target=work, args=(s,))
                       for s in range(16)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert errors == []


def test_close_waits_for_reads_in_flight(h5py_file, tmp_path):
    """`close` waits while a read holds the descriptor, and reads that
    start after it raise; threads reading while the file closes under
    them, and another file opens (it may reuse the descriptor's number),
    get h5py's rows or "closed", never another file's bytes."""
    f = h5.File(h5py_file)
    with f._open_fd():
        closer = threading.Thread(target=f.close)
        closer.start()
        closer.join(timeout=0.3)
        assert closer.is_alive()  # waiting for the read in flight
    closer.join(timeout=10)
    assert not closer.is_alive()
    with pytest.raises(ValueError, match="closed"):
        f["images"][0]

    with h5py.File(h5py_file, "r") as ref:
        want = ref["images"][()]
    other = tmp_path / "other.h5"
    with h5.File(other, "w") as g:  # the same layout, other bytes
        g.create_dataset("images", data=255 - want)
    errors, interval = [], sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        for _ in range(5):
            f = h5.File(h5py_file)
            images = f["images"]

            def work(seed):
                rng = np.random.default_rng(seed)
                for _ in range(400):
                    i = int(rng.integers(len(want)))
                    try:
                        row = images[i]
                    except ValueError as e:
                        if "closed" not in str(e):
                            errors.append(repr(e))
                        return
                    if not np.array_equal(row, want[i]):
                        errors.append(i)

            threads = [threading.Thread(target=work, args=(s,))
                       for s in range(8)]
            for t in threads:
                t.start()
            f.close()
            reopened = [h5.File(other) for _ in range(4)]
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
            for g in reopened:
                g.close()
    finally:
        sys.setswitchinterval(interval)
    assert errors == []


def write_with_codec(path, arrays):
    """The schema through the codec as the port writes it: images
    allocated first and filled one canvas at a time, bool and float rows
    one image at a time, the rest from data."""
    with h5.File(path, "w") as f:
        imgs = arrays["images"]
        d = f.create_dataset("images", imgs.shape, dtype=np.uint8)
        for i in range(len(imgs)):
            d[i] = imgs[i]
        rows = {k: f.create_dataset(k, arrays[k].shape, dtype=arrays[k].dtype)
                for k in ("valid", "feats")}
        for k, dset in rows.items():
            for i in range(len(arrays[k])):
                dset[i] = arrays[k][i]
        for k, v in arrays.items():
            if k not in ("images", "valid", "feats"):
                f.create_dataset(k, data=v)
        f.create_dataset("never_written", (3, 5), dtype=np.float32)
        f.create_dataset("scalar", data=np.int64(-7))


def test_writer_read_by_h5py_and_codec(tmp_path):
    arrays = schema(np.random.default_rng(1))
    path = tmp_path / "codec.h5"
    write_with_codec(path, arrays)
    expect = {**arrays, "never_written": np.zeros((3, 5), np.float32),
              "scalar": np.int64(-7)}
    for opener in (lambda p: h5py.File(p, "r"), h5.File):
        with opener(path) as f:
            assert sorted(f) == sorted(expect)
            for k, v in expect.items():
                got = f[k][()]
                assert f[k].shape == np.shape(v), k
                assert f[k].dtype == np.asarray(v).dtype, k
                if k == "paths":  # h5py gives vlen strings as bytes
                    assert list(got) == [s.encode() for s in PATHS]
                else:
                    np.testing.assert_array_equal(got, v, err_msg=k)
    with h5py.File(path, "r") as f:
        assert h5py.check_string_dtype(f["paths"].dtype).encoding == "utf-8"
        assert f["paths"].asstr()[:].tolist() == PATHS


def test_writer_row_writes(tmp_path):
    """Whole rows by int and by slice, a string row; a write into part
    of a row, or of a value of another shape, is refused."""
    path = tmp_path / "rows.h5"
    with h5.File(path, "w") as f:
        d = f.create_dataset("images", (3, 2, 4, 5), dtype=np.uint8)
        d[2] = np.full((2, 4, 5), 9, np.uint8)
        d[0:2] = np.arange(80, dtype=np.uint8).reshape(2, 2, 4, 5)
        with pytest.raises(ValueError, match="whole rows"):
            d[1, :, :2, :3] = 7
        with pytest.raises(ValueError, match="shape"):
            d[1] = 7
        s = f.create_dataset("names", (3,), dtype=h5.string_dtype())
        s[1] = "é"
        assert f["images"][1][0, 0, 0] == 40
    want = np.full((3, 2, 4, 5), 9, np.uint8)
    want[:2] = np.arange(80).reshape(2, 2, 4, 5)
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["images"][()], want)
        assert f["names"][()].tolist() == [b"", "é".encode(), b""]


DTYPES = [np.uint8, np.int8, np.uint16, np.int16, np.uint32, np.int32,
          np.uint64, np.int64, np.float32, np.float64, np.bool_]


@st.composite
def arrays(draw):
    shape = tuple(draw(st.lists(st.integers(0, 4), min_size=0, max_size=4)))
    dtype = np.dtype(draw(st.sampled_from(DTYPES)))
    rng = np.random.default_rng(draw(st.integers(0, 2**32 - 1)))
    if dtype == np.bool_:
        a = rng.random(shape) > 0.5
    elif dtype.kind == "f":
        a = rng.standard_normal(shape).astype(dtype) * 1e3
    else:
        info = np.iinfo(dtype)
        a = rng.integers(info.min, info.max, shape, dtype=dtype,
                         endpoint=True)
    return a


@settings(max_examples=40, deadline=None, database=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(data=st.lists(arrays(), min_size=1, max_size=12))
def test_property_round_trips(tmp_path, data):
    """Any of these shapes and dtypes, as many datasets as drawn: the
    codec's file read by h5py, and h5py's file read by the codec, equal."""
    names = [f"d{i}" for i in range(len(data))]
    ours, theirs = tmp_path / "ours.h5", tmp_path / "theirs.h5"
    with h5.File(ours, "w") as f:
        for n, a in zip(names, data):
            f.create_dataset(n, data=a)
    with h5py.File(theirs, "w") as f:
        for n, a in zip(names, data):
            f.create_dataset(n, data=a)
    for writer, reader in ((ours, lambda p: h5py.File(p, "r")),
                           (theirs, h5.File)):
        with reader(writer) as f:
            assert sorted(f) == sorted(names)
            for n, a in zip(names, data):
                got = f[n][()]
                assert f[n].dtype == a.dtype and f[n].shape == a.shape
                np.testing.assert_array_equal(got, a)


@pytest.mark.parametrize("kind", ["chunked", "gzip", "big-endian",
                                  "superblock"])
def test_refusals(tmp_path, kind):
    path = tmp_path / f"{kind}.h5"
    libver = "latest" if kind == "superblock" else "earliest"
    with h5py.File(path, "w", libver=libver) as f:
        a = np.arange(64, dtype=np.int32).reshape(8, 8)
        if kind == "chunked":
            f.create_dataset("x", data=a, chunks=(4, 4))
        elif kind == "gzip":
            f.create_dataset("x", data=a, compression="gzip")
        elif kind == "big-endian":
            f.create_dataset("x", data=a.astype(">i4"))
        else:
            f.create_dataset("x", data=a)
    word = {"chunked": "chunked", "gzip": "filtered",
            "big-endian": "big-endian", "superblock": "superblock version"}
    with pytest.raises(ValueError, match=word[kind]):
        with h5.File(path) as f:
            f["x"][()]


def test_writer_refuses_what_it_cannot_write(tmp_path):
    with h5.File(tmp_path / "w.h5", "w") as f:
        with pytest.raises(ValueError, match="dtype"):
            f.create_dataset("u", data=np.asarray(["a", "b"]))
        with pytest.raises(ValueError, match="dtype"):
            f.create_dataset("h", (2,), dtype=np.float16)
        f.create_dataset("x", data=np.zeros(2))
        with pytest.raises(ValueError, match="already"):
            f.create_dataset("x", data=np.zeros(2))
        for i in range(h5.MAX_NAMES - 1):  # one B-tree node's worth
            f.create_dataset(f"y{i}", data=np.int32(i))
        with pytest.raises(ValueError, match="at most"):
            f.create_dataset("one_more", data=np.int8(0))
    with h5py.File(tmp_path / "w.h5", "r") as g:  # a full B-tree node
        assert len(g) == h5.MAX_NAMES and g["y254"][()] == 254
    with pytest.raises(ValueError, match="mode"):
        h5.File(tmp_path / "w.h5", "a")
    with h5.File(tmp_path / "w.h5") as f:
        with pytest.raises(ValueError, match="reading"):
            f["x"][0] = 1.0
    with pytest.raises(ValueError, match="closed"):
        f["x"][0]


@pytest.fixture(scope="module")
def both_h5(mini_vg):  # noqa: F811 (the imported fixture)
    """The mini VG through the JAX preprocess (h5py) and the port's
    (the codec)."""
    return _run(jax_pp, mini_vg, "jax"), _run(pp, mini_vg, "port")


def test_jax_preprocess_h5_through_the_codec(both_h5):
    (jax_h5, _), (port_h5, _) = both_h5
    for path in (jax_h5, port_h5):
        with h5py.File(path, "r") as ref, h5.File(path) as got:
            assert got.keys() == sorted(ref)
            for k in ref:
                assert got[k].dtype == ref[k].dtype
                np.testing.assert_array_equal(got[k][()], ref[k][()])


def _batches(loader, n=4, batch_size=2):
    out = []
    for split in (0, 1, 2):
        loader.reset_iterator(split)
        for _ in range(n):
            b = loader.get_batch(batch_size, split)
            out.append({k: b[k] for k in BATCH_KEYS})
    return out


def _same_batches(xs, ys):
    assert len(xs) == len(ys)
    for x, y in zip(xs, ys):
        for k in BATCH_KEYS:
            assert x[k].dtype == y[k].dtype, k
            np.testing.assert_array_equal(x[k], y[k], err_msg=k)


def test_jax_loader_over_the_port_h5(both_h5):
    """The JAX loader gives the same batches over the codec's h5 as over
    h5py's; the port's loader over h5py's gives the JAX loader's."""
    (jax_h5, jax_json), (port_h5, port_json) = both_h5
    runs = []
    for loader in (JaxLoader(jax_h5, jax_json, max_gt_boxes=3,
                             raw_images=True),
                   JaxLoader(port_h5, port_json, max_gt_boxes=3,
                             raw_images=True),
                   DenseCapLoader(jax_h5, jax_json, max_gt_boxes=3)):
        try:
            runs.append(_batches(loader))
        finally:  # the JAX loader leaves its h5py file to the caller
            (loader.close if isinstance(loader, DenseCapLoader)
             else loader.h5.close)()
    _same_batches(runs[1], runs[0])
    _same_batches(runs[2], runs[0])
