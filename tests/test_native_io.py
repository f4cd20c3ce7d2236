"""Native C++ parser vs pure-Python parser: identical output on every input
shape (property test), and the build/fallback paths behave."""

import subprocess

import numpy as np
import pytest

from pprx.graph import native_io
from pprx.graph.io import load_edge_list


@pytest.fixture
def native():
    if not native_io.available():
        pytest.skip("native library could not be built (make -C native)")


def write(tmp_path, text):
    p = tmp_path / "g.txt"
    p.write_text(text)
    return str(p)


CASES = [
    "0 1\n1 2\n2 0\n",
    "# comment\n% other comment\n5 7 3.5\n7 5 1.0\n\n5 9 2.25\n",
    "1 2 9\n3 4\n",  # mixed ts / no-ts lines
    "  3   4  \n5\t6\n",  # odd whitespace
    "bogus line\n1 2\nx y z\n3 4\n",  # malformed lines skipped
    "",  # empty file
    "# only comments\n% here\n",
]


@pytest.mark.parametrize("text", CASES)
def test_native_matches_python(native, tmp_path, text):
    path = write(tmp_path, text)
    ns, nd, nn = load_edge_list(path, use_native=True)
    ps, pd, pn = load_edge_list(path, use_native=False)
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_array_equal(nd, pd)
    assert nn == pn


def test_native_large_random_roundtrip(native, tmp_path):
    rng = np.random.default_rng(0)
    m = 50_000
    src = rng.integers(0, 5000, m)
    dst = rng.integers(0, 5000, m)
    ts = rng.random(m)
    lines = [f"{s} {d} {t:.17g}" for s, d, t in zip(src, dst, ts)]
    path = write(tmp_path, "\n".join(lines) + "\n")
    ns, nd, nn = load_edge_list(path, use_native=True)
    ps, pd, pn = load_edge_list(path, use_native=False)
    np.testing.assert_array_equal(ns, ps)
    np.testing.assert_array_equal(nd, pd)
    assert nn == pn


def test_native_missing_file(native):
    with pytest.raises(RuntimeError, match="native edge parse failed"):
        native_io.parse_edgelist_raw("/nonexistent/file.txt")


def test_renumber_scatter_path_matches_unique_path():
    """The O(M)-scatter first-seen renumber (dense raw-id gate) must agree
    exactly with the sort-based np.unique path — including first-seen
    ordering with duplicates and gaps (round-4 IO fast path)."""
    from pprx.graph.io import renumber

    rng = np.random.default_rng(5)
    for trial in range(100):
        m = int(rng.integers(1, 80))
        hi = int(rng.integers(2, 10**5))
        src = rng.integers(0, hi, m)
        dst = rng.integers(0, hi, m)
        a = renumber(src, dst)
        off = 2**40  # push ids beyond the dense gate -> unique path
        b = renumber(src + off, dst + off)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert a[2] == b[2]


def _fresh_loader(monkeypatch, native_dir):
    monkeypatch.setattr(native_io, "_NATIVE_DIR", str(native_dir))
    monkeypatch.setattr(
        native_io, "_LIB_PATH", str(native_dir / "libpprx_edgeio.so")
    )
    monkeypatch.setattr(native_io, "_lib", None)
    monkeypatch.setattr(native_io, "_loaded", False)


def test_native_builds_from_source_on_first_use(tmp_path, monkeypatch):
    """The library is not kept in git: the first use builds it from
    native/edgeio.cpp with make, then loads it."""
    import shutil

    src_dir = tmp_path / "native"
    src_dir.mkdir()
    for name in ("Makefile", "edgeio.cpp"):
        shutil.copy(f"{native_io._NATIVE_DIR}/{name}", src_dir / name)
    monkeypatch.delenv("PPRX_NO_NATIVE", raising=False)
    _fresh_loader(monkeypatch, src_dir)
    if shutil.which("make") is None or shutil.which("g++") is None:
        pytest.skip("no C++ toolchain on this machine")
    assert native_io.available()
    assert (src_dir / "libpprx_edgeio.so").exists()
    path = write(tmp_path, "0 1\n1 2\n")
    src, dst, ts, has_ts = native_io.parse_edgelist_raw(path)
    np.testing.assert_array_equal(src, [0, 1])
    np.testing.assert_array_equal(dst, [1, 2])


def test_native_opt_out_falls_back_to_python(tmp_path, monkeypatch):
    """PPRX_NO_NATIVE=1: no build, the auto-selected parser is pure Python
    and gives the same result."""
    _fresh_loader(monkeypatch, tmp_path / "absent")
    monkeypatch.setenv("PPRX_NO_NATIVE", "1")
    assert not native_io.available()
    path = write(tmp_path, "3 4\n4 5\n")
    s, d, n = load_edge_list(path)
    assert n == 3 and s.tolist() == [0, 1] and d.tolist() == [1, 2]
    with pytest.raises(RuntimeError, match="not available"):
        native_io.parse_edgelist_raw(path)
