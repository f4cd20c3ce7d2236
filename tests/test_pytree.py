"""The engines' state containers as pytrees (pprx.pytree): leaves, static
fields, ``.replace`` and jit donation — one case per class — plus where the
compile cache goes (pprx.compile_cache)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pprx.engine.frontier import CsrSnapshot, Overlay, build_snapshot
from pprx.engine.sparse import HybridGraph
from pprx.engine.state import FORWARD, REVERSE, PprState, PushStats, init_state
from pprx.engine.wl2 import KillGraph, build_kill_graph
from pprx.graph.dynamic import WindowGraph
from tests.conftest import random_multigraph


def _window():
    src, dst = random_multigraph(np.random.default_rng(5), 12, 40)
    return WindowGraph.from_coo(src, dst, 12, capacity=48)


def _make(name):
    w = _window()
    return {
        "PprState": lambda: init_state(12, [0, 3], mode=REVERSE),
        "PushStats": PushStats.zero,
        "WindowGraph": lambda: w,
        "KillGraph": lambda: build_kill_graph(w, FORWARD, fring=8),
        "CsrSnapshot": lambda: build_snapshot(w.src, w.dst, w.n),
        "Overlay": lambda: Overlay.empty(6, w.n),
        "HybridGraph": lambda: HybridGraph.build(w, FORWARD, overlay_cap=6),
    }[name]()


CLASSES = {
    "PprState": PprState, "PushStats": PushStats, "WindowGraph": WindowGraph,
    "KillGraph": KillGraph, "CsrSnapshot": CsrSnapshot, "Overlay": Overlay,
    "HybridGraph": HybridGraph,
}


@pytest.mark.parametrize("name", sorted(CLASSES))
def test_pytree_dataclass_roundtrip(name):
    obj = _make(name)
    cls = CLASSES[name]
    assert isinstance(obj, cls)
    leaves, treedef = jax.tree_util.tree_flatten(obj)
    assert leaves and all(isinstance(x, jax.Array) for x in leaves)
    back = jax.tree_util.tree_unflatten(treedef, leaves)
    assert type(back) is cls
    for a, b in zip(leaves, jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))

    # frozen; .replace returns an updated copy and leaves the original
    first = dataclasses.fields(cls)[0].name
    with pytest.raises(dataclasses.FrozenInstanceError):
        setattr(obj, first, None)
    old = getattr(obj, first)
    new_val = jax.tree_util.tree_map(lambda x: x + 1, old)
    upd = obj.replace(**{first: new_val})
    assert type(upd) is cls and getattr(obj, first) is old
    np.testing.assert_array_equal(
        np.asarray(jax.tree_util.tree_leaves(getattr(upd, first))[0]),
        np.asarray(jax.tree_util.tree_leaves(old)[0]) + 1,
    )

    # through jit with donation, the class and the static fields survive
    step = jax.jit(lambda o: jax.tree_util.tree_map(lambda x: x * 2, o),
                   donate_argnums=0)
    copy = jax.tree_util.tree_map(jnp.array, obj)
    out = step(copy)
    assert type(out) is cls
    assert jax.tree_util.tree_structure(out) == treedef
    for a, b in zip(leaves, jax.tree_util.tree_leaves(out)):
        np.testing.assert_array_equal(np.asarray(a) * 2, np.asarray(b))


def test_static_field_is_structure_not_data():
    """PprState.mode lives in the treedef: forward and reverse states have
    different structures (distinct compiled programs), same leaf count."""
    fwd = init_state(12, [0], mode=FORWARD)
    rev = init_state(12, [0], mode=REVERSE)
    assert len(jax.tree_util.tree_leaves(fwd)) == 2
    assert jax.tree_util.tree_structure(fwd) != jax.tree_util.tree_structure(rev)
    assert jax.jit(lambda s: s)(rev).mode == REVERSE


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_compile_cache_honors_env_var(monkeypatch, tmp_path,
                                      restore_cache_dir):
    from pprx.compile_cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself; the helper sets no other directory
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_inside_checkout(monkeypatch,
                                                restore_cache_dir):
    import pathlib

    from pprx.compile_cache import DEFAULT_CACHE_DIR, enable_compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = enable_compile_cache()
    repo = pathlib.Path(__file__).resolve().parent.parent
    assert got == str(DEFAULT_CACHE_DIR) == str(repo / ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
