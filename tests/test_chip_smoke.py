"""chip_smoke.py's phases, rehearsed on the CPU at tiny sizes (the script
itself refuses to run without a GPU)."""

import jax.numpy as jnp
import numpy as np
import pytest

import chip_smoke as cs

TINY = cs.Shapes(n=3000, window=30_000, slide=2_000, sources=16)
TINY_REV = cs.Shapes(n=1500, window=12_000, slide=200, sources=4)
CARD = "cpu rehearsal"


@pytest.fixture(autouse=True)
def float32_state(monkeypatch):
    # the script runs the engines in float32, as on the card; the suite's
    # x64 mode would otherwise promote host-built float64 inputs
    import jax

    jax.config.update("jax_enable_x64", False)
    yield
    jax.config.update("jax_enable_x64", True)


def test_check_device_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        cs.check_device()
    assert e.value.code not in (0, None)


def test_phase_delivery_and_memory_analysis(capsys):
    src, dst = cs.make_stream(TINY, 4, seed=1)
    drv = cs.build_forward_driver(src, dst, TINY)
    cs.phase_delivery(drv, widths=(16, 1), reps=2)
    out = capsys.readouterr().out
    assert "worst err/bound" in out and "memory_analysis" in out


def test_phase_cli_forward_and_sharded(tmp_path, capsys):
    from pprx.graph.io import save_packed

    slides = cs.forward_slide_count(TINY)
    src, dst = cs.make_stream(TINY, slides + 6, seed=7)
    npz = str(tmp_path / "s.npz")
    save_packed(npz, src, dst, TINY.n)
    cs.phase_cli(npz, TINY, str(tmp_path), batch=32)
    drv = cs.build_forward_driver(src, dst, TINY)
    head, exact = cs.phase_forward(drv, src, dst, TINY, CARD)
    assert head == TINY.window + slides * TINY.slide
    head6 = cs.phase_sharded(src, dst, TINY, 1, "wl", slides, exact, CARD,
                             "6 sharded 1x1")
    assert head6 == head
    out = capsys.readouterr().out
    assert "bit-identical=True" in out  # CPU scatter-add is deterministic


def test_phase_reverse(capsys):
    cs.phase_reverse(TINY_REV, CARD)
    assert "max |p - exact" in capsys.readouterr().out


@pytest.mark.parametrize("engine", ["wl", "wlp"])
def test_phase_four_on_virtual_devices(engine):
    slides = cs.forward_slide_count(TINY)
    src, dst = cs.make_stream(TINY, slides + 1, seed=7)
    head = TINY.window + slides * TINY.slide
    checked = [int(q) for q in np.linspace(0, TINY.sources - 1, 4).astype(int)]
    exact = cs.exact_vectors(src, dst, head, TINY, checked)
    assert cs.phase_sharded(src, dst, TINY, 4, engine, slides, exact, CARD,
                            f"7 four {engine}") == head


def test_forward_checks_reject_a_broken_state():
    """The accuracy gate fails loudly: a state with mass missing raises."""
    src, dst = cs.make_stream(TINY, 0, seed=3)
    exact = cs.exact_vectors(src, dst, TINY.window, TINY, [0])
    p = np.zeros((TINY.n + 1, TINY.sources), np.float32)
    r = np.zeros_like(p)
    p[: TINY.n, 0] = exact[0]
    p[: TINY.n, 0] *= 0.9  # lose 10% of the mass
    with pytest.raises(AssertionError):
        cs.check_forward("broken", p, r, list(range(TINY.sources)), exact,
                         TINY, cs.EPS, cs.PRECISION_MAINTAINED)
