"""CLI surface tests (SURVEY.md §2.1 CLI binaries): each subcommand runs end
to end and emits parseable JSON."""

import json

import numpy as np
import pytest

from pprx import cli
from pprx.graph.io import synthetic_powerlaw_stream


@pytest.fixture
def graph_npz(tmp_path):
    from pprx.graph.io import save_packed

    src, dst, n = synthetic_powerlaw_stream(50, 600, seed=1)
    path = str(tmp_path / "g.npz")
    save_packed(path, src, dst, n)
    return path


def run_cli(capsys, argv):
    cli.main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return json.loads(out[-1])


def test_convert(tmp_path, capsys):
    txt = tmp_path / "g.txt"
    txt.write_text("# c\n1 2\n2 3\n3 1\n")
    out = run_cli(capsys, ["convert", str(txt), str(tmp_path / "g.npz")])
    assert out["n"] == 3 and out["edges"] == 3


def test_static_check_exact(graph_npz, capsys):
    out = run_cli(
        capsys,
        ["static", graph_npz, "--queries", "0,3", "--eps", "1e-7", "--f64", "--check-exact"],
    )
    assert out["rounds"] > 0
    assert all(e < out["l1_bound"] for e in out["l1_error"])


def test_static_reverse(graph_npz, capsys):
    out = run_cli(capsys, ["static", graph_npz, "--mode", "rev", "--f64", "--check-exact"])
    assert all(e < out["l1_bound"] for e in out["l1_error"])


def test_stream_with_checkpoint(graph_npz, tmp_path, capsys):
    log = str(tmp_path / "log.jsonl")
    ck = str(tmp_path / "ck.npz")
    out = run_cli(
        capsys,
        [
            "stream", graph_npz, "--window", "300", "--slide", "30",
            "--steps", "5", "--log", log, "--checkpoint", ck,
            "--checkpoint-every", "2", "--f64",
        ],
    )
    assert out["steps"] == 5
    assert out["updates_per_sec"] > 0
    events = [json.loads(l) for l in open(log)]
    assert [e["event"] for e in events][:2] == ["seed", "slide"]
    assert any(e["event"] == "checkpoint" for e in events)
    assert events[-1]["event"] == "summary"


def test_retrieve(graph_npz, capsys):
    out = run_cli(
        capsys,
        ["retrieve", graph_npz, "--queries", "random", "--batch", "16", "--k", "10", "--f64"],
    )
    assert out["batch"] == 16 and out["k"] == 10
    assert out["retrieval_ms"] > 0


def test_stream_sharded_engine(graph_npz, tmp_path, capsys):
    """--engine sharded runs on the virtual CPU mesh (rows x srcs) through
    the same CLI surface (SURVEY.md §5 comm backend / L7)."""
    out = run_cli(
        capsys,
        [
            "stream", graph_npz, "--window", "300", "--slide", "30",
            "--steps", "3", "--engine", "sharded", "--mesh", "4,2",
            "--queries", "0,5", "--f64",
        ],
    )
    assert out["steps"] == 3
    assert out["n_chips"] == 8
    assert out["updates_per_sec"] > 0


def test_bench_config2_on_packed_graph(graph_npz):
    """Milestone config 2 consumes a real packed .npz stream (VERDICT
    round-2 item 7): n comes from the file, the stream is tiled to cover
    window + slides, and the run reports sane throughput fields."""
    from pprx.bench.run import run_config

    out = run_config(2, graph=graph_npz, w=400, b=40, steps=2)
    assert out["config"] == 2
    assert out["n"] == 50  # from the packed file, not the synthetic default
    assert out["window"] == 400 and out["slide"] == 40
    assert out["updates_per_sec"] > 0
    assert out["rounds"] > 0


def test_bench_config5_small_shapes():
    """Config 5 headline defaults are overridable down to CPU-mesh smoke
    shapes; the wlp engine is selectable."""
    from pprx.bench.run import run_config

    out = run_config(5, n=2_000, w=20_000, b=200, s=2, steps=2, engine="wlp")
    assert out["config"] == 5 and out["engine"] == "wlp"
    assert out["updates_per_sec"] > 0


def test_retrieve_from_checkpoint(graph_npz, tmp_path, capsys):
    """The serving loop end to end: stream maintains + checkpoints, then
    retrieve serves from the maintained state with optional refinement."""
    ck = str(tmp_path / "serve.npz")
    run_cli(capsys, [
        "stream", graph_npz, "--window", "300", "--slide", "30",
        "--steps", "3", "--queries", "0,5,9", "--checkpoint", ck,
        "--checkpoint-every", "3",
    ])
    out = run_cli(capsys, [
        "retrieve", graph_npz, "--from-checkpoint", ck, "--k", "5",
        "--refine-eps", "1e-7",
    ])
    assert out["k"] == 5 and out["batch"] == 3
    assert out["refine_eps"] == 1e-7 and out["refine_rounds"] > 0
    assert len(out["top1"]) == 3


def test_serve_incremental(graph_npz, capsys):
    """Bounded-stall serving loop (round 5): budgeted per-slide refine +
    periodic top-k reads, JSON summary with the stall metric."""
    out = run_cli(
        capsys,
        ["serve", graph_npz, "--window", "300", "--slide", "25",
         "--steps", "8", "--queries", "0,3,7", "--k", "5",
         "--eps", "1e-6", "--eps-retrieve", "1e-7",
         "--refine-budget", "4", "--serve-every", "4", "--emit-ids", "2"],
    )
    assert out["mode"] == "serve"
    assert out["steps"] == 8
    assert out["serve_events"] == 2
    assert out["slide_ms_worst"] is not None
    assert out["retrieval_ms_mean"] is not None
    assert out["refine_budget_rounds"] == 4


def test_serve_event_mode(graph_npz, capsys):
    """--refine-budget 0: full refine at each serve event (the round-4
    event protocol) still works through the same subcommand."""
    out = run_cli(
        capsys,
        ["serve", graph_npz, "--window", "300", "--slide", "25",
         "--steps", "4", "--queries", "0,3", "--k", "5",
         "--refine-budget", "0", "--serve-every", "2"],
    )
    assert out["mode"] == "serve"
    assert out["serve_events"] == 2
