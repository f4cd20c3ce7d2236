"""pprx — dynamic Personalized PageRank retrieval engine.

A from-scratch JAX/XLA/shard_map framework with the capabilities of
``guowentian/dynamicppr`` (Guo, Li, Sha, Tan, "Parallel Personalized PageRank
on Dynamic Graphs", PVLDB 10(12), 2017): forward- and reverse-push PPR with
reserve/residual maintenance, incremental epsilon-fresh updates under batched
sliding-window edge insertions/deletions, multi-source batched queries with a
top-k retrieval head, and vertex-row-sharded execution across several GPUs.

NOTE ON CITATIONS: the reference mount ``/root/reference`` was empty in every
session so far (see SURVEY.md header), so docstrings cite the reference at the
level of SURVEY.md sections (which carry provenance tags) rather than
file:line into the reference tree.
"""

from pprx.config import PprConfig, StreamConfig, MeshConfig

__version__ = "0.1.0"

__all__ = [
    "PprConfig",
    "StreamConfig",
    "MeshConfig",
    "__version__",
]
