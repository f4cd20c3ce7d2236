"""Multi-host runtime initialization (SURVEY.md §5 "Distributed
communication backend": jax.distributed.initialize).

The reference is single-process (no NCCL/MPI); multi-host is a build-first
component. One call per process, BEFORE any other JAX API touches the
backend:

    from pprx.dist.init import init_distributed
    init_distributed(coordinator="host0:8476", num_processes=4, process_id=i)

Inside a cluster environment that JAX detects by itself (Open MPI, Slurm,
mpi4py, Kubernetes and Google Cloud's own launchers) the three arguments
are optional, so ``init_distributed()`` with no arguments is enough.
Elsewhere (and in the 2-process CPU smoke test, tests/test_multiprocess.py)
they are required. One process can also drive all the GPUs of one host
without any of this. After initialization, ``jax.devices()`` is the GLOBAL
device list; build the ('rows', 'srcs') mesh over it with
pprx.dist.mesh.make_row_mesh.
"""

from __future__ import annotations

import os


def init_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Initialize the JAX distributed runtime for a multi-process run.

    Arguments fall back to the standard env vars (JAX_COORDINATOR_ADDRESS,
    JAX_NUM_PROCESSES, JAX_PROCESS_ID) and then to JAX's cluster
    auto-detection. Returns True if the runtime was initialized
    by this call, False if it was skipped (single-process run: no
    coordinator given anywhere and not on an auto-detectable cluster).
    Safe to call twice (second call is a no-op)."""
    import jax

    coordinator = coordinator or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if num_processes is None and "JAX_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["JAX_NUM_PROCESSES"])
    if process_id is None and "JAX_PROCESS_ID" in os.environ:
        process_id = int(os.environ["JAX_PROCESS_ID"])

    state = jax._src.distributed.global_state
    if state.client is not None:  # already initialized
        return False
    if coordinator is None and num_processes is None:
        # auto-detection only inside a cluster environment JAX recognizes;
        # plain single-process runs skip initialization entirely
        import jax._src.clusters as clusters

        auto = any(c.is_env_present() for c in clusters.ClusterEnv._cluster_types)
        if not auto:
            return False
        jax.distributed.initialize()
        return True
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True
