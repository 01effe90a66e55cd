"""Multi-host distribution: jax.distributed bring-up + cross-host
image/gradient reduction (SURVEY §5 "Distributed communication
backend"; replaces the reference's shared-FS `--no-overwrite` frame
claiming, src/main.cpp:242-245, with a real collective runtime).

Topology: one 1-D mesh over every chip of every host (MeshContext
already spans all local devices; under jax.distributed,
`jax.devices()` returns the global device list).  Scene arrays are
replicated per chip; wavefront lanes are sharded; each host feeds the
lanes of its addressable shard.  Round-end reductions:

* pixel radiance sums  — `process_allgather` of the per-host partial
  accumulation (hosts own disjoint lane ranges, so a sum-reduce);
* BDPT splat images    — same sum-reduce (any lane may splat any
  pixel, each splat counted once by its owning lane's host);
* parameter gradients  — `psum` over the mesh inside the backward
  pass (diff/params.py), riding ICI, overlapped by XLA.

Determinism: sample values are pure functions of (seed, pixel,
sample), so host count / mesh shape never changes what is integrated,
only where (tests/test_parallel.py pins 1-device == 8-device output).
"""

from __future__ import annotations

import numpy as np

import jax

from ..utils import log as out


def initialize(coordinator: str = "", num_processes: int = 1,
               process_id: int = 0) -> None:
    """Bring up the jax.distributed runtime (no-op single-process).

    coordinator: "host:port" of process 0; under orchestrators that
    set JAX's standard env vars, call with no arguments and jax
    auto-detects.
    """
    if num_processes <= 1 and not coordinator:
        out.log(3, "multihost: single process, skipping distributed init")
        return
    kwargs = {}
    if coordinator:
        kwargs.update(coordinator_address=coordinator,
                      num_processes=num_processes, process_id=process_id)
    jax.distributed.initialize(**kwargs)
    out.log(2, f"multihost: process {jax.process_index()} of "
               f"{jax.process_count()}, {jax.local_device_count()} local / "
               f"{jax.device_count()} global devices")


def process_count() -> int:
    return jax.process_count()


def process_index() -> int:
    return jax.process_index()


def host_lane_range(total_lanes: int) -> tuple:
    """The contiguous lane slice this host renders.

    Lanes split evenly over processes with the remainder spread one
    apiece over the first (total % n) hosts — no host ever carries
    more than one extra unit, which matters for the >85% scaling
    efficiency target (a last-host remainder dump can leave every
    other host idle on small frames)."""
    n = jax.process_count()
    i = jax.process_index()
    per, rem = divmod(total_lanes, n)
    lo = i * per + min(i, rem)
    return lo, lo + per + (1 if i < rem else 0)


def allreduce_image(partial_sum: np.ndarray) -> np.ndarray:
    """Sum per-host partial pixel accumulations across hosts.

    Single-process: identity.  Multi-process: gathers every host's
    partial into a [n_hosts, ...] stack on device and sums — the
    replacement for the reference's mutex-guarded
    Accumulate (render_driver.cpp:179-182) across machines.
    """
    if jax.process_count() == 1:
        return np.asarray(partial_sum)
    from jax.experimental import multihost_utils

    stacked = multihost_utils.process_allgather(
        np.asarray(partial_sum, np.float32))
    return np.asarray(stacked).sum(axis=0)


def broadcast_scalar(value: float) -> float:
    """Agreement on a host-0 scalar (round index, stop flag)."""
    if jax.process_count() == 1:
        return value
    from jax.experimental import multihost_utils

    arr = multihost_utils.broadcast_one_to_all(
        np.asarray([value], np.float32))
    return float(arr[0])
