"""Multi-device SPMD rendering over a 1-D jax.sharding.Mesh.

The scaling design (SURVEY §2.7/§5): ray wavefront lanes are sharded
over all chips (`P("d")`); the scene — triangle soup, BVH, materials,
texture atlas, LTC tables, light tables — is replicated per device and
resident in HBM.  With lanes embarrassingly parallel, the only
cross-device communication in the forward render is the scalar ray-
counter reduction; XLA inserts the psum.  Light-tracing splats — the
one cross-device scatter — are reduced per block via psum over
DEVICE-LOCAL splat images: each shard scatters its own lanes' camera
splats into a local [H*W+1, 3] buffer inside
integrator/path.trace_wavefront_queued_bdpt, and make_queued_bdpt_fn
psums the buffers so every device returns the same replicated image.

Multi-host extends the same mesh over `jax.distributed.initialize`:
each host feeds its local shard of lanes; `process_allgather` collects
pixel sums at round end (driver).  Sample values depend only on
(seed, pixel, sample), never on lane placement, so a given mesh shape
is bitwise deterministic run-to-run, and different mesh shapes agree
to float32 rounding (XLA codegen may fuse differently per shard size).
"""

from __future__ import annotations

from functools import partial

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..integrator.path import render_lanes


class MeshContext:
    """A 1-D device mesh + sharded render function factory."""

    def __init__(self, n_devices: int = 0, devices=None):
        if devices is None:
            # Local (addressable) devices — under jax.distributed,
            # jax.devices() is the global list and identical on every
            # process; a mesh of another host's chips cannot be fed.
            devices = jax.local_devices()
        if n_devices and n_devices > 0:
            devices = devices[:n_devices]
        self.devices = devices
        self.n = len(devices)
        self.mesh = Mesh(np.asarray(devices), ("d",))
        self.lane_sharding = NamedSharding(self.mesh, P("d"))
        self.replicated = NamedSharding(self.mesh, P())

    def shard_scene(self, scene):
        """Replicate the committed scene across the mesh once."""
        return jax.device_put(
            scene, jax.tree_util.tree_map(lambda _: self.replicated,
                                          scene))

    def make_queued_fn(self, meta, settings, sampler_mode: int = 1):
        """Sharded queued-regeneration tracer: one lane per PIXEL,
        samples traced back-to-back per lane (integrator/path.py
        trace_wavefront_queued), lanes sharded over the mesh via
        shard_map.

        The tracer is a pure per-lane while_loop, so sharding is
        exact: every per-(pixel, sample) value is a pure function of
        (seed, pixel, sample) regardless of lane placement, keeping
        the bitwise 1-dev == N-dev contract.  shard_map (not plain
        jit sharding) keeps each shard's wavefront, and the
        intersection kernel it calls, device-local.  The scalar ray
        counter is the only cross-device communication (psum)."""
        from jax import shard_map

        from ..integrator.path import trace_wavefront_queued

        ms = max(1, int(settings.multisample))

        def local(scene, cam, px, py, round_off, seed):
            rad, rays = trace_wavefront_queued(
                scene, meta, settings, cam, px, py, round_off, ms,
                seed, sampler_mode=sampler_mode)
            return rad, jax.lax.psum(rays, "d")

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(P(), P(), P("d"), P("d"), P(), P()),
            out_specs=(P("d"), P()))

    def make_queued_bdpt_fn(self, meta, settings, sampler_mode: int = 1):
        """Sharded queued-regeneration BDPT tracer (reverse > 0):
        lanes sharded as in make_queued_fn; each shard's light-path
        camera splats land in a device-local [H*W+1, 3] image that is
        psum-reduced over the mesh (SURVEY §5's communication design:
        local scatter + one collective, never a global scatter across
        shards)."""
        from jax import shard_map

        from ..integrator.path import trace_wavefront_queued_bdpt

        ms = max(1, int(settings.multisample))

        def local(scene, cam, px, py, round_off, seed):
            rad, splat_img, rays = trace_wavefront_queued_bdpt(
                scene, meta, settings, cam, px, py, round_off, ms,
                seed, sampler_mode=sampler_mode)
            return (rad, jax.lax.psum(splat_img, "d"),
                    jax.lax.psum(rays, "d"))

        return shard_map(
            local, mesh=self.mesh,
            in_specs=(P(), P(), P("d"), P("d"), P(), P()),
            out_specs=(P("d"), P(), P()))

    def make_render_fn(self, meta, settings, sampler_mode: int = 1):
        """Jitted lane renderer with lanes sharded over the mesh.

        Lane-count inputs must be divisible by the mesh size (the
        driver pads its blocks to a multiple of `self.n`).
        """
        f = partial(render_lanes, meta=meta, settings=settings,
                    sampler_mode=sampler_mode)

        lane = self.lane_sharding
        repl = self.replicated

        @partial(jax.jit, static_argnames=())
        def sharded(scene, cam, px, py, sample_idx, seed):
            px = jax.lax.with_sharding_constraint(px, lane)
            py = jax.lax.with_sharding_constraint(py, lane)
            sample_idx = jax.lax.with_sharding_constraint(sample_idx, lane)
            return f(scene=scene, cam=cam, px=px, py=py,
                     sample_idx=sample_idx, seed=seed)

        def run(scene, cam, px, py, sample_idx, seed):
            return sharded(scene, cam, px, py, sample_idx, seed)

        return run
