"""Progressive render driver: rounds/timed loop, chunking, progress.

The counterpart of the reference's RenderDriver (reference
src/render_driver.cpp): where the reference fans 32x32 tiles over a
thread pool, we launch jit-compiled wavefront chunks over the device
(or device mesh, see parallel/), accumulate radiance sums + sample
counts per pixel, and rewrite the output EXR after every round so a
killed render keeps its last round (render_driver.cpp:227-248).

Chunking: one jitted function of fixed lane count renders any subset
of (pixel, sample) lanes; large frames iterate over pixel blocks so
compilation happens exactly once per shape.  Seeds derive from
(base_seed, round) — deterministic and restartable from a round index
(the checkpoint/resume story: sum, count, round, seed).
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

from ..io.exr import AccumulationImage
from ..parallel import multihost
from ..utils import log as out
from ..utils.format import LowPass, format_int_thousands, format_time


@dataclass
class RenderStats:
    rounds: int = 0
    rays: int = 0
    lanes: int = 0
    seconds: float = 0.0          # rendering, after compilation
    compile_seconds: float = 0.0  # the block step, ahead of round 0
    commit_seconds: float = 0.0   # scene build, when the caller times it
    write_seconds: float = 0.0    # per-round EXR + checkpoint writes

    @property
    def rays_per_sec(self) -> float:
        return self.rays / self.seconds if self.seconds > 0 else 0.0


class RenderDriver:
    """Drives progressive rendering of one frame."""

    def __init__(self, settings, scene, meta, camera, seed: int = 42,
                 sampler_mode: int = 1, chunk_lanes: int = 1 << 20,
                 mesh=None):
        self.settings = settings
        self.scene = scene
        self.meta = meta
        self.camera = camera
        self.seed = seed
        self.sampler_mode = sampler_mode
        self.chunk_lanes = int(chunk_lanes)
        self.mesh = mesh  # optional parallel.MeshContext

        xres, yres = camera.xres, camera.yres
        self.acc = AccumulationImage(xres, yres)
        self.stats = RenderStats()
        # First round index to render; load_checkpoint advances it so a
        # resumed render traces FRESH (round x ms) sample indices
        # instead of re-tracing the ones already in the accumulator.
        self.start_round = 0

        # Pixel-block decomposition.  Both tracers run one lane per
        # pixel with samples traced back-to-back (queued in-place
        # regeneration, integrator/path.py trace_wavefront_queued /
        # trace_wavefront_queued_bdpt): lane occupancy stays near
        # 100% where a per-sample wavefront pays max-depth sweeps on
        # mostly-dead lanes.  BDPT blocks are ms-times smaller so the
        # vectorized light-subpath phase and its per-(lane, sample)
        # vertex store stay inside the lane budget.  Under a device
        # mesh both run inside shard_map (parallel/mesh.py) with
        # lanes sharded, the ray counter psum'd, and BDPT splat
        # images reduced from device-local buffers — so single-chip
        # occupancy wins carry to multi-chip renders.
        ms = max(1, int(settings.multisample))
        self.ms = ms
        self.n_procs = multihost.process_count()
        self.proc_id = multihost.process_index()
        self._queued = int(settings.reverse) == 0
        block = (self.chunk_lanes if self._queued
                 else max(1, self.chunk_lanes // ms))
        n_pixels = xres * yres
        if self.n_procs > 1:
            # Multi-host work is parcelled in pixel blocks; keep the
            # block small enough that every host gets at least one
            # (a single ~1M-lane block would put the whole frame on
            # one host and idle the rest).
            block = min(block, -(-n_pixels // self.n_procs))
        self.block = max(1, min(block, n_pixels))
        if mesh is not None and self.block % mesh.n:
            # Lane counts must divide the mesh; round the block up.
            self.block += mesh.n - self.block % mesh.n
        self.n_blocks = (n_pixels + self.block - 1) // self.block
        # Multi-host: each host renders a contiguous slice of blocks
        # and the images are sum-reduced before writes (reference
        # --no-overwrite shared-FS farming, main.cpp:242-245, replaced
        # by real collectives; SURVEY §5).  Block size may differ with
        # process count, but every pixel's radiance is a pure function
        # of (seed, pixel, sample) summed in a block-independent order,
        # so NEE renders stay bitwise process-count-invariant (BDPT
        # splat sums are scatter-order-sensitive at the 1-ulp level).
        self._blk_lo, self._blk_hi = multihost.host_lane_range(self.n_blocks)
        self.local_blocks = self._blk_hi - self._blk_lo

        if mesh is not None:
            self.scene = mesh.shard_scene(scene)

        # The round's accumulation stays ON DEVICE: each block scatters
        # its per-pixel radiance sums (and any BDPT splats) into a
        # device-resident [H*W+1, 3] buffer (row H*W swallows padding
        # lanes), and the device buffer crosses to the host only when
        # the EXR is written — not once per block (the reference's
        # mutex-guarded host frame buffer, render_driver.cpp:179-182).
        ms = self.ms
        hw = xres * yres

        if self._queued:
            from ..integrator.path import trace_wavefront_queued

            qfn = (mesh.make_queued_fn(meta, settings, sampler_mode)
                   if mesh is not None else None)

            def _round_block(acc, rays_acc, scene_arg, cam, px, py,
                             round_off, seed, pix_idx):
                if qfn is not None:
                    rad, rays = qfn(scene_arg, cam, px, py, round_off,
                                    seed)
                else:
                    rad, rays = trace_wavefront_queued(
                        scene_arg, meta, settings, cam, px, py,
                        round_off, ms, seed,
                        sampler_mode=self.sampler_mode)
                acc = acc.at[pix_idx].add(rad)
                return acc, rays_acc + rays.astype(jnp.float32)
        else:
            # BDPT (reverse > 0): the queued bidirectional tracer —
            # vectorized light subpaths + device-local splat image,
            # queued-regeneration eye walk (integrator/path.py
            # trace_wavefront_queued_bdpt).
            from ..integrator.path import trace_wavefront_queued_bdpt

            qbfn = (mesh.make_queued_bdpt_fn(meta, settings,
                                             sampler_mode)
                    if mesh is not None else None)

            def _round_block(acc, rays_acc, scene_arg, cam, px, py,
                             round_off, seed, pix_idx):
                if qbfn is not None:
                    rad, splat_img, rays = qbfn(scene_arg, cam, px, py,
                                                round_off, seed)
                else:
                    rad, splat_img, rays = trace_wavefront_queued_bdpt(
                        scene_arg, meta, settings, cam, px, py,
                        round_off, ms, seed,
                        sampler_mode=self.sampler_mode)
                acc = acc.at[pix_idx].add(rad)
                acc = acc + splat_img
                return acc, rays_acc + rays.astype(jnp.float32)

        self._block_fn = jax.jit(_round_block, donate_argnums=(0, 1))
        self._compiled = False

        # Flat pixel coordinates, padded to whole blocks (padding lanes
        # re-render pixel 0 and scatter into the dummy row hw).
        pix = np.arange(self.n_blocks * self.block, dtype=np.int64)
        self._pad_mask = pix < n_pixels
        # Real (non-padding) lanes THIS host traces per round; the
        # global figure is allreduced in fetch_accumulation.
        self._local_lanes = int(
            self._pad_mask[self._blk_lo * self.block:
                           self._blk_hi * self.block].sum()) * ms
        self._lanes_done = 0  # this host's cumulative lane count
        self._px = np.where(self._pad_mask, pix % xres, 0).astype(np.int32)
        self._py = np.where(self._pad_mask, pix // xres, 0).astype(np.int32)
        pix_idx = np.where(self._pad_mask, pix, hw).astype(np.int32)
        # Device-resident per-block inputs, built once (only this
        # host's slice of blocks lives in device memory).  Under a mesh
        # they are placed as the block step consumes them — lanes
        # sharded, the accumulation replicated — so no call reshards.
        self._px_dev = []
        self._py_dev = []
        self._pix_idx_dev = []
        for b in range(self._blk_lo, self._blk_hi):
            s, e = b * self.block, (b + 1) * self.block
            self._px_dev.append(self._put(self._px[s:e], lanes=True))
            self._py_dev.append(self._put(self._py[s:e], lanes=True))
            self._pix_idx_dev.append(self._put(pix_idx[s:e], lanes=True))
        self._acc_dev = self._put(np.zeros((hw + 1, 3), np.float32))
        # f32 ray counter: exact to 16.7M per add and ~1e-7 relative
        # beyond — a progress metric, not radiometry.
        self._rays_dev = self._put(np.zeros((), np.float32))

    def _put(self, a, lanes: bool = False):
        """A host array on the device, or on the mesh: lane-sharded
        (`lanes`) or replicated."""
        if self.mesh is None:
            return jnp.asarray(a)
        return jax.device_put(a, self.mesh.lane_sharding if lanes
                              else self.mesh.replicated)

    def _block_args(self, i: int, round_idx: int):
        return (self._acc_dev, self._rays_dev,
                self.scene, self.camera, self._px_dev[i], self._py_dev[i],
                jnp.uint32(round_idx * self.ms),
                jnp.uint32(self.seed), self._pix_idx_dev[i])

    def compile(self) -> float:
        """Compile the block step ahead of the first round (a no-op if
        done already or if this host has no block).  Returns and
        records the seconds it took."""
        if self._compiled or not self.local_blocks:
            return 0.0
        t0 = time.time()
        self._block_fn = self._block_fn.lower(
            *self._block_args(0, self.start_round)).compile()
        self._compiled = True
        self.stats.compile_seconds = time.time() - t0
        return self.stats.compile_seconds

    def render_round(self, round_idx: int, monitor=None) -> None:
        """Render every pixel x multisample once; accumulate on device.
        Under multi-host, only this host's block slice is traced."""
        for i in range(self.local_blocks):
            self._acc_dev, self._rays_dev = self._block_fn(
                *self._block_args(i, round_idx))
            if monitor is not None:
                monitor.add_blocks(1)
        self._lanes_done += self._local_lanes
        self.stats.lanes = self._lanes_done
        self.stats.rounds += 1

    def fetch_accumulation(self) -> None:
        """Pull the device accumulation into the host AccumulationImage
        (one transfer; called before EXR writes / checkpointing).

        Multi-host: a COLLECTIVE — every process must call it for the
        same round.  Hosts own disjoint pixel blocks, so the cross-host
        sum-reduce recovers the full frame exactly (adding zeros), and
        the result is bitwise process-count-invariant."""
        xres, yres = self.camera.xres, self.camera.yres
        acc_host = np.asarray(self._acc_dev[:-1], np.float32)
        rays = float(self._rays_dev)
        lanes = float(self._lanes_done)
        if self.n_procs > 1:
            acc_host = multihost.allreduce_image(acc_host)
            rays, lanes = (float(v) for v in multihost.allreduce_image(
                np.asarray([rays, lanes], np.float32)))
        self.acc.sum = np.asarray(acc_host, np.float64).reshape(
            yres, xres, 3)
        self.acc.count = np.full((yres, xres),
                                 float(self.ms * self.stats.rounds))
        self.stats.rays = int(rays)
        self.stats.lanes = int(lanes)

    def render_frame(self, out_path: Optional[str] = None) -> RenderStats:
        """Run the rounds/timed loop, writing the EXR progressively."""
        from .monitor import FrameMonitor

        s = self.settings
        self.compile()
        t0 = time.time()
        eta = LowPass()
        est_rounds = (1 if s.timed
                      else max(1, int(s.rounds) - self.start_round))
        monitor = FrameMonitor(self.local_blocks * est_rounds,
                               enabled=(out.get_verbosity() >= 2
                                        and self.proc_id == 0))
        monitor.__enter__()
        try:
            return self._render_frame_loop(out_path, s, t0, eta, monitor)
        finally:
            monitor.__exit__()

    def _render_frame_loop(self, out_path, s, t0, eta, monitor):
        round_idx = self.start_round
        while True:
            rt0 = time.time()
            self.render_round(round_idx, monitor=monitor)
            round_idx += 1
            rt = time.time() - rt0
            self.stats.seconds = time.time() - t0
            if out_path:
                wt0 = time.time()
                self.fetch_accumulation()  # collective under multi-host
                if self.proc_id == 0:
                    self.acc.save(out_path, scale=s.output_scale)
                    self.save_checkpoint(out_path + ".ckpt.npz", round_idx)
                self.stats.write_seconds += time.time() - wt0
            monitor.set_rays(self.stats.rays)
            rays_s = self.stats.rays_per_sec
            if s.timed:
                total = s.render_minutes * 60.0
                left = total - self.stats.seconds
                # Timed mode: re-estimate the block total from the
                # measured pace so the bar tracks wall-clock progress.
                monitor.total = max(
                    monitor.done,
                    int(round(self.local_blocks * round_idx
                              * total / max(self.stats.seconds, 1e-6))))
                out.log(2, f"Round {round_idx} in {rt:.1f}s | "
                           f"{format_int_thousands(int(rays_s))} rays/s | "
                           f"{format_time(max(0, left))} left")
                # Timed stop is host 0's call: clock skew must not let
                # hosts disagree on the round count (a disagreeing host
                # would wedge the next collective).
                stop = self.stats.seconds >= total
                if self.n_procs > 1:
                    stop = multihost.broadcast_scalar(
                        1.0 if stop else 0.0) > 0.5
                if stop:
                    break
            else:
                remaining = (s.rounds - round_idx) * eta.push(rt)
                out.log(2, f"Round {round_idx}/{s.rounds} in {rt:.1f}s | "
                           f"{format_int_thousands(int(rays_s))} rays/s | "
                           f"ETA {format_time(remaining)}")
                if round_idx >= s.rounds:
                    break
        self.stats.seconds = time.time() - t0
        self.fetch_accumulation()
        out.log(1, f"Total rays: {format_int_thousands(self.stats.rays)}; "
                   f"avg {format_int_thousands(int(self.stats.rays_per_sec))}"
                   f" rays/s")
        return self.stats

    # ---- checkpoint/resume (SURVEY §5: sum, count, round, seed) ----

    def save_checkpoint(self, path: str, next_round: int) -> None:
        np.savez_compressed(path, sum=self.acc.sum, count=self.acc.count,
                            next_round=next_round, seed=self.seed,
                            rays=self.stats.rays)

    def try_resume(self, path: str) -> int:
        """Multi-host-safe resume: process 0 alone inspects and loads
        the checkpoint and broadcasts the next round index, so hosts
        never diverge on round count when the filesystem is not shared
        (a diverging host would wedge the fetch_accumulation
        collective).  Returns the next round index (0 = no resume)."""
        if self.n_procs == 1:
            return self.load_checkpoint(path) if os.path.exists(path) else 0
        exists = (1.0 if (self.proc_id == 0 and os.path.exists(path))
                  else 0.0)
        if multihost.broadcast_scalar(exists) < 0.5:
            return 0
        nr = self.load_checkpoint(path) if self.proc_id == 0 else 0
        nr = int(multihost.broadcast_scalar(float(nr)))
        if self.proc_id != 0:
            # Workers carry zero accumulation (proc 0 owns the
            # checkpointed sums — fetch_accumulation sum-reduces);
            # they only need to agree on where the round loop starts.
            self.start_round = nr
            self.stats.rounds = nr
        return nr

    def load_checkpoint(self, path: str) -> int:
        """Restore accumulation state; returns the next round index."""
        d = np.load(path)
        if int(d["seed"]) != self.seed:
            raise ValueError("checkpoint seed mismatch")
        self.acc.sum = d["sum"]
        self.acc.count = d["count"]
        self.stats.rounds = int(round(float(d["count"].max()) / self.ms))
        self.stats.rays = int(d["rays"]) if "rays" in d else 0
        # Re-seed the device accumulation buffer from the checkpoint.
        # Multi-host: ONLY process 0 carries the checkpointed sums —
        # fetch_accumulation sum-reduces across hosts, so seeding every
        # host would count the checkpoint n_procs times.
        flat = np.zeros((self.camera.xres * self.camera.yres + 1, 3),
                        np.float32)
        if self.proc_id == 0:
            flat[:-1] = np.asarray(d["sum"], np.float32).reshape(-1, 3)
        self._acc_dev = self._put(flat)
        self._rays_dev = self._put(np.float32(
            self.stats.rays if self.proc_id == 0 else 0.0))
        self.start_round = int(d["next_round"])
        return self.start_round
