"""Command-line interface.

Flag parity with the reference CLI (reference src/main.cpp:58-260):
preview mode (-p: dims/4, samples/2 — the "48x faster" sanity render),
timed override (-t minutes), output dir/scale overrides, verbosity,
orbit animation (-r: 250 frames, camera orbiting the lookat point),
--no-overwrite frame claiming for shared-FS render farming, and -c
compare-suffix mode.

Usage:
    python -m rgk.driver.cli scene.json [options]

On a host with several accelerators, one process owns all of them and
shards each frame over a 1-D mesh (`--devices 0`, the default).
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from ..scene.config import build_scene, load_config
from ..utils import log as out
from ..utils.format import format_time
from .render import RenderDriver

ANIMATION_FRAMES = 250  # reference main.cpp: 250 frames @ 50 fps


def insert_file_suffix(path: str, suffix: str) -> str:
    base, ext = os.path.splitext(path)
    return f"{base}.{suffix}{ext}"


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="rgk",
        description="Differentiable wavefront path tracer (JAX)")
    p.add_argument("config", help="scene configuration JSON")
    p.add_argument("-p", "--preview", action="store_true",
                   help="preview: resolution/4, multisample/2")
    p.add_argument("-t", "--timed", type=float, metavar="MINUTES",
                   help="override: render for this many minutes")
    p.add_argument("-D", "--output-dir", metavar="DIR",
                   help="override output directory")
    p.add_argument("-s", "--scale", type=float, metavar="S",
                   help="override output-scale (exposure)")
    p.add_argument("-v", "--verbose", action="count", default=0)
    p.add_argument("-q", "--quiet", action="count", default=0)
    p.add_argument("-r", "--rotate", action="store_true",
                   help="render a 250-frame orbit animation")
    p.add_argument("-c", "--compare", action="store_true",
                   help="write output with a .cmp suffix for A/B")
    p.add_argument("--no-overwrite", action="store_true",
                   help="skip frames whose output file already exists")
    p.add_argument("--resume", action="store_true",
                   help="resume from <output>.ckpt.npz if present")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--sampler",
                   choices=["halton", "independent", "stratified", "lhs",
                            "vdc"],
                   default="halton",
                   help="low-discrepancy sampler family (the reference's "
                        "Independent/Halton/Stratified/LatinHypercube/"
                        "VanDerCorput samplers, src/sampler.hpp)")
    # Untuned for the GPU: the value was tuned on the previous
    # accelerator.
    p.add_argument("--chunk-lanes", type=int, default=1 << 20,
                   help="max wavefront lanes per device dispatch")
    p.add_argument("--devices", type=int, default=0,
                   help="shard over N devices (0 = all available)")
    p.add_argument("--cpu", action="store_true",
                   help="force the CPU backend")
    p.add_argument("--coordinator", metavar="HOST:PORT", default="",
                   help="multi-host: address of process 0's coordinator")
    p.add_argument("--num-processes", type=int, default=1,
                   help="multi-host: total participating processes")
    p.add_argument("--process-id", type=int, default=0,
                   help="multi-host: this process's rank")
    p.add_argument("-d", "--debug-pixel", nargs=2, type=int,
                   metavar=("X", "Y"),
                   help="print a per-bounce trace of one pixel before "
                        "rendering (reference -d, main.cpp:95-107)")
    return p


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> list:
    """The CLI's work; returns the RenderDriver of every frame it
    rendered (their `stats` carry rays, seconds, compile and commit
    time)."""
    args = build_parser().parse_args(argv)
    out.set_verbosity(2 + args.verbose - args.quiet)

    import jax
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")
    from ..utils.cache import enable_compile_cache
    enable_compile_cache()

    if args.num_processes > 1 or args.coordinator:
        from ..parallel import multihost
        if args.cpu:
            # CPU cross-process collectives need the gloo backend
            # (the 2-process smoke-test topology, SURVEY §4).
            jax.config.update("jax_cpu_collectives_implementation",
                              "gloo")
        multihost.initialize(args.coordinator, args.num_processes,
                             args.process_id)
        if jax.process_index() != 0:
            # One progress stream: workers log errors only.
            out.set_verbosity(0)

    cfg = load_config(args.config)
    s = cfg.settings
    if args.preview:
        s.xres = max(1, s.xres // 4)
        s.yres = max(1, s.yres // 4)
        s.multisample = max(1, s.multisample // 2)
    if args.timed is not None:
        s.timed = True
        s.render_minutes = args.timed
    if args.scale is not None:
        s.output_scale = args.scale

    out_file = s.output_file
    if args.output_dir:
        out_file = os.path.join(args.output_dir, os.path.basename(out_file))
    if args.compare:
        out_file = insert_file_suffix(out_file, "cmp")

    out.log(2, f"Loading scene from {args.config}")
    t0 = time.time()
    arrays, meta, _ = build_scene(cfg)
    commit_seconds = time.time() - t0
    from ..ops.sampler import MODE_NAMES
    sampler_mode = MODE_NAMES[args.sampler]

    mesh = None
    # Mesh over LOCAL devices; cross-process distribution is
    # block-partitioned by the driver (parallel/multihost.py).  Under
    # jax.distributed, jax.devices() is the GLOBAL list (identical on
    # every process), so the mesh is built from this process's
    # addressable devices explicitly.
    n = (min(args.devices, jax.local_device_count())
         if args.devices > 0 else jax.local_device_count())
    if n > 1:
        from ..parallel.mesh import MeshContext
        mesh = MeshContext(n, devices=jax.local_devices()[:n])
        out.log(2, f"Sharding wavefronts over {n} local devices")

    drivers = []
    frames = ANIMATION_FRAMES if args.rotate else 1
    for frame in range(frames):
        rotation = frame / frames if args.rotate else 0.0
        frame_file = (insert_file_suffix(out_file, f"{frame:04d}")
                      if args.rotate else out_file)
        if args.no_overwrite and os.path.exists(frame_file):
            out.log(2, f"Skipping existing frame {frame_file}")
            continue
        cam = cfg.get_camera(rotation)
        cfg.post_check()
        if args.debug_pixel is not None and frame == 0:
            from ..integrator.debug import trace_pixel_debug
            dx, dy = args.debug_pixel
            trace_pixel_debug(arrays, meta, s, cam, dx, dy,
                              seed=args.seed, sampler_mode=sampler_mode)
        driver = RenderDriver(s, arrays, meta, cam, seed=args.seed,
                              sampler_mode=sampler_mode,
                              chunk_lanes=args.chunk_lanes, mesh=mesh)
        if args.resume:
            nr = driver.try_resume(frame_file + ".ckpt.npz")
            if nr:
                out.log(2, f"Resuming from round {nr}")
        os.makedirs(os.path.dirname(os.path.abspath(frame_file)),
                    exist_ok=True)
        driver.stats.commit_seconds = commit_seconds
        stats = driver.render_frame(frame_file)
        out.log(1, f"Wrote {frame_file} after {stats.rounds} rounds in "
                   f"{format_time(stats.seconds)}")
        drivers.append(driver)
    return drivers


if __name__ == "__main__":
    sys.exit(main())
