"""rgk — a differentiable wavefront path tracer in JAX.

A ground-up JAX/XLA/Pallas re-design of the capabilities of the RGKrt
reference renderer (a CPU C++ path tracer): wavefront path tracing over
flat ray batches, SoA scene arrays resident in device memory, branchless BxDF
dispatch, counter-based stateless low-discrepancy sampling, host-built
BVH traversed on device, and SPMD scaling over a `jax.sharding.Mesh`.

Public entry points:
    rgk.scene.config.load_config      — parse a scene JSON (reference-compatible)
    rgk.scene.builder.SceneBuilder    — build & commit a scene to device arrays
    rgk.driver.render.RenderDriver    — progressive rounds/timed render loop
    rgk.driver.cli.main               — command-line interface
"""

__version__ = "0.1.0"
