"""Float32 exactness on a GPU: a float32 matrix product there runs in
TF32 (10 mantissa bits) unless a precision is stated.  The render path
must hold no such product, and table lookups must be exact gathers."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from rgk.ops import vecmath as vm


def _dots_below_highest(closed_jaxpr):
    """Every dot_general in a jaxpr, nested jaxprs included, whose
    operands are floating point and whose precision is not HIGHEST."""
    highest = jax.lax.Precision.HIGHEST
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                prec = eqn.params.get("precision")
                precs = prec if isinstance(prec, tuple) else (prec,)
                floats = any(jnp.issubdtype(v.aval.dtype, jnp.floating)
                             for v in eqn.invars)
                if floats and not all(p == highest for p in precs):
                    found.append(eqn)
            for p in eqn.params.values():
                for sub in (p if isinstance(p, (list, tuple)) else (p,)):
                    if hasattr(sub, "jaxpr") and hasattr(sub, "consts"):
                        walk(sub.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)

    walk(closed_jaxpr.jaxpr)
    return found


def test_walker_flags_default_precision_dots():
    x = jnp.ones((4, 3), jnp.float32)
    assert _dots_below_highest(jax.make_jaxpr(lambda a: a @ a.T)(x))
    assert _dots_below_highest(jax.make_jaxpr(
        lambda a: jax.lax.cond(True, lambda b: b @ b.T,
                               lambda b: b[:, :1] * b[:, :1].T, a))(x))
    assert not _dots_below_highest(jax.make_jaxpr(
        lambda a: jnp.dot(a, a.T, precision="highest"))(x))


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    from rgk.scene.config import build_scene, load_config
    from tools.bdpt_scene import scene_dict as bdpt_dict
    from tools.cornell_scene import scene_dict as cornell_dict

    d = tmp_path_factory.mktemp("precision")
    out = {}
    for name, sd in (("cornell", cornell_dict(res=8, ms=2)),
                     ("bdpt", bdpt_dict(res=8, ms=2))):
        p = d / f"{name}.json"
        p.write_text(json.dumps(sd))
        cfg = load_config(str(p))
        out[name] = (cfg, build_scene(cfg, build_bvh=False)[:2])
    cfg = out["cornell"][0]
    out["cornell_bvh"] = (cfg, build_scene(cfg, build_bvh=True,
                                           bvh_threshold=8)[:2])
    return out


@pytest.mark.parametrize("name,tracer", [
    ("cornell", "render_lanes"), ("cornell_bvh", "render_lanes"),
    ("cornell", "queued"), ("cornell_bvh", "queued"),
    ("bdpt", "queued_bdpt")])
def test_render_path_has_no_reduced_precision_dot(scenes, name, tracer):
    """Intersection (both platforms' branches), shading, LTC, thin
    glass and accumulation: no float dot below HIGHEST."""
    from rgk.integrator import path

    cfg, (arrays, meta) = scenes[name]
    cam = cfg.get_camera()
    px = jnp.arange(16, dtype=jnp.int32) % 8
    s = cfg.settings

    if tracer == "render_lanes":
        def fn(a):
            return path.render_lanes(a, meta, s, cam, px, px,
                                     px.astype(jnp.uint32), jnp.uint32(1))
    elif tracer == "queued":
        def fn(a):
            return path.trace_wavefront_queued(a, meta, s, cam, px, px,
                                               jnp.uint32(0), 2,
                                               jnp.uint32(1))
    else:
        def fn(a):
            return path.trace_wavefront_queued_bdpt(a, meta, s, cam, px, px,
                                                    jnp.uint32(0), 2,
                                                    jnp.uint32(1))
    assert not _dots_below_highest(jax.make_jaxpr(fn)(arrays))


def test_intersectors_ltc_thinglass_have_no_reduced_precision_dot():
    from rgk.ops import ltc, thinglass
    from rgk.ops.intersect import intersect_brute

    class Scene:
        tri_pack = jnp.ones((5, 13), jnp.float32)
        glass_pack = jnp.ones((3, 12), jnp.float32)
        glass_ids = jnp.arange(3, dtype=jnp.int32)

    ro = jnp.zeros((8, 3), jnp.float32)
    rd = jnp.ones((8, 3), jnp.float32)
    jaxprs = [
        jax.make_jaxpr(lambda o, d: intersect_brute(Scene, o, d, 0.0,
                                                    1e4))(ro, rd),
        jax.make_jaxpr(lambda o, d: thinglass.collect_thinglass(
            Scene, o, d, 0.0, 1e4))(ro, rd),
        jax.make_jaxpr(lambda m, v: ltc._matvec(m, v))(
            jnp.ones((8, 3, 3)), rd),
    ]
    for jp in jaxprs:
        assert not _dots_below_highest(jp)


def test_take_rows_is_bit_exact_for_float_rows():
    rng = np.random.default_rng(0)
    # Full 23-bit mantissas: TF32 would keep only 10 of them.
    table = rng.standard_normal((36, 24)).astype(np.float32)
    idx = rng.integers(0, 36, 1000).astype(np.int32)
    rows = jax.jit(vm.take_rows)(jnp.asarray(table), jnp.asarray(idx))
    assert rows.dtype == jnp.float32
    np.testing.assert_array_equal(np.asarray(rows), table[idx])


def test_take_rows_is_exact_for_large_integers():
    rng = np.random.default_rng(1)
    # Above 2048 a TF32 (or one-hot float) path would round them.
    table = rng.integers(2049, 1 << 30, (40, 4)).astype(np.int32)
    idx = rng.integers(0, 40, 500).astype(np.int32)
    rows = jax.jit(vm.take_rows)(jnp.asarray(table), jnp.asarray(idx))
    assert rows.dtype == jnp.int32
    np.testing.assert_array_equal(np.asarray(rows), table[idx])


def test_take_rows_gradient_reaches_table_rows():
    table = jnp.arange(12.0).reshape(4, 3)
    idx = jnp.asarray([2, 2, 0], jnp.int32)
    g = jax.grad(lambda t: vm.take_rows(t, idx).sum())(table)
    np.testing.assert_array_equal(np.asarray(g),
                                  [[1, 1, 1], [0, 0, 0], [2, 2, 2],
                                   [0, 0, 0]])
