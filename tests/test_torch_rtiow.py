"""The benchmark's `rtiow_final` configuration ("Ray Tracing in One Weekend",
final scene) on the CPU, at a small size: a 4x4 sphere field, icosphere
levels 1 (the spheres) and 3 (the ground), 64x48 pixels, 2 spp.

- The generator keeps `random_scene`'s rules (the candidate grid and its
  draw order, the exclusion radius, the three large spheres, the material
  parameter ranges) and the counts and sags its configuration file states.
- The CRTS file loads into the expected meshes, parameterized meshes,
  instances, materials and generated light, as the RefScene states them.
- The port's plain CPU path and the benchmark's plain reference agree on
  the sRGB8 image and the ray counts within the cell's limits, with the
  RNG seeded alike; the reference with bfloat16 state fails them.
- The counters this scene feeds: off, a frame records nothing and adds no
  sync span; on, lanes.shaded, the set-up's tables.* and one frame.sample
  span a sample; the route "auto" picks for its two-level table on either
  side of the L2 gate.
"""

import copy
import json
import os
import shutil
import time

import numpy as np
import pytest
import torch

from benchmark import readings
from benchmark.harness import bench, check, spec
from chameleonrt_tpu_torch import native
from chameleonrt_tpu_torch.core import get_backend, tracing
from chameleonrt_tpu_torch.scene.loader import load_scene

torch.set_num_threads(1)

pytestmark = pytest.mark.skipif(native.get_lib() is None, reason="native builder unavailable")

CELL = "rtiow-1200x800-10spp"
W, H, SPP = 64, 48, 2
FRAMES = 3
SEED = 2**31 + 4021


def _config():
    return spec.load_cell(CELL).config


def _small(cfg):
    """The configuration cut for the CPU: a 4x4 field, levels 1 and 3."""
    cfg = copy.deepcopy(cfg)
    cfg["field"]["grid"] = [-2, 2]
    cfg["tessellation"].update(sphere_level=1, ground_level=3)
    return cfg


def _generator():
    return spec.load_cell(CELL).generator()


@pytest.fixture(scope="module")
def small_bench(tmp_path_factory):
    """A copy of the benchmark whose rtiow_final is cut small, with one cell
    `t-rtiow` of it at W x H and SPP on the full cell's limits."""
    root = str(tmp_path_factory.mktemp("rtiow"))
    bench_dir = os.path.join(root, "benchmark")
    shutil.copytree(spec.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    with open(os.path.join(bench_dir, "configs", "rtiow_final.json"), "w") as f:
        json.dump(_small(_config()), f)
    with open(os.path.join(bench_dir, "traffic", "small.json"), "w") as f:
        json.dump({"width": W, "height": H, "spp": SPP, "camera": "static"}, f)
    with open(os.path.join(bench_dir, "cells", CELL + ".json")) as f:
        cell = json.load(f)
    cell.update(traffic="small", reference_lanes=4000, min_pixels=64, max_pixels=W * H)
    with open(os.path.join(bench_dir, "cells", "t-rtiow.json"), "w") as f:
        json.dump(cell, f)
    with open(os.path.join(os.path.dirname(spec.BENCH_DIR), "BENCHMARK.json")) as f:
        bench_json = json.load(f)
    bench_json["workloads"].append({"name": "t-rtiow", "config": "rtiow_final", "traffic": "small",
                                    "chips": 1, "why": "a CPU test"})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench_json, f)
    return bench_dir


@pytest.fixture(scope="module")
def small_scene(tmp_path_factory):
    """(the loaded Scene, the RefScene, the configuration) of the small
    field's CRTS file."""
    cfg = _small(_config())
    out = str(tmp_path_factory.mktemp("rtiow_file"))
    path, make_ref = _generator().generate(out, SEED, cfg, bench.camera_for(cfg, SEED))
    return load_scene(path), make_ref(), cfg


@pytest.fixture(autouse=True)
def _tracing_off():
    tracing.enable(False)
    yield
    tracing.enable(False)


def test_the_field_keeps_random_scenes_rules_and_the_stated_counts():
    cfg = _config()
    field = cfg["field"]
    spheres = _generator().random_scene(cfg)
    ground, grid, large = spheres[0], spheres[1:-3], spheres[-3:]
    assert np.array_equal(ground[0], [0.0, -1000.0, 0.0]) and ground[1] == 1000.0
    assert ground[2] == "diffuse" and np.array_equal(ground[3], [0.5] * 3)
    # the draw order: choice, x, z, then the kept sphere's material draws
    rng = np.random.default_rng(cfg["layout_seed"])
    choose, x, z = rng.random(), -11 + 0.9 * rng.random(), -11 + 0.9 * rng.random()
    first = grid[0]
    assert np.array_equal(first[0], [x, 0.2, z])
    assert first[2] == ("diffuse" if choose < 0.8 else "metal" if choose < 0.95 else "glass")
    cells = set()
    for center, radius, kind, albedo, fuzz in grid:
        a, b = int(np.floor(center[0])), int(np.floor(center[2]))
        assert -11 <= a < 11 and -11 <= b < 11 and (a, b) not in cells
        cells.add((a, b))
        assert center[0] - a < 0.9 and center[2] - b < 0.9 and center[1] == 0.2 and radius == 0.2
        assert np.linalg.norm(center - np.array([4.0, 0.2, 0.0])) > 0.9
        if kind == "diffuse":
            assert ((albedo >= 0.0) & (albedo < 1.0)).all() and fuzz == 0.0
        elif kind == "metal":
            assert ((albedo >= 0.5) & (albedo < 1.0)).all() and 0.0 <= fuzz < 0.5
        else:
            assert kind == "glass" and np.array_equal(albedo, [1.0] * 3)
    assert [(tuple(s[0]), s[1], s[2]) for s in large] == [
        ((0.0, 1.0, 0.0), 1.0, "glass"), ((-4.0, 1.0, 0.0), 1.0, "diffuse"),
        ((4.0, 1.0, 0.0), 1.0, "metal")]
    assert np.array_equal(large[1][3], [0.4, 0.2, 0.1])
    assert np.array_equal(large[2][3], [0.7, 0.6, 0.5]) and large[2][4] == 0.0
    stated = cfg["spheres"]
    kinds = [s[2] for s in spheres]
    assert (len(spheres), len(grid), 22 * 22 - len(grid)) == (
        stated["objects"], stated["grid_kept"], stated["grid_dropped"])
    assert {k: kinds.count(k) for k in ("diffuse", "metal", "glass")} == {
        k: stated[k] for k in ("diffuse", "metal", "glass")}
    assert field["diffuse_below"] == 0.8 and field["metal_below"] == 0.95 and field["ior"] == 1.5


def test_the_materials_map_to_disney():
    gen = _generator()
    d = gen.disney("diffuse", np.array([0.25, 0.5, 0.75]), 0.0, 1.5)
    m = gen.disney("metal", np.array([0.6, 0.7, 0.8]), 0.3, 1.5)
    g = gen.disney("glass", np.ones(3), 0.0, 1.5)
    # base colour, metallic, roughness, ior, specular transmission; every other parameter 0
    assert list(d[[0, 1, 2, 3, 5, 12, 13]]) == [0.25, 0.5, 0.75, 0.0, 1.0, 1.5, 0.0]
    assert list(m[[3, 5, 13]]) == [1.0, np.float32(0.3), 0.0] and np.allclose(m[:3], [0.6, 0.7, 0.8])
    assert list(g[[0, 1, 2, 3, 5, 12, 13]]) == [1.0, 1.0, 1.0, 0.0, 0.0, 1.5, 1.0]
    for rec in (d, m, g):
        assert not rec[[4, 6, 7, 8, 9, 10, 11]].any()


def test_each_level_is_the_smallest_under_the_sag_limit():
    tess = _config()["tessellation"]
    gen = _generator()
    limit = tess["sag_limit"]
    assert limit == pytest.approx(2 * 10 * np.tan(np.radians(10)) / 800 / 4)
    for mesh, radius in (("sphere", 1.0), ("ground", 1000.0)):
        level = tess[f"{mesh}_level"]
        chord, face = gen.largest_sags(level)
        coarser, _ = gen.largest_sags(level - 1)
        assert [chord * radius, coarser * radius] == pytest.approx(tess[f"{mesh}_chord_sag"], rel=1e-9)
        assert face * radius == pytest.approx(tess[f"{mesh}_face_gap"], rel=1e-9)
        assert chord * radius <= limit < coarser * radius
        assert tess[f"{mesh}_triangles"] == 20 * 4 ** level
    v, f = gen.icosphere(2)
    assert np.allclose(np.linalg.norm(v, axis=1), 1.0) and len(v) == 162 and len(f) == 320
    a, b, c = v[f[:, 0]], v[f[:, 1]], v[f[:, 2]]
    assert ((np.cross(b - a, c - a) * (a + b + c)).sum(axis=1) > 0).all()  # outward
    assert tess["unique_triangles"] == 20 * 4 ** 4 + 20 * 4 ** 9
    assert tess["instanced_triangles"] == 20 * 4 ** 9 + (_config()["spheres"]["objects"] - 1) * 5120


def test_the_crts_file_loads_as_the_refscene_states_it(small_scene):
    from chameleonrt_tpu_torch.engine.device_scene import _host_tables

    scene, ref, cfg = small_scene
    n = len(_generator().random_scene(cfg))
    assert n == 1 + 16 + 3
    assert (len(scene.meshes), len(scene.parameterized_meshes), len(scene.instances)) == (2, n, n)
    assert (len(scene.materials), len(scene.textures), len(scene.lights)) == (n, 0, 1)
    assert scene.unique_tris() == 20 * 4 ** 3 + 20 * 4 and scene.total_tris() == 20 * 4 ** 3 + (n - 1) * 80
    assert [i.parameterized_mesh_id for i in scene.instances] == list(range(n))
    assert [scene.parameterized_meshes[i].mesh_id for i in range(n)] == [0] + [1] * (n - 1)
    assert len(ref.tri_v0) == scene.total_tris()
    t, _ = _host_tables(scene)
    assert np.array_equal(t["mat_rows"][:, :14].view(np.uint32), ref.materials.view(np.uint32))
    (x,), (y,) = scene.lights, ref.lights
    for k in ("emission", "position", "normal", "v_x", "v_y"):
        assert np.array_equal(getattr(x, k), getattr(y, k)), k
    assert (x.width, x.height) == (y.width, y.height) == (5.0, 5.0)
    # the world triangles are the instances' matrices over the shared meshes
    ground, sphere = (m.geometries[0] for m in scene.meshes)
    for i, start in ((0, 0), (5, ground.num_tris + 4 * sphere.num_tris)):
        g = ground if i == 0 else sphere
        m = scene.instances[i].transform.astype(np.float64)
        w = (g.vertices.astype(np.float64) @ m[:3, :3].T + m[:3, 3]).astype(np.float32)
        idx = g.indices.astype(np.int64)
        np.testing.assert_array_equal(ref.tri_v0[start:start + len(idx)], w[idx[:, 0]])
        np.testing.assert_array_equal(ref.tri_v0[start:start + len(idx)] + ref.tri_e1[start:start + len(idx)],
                                      ref.tri_v0[start:start + len(idx)] + (w[idx[:, 1]] - w[idx[:, 0]]))


def _limits():
    with open(os.path.join(spec.BENCH_DIR, "cells", CELL + ".json")) as f:
        return json.load(f)["limits"]


def test_the_port_agrees_with_the_reference(small_scene):
    """What bench.run_cell holds the program to (it refuses a process that
    loaded jax, as this one has): the port's sRGB8 image after FRAMES frames
    and its last frame's rays against the reference's, every pixel."""
    from benchmark.reference import camera as ref_camera
    from benchmark.reference import path as ref_path

    scene, ref, cfg = small_scene
    scene.samples_per_pixel = SPP
    b = _backend(scene)
    view = bench.view_of(bench.camera_for(cfg, SEED))
    for i in range(FRAMES):
        stats = b.render(*view, camera_changed=i == 0, readback_framebuffer=i == FRAMES - 1)
    tables = ref_path.build_tables(ref, "cpu")
    ys, xs = torch.meshgrid(torch.arange(H), torch.arange(W), indexing="ij")
    rv = ref_camera.compute_view_params(*view, W, H)
    accum, _, _ = ref_path.render_pixels(tables, rv, xs.reshape(-1), ys.reshape(-1), FRAMES, W, H, SPP)
    ref_u8 = ref_path.tonemap_u8(accum).numpy()
    values = check.readings(b.img[..., :3].reshape(-1, 3), ref_u8, stats.rays_traced,
                            ref_path.frame_rays(tables, rv, FRAMES - 1, W, H, SPP))
    correct, rows = check.judge(values, _limits())
    assert correct, rows
    assert values["srgb_mad"] < 0.5 and values["frame_rays_gap"] < 0.05


def test_the_bfloat16_reference_fails(small_bench):
    cell = spec.load_cell("t-rtiow", small_bench)
    values = readings.control_readings(cell, SEED, frames=FRAMES, device="cpu")
    correct, rows = check.judge(values, _limits())
    assert not correct, rows


def _backend(scene):
    b = get_backend("cuda", device="cpu")
    b.initialize(W, H)
    b.set_scene(scene)
    return b


def _frame(b, cfg):
    pos, d, up, fov = bench.view_of(bench.camera_for(cfg, SEED))
    return b.render(pos, d, up, fov, camera_changed=True)


def test_off_the_counters_record_nothing(small_scene):
    scene, _, cfg = small_scene
    scene.samples_per_pixel = SPP
    b = _backend(scene)
    _frame(b, cfg)
    assert tracing.SPANS == [] and tracing.COUNTS == {} and tracing.DEVICE_COUNTS == {}


def test_on_the_counters_and_spans_read_as_documented(small_scene):
    scene, _, cfg = small_scene
    scene.samples_per_pixel = SPP
    tracing.enable(True)
    b = _backend(scene)
    stats = _frame(b, cfg)
    spans = [list(s) for s in tracing.SPANS]
    samples = [i for i, s in enumerate(spans) if s[0] == "frame.sample"]
    assert len(samples) == SPP and all(spans[spans[i][1]][0] == "frame" for i in samples)

    def in_sample(i):
        while i >= 0 and spans[i][0] != "frame.sample":
            i = spans[i][1]
        return i >= 0

    # each sample's camera and bounces nest in its frame.sample; the frame's own
    # set-up (its pixel ids and sums) is the one frame.camera outside them
    for name, n in (("frame.camera", SPP), ("bounce.closest", 5 * SPP), ("bounce.shade", 5 * SPP),
                    ("bounce.any", 5 * SPP)):
        assert sum(1 for i, sp in enumerate(spans) if sp[0] == name and in_sample(i)) == n, name
    assert sum(1 for i, sp in enumerate(spans) if sp[0] == "frame.camera" and not in_sample(i)) == 1
    summary = tracing.frame_summary()
    counts, setup = summary["counts"], summary["setup_counts"]
    # one nonzero sync a bounce a sample, one ray count
    assert counts["host_syncs"] == 5 * SPP + 1
    assert counts["rays.closest"] + counts["rays.any"] == stats.rays_traced
    assert 0 < counts["lanes.shaded"] <= counts["rays.closest"]
    n = len(scene.instances)
    assert setup["tables.instances"] == n and setup["tables.triangles"] == scene.unique_tris()
    blas = b.flat.blas[0]
    distinct = {t.data_ptr(): t.numel() * 4 for t in (blas.closest.nodes, blas.closest.leaf_rows,
                                                      blas.any.nodes, blas.any.leaf_rows)}
    assert setup["tables.bytes"] == sum(distinct.values()) > 0


def test_tables_streamed_counts_the_tier_the_trace_functions_took(small_scene, monkeypatch):
    """The route "auto" takes for the scene's two-level table: B5c/B5d of
    the streamed tier where the table exceeds the L2 (l2_bytes one byte
    short of it), B3/B4 where it fits; a table on the CPU, which has no L2,
    stays in the B1-B4 tier."""
    from chameleonrt_tpu_torch.engine import trace_bvh

    monkeypatch.delenv("CHAMELEONRT_SLOTLANE", raising=False)
    monkeypatch.delenv("CHAMELEONRT_PACKET", raising=False)
    scene = small_scene[0]
    b = _backend(scene)
    table = b.flat.blas[0].any
    n, size = len(scene.instances), trace_bvh.table_bytes(table)
    for l2, want in ((size - 1, "_stream"), (size, ""), (None, "")):
        route = trace_bvh.choose_route("auto", n, True, table, l2_bytes=l2)
        assert route == (f"closest_unified{want}", f"any_unified{want}", "any", "any"), l2


def test_a_sample_that_left_float32_is_dropped(small_scene, monkeypatch):
    """A lane whose radiance is inf or NaN adds nothing to its pixel; every
    other lane and sample is as without it."""
    from chameleonrt_tpu_torch.engine import path_tracer
    from chameleonrt_tpu_torch.ops import camera as camera_ops

    scene, _, cfg = small_scene
    scene.samples_per_pixel = SPP
    b = _backend(scene)
    vp = camera_ops.compute_view_params(*bench.view_of(bench.camera_for(cfg, SEED)), W, H)
    xs, ys = b._pixels

    def render():
        return path_tracer.render_pixels(b.flat, b.meta, *b._trace, vp, 0, xs, ys, W, H, SPP)[0]

    clean = render()
    trace_waves = path_tracer._trace_waves
    poisoned = []

    def poison(meta, shards, waves, rebalance=False):
        waves, rays, moved = trace_waves(meta, shards, waves, rebalance)
        state, orig, dir, tp, illum, active, lane_pixel = waves[0]
        illum = illum.clone()
        bad = [float("inf"), float("nan")][len(poisoned)]
        illum[lane_pixel == 7, 1] = bad  # pixel 7, one channel
        poisoned.append(bad)
        return [(state, orig, dir, tp, illum, active, lane_pixel)], rays, moved

    monkeypatch.setattr(path_tracer, "_trace_waves", poison)
    dropped = render()
    assert len(poisoned) == SPP and torch.isfinite(dropped).all()
    keep = torch.ones(W * H, dtype=torch.bool)
    keep[7] = False
    assert torch.equal(dropped[keep], clean[keep])
    assert torch.equal(dropped[7], torch.zeros(3)) and (clean[7] > 0).any()  # both samples dropped
