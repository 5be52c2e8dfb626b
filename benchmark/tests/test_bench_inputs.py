"""The frozen generator: the same seed gives the same inputs and two seeds
different ones, and the program loads its file as the published Cornell
Box and as the RefScene states it."""

import os

import numpy as np

from benchmark.harness import bench, spec

CELL = "cornell-960-1spp"


def _generate(tmp_path, seed):
    cell = spec.load_cell(CELL)
    out = tmp_path / f"cornell-{seed}"
    out.mkdir()
    camera = bench.camera_for(cell.config, seed)
    path, make_ref = cell.generator().generate(str(out), seed, cell.config, camera)
    return path, make_ref, camera


def _files(path):
    d = os.path.dirname(path)
    return {f: open(os.path.join(d, f), "rb").read() for f in sorted(os.listdir(d))}


def test_same_seed_same_inputs_other_seed_other(tmp_path):
    big = 2**31 + 12345
    a, ref_a, cam_a = _generate(tmp_path, big)
    (tmp_path / "again").mkdir()
    b, ref_b, cam_b = _generate(tmp_path / "again", big)
    c, ref_c, cam_c = _generate(tmp_path, 7)
    assert _files(a) == _files(b)
    assert all(np.array_equal(x, y) for x, y in zip(cam_a, cam_b))
    assert _files(a) != _files(c)
    assert not np.array_equal(cam_a[0], cam_c[0]) and not np.array_equal(cam_a[1], cam_c[1])
    # the seed moves the camera (and its look-at point alike) by at most `shift`, never the scene
    cfg = spec.load_cell(CELL).config["camera"]
    for cam in (cam_a, cam_c):
        d = cam[0] - np.asarray(cfg["position"], np.float32)
        assert np.allclose(cam[1] - np.asarray(cfg["center"], np.float32), d, atol=1e-3)
        assert np.abs(d).max() <= cfg["shift"] + 1e-3 and d[2] == 0.0
    ra, rc = ref_a(), ref_c()
    for key in ("tri_v0", "tri_e1", "tri_e2", "tri_mat", "materials"):
        assert np.array_equal(getattr(ra, key), getattr(rc, key))


def test_program_loads_the_cornell_box_as_stated(tmp_path):
    from chameleonrt_tpu_torch.engine.device_scene import _host_tables
    from chameleonrt_tpu_torch.scene.loader import load_scene

    cfg = spec.load_cell(CELL).config
    path, make_ref, _ = _generate(tmp_path, 20260)
    scene = load_scene(path)
    assert (scene.unique_tris(), scene.total_tris(), len(scene.instances)) == (cfg["triangles"], 32, 1)
    assert (len(scene.materials), len(scene.textures)) == (cfg["materials"], cfg["textures"])
    ref = make_ref()
    t, _ = _host_tables(scene)
    for key in ("tri_v0", "tri_e1", "tri_e2"):
        assert np.array_equal(t[key], getattr(ref, key))
    assert np.array_equal(t["mat_rows"][:, :14].view(np.uint32), ref.materials.view(np.uint32))
    assert np.array_equal(t["shade_rows"][:, 13].view(np.int32), ref.tri_mat)
    (x,), (y,) = scene.lights, ref.lights
    for k in ("emission", "position", "normal", "v_x", "v_y"):
        assert np.array_equal(getattr(x, k), getattr(y, k)), k
    assert (x.width, x.height) == (y.width, y.height) and sorted((x.width, x.height)) == [105.0, 130.0]
    # the published quads, each two triangles (a, b, c) and (a, c, d), the light 0.1 lower
    quads = []
    for name in ("light", "floor", "ceiling", "back_wall", "short_block", "tall_block", "left_wall",
                 "right_wall"):
        q = np.asarray(cfg["quads"][name], np.float32).reshape(-1, 4, 3)
        if name == "light":
            q = q - np.float32([0.0, cfg["light_drop"], 0.0])
        quads.append(q)
    q = np.concatenate(quads)
    tris = np.stack([q[:, [0, 1, 2]], q[:, [0, 2, 3]]], axis=1).reshape(-1, 3, 3)
    np.testing.assert_allclose(ref.tri_v0, tris[:, 0], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ref.tri_v0 + ref.tri_e1, tris[:, 1], rtol=0, atol=1e-4)
    np.testing.assert_allclose(ref.tri_v0 + ref.tri_e2, tris[:, 2], rtol=0, atol=1e-4)
