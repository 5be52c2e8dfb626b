"""Scenes and lanes for the tests of S1, the shading kernel
(tests/test_torch_shade_host.py on the CPU, tests/test_torch_shade_cuda.py
on the card). Imports nothing of JAX.

SCENES: the Cornell Box; the Cornell Box with anisotropic metal, clearcoat
and sheen, and a rough dielectric hit from both sides; the textured hall;
the Cornell Box with rotated instances inside it; and the Cornell Box with
three lights. frame_lanes captures every shading call of a frame that the
port renders.
"""

import numpy as np
import pytest

from chameleonrt_tpu_torch.engine.backend_cuda import CudaBackend
from chameleonrt_tpu_torch.ops import shade_cuda
from chameleonrt_tpu_torch.scene.loader import load_scene
from chameleonrt_tpu_torch.scene.types import DisneyMaterial, Instance, ParameterizedMesh, QuadLight


def materials_box():
    """The Cornell Box with anisotropic metal (left wall), clearcoat and
    sheen (right wall) and a rough dielectric (floor, ceiling, back wall
    and both blocks, entered and left by the paths through them)."""
    scene = load_scene("proc://cornell")
    scene.materials = [
        DisneyMaterial(base_color=np.array([0.9, 0.9, 0.85], np.float32), roughness=0.2,
                       specular=0.5, clearcoat=0.3, clearcoat_gloss=0.9, ior=1.45,
                       specular_transmission=0.9),
        DisneyMaterial(base_color=np.array([0.7, 0.2, 0.1], np.float32), metallic=0.8,
                       roughness=0.4, specular=0.5, specular_tint=0.3, anisotropy=0.7),
        DisneyMaterial(base_color=np.array([0.2, 0.6, 0.3], np.float32), roughness=0.6,
                       specular=0.5, sheen=0.8, sheen_tint=0.5, clearcoat=1.0,
                       clearcoat_gloss=0.7),
    ]
    return scene


def instanced_box():
    """The Cornell Box (instance 0) with six rotated, scaled instances of
    the instanced grid's box inside it, in the grid's two materials: a
    closed room, so paths live to bounce 4, in a two-level scene."""
    scene = load_scene("proc://cornell")
    grid = load_scene("proc://instances?nx=2&ny=3&subdiv=1")
    n_mat = len(scene.materials)
    scene.materials += grid.materials
    scene.meshes.append(grid.meshes[0])
    scene.parameterized_meshes += [ParameterizedMesh(1, [n_mat + m]) for m in (0, 1)]
    for k, inst in enumerate(grid.instances):
        t = inst.transform.copy()
        t[:3, :3] *= 0.4
        t[:3, 3] = [(k % 3 - 1) * 0.55, (k // 3) * 0.9 - 0.3, 0.3 * (k % 2)]
        scene.instances.append(Instance(t, 1 + k % 2))
    return scene


def three_lights():
    """The Cornell Box lit by three quads of different sizes and powers."""
    scene = load_scene("proc://cornell")
    one = scene.lights[0]
    scene.lights = [one] + [
        QuadLight(emission=one.emission * k, position=one.position + np.float32([dx, 0.0, dz]),
                  normal=one.normal, v_x=one.v_x, v_y=one.v_y, width=one.width * k,
                  height=one.height * k)
        for k, dx, dz in ((0.5, -0.6, 0.3), (0.8, 0.4, -0.5))
    ]
    return scene


SCENES = {
    "cornell": lambda: load_scene("proc://cornell"),
    "materials": materials_box,
    "textured": lambda: load_scene("proc://hall?subdiv=0&textured=1"),
    "instances": instanced_box,
    "three_lights": three_lights,
}


def frame_lanes(scene, width, height, device="cpu"):
    """Every shading call of one width x height 1-spp frame that the port's
    cuda backend renders on device: [(flat, meta, bounce, lanes)], the
    lanes as _shade_bounce takes them, captured at
    ops/shade_cuda.shade_bounce."""
    b = CudaBackend(device=device)
    b.initialize(width, height)
    b.set_scene(scene)
    calls = []
    shade = shade_cuda.shade_bounce

    def capture(flat, meta, bounce, *lanes):
        calls.append((flat, meta, bounce, tuple(x.clone() for x in lanes)))
        return shade(flat, meta, bounce, *lanes)

    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(shade_cuda, "shade_bounce", capture)
        cam = scene.cameras[0]
        d = cam.center - cam.position
        b.render(cam.position, d / np.linalg.norm(d), cam.up, cam.fov_y, True,
                 readback_framebuffer=False)
    finally:
        mp.undo()
    return calls
