"""Scene loading dispatch by file extension
(reference util/scene.cpp:49-67), plus the ``proc://`` scheme for the
procedural benchmark scenes that substitute for downloaded assets.
"""

from __future__ import annotations

import os

from chameleonrt_tpu_torch.scene.types import MaterialMode, Scene


def load_scene(path: str, material_mode: MaterialMode = MaterialMode.DEFAULT) -> Scene:
    if path.startswith("proc://"):
        from chameleonrt_tpu_torch.scene import procedural

        spec = path[len("proc://") :]
        name, _, argstr = spec.partition("?")
        kwargs = {}
        if argstr:
            for kv in argstr.split("&"):
                k, _, v = kv.partition("=")
                kwargs[k] = int(v) if v.lstrip("-").isdigit() else float(v)
        scene = procedural.make_procedural(name, **kwargs)
        if material_mode == MaterialMode.WHITE_DIFFUSE:
            _strip_materials(scene)
        scene.material_mode = material_mode
        return scene

    ext = os.path.splitext(path)[1].lower()
    if ext == ".obj":
        from chameleonrt_tpu_torch.scene.obj_loader import load_obj

        return load_obj(path, material_mode)
    if ext in (".gltf", ".glb"):
        from chameleonrt_tpu_torch.scene.gltf_loader import load_gltf

        return load_gltf(path, material_mode)
    if ext == ".crts":
        from chameleonrt_tpu_torch.scene.crts_loader import load_crts

        return load_crts(path, material_mode)
    if ext == ".pbrt":
        from chameleonrt_tpu_torch.scene.pbrt_loader import load_pbrt

        return load_pbrt(path, material_mode)
    raise ValueError(f"unsupported scene format: {path}")


def _strip_materials(scene: Scene) -> None:
    """WHITE_DIFFUSE mode for procedural scenes: drop all materials and let
    validate_materials assign the default white-diffuse one
    (reference util/scene.cpp:126-130 + :935-958)."""
    scene.materials = []
    scene.textures = []
    for pm in scene.parameterized_meshes:
        pm.material_ids = [-1] * len(pm.material_ids)
    scene.validate_materials()
