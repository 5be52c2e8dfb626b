"""Host-side scene data model.

Mirrors the backend-agnostic flat scene POD of the reference
(reference util/scene.h:23-33, util/mesh.h:6-47, util/material.h:11-46,
util/lights.h:6-18, util/camera.h:5-8): plain arrays that every backend
consumes in ``set_scene`` to build its device structures. Here the arrays are
numpy; engine/device_scene.py flattens them into torch tensors.

The port's own copy of chameleonrt_tpu/scene/types.py: the port's entry
points take a Scene of this module and refuse any other class, since the
enums here compare unequal to those of the JAX package.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from chameleonrt_tpu_torch.scene import texture_mask

# Default Disney material parameter values (reference util/material.h:29-46).
DEFAULT_BASE_COLOR = (0.9, 0.9, 0.9)
DEFAULT_ROUGHNESS = 1.0
DEFAULT_IOR = 1.5


class MaterialMode(enum.Enum):
    """Material benchmarking modes (reference util/scene.h:16-21).

    DEFAULT: use the materials/textures as authored in the file.
    WHITE_DIFFUSE: ignore all materials; shade with the default white-diffuse
    material to isolate traversal performance from shading.
    """

    DEFAULT = "default"
    WHITE_DIFFUSE = "white_diffuse"


class ColorSpace(enum.Enum):
    LINEAR = 0
    SRGB = 1


@dataclass
class Geometry:
    """One triangle-soup geometry (reference util/mesh.h:6-13).

    vertices: (V, 3) float32; indices: (T, 3) uint32; normals (V, 3) or None;
    uvs (V, 2) or None. A single index per vertex addresses all attributes.
    """

    vertices: np.ndarray
    indices: np.ndarray
    normals: Optional[np.ndarray] = None
    uvs: Optional[np.ndarray] = None

    def __post_init__(self):
        self.vertices = np.ascontiguousarray(self.vertices, dtype=np.float32)
        self.indices = np.ascontiguousarray(self.indices, dtype=np.uint32)
        if self.normals is not None and len(self.normals):
            self.normals = np.ascontiguousarray(self.normals, dtype=np.float32)
        else:
            self.normals = None
        if self.uvs is not None and len(self.uvs):
            self.uvs = np.ascontiguousarray(self.uvs, dtype=np.float32)
        else:
            self.uvs = None

    @property
    def num_tris(self) -> int:
        return int(self.indices.shape[0])


@dataclass
class Mesh:
    """A list of geometries sharing one acceleration structure
    (reference util/mesh.h:15-22)."""

    geometries: List[Geometry] = field(default_factory=list)

    @property
    def num_tris(self) -> int:
        return sum(g.num_tris for g in self.geometries)


@dataclass
class ParameterizedMesh:
    """A mesh plus per-geometry material ids (reference util/mesh.h:28-36)."""

    mesh_id: int
    material_ids: List[int] = field(default_factory=list)


@dataclass
class Instance:
    """Placement of a parameterized mesh via a 4x4 transform
    (reference util/mesh.h:40-47). ``transform`` is column-major semantics
    matching glm: transform @ [x, y, z, 1]^T."""

    transform: np.ndarray
    parameterized_mesh_id: int

    def __post_init__(self):
        self.transform = np.ascontiguousarray(self.transform, dtype=np.float32)
        assert self.transform.shape == (4, 4)


@dataclass
class Image:
    """A texture image (reference util/material.h:11-27): uint8 HWC data plus
    the color space it was authored in (SRGB images are linearized on device
    upload, mirroring backends/embree/render_embree.cpp:90-104)."""

    name: str
    data: np.ndarray  # (H, W, C) uint8
    color_space: ColorSpace = ColorSpace.LINEAR

    def __post_init__(self):
        self.data = np.ascontiguousarray(self.data, dtype=np.uint8)
        assert self.data.ndim == 3

    @property
    def width(self) -> int:
        return int(self.data.shape[1])

    @property
    def height(self) -> int:
        return int(self.data.shape[0])

    @property
    def channels(self) -> int:
        return int(self.data.shape[2])


# Order of the 12 scalar slots in the packed material record. base_color takes
# slots 0..2; each remaining slot is a float that may carry a texture handle in
# its bit pattern (see texture_mask; reference util/texture_channel_mask.h).
MATERIAL_PARAM_NAMES = (
    "base_color_r",
    "base_color_g",
    "base_color_b",
    "metallic",
    "specular",
    "roughness",
    "specular_tint",
    "anisotropy",
    "sheen",
    "sheen_tint",
    "clearcoat",
    "clearcoat_gloss",
    "ior",
    "specular_transmission",
)
NUM_MATERIAL_PARAMS = len(MATERIAL_PARAM_NAMES)  # 14


@dataclass
class DisneyMaterial:
    """Disney BSDF parameters (reference util/material.h:29-46). Any float
    field's bit pattern may be a texture handle (sign bit set) per
    util/texture_channel_mask.h; base_color.r carries full-RGB texture
    handles."""

    base_color: np.ndarray = field(default_factory=lambda: np.array(DEFAULT_BASE_COLOR, np.float32))
    metallic: float = 0.0
    specular: float = 0.0
    roughness: float = DEFAULT_ROUGHNESS
    specular_tint: float = 0.0
    anisotropy: float = 0.0
    sheen: float = 0.0
    sheen_tint: float = 0.0
    clearcoat: float = 0.0
    clearcoat_gloss: float = 0.0
    ior: float = DEFAULT_IOR
    specular_transmission: float = 0.0

    def __post_init__(self):
        self.base_color = np.asarray(self.base_color, dtype=np.float32)

    def pack(self) -> np.ndarray:
        """Pack into the 14-float GPU-friendly record (order of
        MATERIAL_PARAM_NAMES)."""
        return np.array(
            [
                self.base_color[0],
                self.base_color[1],
                self.base_color[2],
                self.metallic,
                self.specular,
                self.roughness,
                self.specular_tint,
                self.anisotropy,
                self.sheen,
                self.sheen_tint,
                self.clearcoat,
                self.clearcoat_gloss,
                self.ior,
                self.specular_transmission,
            ],
            dtype=np.float32,
        )

    def set_color_texture(self, texture_id: int) -> None:
        self.base_color = self.base_color.copy()
        self.base_color[0] = texture_mask.make_texture_handle(texture_id)


@dataclass
class QuadLight:
    """Quad-shaped area light (reference util/lights.h:6-18): emission RGB,
    center-ish position, normal, spanning basis v_x/v_y with width/height."""

    emission: np.ndarray
    position: np.ndarray
    normal: np.ndarray
    v_x: np.ndarray
    v_y: np.ndarray
    width: float
    height: float

    def __post_init__(self):
        for name in ("emission", "position", "normal", "v_x", "v_y"):
            setattr(self, name, np.asarray(getattr(self, name), dtype=np.float32)[:3])

    def pack(self) -> np.ndarray:
        """Pack into a 17-float record: emission(3) position(3) normal(3)
        v_x(3) v_y(3) width height."""
        rec = np.zeros(17, dtype=np.float32)
        rec[0:3] = self.emission
        rec[3:6] = self.position
        rec[6:9] = self.normal
        rec[9:12] = self.v_x
        rec[12:15] = self.v_y
        rec[15] = self.width
        rec[16] = self.height
        return rec


@dataclass
class Camera:
    """Scene camera POD (reference util/camera.h:5-8)."""

    position: np.ndarray
    center: np.ndarray
    up: np.ndarray
    fov_y: float = 65.0

    def __post_init__(self):
        self.position = np.asarray(self.position, dtype=np.float32)[:3]
        self.center = np.asarray(self.center, dtype=np.float32)[:3]
        self.up = np.asarray(self.up, dtype=np.float32)[:3]


@dataclass
class Scene:
    """The flat, host-side, backend-agnostic scene container
    (reference util/scene.h:23-33)."""

    meshes: List[Mesh] = field(default_factory=list)
    parameterized_meshes: List[ParameterizedMesh] = field(default_factory=list)
    instances: List[Instance] = field(default_factory=list)
    materials: List[DisneyMaterial] = field(default_factory=list)
    textures: List[Image] = field(default_factory=list)
    lights: List[QuadLight] = field(default_factory=list)
    cameras: List[Camera] = field(default_factory=list)
    samples_per_pixel: int = 1
    material_mode: MaterialMode = MaterialMode.DEFAULT

    def unique_tris(self) -> int:
        """Unique triangles before instancing (reference util/scene.cpp:69-75)."""
        return sum(m.num_tris for m in self.meshes)

    def total_tris(self) -> int:
        """Total triangles after instancing (reference util/scene.cpp:77-85)."""
        return sum(
            self.meshes[self.parameterized_meshes[inst.parameterized_mesh_id].mesh_id].num_tris
            for inst in self.instances
        )

    def num_geometries(self) -> int:
        return sum(len(m.geometries) for m in self.meshes)

    def validate_materials(self) -> None:
        """Append a default material and point any material_id == -1 at it
        (reference util/scene.cpp:935-958)."""
        needs_default = any(
            mid < 0 for pm in self.parameterized_meshes for mid in pm.material_ids
        )
        if not needs_default:
            return
        default_id = len(self.materials)
        self.materials.append(DisneyMaterial())
        for pm in self.parameterized_meshes:
            pm.material_ids = [default_id if mid < 0 else mid for mid in pm.material_ids]


def ortho_basis(n: np.ndarray):
    """Build a right-handed orthonormal basis around normal ``n``
    (reference util/util.cpp:43-58 / backends/embree/util.ih:32-46)."""
    n = np.asarray(n, dtype=np.float32)
    v_y = np.zeros(3, dtype=np.float32)
    if -0.6 < n[0] < 0.6:
        v_y[0] = 1.0
    elif -0.6 < n[1] < 0.6:
        v_y[1] = 1.0
    elif -0.6 < n[2] < 0.6:
        v_y[2] = 1.0
    else:
        v_y[0] = 1.0
    v_x = np.cross(v_y, n)
    v_x /= np.linalg.norm(v_x)
    v_y = np.cross(n, v_x)
    v_y /= np.linalg.norm(v_y)
    return v_x, v_y


def default_obj_light() -> QuadLight:
    """The generated quad light for scenes without lights
    (reference util/scene.cpp:218-227)."""
    normal = np.array([0.5, -0.8, -0.5], dtype=np.float32)
    normal /= np.linalg.norm(normal)
    position = -10.0 * normal
    v_x, v_y = ortho_basis(normal)
    return QuadLight(
        emission=np.full(3, 20.0, np.float32),
        position=position,
        normal=normal,
        v_x=v_x,
        v_y=v_y,
        width=5.0,
        height=5.0,
    )
