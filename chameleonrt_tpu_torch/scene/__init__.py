from chameleonrt_tpu_torch.scene.types import (  # noqa: F401
    Camera,
    ColorSpace,
    DisneyMaterial,
    Geometry,
    Image,
    Instance,
    MaterialMode,
    Mesh,
    ParameterizedMesh,
    QuadLight,
    Scene,
)
from chameleonrt_tpu_torch.scene.loader import load_scene  # noqa: F401
