"""computervisionimagestich2_tpu — a JAX panorama stitching framework.

A ground-up JAX/XLA/Pallas rebuild of the capabilities of the reference
C++ CImg+VLFeat panorama stitcher (chensh236/ComputerVisionImageStich2):
cylindrical projection, SIFT features, ratio-test matching, RANSAC warp
estimation, canvas compositing, Laplacian-pyramid blending, histogram
equalization, and Reinhard color transfer — every hot loop a compiled
XLA/Pallas kernel.
"""
from .config import (  # noqa: F401
    DEFAULT_CONFIG,
    BlendConfig,
    EnhanceConfig,
    MatchConfig,
    ProjectionConfig,
    RansacConfig,
    SiftConfig,
    StitchConfig,
)

__version__ = "0.1.0"


def __getattr__(name):
    # Lazy public API: keep `import computervisionimagestich2_tpu` light.
    if name in ("Stitcher", "stitch", "stitch_files"):
        from .models import stitcher as _stitcher

        return getattr(_stitcher, name)
    if name == "ImageProcess":
        from .api.compat import ImageProcess

        return ImageProcess
    if name == "Projection":
        from .api.compat import Projection

        return Projection
    raise AttributeError(name)
