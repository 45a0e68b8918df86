from .interface import ErasureCodeInterface  # noqa: F401
from .base import ErasureCode, SIMD_ALIGN  # noqa: F401
from .registry import (  # noqa: F401
    ErasureCodePluginRegistry,
    instance as plugin_registry,
    create_erasure_code,
)
