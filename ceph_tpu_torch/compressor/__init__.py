"""Compressor plugins of the port (``compressor/registry.py``)."""
from .registry import (
    Compressor, CompressorRegistry, create_compressor, g_compressor_registry,
)

__all__ = ["Compressor", "CompressorRegistry", "create_compressor",
           "g_compressor_registry"]
