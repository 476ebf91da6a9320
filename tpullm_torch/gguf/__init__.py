"""GGUF container: constants, mmap reader, writer."""

from .constants import GGMLType, GGUFValueType, Keys, TokenType, TYPE_TRAITS
from .reader import GGUFReader, GGUFTensorInfo
from .writer import GGUFWriter

__all__ = ["GGMLType", "GGUFValueType", "Keys", "TokenType", "TYPE_TRAITS",
           "GGUFReader", "GGUFTensorInfo", "GGUFWriter"]
