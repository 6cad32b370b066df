"""Native (C++) components: the MAS oracle, built on demand with g++ and
loaded through ctypes (a copy of aligner_tpu/native).

One small C++ source is compiled lazily into a cache directory: no
generated artifacts in the tree and no coupling to the interpreter's
version. `maximum_path(..., implementation="cpp")` runs it on the host.
"""
from .build import load_mas_cpu, maximum_path_cpp

__all__ = ["load_mas_cpu", "maximum_path_cpp"]
