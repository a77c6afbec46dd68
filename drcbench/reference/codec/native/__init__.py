"""No native library: the copy runs the codec's pure numpy and Python
paths. Every entry point the codec asks for answers None, which its
callers read as "no native fast path"."""

from . import topo  # noqa: F401 (the codec imports it by name)


def load_library():
    return None


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    return lambda *args, **kwargs: None
