"""No native topology passes: each answers None (see ``__init__``)."""


def __getattr__(name):
    if name.startswith("__"):
        raise AttributeError(name)
    return lambda *args, **kwargs: None
