from . import comodo, metadata, sgrid  # noqa: F401
