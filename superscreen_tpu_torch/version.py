"""Package version (importable with no dependencies: ``about.py`` and the
packaging read it before torch is imported)."""

__version_info__ = (0, 1, 0)
__version__ = ".".join(map(str, __version_info__))
