"""The least device time of one served batch: ``classify_loop``'s, whose
serving loop this driver runs."""

from .classify_loop import least_seconds  # noqa: F401
