from .server import MDSDaemon  # noqa: F401
