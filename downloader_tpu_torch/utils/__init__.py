from .logging import get_logger  # noqa: F401
