from .app import Daemon, serve  # noqa: F401
from .config import Config  # noqa: F401
