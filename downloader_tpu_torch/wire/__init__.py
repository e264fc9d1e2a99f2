from .contract import Media, Download, Convert  # noqa: F401
from .protowire import WireError  # noqa: F401
