from .media import scan_dir, MEDIA_EXTENSIONS  # noqa: F401
