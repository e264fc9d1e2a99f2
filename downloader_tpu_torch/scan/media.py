"""Media file discovery in a downloaded directory.

Rebuild of the reference's ``internal/process`` package (process.go:33-93),
its only unit-tested component. Semantics reproduced exactly:

- A file is media iff its extension is one of .mp4/.mkv/.mov/.webm
  (process.go:17-22).
- Directories are descended into only if their basename contains "season"
  (process.go:23-26), matches ``s\\d+`` (process.go:28-30), or — when the
  scanned root contains exactly one top-level directory — that directory
  (process.go:49-52). All other directories are skipped wholesale
  (process.go:71).
- Results are returned in deterministic walk order (the reference's
  filepath.Walk is lexical; os.walk here is sorted to match).
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import Iterable, List

from ..utils import tracing

MEDIA_EXTENSIONS = frozenset({".mp4", ".mkv", ".mov", ".webm"})

_ALLOWED_DIR_SUBSTRINGS = ("season",)
_ALLOWED_DIR_PATTERNS = (re.compile(r"s\d+"),)


def _dir_allowed(name: str, extra_allowed: Iterable[str]) -> bool:
    for allowed in (*_ALLOWED_DIR_SUBSTRINGS, *extra_allowed):
        if allowed in name:
            return True
    return any(pattern.search(name) for pattern in _ALLOWED_DIR_PATTERNS)


def scan_dir(path: str | os.PathLike[str]) -> List[str]:
    """Find media files under ``path`` and return their paths.

    Equivalent of the reference's ``process.Dir`` (process.go:33). Raises
    OSError if ``path`` is unreadable, as the reference returns the
    ReadDir error.
    """
    root = Path(path)
    with tracing.span("scan-walk") as walk_span:
        # follow_symlinks=False throughout: the reference's filepath.Walk
        # lstats entries and never follows directory symlinks, so a symlink
        # loop inside a download cannot hang or crash the scan.
        top_level_dirs = [
            entry.name
            for entry in os.scandir(root)
            if entry.is_dir(follow_symlinks=False)
        ]

        # A single top-level directory is treated as allowed, so archives
        # that unpack into "Title/..." still get scanned (process.go:49-52).
        extra_allowed = (
            tuple(top_level_dirs) if len(top_level_dirs) == 1 else ()
        )

        found: List[str] = []

        def walk(directory: Path) -> None:
            for entry in sorted(os.scandir(directory), key=lambda e: e.name):
                entry_path = directory / entry.name
                if entry.is_dir(follow_symlinks=False):
                    if _dir_allowed(entry.name, extra_allowed):
                        walk(entry_path)
                    continue
                if os.path.splitext(entry.name)[1] in MEDIA_EXTENSIONS:
                    found.append(str(entry_path))

        walk(root)
        walk_span.annotate(found=len(found))
    return found
