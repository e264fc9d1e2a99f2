#!/usr/bin/env python3
"""Build the PyTorch/CUDA port as one executable file, a stdlib zipapp.

    python3 hack/build_torch_pyz.py [--out bin/downloader-torch.pyz]

Run it from anywhere; it reads the package from this checkout. The
archive holds ``downloader_tpu_torch/`` (nothing of the JAX package) and
a ``__main__.py`` that calls the port's ``cli.main``, and beside the
sources it ships the native libraries this host can build:

- ``fetch/_rc4.so``, the MSE RC4 core, when a C compiler exists
  (compiled by ``fetch/rc4_native.py``'s own step);
- ``parallel/libsha1-<hash>.so``, the CUDA SHA-1 kernel for ``sm_90a``,
  when nvcc exists (``utils/usercache.find_nvcc``, the port's own
  lookup); ``python -m downloader_tpu_torch.parallel --out`` compiles it,
  and imports the package, so that step needs torch.

A library that does not load here is left out. At run time ctypes
cannot load from a zip, so each module extracts its library into the
per-user cache (``utils/usercache.py``); without one it compiles from
the shipped source or, for RC4, runs in pure Python. The last line of
the output is one JSON object: the archive, the libraries it holds,
the ones left out, and the seconds the build took.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
import tempfile
import time
import zipapp
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PACKAGE = "downloader_tpu_torch"
MAIN = "import sys\n\nfrom downloader_tpu_torch.cli import main\n\nsys.exit(main())\n"


def loads(path: Path) -> bool:
    try:
        ctypes.CDLL(str(path))
        return True
    except OSError:
        return False


def build(out: Path) -> dict:
    start = time.perf_counter()
    sys.path.insert(0, str(REPO))
    from downloader_tpu_torch.fetch import rc4_native
    from downloader_tpu_torch.utils import usercache

    with tempfile.TemporaryDirectory(prefix="downloader-torch-pyz-") as staging:
        package = Path(staging) / PACKAGE
        shutil.copytree(
            REPO / PACKAGE, package,
            ignore=shutil.ignore_patterns("__pycache__", "*.pyc", "*.so", "*.tmp"),
        )
        if rc4_native._find_compiler() is not None:
            source = package / "fetch" / "_rc4.c"
            rc4_native._compile_source(str(source), str(source.with_suffix(".so")))
        if usercache.find_nvcc() is not None:
            subprocess.run(
                [sys.executable, "-m", f"{PACKAGE}.parallel",
                 "--out", str(package / "parallel")],
                cwd=REPO, check=True, stdout=subprocess.DEVNULL,
            )
        libraries, dropped = [], []
        for library in sorted(package.rglob("*.so")):
            name = str(library.relative_to(staging))
            if loads(library):
                libraries.append(name)
            else:
                library.unlink()
                dropped.append(name)
        (Path(staging) / "__main__.py").write_text(MAIN)
        out.parent.mkdir(parents=True, exist_ok=True)
        zipapp.create_archive(
            staging, out, interpreter="/usr/bin/env python3", compressed=True
        )
    return {
        "pyz": str(out),
        "libraries": libraries,
        "dropped": dropped,
        "seconds": time.perf_counter() - start,
    }


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--out", type=Path, default=REPO / "bin" / "downloader-torch.pyz",
        help="the archive to write (default: bin/downloader-torch.pyz)",
    )
    args = parser.parse_args(argv)
    print(json.dumps(build(args.out.resolve())))
    return 0


if __name__ == "__main__":
    sys.exit(main())
