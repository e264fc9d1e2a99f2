"""Compile the CUDA SHA-1 kernel library into a directory and print its path.

    python -m downloader_tpu_torch.parallel --out DIR

The one build step of the kernel: ``sha1_cuda.build(DIR)`` with the
module's own ``NVCC_FLAGS`` (needs nvcc). The Makefile's
``kernel-torch``, the CUDA image (Dockerfile.cuda) and the zipapp build
(hack/build_torch_pyz.py) call it. It lives here and not under
``sha1_cuda``'s ``__main__``: the package imports ``sha1_cuda`` first,
and ``-m`` would run a second copy of it with its own state.
"""

import argparse
import sys
from pathlib import Path

from . import sha1_cuda


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m downloader_tpu_torch.parallel",
        description=__doc__.splitlines()[0],
    )
    parser.add_argument("--out", type=Path, required=True, help="directory")
    args = parser.parse_args(argv)
    print(sha1_cuda.build(args.out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
