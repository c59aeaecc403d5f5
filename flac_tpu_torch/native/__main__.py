"""Explicit native build step: `python -m flac_tpu_torch.native [--force]`.

Compiles flac_native.cpp with the host toolchain (again with --force),
loads it, checks its ABI stamp and prints where the library is.  A failed
build exits 1 with the compiler's message.
"""

from __future__ import annotations

import sys

from . import ABI_VERSION, build, lib


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        path = build(force="--force" in argv)
        lib()
    except (OSError, RuntimeError) as e:
        print(f"BUILD FAILED: {e}", file=sys.stderr)
        return 1
    print(f"built {path} (ABI v{ABI_VERSION}); native runtime ACTIVE")
    return 0


if __name__ == "__main__":
    sys.exit(main())
