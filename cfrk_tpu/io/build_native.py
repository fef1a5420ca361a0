"""Build the native extension from ``native/fastaio.cpp``, in place.

    python -m cfrk_tpu.io.build_native

Importing this module does not load the extension, so a process can
rebuild it before its first use.  It makes one direct compiler call with
the interpreter's own ``sysconfig`` paths (no setuptools needed).  The
result, ``native/_fastaio<EXT_SUFFIX>``, is listed in ``.gitignore``; it
is written to a temporary name and renamed into place, so a process
that already loaded the old library keeps it.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sysconfig

__all__ = ["SOURCE", "build_extension"]

SOURCE = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "native", "fastaio.cpp"
)


def build_extension(out_dir: str | None = None, timeout: float = 600) -> str:
    """Compile :data:`SOURCE` into ``out_dir`` (default: next to it).

    Returns the path of the built library; raises
    ``subprocess.CalledProcessError`` with the compiler's output on
    failure.
    """
    out_dir = out_dir or os.path.dirname(SOURCE)
    target = os.path.join(
        out_dir, "_fastaio" + sysconfig.get_config_var("EXT_SUFFIX")
    )
    cxx = (sysconfig.get_config_var("CXX") or "c++").split()
    if shutil.which(cxx[0]) is None:
        cxx = ["c++"]
    tmp = f"{target}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            [
                *cxx, "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                "-I" + sysconfig.get_paths()["include"],
                SOURCE, "-o", tmp,
            ],
            check=True, capture_output=True, text=True, timeout=timeout,
        )
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return target


if __name__ == "__main__":
    print(build_extension())
