"""Build-at-first-use for the port's native sources.

Every shared library the port loads is compiled from a source under
``csrc/`` into ``_build/`` (git-ignored), named by a hash of the source
and the command line, so an edited source or flag never loads a stale
library.  The compiler writes to a per-process temporary name that is
renamed into place, so test workers that build the same library at the
same time cannot load a half-written file.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Sequence

PACKAGE_DIR = Path(__file__).resolve().parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"


def find_tool(name: str, extra_dirs: Sequence[str] = ()) -> str:
    """Absolute path of a compiler on PATH or in ``extra_dirs``; raises
    when it is missing (there is no fallback build)."""
    path = shutil.which(name)
    if path is None:
        for d in extra_dirs:
            cand = Path(d) / name
            if cand.exists():
                path = str(cand)
                break
    if path is None:
        raise RuntimeError(
            f"{name} not found on PATH or in {list(extra_dirs)}: it is "
            "needed to build the port's native library"
        )
    return path


def build_shared_library(source: str, compiler: str, flags: Sequence[str],
                         timeout: float = 600.0) -> Path:
    """Compile ``csrc/<source>`` into ``_build/`` and return the path of
    the shared library (reused when it already exists).  The compiler's
    output is kept beside it, in :func:`build_log` of the library."""
    src = CSRC_DIR / source
    cmd_key = " ".join([Path(compiler).name, *flags])
    digest = hashlib.sha256(
        src.read_bytes() + cmd_key.encode()
    ).hexdigest()[:12]
    out = BUILD_DIR / f"lib{src.stem}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f".{out.name}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [compiler, *flags, "-o", str(tmp), str(src)],
        capture_output=True, text=True, timeout=timeout,
    )
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building {src.name} failed ({compiler}, rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    tmp_log = tmp.with_suffix(".log")
    tmp_log.write_text(proc.stdout + proc.stderr)
    os.replace(tmp_log, build_log(out))
    os.replace(tmp, out)
    return out


def build_log(library: Path) -> Path:
    """The compiler's output for a library built by
    :func:`build_shared_library`."""
    return library.with_suffix(".log")
