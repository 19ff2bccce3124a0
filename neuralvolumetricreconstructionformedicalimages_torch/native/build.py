"""Build the host data engine (g++ -> shared library, loaded via ctypes).

The library exposes a plain C ABI (``src/data_engine.cpp``) and Python
binds it with ctypes.  It is compiled on first use into
``build/native/libnvr_data_engine-<hash>.so`` at the repository root,
where ``<hash>`` covers the source and the flags, so an edited source
rebuilds.  Each build writes a file of its own process and renames it
into place, so processes that build at once each load a whole library.

    python -m neuralvolumetricreconstructionformedicalimages_torch.native.build
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src" / "data_engine.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-Wall")


def lib_path(build_dir: Path = BUILD_DIR) -> Path:
    digest = hashlib.sha256(SRC.read_bytes() + " ".join(FLAGS).encode()).hexdigest()
    return Path(build_dir) / f"libnvr_data_engine-{digest[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compile the library unless it is built; return its path.  OpenMP
    (parallel over views) where the compiler has it.  Raises with g++'s
    output when neither build succeeds."""
    out = lib_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    errors = []
    for extra in (["-fopenmp"], []):
        cmd = ["g++", *FLAGS, *extra, str(SRC), "-o", str(tmp)]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except FileNotFoundError as e:
            errors.append(str(e))
            break
        except subprocess.CalledProcessError as e:
            errors.append(e.stderr)
            continue
        os.replace(tmp, out)   # atomic: concurrent builds race safely
        return out
    raise RuntimeError("g++ failed to build the data engine:\n" + "\n".join(errors))


if __name__ == "__main__":
    print(build())
