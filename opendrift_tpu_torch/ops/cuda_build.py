"""Building the port's CUDA sources into shared libraries.

Each source under ``csrc/`` has a plain C interface and is compiled with
``nvcc`` for ``sm_90a`` on first use into ``opendrift_tpu_torch/_build/``
(git-ignored), once per source content and flag set, and loaded with
ctypes by the module that wraps it (``ops/mixing.py``, ``ops/gather.py``).
Nothing is built when a module is imported.
"""

import hashlib
import os
import subprocess

_PKG = os.path.dirname(os.path.dirname(__file__))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3"]
SHARED_FLAGS = ["-Xptxas=-v", "-shared", "-Xcompiler", "-fPIC"]


def nvcc():
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    return path if os.path.exists(path) else "nvcc"


def build(source, flags):
    """Compile ``csrc/<source>`` (or ``source``, an absolute path: another
    version of a source, for an A/B) with ``flags`` unless a library of
    the same content and flags is there already.  Returns (path of the
    shared library, the compiler's report of this build or None)."""
    src = os.path.join(CSRC_DIR, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode())
    stem = os.path.splitext(os.path.basename(source))[0]
    so = os.path.join(BUILD_DIR, f"lib{stem}_{digest.hexdigest()[:16]}.so")
    if os.path.exists(so):
        return so, None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    out = subprocess.run([nvcc(), *flags, "-o", tmp, src],
                         capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"nvcc failed on {src}:\n{out.stderr}")
    os.replace(tmp, so)
    return so, out.stderr


def check_launch(rc, name):
    """Raise when a launcher returned a cudaError_t other than 0."""
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {rc}")
