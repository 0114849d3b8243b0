"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled on its own by

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared -Xcompiler -fPIC -Xptxas -v

into ``build/casapose_tpu_torch/<name>-<hash>.so`` at the repository root,
keyed on a hash of every file in ``csrc/`` and the flags, so an edited source
rebuilds and an unchanged one loads at once. :func:`build` starts one nvcc
per source, all together. The sources have a plain C interface; no PyTorch
header is compiled. ptxas's report (registers, spills) is kept beside each
library and returned by :func:`ptxas_report`.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "casapose_tpu_torch")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points: name -> (source stem, argtypes). Each returns a cudaError_t as int.
_SIGNATURES = {
    "voting_grid": ("voting", [_I, _I, _I, _I, _I, _I, _P]),
    "voting_accumulate": ("voting", [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    "solve_pnp": ("pnp", [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "lm_refine": ("pnp", [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P]),
    "cc_label": ("cc", [_P, _P, _P, _I, _I, _I, _I, _P]),
    "cc_config": ("cc", [_I, _I, _P]),
}
SOURCES = sorted({src for src, _ in _SIGNATURES.values()})

_lock = threading.Lock()
_libs = {}


def _sources_hash():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in sorted(os.listdir(CSRC_DIR)):
        with open(os.path.join(CSRC_DIR, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read())
    return h.hexdigest()[:16]


def _lib_path(name):
    return os.path.join(BUILD_DIR, f"{name}-{_sources_hash()}.so")


def _nvcc():
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("casapose_tpu_torch: nvcc not found; the CUDA kernels build only on a CUDA host")
    return nvcc


def build(names=None):
    """Compile the named sources (default: all) that are not built yet, one nvcc each, in parallel."""
    todo = [n for n in (names or SOURCES) if not os.path.exists(_lib_path(n))]
    if not todo:
        return
    nvcc = _nvcc()
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = []
    for name in todo:
        tmp = _lib_path(name) + f".tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, name + ".cu")]
        procs.append((name, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, tmp, proc in procs:
        log = proc.communicate()[0]
        with open(_lib_path(name) + ".log", "w") as f:
            f.write(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu:\n{log}")
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))


def ptxas_report(name):
    """The compiler's output (ptxas registers / spills) from building ``csrc/<name>.cu``."""
    with open(_lib_path(name) + ".log") as f:
        return f.read()


def load(name):
    """The loaded library of ``csrc/<name>.cu``, built first if needed, with every entry point declared."""
    with _lock:
        if name not in _libs:
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            for fn, (src, argtypes) in _SIGNATURES.items():
                if src == name:
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return _libs[name]
