"""Build the CUDA kernels under csrc/ with nvcc at first use and bind them
with ctypes.

Each source in csrc/ becomes one shared library with a plain C interface
(no PyTorch headers, so nvcc takes seconds): every entry takes raw device
pointers and the CUDA stream, and returns cudaGetLastError().  All sources
are compiled at once, one nvcc process each, the first time any kernel is
launched; importing this module needs no nvcc.  Libraries land in
`_build/` (git-ignored) under a name that carries a digest of the sources
and flags, so an edited kernel is never served from a stale build.

A failed build raises; nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("field_ops", "g1", "g2", "jub", "poseidon", "ntt", "mimc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_I = ctypes.c_int
SIGNATURES = {
    "field_ops": {
        "field_mul_launch": (_P, _P, _P, _LL, _I, _I, _I, _P),
        "field_add_launch": (_P, _P, _P, _LL, _I, _I, _I, _P),
        "field_sub_launch": (_P, _P, _P, _LL, _I, _I, _I, _P),
    },
    "g1": {
        "g1_add_launch": (_P,) * 9 + (_LL, _P),
        "g1_double_launch": (_P,) * 6 + (_LL, _P),
        "g1_scalar_mul_launch": (_P,) * 7 + (_LL, _I, _P),
    },
    "g2": {
        "g2_add_launch": (_P,) * 9 + (_LL, _P),
        "g2_double_launch": (_P,) * 6 + (_LL, _P),
        "g2_scalar_mul_launch": (_P,) * 7 + (_LL, _I, _P),
        "g2_consts_upload": (_P,),
    },
    "jub": {
        "jub_add_launch": (_P,) * 9 + (_LL, _P),
        "jub_scalar_mul_launch": (_P,) * 7 + (_LL, _I, _P),
        "jub_consts_upload": (_P,),
    },
    "poseidon": {
        "poseidon2_launch": (_P, _P, _P, _LL, _P),
        "poseidon_consts_upload": (_P, _P, _I),
    },
    "ntt": {
        "ntt_stage_launch": (_P, _P, _LL, _LL, _I, _I, _P),
        "ntt_cols_launch": (_P, _P, _P, _I, _LL, _P),
    },
    "mimc": {
        "mimc2_launch": (_P, _P, _P, _LL, _P),
        "mimc_consts_upload": (_P, _I),
    },
}


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.is_file():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for part in (CSRC / "field.cuh", CSRC / f"{name}.cu"):
        h.update(part.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def words_le(x: int, n: int = 8) -> list[int]:
    """Little-endian 32-bit words of a non-negative int."""
    return [(x >> (32 * i)) & 0xFFFFFFFF for i in range(n)]


def _field_consts_words() -> np.ndarray:
    from ..oracle.field import P_FQ, P_FR

    words = []
    for p in (P_FR, P_FQ):
        words += words_le(p) + [(-pow(p, -1, 1 << 32)) % (1 << 32)] + words_le(2 * p)
    return np.asarray(words, np.uint32)


def _poseidon_consts_words():
    """circomlib t = 3 round constants (n_rounds, 3, 8) and MDS (3, 3, 8)
    as Montgomery words."""
    from ..oracle.field import P_FR
    from ..ops.constants import POSEIDON_RF, POSEIDON_RP, poseidon_params

    t = 3
    C, M = poseidon_params(t)
    n_rounds = POSEIDON_RF + POSEIDON_RP[t - 2]
    mont = lambda v: words_le(v * (1 << 256) % P_FR)  # noqa: E731
    c = np.asarray([mont(v) for v in C], np.uint32).reshape(n_rounds, t, 8)
    m = np.asarray([mont(M[i][j]) for i in range(t) for j in range(t)],
                   np.uint32).reshape(t, t, 8)
    return np.ascontiguousarray(c), np.ascontiguousarray(m), n_rounds


def _mimc_consts_words():
    """The 91 MiMC7 round constants (91, 8) as Montgomery words."""
    from ..oracle.field import P_FR
    from ..ops.constants import mimc7_constants

    cts = mimc7_constants()
    c = np.asarray([words_le(v * (1 << 256) % P_FR) for v in cts], np.uint32)
    return np.ascontiguousarray(c), len(cts)


def library_path(name: str) -> Path:
    """Where the library built from csrc/<name>.cu for these sources and
    flags lives."""
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


class _Libraries:
    """The loaded kernel libraries of this process (built on first use)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}
        self.logs: dict[str, str] = {}

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if not self._libs:
                self._build_and_load()
            return self._libs[name]

    def _build_and_load(self) -> None:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        targets = {n: library_path(n) for n in SOURCES}
        procs = {}
        for name, so in targets.items():
            if so.exists():
                continue
            tmp = so.with_name(so.name + f".{os.getpid()}.tmp")
            cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True),
                           tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            so.with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{out}")
                continue
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
        consts = _field_consts_words()
        for name, so in targets.items():
            log = so.with_suffix(".log")
            self.logs[name] = log.read_text() if log.exists() else ""
            lib = ctypes.CDLL(str(so))
            for fn, argtypes in (("field_consts_upload", (_P,)),
                                 *SIGNATURES[name].items()):
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            check(lib.field_consts_upload(consts.ctypes.data), f"{name}: field constants")
            if name == "g2":
                from .g2 import b3_mont_words

                b3 = np.asarray(b3_mont_words(), np.uint32)
                check(lib.g2_consts_upload(b3.ctypes.data), "g2: b3")
            if name == "jub":
                from .jub import jub_consts_words

                words = np.asarray(jub_consts_words(), np.uint32)
                check(lib.jub_consts_upload(words.ctypes.data), "jub: 1, A and D")
            if name == "poseidon":
                c, m, n_rounds = _poseidon_consts_words()
                check(lib.poseidon_consts_upload(c.ctypes.data, m.ctypes.data, n_rounds),
                      "poseidon: round constants")
            if name == "mimc":
                c, n_rounds = _mimc_consts_words()
                check(lib.mimc_consts_upload(c.ctypes.data, n_rounds), "mimc: round constants")
            self._libs[name] = lib


LIBRARIES = _Libraries()


def library(name: str) -> ctypes.CDLL:
    """The ctypes handle of one kernel library, building all on first use."""
    return LIBRARIES.get(name)


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
