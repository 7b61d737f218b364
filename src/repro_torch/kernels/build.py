"""Build the port's CUDA kernels and bind them with ctypes.

Each ``csrc/*.cu`` compiles with ``nvcc`` into its own shared library with
a plain C interface, all sources in parallel, into ``_build/`` beside this
file (listed in ``.gitignore``; override with ``REPRO_TORCH_BUILD_DIR``).
Libraries are named by a hash of their sources and flags, so a build is
reused until a source changes.  Nothing is built at import: the first
kernel launch builds, and :func:`build_all` builds ahead of time.

A program without a hand-written device rule (or hook rule) runs a
generated one (``kernels/rulegen.py``): its header, weight and hooks
together, is written to ``_build/gen-<hash>/generated_rule.cuh`` and
``ervs.cu``, ``erjs.cu``, ``megastep.cu`` and ``baselines.cu`` are built
again with ``-DREPRO_GENERATED_RULE`` against it
(:data:`GENERATED_SOURCES`), into libraries whose name hashes the header
with the sources and flags, so two programs never share one.

Flags: ``-gencode arch=compute_90a,code=sm_90a`` for Hopper, ``-O3``,
``-fmad=false`` (no multiply-add contraction: the reference rounds each
multiply and add; the sources also use ``__f*_rn``), and never
``--use_fast_math`` (``logf``/``expf`` must be the accurate ones).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Optional, Tuple

from repro_torch.kernels.rules import RuleStruct

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("ervs.cu", "erjs.cu", "its.cu", "alias.cu", "megastep.cu",
           "ervs_block.cu", "erjs_block.cu", "token_sample.cu",
           "baselines.cu")
#: the sources a generated rule builds instances of (K1, K2, K4, K9–K12)
GENERATED_SOURCES = ("ervs.cu", "erjs.cu", "megastep.cu", "baselines.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

#: launches of each kernel since the last :func:`reset_launches`; every
#: wrapper adds one right after its kernel launched, and nowhere else
LAUNCHES: Dict[str, int] = {
    "ervs_select": 0, "ervs_jump_select": 0,
    "ervs_interleaved_select": 0, "erjs_select": 0,
    "its_search": 0, "alias_pick": 0, "fused_epoch_reservoir": 0,
    "fused_epoch_rejection": 0, "fused_epoch_precomp_its": 0,
    "fused_epoch_precomp_alias": 0, "ervs_block_select": 0,
    "erjs_block_select": 0, "its_search_aligned": 0,
    "alias_pick_aligned": 0, "token_sample": 0, "its_row": 0,
    "rvs_prefix_row": 0, "als_row": 0, "row_max": 0}

#: loaded libraries: by source stem, and by (stem, header) for the
#: instances of a generated rule
_LIBS: Dict[object, ctypes.CDLL] = {}

#: kernels' scratch tensors, by (name, device index, raw stream)
SCRATCH: Dict[Tuple[str, Optional[int], int], "torch.Tensor"] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def build_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_BUILD_DIR",
                               Path(__file__).resolve().parent / "_build"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin/nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def _key(stem: str, header: str):
    return (stem, header) if header else stem


def _gen_dir(header: str) -> Path:
    digest = hashlib.sha256(header.encode()).hexdigest()[:16]
    return build_dir() / f"gen-{digest}"


def _lib_path(source: str, header: str = "") -> Path:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(CSRC.glob("*.cuh")) + [CSRC / source]:
        digest.update(f.read_bytes())
    stem = Path(source).stem
    if header:
        digest.update(header.encode())
        stem += "-gen"
    return build_dir() / f"{stem}-{digest.hexdigest()[:16]}.so"


def build_all(headers=("",)) -> Dict[object, ctypes.CDLL]:
    """Compile every missing library (one ``nvcc`` per source and header,
    all started together): every source for the header "" (the
    hand-written rules), :data:`GENERATED_SOURCES` for each generated
    header.  Load them all and return them, by source stem (and header)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    wanted = [(src, h) for h in headers
              for src in (GENERATED_SOURCES if h else SOURCES)]
    jobs = []
    for src, header in wanted:
        lib = _lib_path(src, header)
        if lib.exists() or _key(Path(src).stem, header) in _LIBS:
            continue
        flags = list(NVCC_FLAGS)
        if header:
            gen = _gen_dir(header)
            gen.mkdir(parents=True, exist_ok=True)
            (gen / "generated_rule.cuh").write_text(header)
            flags += ["-DREPRO_GENERATED_RULE", "-I", str(gen)]
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        log = open(lib.with_suffix(".log"), "w")
        cmd = [_nvcc(), *flags, "-o", str(tmp), str(CSRC / src)]
        jobs.append((src, lib, tmp, log,
                     subprocess.Popen(cmd, stdout=log,
                                      stderr=subprocess.STDOUT)))
    failed = []
    for src, lib, tmp, log, proc in jobs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(f"{src} (rc={rc}, see {lib.with_suffix('.log')}):\n"
                          + lib.with_suffix(".log").read_text()[-4000:])
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    for src, header in wanted:
        stem = Path(src).stem
        if _key(stem, header) not in _LIBS:
            _LIBS[_key(stem, header)] = _bind(
                stem, ctypes.CDLL(str(_lib_path(src, header))))
    return _LIBS


_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, \
    ctypes.c_int64
_R = ctypes.POINTER(RuleStruct)
_SIGNATURES = {
    "ervs": [("repro_ervs_select",
              [_P, _P, _P, _P, _R] + [_P] * 6 + [_I, _I, _I, _P, _P, _P]),
             ("repro_ervs_interleaved_select",
              [_P, _P, _P, _P, _R] + [_P] * 6 + [_I, _I] + [_P] * 5
              + [_I, _P, _P])],
    "erjs": [("repro_erjs_select",
              [_P, _P, _P, _P, _R] + [_P] * 7 + [_I, _I, _I] + [_P] * 5)],
    "its": [("repro_its_search", [_P, _P, _P, _L, _P, _P, _I, _P, _P]),
            ("repro_its_search_aligned", [_P] * 5 + [_I, _L, _P, _P])],
    "alias": [("repro_alias_pick", [_P, _P, _P, _P, _I, _P, _P]),
              ("repro_alias_pick_aligned", [_P] * 6 + [_I, _L, _P, _P])],
    "megastep": [("repro_fused_epoch",
                  [_P, _P, _P, _P, _R, _I, _F, _F, _I] + [_P] * 10
                  + [_L] + [_P] * 3 + [_I, _I, _I, _I, _I, _L] + [_P] * 8)],
    "ervs_block": [("repro_ervs_block_plan",
                    [_P, _P, _I, _L] + [_P] * 8),
                   ("repro_ervs_block_tables",
                    [_P, _P, _P, _L, _P, _I, _I] + [_P] * 7),
                   ("repro_ervs_block_walk",
                    [_P] * 4 + [_I, _L] + [_P] * 11)],
    "erjs_block": [("repro_erjs_block_select",
                    [_P] * 5 + [_I, _L, _I] + [_P] * 3)],
    "token_sample": [("repro_token_sample",
                      [_P, _P, _I, _I, _I, _F, _I] + [_P] * 5)],
    "baselines": [("repro_baseline_rows",
                   [_I] + [_P] * 4 + [_R] + [_P] * 6 + [_I, _L] + [_P] * 4),
                  ("repro_row_max",
                   [_P] * 4 + [_R] + [_P] * 5 + [_I, _L, _P, _P])],
}


def _bind(stem: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn_name, argtypes in _SIGNATURES[stem]:
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def library(stem: str, header: str = "") -> ctypes.CDLL:
    """The loaded library of ``csrc/<stem>.cu`` (building on first use),
    the instance of the generated rule ``header`` where one is given."""
    if _key(stem, header) not in _LIBS:
        build_all((header,))
    return _LIBS[_key(stem, header)]


def scratch(name: str, device, stream: int, numel: int, dtype):
    """Scratch tensor ``name`` of a kernel on (``device``, ``stream``), at
    least ``numel`` elements: zeroed when allocated, kept across launches,
    grown on demand and never shrunk.  Launches on one stream run in order,
    so they share it; a kernel that needs it zero at every launch leaves it
    zero or clears it itself."""
    import torch

    key = (name, device.index, stream)
    t = SCRATCH.get(key)
    if t is None or t.numel() < numel:
        t = SCRATCH[key] = torch.zeros(numel, dtype=dtype, device=device)
    return t


def drop_scratch(prefix: str) -> None:
    """Free the scratch tensors whose names start with ``prefix`` (a
    kernel's, as in ``"ervs_block."``): its next launch allocates them
    anew."""
    for key in [k for k in SCRATCH if k[0].startswith(prefix)]:
        del SCRATCH[key]


def check(err: int, name: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if err:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def require(t, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` — what a kernel takes; wrappers never copy to fix it up."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def require_graph(graph, device) -> None:
    import torch

    V, E = graph.num_nodes, graph.num_edges
    require(graph.indptr, "graph.indptr", torch.int32, (V + 1,), device)
    require(graph.indices, "graph.indices", torch.int32, (E,), device)
    require(graph.h, "graph.h", torch.float32, (E,), device)
    require(graph.labels, "graph.labels", torch.int32, (E,), device)
