"""Build the Fortran/C binding shim and its C drivers.

``build()`` compiles the port's own copy of the shim
(``lis_tpu_torch/_native/lisf_tpu.c``) into ``liblisf_tpu.so`` and the C
drivers beside it (``ftest/*.c``: the call sequences of the reference's
Fortran test programs test1f, test2f, test6f, test7f, test8f, etest1f and
etest4f, and ``lisf_demo.c``, its test4f) into executables linked to it.
The compiler is gcc; Python's include path and libpython come from
``sysconfig``.  The output goes to ``build/lis_tpu_torch/`` at the
repository root unless another directory is named, and nothing is built
at import.  A file is rebuilt when it is missing or older than its
sources, and everything when the interpreter, libpython or checkout the
library was built for (recorded beside it in ``liblisf_tpu.cfg``) is not
this process's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import sysconfig
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_HERE))
_FTEST = os.path.join(_HERE, "ftest")
SHIM_SRC = os.path.join(_HERE, "lisf_tpu.c")
DRIVERS = ("test1f", "test2f", "test6f", "test7f", "test8f", "etest1f",
           "etest4f", "lisf_demo")
LIB = "liblisf_tpu.so"

# seconds spent in gcc by the last build() (0.0 when all was up to date)
build_seconds = 0.0


def default_dir() -> str:
    return os.path.join(_ROOT, "build", "lis_tpu_torch")


def _driver_src(name: str) -> str:
    return os.path.join(_HERE if name == "lisf_demo" else _FTEST,
                        name + ".c")


def _libpython() -> tuple[str, str]:
    """(directory, library name) of the shared libpython."""
    ver = sysconfig.get_config_var("LDVERSION") or \
        sysconfig.get_config_var("VERSION")
    name = f"python{ver}"
    dirs = [sysconfig.get_config_var("LIBDIR"),
            sysconfig.get_config_var("LIBPL"),
            os.path.join(sys.base_prefix, "lib")]
    for d in dirs:
        if d and os.path.exists(os.path.join(d, f"lib{name}.so")):
            return d, name
    raise RuntimeError(f"no shared lib{name}.so in {dirs}: the shim embeds "
                       f"CPython and needs it")


def _stale(out: str, *srcs: str) -> bool:
    return not os.path.exists(out) or any(
        os.path.getmtime(out) < os.path.getmtime(s) for s in srcs)


def _gcc(args: list[str], out: str) -> subprocess.Popen:
    """Start gcc writing ``out`` under a private name (renamed into place
    by ``_finish``), so a concurrent build never loads a half-written
    file."""
    tmp = f"{out}.{os.getpid()}.tmp"
    return subprocess.Popen(["gcc", *args, "-o", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish(proc: subprocess.Popen, out: str) -> None:
    log, _ = proc.communicate(timeout=240)
    if proc.returncode != 0:
        raise RuntimeError(f"gcc failed building {out}:\n{log}")
    os.replace(f"{out}.{os.getpid()}.tmp", out)


def build(dest: str | None = None, drivers=DRIVERS) -> dict[str, str]:
    """Build the shim and ``drivers`` into ``dest`` (None: the default
    directory); return {"lib": path, driver name: path, ...}."""
    global build_seconds
    dest = dest or default_dir()
    os.makedirs(dest, exist_ok=True)
    lib = os.path.join(dest, LIB)
    header = os.path.join(_FTEST, "lisf_tpu.h")
    t0 = time.perf_counter()
    built = False
    libdir, pyname = _libpython()
    cfg = os.path.join(dest, "liblisf_tpu.cfg")
    config = json.dumps([sys.executable, libdir, pyname, _ROOT])
    old = open(cfg).read() if os.path.exists(cfg) else None
    if old != config or _stale(lib, SHIM_SRC):
        inc = sysconfig.get_paths()["include"]
        proc = _gcc(["-shared", "-fPIC", "-O2", SHIM_SRC, f"-I{inc}",
                     f"-DLISF_PYTHON={json.dumps(sys.executable)}",
                     f"-DLISF_ROOT={json.dumps(_ROOT)}",
                     f"-L{libdir}", f"-l{pyname}", f"-Wl,-rpath,{libdir}"],
                    lib)
        _finish(proc, lib)
        with open(cfg, "w") as f:
            f.write(config)
        built = True
    out = {"lib": lib}
    procs = []
    for name in drivers:
        exe = os.path.join(dest, name)
        out[name] = exe
        src = _driver_src(name)
        if built or _stale(exe, src, header):
            procs.append((_gcc([src, f"-I{_FTEST}", f"-L{dest}",
                                "-llisf_tpu", f"-Wl,-rpath,{dest}"], exe),
                          exe))
    for proc, exe in procs:
        _finish(proc, exe)
    build_seconds = time.perf_counter() - t0 if built or procs else 0.0
    return out
