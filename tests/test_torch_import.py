"""lis_tpu_torch imports without JAX or lis_tpu, and its import builds
nothing (kernels compile at first use on a CUDA device; the host library
and the Fortran/C shim at first use)."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import sys
import lis_tpu_torch
import lis_tpu_torch.interop.state
import lis_tpu_torch.matrix.dia, lis_tpu_torch.matrix.hybrid
import lis_tpu_torch.matrix.css, lis_tpu_torch.utils.testmat
import lis_tpu_torch.io.mm, lis_tpu_torch._native
import lis_tpu_torch.cli.lsolve, lis_tpu_torch.cli.hpcg
import lis_tpu_torch.matrix.split, lis_tpu_torch.ops.trisolve
import lis_tpu_torch.precon.ssor, lis_tpu_torch.precon.ilu
import lis_tpu_torch.precon.ads, lis_tpu_torch.precon.jacobi
import lis_tpu_torch.precon.is_precon, lis_tpu_torch.precon.sainv
import lis_tpu_torch.precon.hybrid, lis_tpu_torch.precon.saamg
import lis_tpu_torch.ops.amg
import lis_tpu_torch.solvers.stationary, lis_tpu_torch.solvers.gmres
import lis_tpu_torch.solvers.cgs, lis_tpu_torch.solvers.tfqmr
import lis_tpu_torch.solvers.orthomin, lis_tpu_torch.solvers.gpbicg
import lis_tpu_torch.solvers.bicgsafe, lis_tpu_torch.solvers.minres
import lis_tpu_torch.solvers.bicgstabl, lis_tpu_torch.solvers.idrs
import lis_tpu_torch.esolvers.driver, lis_tpu_torch.esolvers.power
import lis_tpu_torch.esolvers.cgcr, lis_tpu_torch.esolvers.subspace
import lis_tpu_torch.cli.esolve, lis_tpu_torch.cli.esolver
import lis_tpu_torch.cli.gesolve, lis_tpu_torch.cli.gesolver
import lis_tpu_torch.compat, lis_tpu_torch.interop
import lis_tpu_torch.interop.fapi, lis_tpu_torch.cli.spmvtest
import lis_tpu_torch.utils.checkpoint, lis_tpu_torch.utils.profiling
import lis_tpu_torch.core.array, lis_tpu_torch.ops.spmv
import lis_tpu_torch.parallel, lis_tpu_torch.parallel.mesh
import lis_tpu_torch.parallel.dist, lis_tpu_torch.parallel.dist_precon
import lis_tpu_torch.parallel.dist_esolve
import lis_tpu_torch.core.ranges, lis_tpu_torch.cli.scaling
import lis_tpu_torch._native.lisf as lisf
import lis_tpu_torch.ops._cuda as cu
import lis_tpu_torch._native as nat
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'lis_tpu'))
print(bad, cu._lib is None and nat._lib is None
      and lisf.build_seconds == 0.0)
"""


def test_import_without_jax():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"], out.stdout


def test_host_library_source_is_the_ports_own():
    """The port builds its host library from its own copy of the C++
    source: no file it reads lies under lis_tpu/."""
    from lis_tpu_torch import _native
    pkg = os.path.join(_ROOT, "lis_tpu_torch") + os.sep
    src = os.path.realpath(_native._SRC)
    assert src.startswith(pkg) and os.path.isfile(src)
    assert not src.startswith(os.path.join(_ROOT, "lis_tpu") + os.sep)


def test_shim_sources_are_the_ports_own():
    """The Fortran/C shim and its drivers build from the port's copies,
    and the build writes outside the source tree."""
    from lis_tpu_torch._native import lisf
    pkg = os.path.join(_ROOT, "lis_tpu_torch") + os.sep
    srcs = [lisf.SHIM_SRC] + [lisf._driver_src(d) for d in lisf.DRIVERS]
    for src in map(os.path.realpath, srcs):
        assert src.startswith(pkg) and os.path.isfile(src), src
    assert not lisf.default_dir().startswith(pkg)
    with open(lisf.SHIM_SRC) as f:
        text = f.read()
    assert '"lis_tpu_torch.interop.fapi"' in text
    assert '"lis_tpu.interop.fapi"' not in text


def test_parallel_exports_lis_tpus_names():
    """lis_tpu_torch.parallel exports every name of lis_tpu.parallel, and
    its modules import neither jax nor lis_tpu."""
    import ast
    import lis_tpu_torch.parallel as tp
    src = os.path.join(_ROOT, "lis_tpu", "parallel", "__init__.py")
    names = None
    for node in ast.parse(open(src).read()).body:
        if isinstance(node, ast.Assign) and node.targets[0].id == "__all__":
            names = ast.literal_eval(node.value)
    assert names and set(names) <= set(tp.__all__)
    for mod in ("mesh", "dist", "dist_precon", "dist_esolve"):
        text = open(os.path.join(_ROOT, "lis_tpu_torch", "parallel",
                                 mod + ".py")).read()
        assert "import jax" not in text and "from lis_tpu." not in text
        assert "from jax" not in text and "import lis_tpu\n" not in text


def test_every_lis_tpu_module_has_a_counterpart():
    """Each .py module of lis_tpu/ has a module at the same path under
    lis_tpu_torch/."""
    def modules(pkg):
        top = os.path.join(_ROOT, pkg)
        return {os.path.relpath(os.path.join(d, f), top)
                for d, _, fs in os.walk(top) for f in fs
                if f.endswith(".py")}
    assert modules("lis_tpu") - modules("lis_tpu_torch") == set()
