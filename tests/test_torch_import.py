"""lis_tpu_torch imports without JAX or lis_tpu, and its import builds
nothing (kernels compile at first use on a CUDA device)."""

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
import lis_tpu_torch.precon.ads
import lis_tpu_torch.solvers.stationary, lis_tpu_torch.solvers.gmres
import lis_tpu_torch.solvers.cgs, lis_tpu_torch.solvers.tfqmr
import lis_tpu_torch.solvers.orthomin, lis_tpu_torch.solvers.gpbicg
import lis_tpu_torch.solvers.bicgsafe, lis_tpu_torch.solvers.minres
import lis_tpu_torch.solvers.bicgstabl, lis_tpu_torch.solvers.idrs
import lis_tpu_torch.ops._cuda as cu
bad = sorted(m for m in sys.modules
             if m.split('.')[0] in ('jax', 'jaxlib', 'lis_tpu'))
print(bad, cu._lib is None)
"""


def test_import_without_jax():
    env = dict(os.environ, PYTHONPATH=_ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=_ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"], out.stdout
