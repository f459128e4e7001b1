"""The distributed layer: ranks over ``torch.distributed`` (port of
``lis_tpu.parallel``).

One process per rank (``launch`` / ``RankPool`` start them); each rank
holds its shard of a ``distribute_*`` result and calls ``dist_solve`` or
``dist_esolve`` with the same options.  See ``mesh.py`` for the backends,
``dist.py`` for the layouts and ``dist_esolve.py`` for the
eigensolvers."""

from lis_tpu_torch.parallel.mesh import (AXIS, Mesh, RankPool,
                                         ensure_devices, launch, make_mesh,
                                         nprocs)
from lis_tpu_torch.parallel.dist import (DistBESMatrix, DistCSRMatrix,
                                         DistCSTMatrix, DistDIAMatrix,
                                         DistHybridMatrix,
                                         DistMultiBESMatrix,
                                         DistTableCSRMatrix, dist_solve,
                                         distribute_bes, distribute_csr,
                                         distribute_csr_cst,
                                         distribute_csr_table,
                                         distribute_dia, distribute_matrix,
                                         distribute_vector,
                                         redistribute_csr, undistribute_csr)
from lis_tpu_torch.parallel.dist_esolve import dist_esolve

__all__ = ["make_mesh", "nprocs", "ensure_devices", "AXIS",
           "distribute_matrix", "distribute_csr", "distribute_dia",
           "distribute_vector", "dist_solve", "dist_esolve",
           "redistribute_csr",
           "undistribute_csr", "DistCSRMatrix", "DistDIAMatrix",
           "DistHybridMatrix", "Mesh", "RankPool", "launch",
           "distribute_bes", "distribute_csr_cst", "distribute_csr_table",
           "DistBESMatrix", "DistCSTMatrix", "DistMultiBESMatrix",
           "DistTableCSRMatrix"]
