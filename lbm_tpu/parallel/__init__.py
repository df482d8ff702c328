"""Distributed runtime: 1-D row decomposition over a device mesh with
ppermute halo exchange — the equivalent of the reference's MPI
layer (allocate_rows d2q9-bgk.c:483-503, halo_exchange d2q9-bgk.c:341-393,
collate d2q9-bgk.c:395-447).
"""

from lbm_tpu.parallel.decomp import RowDecomposition, make_mesh, largest_divisor_leq

__all__ = ["RowDecomposition", "make_mesh", "largest_divisor_leq"]
