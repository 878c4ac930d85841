"""Sharded SpMV: the port's counterpart of ``spmv_tpu/parallel/``, first
half.

As in the JAX package, which is single-controller (one ``shard_map``
over a 1-D mesh), the port runs one process over a mesh of P shards
(``make_mesh``); the shards may all lie on one device (virtual shards,
as the JAX tests' 8 CPU devices), and a mesh over distinct devices is
refused until that half is ported.  The collectives become tensor
operations on the stacked layout: the all-gather of x is the stacked x
itself, a ``ppermute`` of halo strips a window or a gather of it, an
``all_to_all`` one gather by the schedule's table, and the ``psum`` of
CG's dots the dot over the whole stacked tensor.  Every shard's local
product is one launch of the port's hand-written kernel for its format.

- ``shard`` (``ShardedCsr``): nnz-balanced row blocks, x all-gathered,
  the CSR SpMV a shard;
- ``dia_shard`` (``ShardedDia``): equal row blocks with nearest-neighbour
  halos, K1 (SpMV) or K2 (SpMM) a shard;
- ``halo_shard`` (``ShardedCsrHalo``): the ragged halo exchange of the
  x elements that cross shards (``neighbor`` / ``all2all``), the CSR
  SpMV or SpMM over the interior and the boundary a shard;
- ``halo``: the communication-volume model and the halo plan (numpy).
"""

from spmv_tpu_torch.parallel.dia_shard import (
    ShardedDia,
    make_sharded_dia_matmat,
    make_sharded_dia_matvec,
    shard_dia,
    sharded_dia_spmm,
    sharded_dia_spmv,
    stack_dia_matrix,
    stack_dia_vector,
    unstack_dia_matrix,
    unstack_dia_vector,
)
from spmv_tpu_torch.parallel.halo import (
    HaloPlan,
    build_halo_plan,
    communication_volume,
)
from spmv_tpu_torch.parallel.halo_shard import (
    ShardedCsrHalo,
    make_sharded_halo_matmat,
    make_sharded_halo_matvec,
    shard_csr_halo,
    sharded_halo_spmm,
    sharded_halo_spmv,
    stack_block,
    unstack_block,
)
from spmv_tpu_torch.parallel.mesh import (
    AXIS_SHARDS,
    Mesh,
    MeshError,
    make_mesh,
    mesh_info,
)
from spmv_tpu_torch.parallel.shard import (
    ShardedCsr,
    make_sharded_matvec,
    shard_csr,
    sharded_spmv,
    stack_vector,
    unstack_vector,
)

__all__ = [
    "AXIS_SHARDS",
    "Mesh",
    "MeshError",
    "make_mesh",
    "mesh_info",
    "ShardedCsr",
    "shard_csr",
    "stack_vector",
    "unstack_vector",
    "sharded_spmv",
    "make_sharded_matvec",
    "communication_volume",
    "HaloPlan",
    "build_halo_plan",
    "ShardedCsrHalo",
    "shard_csr_halo",
    "sharded_halo_spmv",
    "make_sharded_halo_matvec",
    "sharded_halo_spmm",
    "make_sharded_halo_matmat",
    "stack_block",
    "unstack_block",
    "ShardedDia",
    "shard_dia",
    "sharded_dia_spmv",
    "sharded_dia_spmm",
    "make_sharded_dia_matvec",
    "make_sharded_dia_matmat",
    "stack_dia_vector",
    "unstack_dia_vector",
    "stack_dia_matrix",
    "unstack_dia_matrix",
]
