"""Sharded SpMV: the port's counterpart of ``spmv_tpu/parallel/``.

As in the JAX package (one ``shard_map`` over a 1-D mesh), a mesh of P
shards runs in one process (``make_mesh``), the shards all on one
device (virtual shards, as the JAX tests' 8 CPU devices; a
single-process mesh over distinct devices is refused, ``MeshError``),
or spans ``torch.distributed`` ranks, one process a GPU
(``distributed``: ``initialize_distributed``, ``global_mesh``), each
rank holding a contiguous block of shards.  On one process the
collectives are tensor operations on the stacked layout: the all-gather
of x is the stacked x itself, a ``ppermute`` of halo strips a window or
a gather of it, an ``all_to_all`` one gather by the schedule's table,
and the ``psum`` of a solver's dots the dot over the whole stacked
tensor; across ranks they are real collectives (``comm``).  Every
shard's local product is a launch of the port's hand-written kernel for
its format.

- ``shard`` (``ShardedCsr``): nnz-balanced row blocks, x all-gathered,
  the CSR SpMV a shard;
- ``dia_shard`` (``ShardedDia``): equal row blocks with nearest-neighbour
  halos, K1 (SpMV) or K2 (SpMM) a shard;
- ``halo_shard`` (``ShardedCsrHalo``): the ragged halo exchange of the
  x elements that cross shards (``neighbor`` / ``all2all``), the CSR
  SpMV or SpMM over the interior and the boundary a shard;
- ``halo``: the communication-volume model and the halo plan (numpy);
- ``well_shard`` (``ShardedWell``, ``ShardedWellHalo``): 128-aligned
  row blocks as WELL, x all-gathered (one K5 launch a shard) or a halo
  exchange (K5 over the interior, the CSR SpMV over the boundary);
- ``wellcw_shard`` (``ShardedWellCwHalo``): WELL-CW interiors (K3a-c /
  K4a-c and the CSR remainder) and CSR boundaries, SpMV and SpMM;
- ``bsr_shard`` (``ShardedBsrHalo``): whole 128-row X tiles as the halo
  unit, one K7 launch a shard on an extended X;
- ``precond_shard`` (``ShardedBlockJacobiIC0``): block-Jacobi IC(0),
  two ``tri_solve``s a shard;
- ``dryrun``: ``dryrun_multichip``, the eleven strategies of
  ``__graft_entry__.py``'s;
- ``distributed``: the ``torch.distributed`` bootstrap and the process
  mesh; ``comm``: its collectives.

Every path runs across ranks: each container is built with only the
rank's own shards (the schedules and the envelope numbers are the whole
job's on every rank), every product's rows are bitwise the single-process
mesh's, and every solver (CG, PCG, batched CG, BiCGSTAB, GMRES,
Chebyshev, ``lanczos_bounds``, LOBPCG) sums its dots over the ranks
given ``mesh=``; ``dryrun`` runs its eleven strategies over the ranks of
a job.
"""

from spmv_tpu_torch.parallel.comm import (
    all_gather_rows,
    all_reduce_max,
    all_reduce_sum,
    all_to_all_strips,
    exchange_strips,
)
from spmv_tpu_torch.parallel.distributed import (
    global_mesh,
    host_local_info,
    initialize_distributed,
    is_multi_host,
    local_rows,
)
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
from spmv_tpu_torch.parallel.precond_shard import (
    ShardedBlockJacobiIC0,
    block_jacobi_ic0,
    make_sharded_block_ic0_preconditioner,
    sharded_block_ic0_apply,
)
from spmv_tpu_torch.parallel.bsr_shard import (
    ShardedBsrHalo,
    make_sharded_bsr_matvec,
    shard_bsr_halo,
    sharded_bsr_spmm,
    sharded_bsr_spmv,
)
from spmv_tpu_torch.parallel.well_shard import (
    ShardedWell,
    ShardedWellHalo,
    make_sharded_well_halo_matvec,
    make_sharded_well_matvec,
    shard_well,
    shard_well_halo,
    sharded_well_halo_spmv,
    sharded_well_spmv,
)
from spmv_tpu_torch.parallel.wellcw_shard import (
    ShardedWellCwHalo,
    make_sharded_wellcw_halo_matmat,
    make_sharded_wellcw_halo_matvec,
    shard_wellcw_halo,
    sharded_wellcw_halo_spmm,
    sharded_wellcw_halo_spmv,
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
    "initialize_distributed",
    "is_multi_host",
    "global_mesh",
    "local_rows",
    "host_local_info",
    "all_gather_rows",
    "exchange_strips",
    "all_to_all_strips",
    "all_reduce_sum",
    "all_reduce_max",
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
    "ShardedBlockJacobiIC0",
    "block_jacobi_ic0",
    "make_sharded_block_ic0_preconditioner",
    "sharded_block_ic0_apply",
    "ShardedBsrHalo",
    "shard_bsr_halo",
    "sharded_bsr_spmm",
    "sharded_bsr_spmv",
    "make_sharded_bsr_matvec",
    "ShardedWell",
    "shard_well",
    "sharded_well_spmv",
    "make_sharded_well_matvec",
    "ShardedWellHalo",
    "shard_well_halo",
    "sharded_well_halo_spmv",
    "make_sharded_well_halo_matvec",
    "ShardedWellCwHalo",
    "shard_wellcw_halo",
    "sharded_wellcw_halo_spmv",
    "make_sharded_wellcw_halo_matvec",
    "sharded_wellcw_halo_spmm",
    "make_sharded_wellcw_halo_matmat",
]
