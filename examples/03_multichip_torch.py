"""Sharded solves over a process mesh: the PyTorch port's counterpart of
``examples/03_multichip.py``.

Every rank of a ``torch.distributed`` job runs this same program.  On
GPUs, one process a GPU (NCCL):

    torchrun --nproc-per-node 4 examples/03_multichip_torch.py

on the CPU, ranks over Gloo (``SPMV_TPU_TORCH_DEVICE=cpu``):

    SPMV_TPU_TORCH_DEVICE=cpu torchrun --nproc-per-node 2 \\
        examples/03_multichip_torch.py

Without a job it runs in one process over P virtual shards of one
device, as the JAX example does over 8 virtual CPU devices.  P is 4, or
the job's rank count where that is larger; rank 0 prints the lines.
"""

import numpy as np
import torch.distributed as dist

from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix
from spmv_tpu_torch.ops import (
    conjugate_gradient,
    preconditioned_conjugate_gradient,
)
from spmv_tpu_torch.parallel import (
    block_jacobi_ic0,
    global_mesh,
    initialize_distributed,
    make_sharded_block_ic0_preconditioner,
    make_sharded_halo_matvec,
    shard_csr,
    shard_csr_halo,
    stack_vector,
    unstack_vector,
)

initialize_distributed()          # torchrun's environment; a no-op alone
P = max(4, dist.get_world_size() if dist.is_initialized() else 1)
mesh = global_mesh(P)
mm = poisson2d(32, 4 * P)
host = CsrMatrix.from_matrix_market(mm)

# ragged halo exchange: only the needed x strips move between ranks
A = shard_csr(host, P, partition="nnz", mesh=mesh)
Ah = shard_csr_halo(host, P, partition="nnz", mesh=mesh)
matvec = make_sharded_halo_matvec(Ah, mesh)

rng = np.random.default_rng(0)
x_true = rng.standard_normal(mm.num_rows)
bs = stack_vector(host.spmv(x_true), A, mesh=mesh)    # this rank's rows

res = conjugate_gradient(matvec, bs, tol=1e-6, max_iterations=500,
                         mesh=mesh)
err = np.linalg.norm(unstack_vector(res.x, A) - x_true) \
    / np.linalg.norm(x_true)
if mesh.rank == 0:
    print(f"sharded CG over {P} devices: iters {int(res.iterations)} "
          f"rel_err {err:.2e} (halo {Ah.comm_elements_padded} elems/step)",
          flush=True)

# block-Jacobi with LOCAL IC(0) solves: zero extra collectives
M = block_jacobi_ic0(host, Ah.bounds, Ah.rows_per_shard, mesh=mesh)
pre = make_sharded_block_ic0_preconditioner(M, mesh)
res_b = preconditioned_conjugate_gradient(matvec, bs, pre, tol=1e-6,
                                          max_iterations=500, mesh=mesh)
if mesh.rank == 0:
    print(f"block-Jacobi-IC(0) PCG: iters {int(res_b.iterations)}",
          flush=True)
if dist.is_initialized():
    dist.destroy_process_group()
