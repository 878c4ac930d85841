#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (each prints readable lines; any failure exits non-zero):

1. Device: nvidia-smi's name and power limit, torch's device name, CUDA
   and nvcc versions.  Without a CUDA device it exits 2 and prints no
   result.
2. Build: compiles the kernels from ``spmv_tpu_torch/csrc`` with nvcc
   (sm_90a) and loads them.
3. Kernel against plain version: K1 (with and without the fused dot)
   and K2 (k = 4) in float64, float32 and bfloat16 storage on
   poisson2d(512, 512), a banded matrix with offsets beyond +-128 and a
   4 x 5 rectangular matrix, then K1 / K2 in float32 and bfloat16 at
   the main path's shape, poisson2d(4096, 4096).
   Then the WELL-CW kernels K3a (fallback level), K3b (pool), K3c
   (merged grid) and the CSR kernel in float64 and float32 on
   banded_random(16384, 512, 6) (merged, 64- and 128-group tails),
   banded_random(4096, 128, 8) (fallback level, pool, tail), the 16384
   matrix with chunks_per_step=32 (forced fallback) and random_sparse(256,
   256, 12) packed with one shallow level (a real CSR remainder): each
   launched twice (bitwise equal), against its plain version, and the
   whole product against the fp64 host product in float32; K3a on both
   of its paths, the level's int16 indices and its int32 ones, bitwise
   equal to each other.  Then the
   WELL-CW SpMM kernels K4a (merged), K4b (level), K4c (pool) and the CSR
   SpMM on the same four matrices in float64 and float32 at k = 3 and
   k = 8: each launched twice (bitwise equal), against its plain version,
   and column by column against the SpMV kernel (K3a-c, CSR) on that
   column, saying whether the columns are bitwise equal to it.  Last, at
   the batched-CG leg's shape (phase 9), poisson2d(1024, 1024) in
   float32: K1 / K2 (k = 4) and the WELL-CW SpMM kernels at k = 4; and
   at the shapes of the CLI's --nrhs 3 runs (phases 4 and 6, whose B is
   built by the SpMM under test): K2 on poisson2d(1024, 1024) and the
   WELL-CW SpMM kernels on poisson2d(256, 256), float32, k = 3.
   Then the WELL kernels K5a (whole x) and K5b (segmented), each the
   whole product in one launch (the live slots of the chunks, then the
   spill), in float64 and float32 on the kinds of matrix of the JAX
   WELL tests: poisson2d(256, 256) whole x and with blocks_per_out 2, a
   random band with forced segment_rows=4 and two far column clusters
   with segment_rows=2 (escaping slots spill), segment_rows=8 with
   blocks_per_out 4, two empty output blocks, a rectangular
   random_sparse(200, 150, 5) and banded_random(65536, 512, 8) with a
   CSR spill: each launched twice (bitwise equal), against its plain
   version, well_spmv_core making that one launch and no CSR launch,
   and in float32 against the fp64 host product.  Then the WELL SpMM
   kernels K6a (whole x) and K6b (segmented), each the whole product in
   one launch (the live slots, then the spill), on the same eight
   matrices at k = 3 and 8, float64 and float32, and at the batched-CG
   shape (poisson2d(1024, 1024), float32, k = 4): twice (bitwise equal),
   against the plain version and column by column against K5 on that
   column, well_spmm_core making
   that one launch and no CSR launch.  Last, K7 (the BSR SpMM) on
   block matrices of block height 8, 32 and 128 with blocks_per_step 8,
   3 and 1, an empty block row, a 300 x 200 shape and ragged 1000 x 900
   matrices of block height 64 and 128, in float64, float32 and bf16
   blocks, at k = 1, 3, 8, 128 and 136: each on the path its shape
   selects (bf16 blocks of 64 or 128 rows with k a multiple of 8 on the
   tensor cores, the rest on the SIMT path; that path's counter must
   move), twice (bitwise equal), against its plain version and the fp64
   host product.  Then K8 (the
   fused V-cycle) against fused_vcycle_reference on the hierarchies of
   poisson2d(16, 128) with smooth_levels 1 and 0, poisson2d(16, 120)
   (identity padding), poisson2d(64, 16) (an offset the JAX kernel's lane
   layout refuses), poisson2d(32, 512) (three levels) and poisson2d(48,
   64) with aggregates of 3 rows and poisson2d(256, 256) (seven levels),
   in float64 (1e-12) and float32 (5e-6, relative 2-norm), each launched
   twice (bitwise equal); the block
   V-cycle (K1 per level) and the generic V-cycle (the CSR kernel) on
   the card against their CPU runs, float64.
4. DIA main path through the CLI, in process, on a Matrix Market file of
   poisson2d(1024, 1024): profile, SpMM profile, CG, Jacobi CG, batched
   CG (--nrhs 3: K2), triad.  The DIA launch counts are zeroed just
   before this phase.
5. DIA full-size profile: poisson2d(4096, 4096) through
   kernels.make_kernel -> time_kernel -> profiling_report in float32 and
   bfloat16 storage, the fp64 host checksum gate, and the plain
   versions timed at the same size.  The DIA launch counts are read
   after it.
6. WELL-CW path through the CLI (the WELL-CW launch counts, K3 and K4,
   are zeroed just before): --profile 3 and --profile 3 --spmm 4 on
   banded_random(65536, 512, 8) (merged grid and tails: K3c/K4a,
   K3b/K4c) and on banded_random(4096, 128, 8) (fallback: K3a/K4b,
   K3b/K4c), --cg 2000 (K3c) and --cg 2000 --nrhs 3 (K4a) on
   poisson2d(256, 256).
7. WELL-CW full-size SpMV profile, the JAX bench's leg on the port:
   banded_random(1048576, 2048, 8) in float32 (merged grid, a 128-group
   tail pool and a CSR remainder: K3c, K3b, CSR) through
   kernels.make_kernel -> time_kernel -> profiling_report: the fp64
   host checksum gate, seconds per SpMV against the plain version, and
   the fraction of the triad roofline with the bench's byte count, a
   torch.profiler table of 50 chained SpMVs (device time per kernel,
   busy share), and the torch.sparse CSR product (cuSPARSE) of the same
   matrix timed as the kernels are (a CUDA graph, the L2 flushed before
   each call) and eagerly.
8. WELL-CW full-size SpMM, the bench's k = 8 leg on the same matrix
   (K4a, K4c, CSR SpMM) through make_kernel(...).spmm_fn(8): the fp64
   host checksum gate, seconds per chained SpMM against the plain
   version, the fraction of the triad roofline with the CLI's byte
   count, the per-nnz cost against the SpMV of phase 7, and a
   torch.profiler table of 20 chained SpMMs.
9. Batched CG, the bench's solver leg: poisson2d(1024, 1024) in float32,
   k = 4, on DIA (K2) and on WELL-CW (K4a): us per iteration of batched
   against single-RHS CG (fixed iteration counts, the slope between two
   lengths; host clock, the median and range of 5 interleaved rounds,
   and the kernels' device time from torch.profiler), the throughput
   against k sequential solves (k t1 / tk), and a solve to tolerance of
   B = A ((j + 1) ones), B from the fp64 host product, whose columns
   must match (j + 1) * ones.  The WELL-CW launch counts are read after
   it.
10. WELL-CW kernels alone at full size (not counted): K3c, K3b and CSR,
   and K4a, K4c and the CSR SpMM at k = 8, on the same matrix; K3a and
   K4b on its fallback layout (chunks_per_step=64): bitwise repeat, max
   error against the plain version, device ms (50 launches in a CUDA
   graph, the L2 flushed before each) and ms a call through the
   wrapper, against plain ms, the bound from the bytes the kernel reads
   (K3a: the int16 index copy in place of the int32 one; K4a: the level
   chunks and the pool list in place of the pool chunks) beside the
   full container's, and the torch.sparse CSR product (cuSPARSE) of the
   part's own entries, timed the same way and eagerly; K3c's and K3b's
   plans (CTAs a cluster, lanes, ring stages, columns of x a K3c CTA
   stages), K3a's index width, K4a's grid, path and pool list size,
   K4c's row list (cells, bytes, the rows that own a cell, the X rows
   they read), K4c timed as a product's first launch (Y zeroed, then
   written; its bound from the row list, those X rows and every Y row
   written) and adding into Y as the main path calls it after the
   product's first part (bound: the list, those X rows and the listed
   Y rows read and written), on its rows of at most 8 cells and its
   longer rows alone; K4b's index width and X path; the CSR SpMM (one
   thread a listed row of the remainder) timed as a product's first
   launch (Y zeroed, then its listed rows written; bound from the list
   and its rows' pointers, the entries, the X rows they read and every
   Y row written) and adding into Y as the main path calls it (bound:
   the same with the listed Y rows read and written; the full
   container's bound, all of X and Y, beside);
   then K3a's, K4a's and K4b's other paths, each bitwise equal to the
   main path and timed the same way (K3a and K4b: int32 indices; K4a
   and K4b: scalar X loads).  Last the CSR SpMM on the whole matrix held
   as one DeviceCsr (the CSR format's own path, no row list) at k = 8:
   bitwise repeat, against its plain version, bitwise the CSR SpMV's
   columns, timed as a product's first launch beside its bound and the
   torch.sparse CSR product of the same entries.
11. WELL path through the CLI (the WELL launch counts, K5a and K5b, are
   zeroed just before): --profile 5 and --cg 2000 on poisson2d(256,
   256) (K5a); the CSR kernel must not be launched.
12. WELL profile: make_kernel("well").run_fn in float32 on
   poisson2d(1024, 1024) (whole x: K5a) and poisson2d(4096, 4096) (the
   DIA matrix of phase 5, segmented: K5b), each with its CSR spill: host
   packing time, the fp64 host checksum gate, seconds per chained SpMV
   (CUDA events) with one K5 launch a SpMV and no CSR launch, the plain
   version's time, the fraction of the triad roofline and K1's time on
   the same matrix.  The WELL launch counts are read after it.
13. K5a and K5b alone at those two sizes (not counted), as in phase 10,
   beside the torch.sparse CSR product (cuSPARSE) of the same entries,
   which are the whole matrix's, timed the same way and eagerly, and the
   bound from the live bytes beside the full container's; what the
   folded spill costs (K5 with its spill taken away) beside the CSR
   kernel over the row-compacted spill alone.
14. WELL SpMM path through the CLI (the K6a, K6b and CSR SpMM launch
   counts are zeroed just before): --profile 5 --spmm 8 and --cg 2000
   --nrhs 3 on poisson2d(256, 256) (K6a; the CSR SpMM must not be
   launched).
15. WELL SpMM profile: make_kernel("well").spmm_fn(8) in float32 on the
   host matrices of phase 12, poisson2d(1024, 1024) (K6a) and
   poisson2d(4096, 4096) (K6b): K6's path (column block, column blocks,
   16-byte X loads), the fp64 host checksum (the DIA
   host product of the same matrix), seconds per chained SpMM with one
   K6 launch a SpMM and no CSR launch, the plain version's time, the
   fraction of the triad roofline with the CLI's byte count (the slots
   K6 reads) and the per-nnz cost against phase 12's SpMV.
16. Batched CG on WELL as phase 9 does for DIA and WELL-CW:
   poisson2d(1024, 1024), float32, k = 4 (K6a; the single-RHS solves
   take K5a, one launch a SpMV and no CSR launch).  The WELL SpMM launch
   counts are read after it: no CSR SpMM launch on the path.
17. BSR path through the CLI (K7's counts are zeroed just before): -s
   bsr --profile 5 --spmm 16 and -s bsr --cg 500 on poisson2d(128, 128),
   and -s auto --profile 3 --spmm 128 on block_random(2048, 2048, 4),
   whose report must name bsr.
18. The JAX bench's BSR leg: block_random(131072, 131072, 8, seed=2)
   through auto_format(workload="spmm"), which must choose bsr, then
   make_kernel("bsr").spmm_fn(128) with float32 and bf16 blocks, whose
   container must store exactly the host's blocks (no zero padding): the
   fp64 host checksum gate (1e-4; 1e-2 for bf16), seconds per chained
   SpMM (the bf16 step casts X to bf16 each step), TFLOP/s, the bound
   and the plain version's ms; every bf16 launch must go to the tensor
   cores, every float32 one to the SIMT path.  Then the same in float32
   on block_random(262144, 262144, 2, seed=3), whose 134 MB X is past the
   80 MB line where the JAX bsr_spmm switches from K7b to K7a.  K7's
   launches are tallied under the Pallas kernel their X size selects and
   the path their shape selects, and read after it.
19. K6a, K6b and K7 at the phase 15 and 18 shapes alone (not counted),
   as in phase 10: K6 on its path (printed) beside the torch.sparse CSR
   SpMM of the whole matrix, timed
   the same way and eagerly, its bound from the live bytes beside the
   full container's; K7 beside one torch.sparse BSR product of the same
   blocks, timed the same way (both in a CUDA graph with the L2 flushed,
   or both eager where torch's product cannot be captured).
20. AMG path through the CLI (the K8, CSR and K1 launch counts are zeroed
   just before): --cg 200 --precondition amg on poisson2d(256, 256) with
   -s dia and -s wellcw (the generic V-cycle: the CSR kernel; the
   operator: K1, K3c): iterations, rms error against ones.
21. The full-size AMG leg, poisson2d(2048, 2048) in float32: the host
   setup (fused_block_setup: seven levels, 178.8 MB of DIA data), then PCG
   to 1e-6 with fused_vcycle_preconditioner (K8) and with
   block_amg_preconditioner (K1 and torch element-wise ops) on the same
   hierarchy: iterations (K8's within one of the block V-cycle's), rms
   error against ones, us per iteration (host clock), K8's launches
   equal to the applies.  The AMG launch counts are read after it.
22. K8 alone at that shape (not counted): bitwise repeat, error against
   the plain version, device ms (a CUDA graph, the L2 flushed before
   each launch), the grid barriers of one launch (read from the
   barrier's generation word), its time by level (the V-cycle from each
   level down, timed alike), against its bound and the plain version's
   ms, and the
   yardstick, the block V-cycle eager and under one CUDA graph (no single
   PyTorch call computes a V-cycle, so there is no library ms).

23. The reference tool's formats through the CLI (the ELL and CSR launch
   counts are zeroed just before): -s csr, xla-csr, coo, coo-atomic, ell
   and hybrid with --profile 5, --profile 5 --spmm 8 and --cg 2000 on
   poisson2d(256, 256) (plus --precondition jacobi and --nrhs 4 on ell
   and hybrid), hybrid's profile and SpMM again on powerlaw(65536,
   65536, 8.0), whose hybrid split has a COO part, and -s csr --reorder
   rcm: each run must launch its format's kernels (CSR for csr and coo,
   ELL for ell and hybrid, both for hybrid with a COO part) and no other
   kernel of the port (none for xla-csr, which is torch.sparse); CG to
   (j + 1) * ones within rms 1e-2; then each format's fp64 host checksum
   of A x and A X (k = 8) through make_kernel's chained steps.
24. ELL at full width, poisson2d(4096, 4096) in float32: the chained
   SpMV and SpMM (k = 8) through make_kernel("ell") (the ELL and CSR
   launch counts are read after it: each must have moved on the formats
   path), then the ELL kernels alone (not counted): against their plain
   versions (float64 at poisson2d(1024, 1024) 1e-12, float32 1e-5),
   twice bitwise, the SpMM's columns bitwise the SpMV kernel's, device ms
   (a CUDA graph, L2 flushed) and eager, the bound (the slots, x and y
   once), the plain version's ms and torch.sparse CSR of the same entries
   timed the same way and eagerly, and the SpMV's path (ell_spmv_plan:
   its template row length); and the CSR SpMV kernel on the whole matrix
   as one DeviceCsr (the path of -s csr) alike, against the fp64 product
   of its entries.  Phase 10 times the CSR
   SpMV on the whole bench matrix the same way.
25. Hybrid at a skewed matrix, powerlaw(4194304, 4194304, 8.0, alpha 1.5,
   seed 5) in float32 (not counted): the SpMV and SpMM (k = 8) against
   the fp64 product of the matrix; the COO part's CSR kernels (its long
   rows on warps and blocks) against that of its entries (the float32
   plain versions add with atomics on the card, in no fixed order, and
   at rows of 44,547 entries their sums moved the difference across
   1e-5), twice bitwise, the SpMM's columns
   bitwise the SpMV's; then the ELL launch, the COO launches (the CSR
   kernels adding into y and Y) and the whole SpMV and SpMM alone, each
   with its bound (the ELL and COO launches with their plain versions'
   ms, the ELL launch with its path), beside torch.sparse of the whole
   matrix and of each part's own entries, and whether the COO launch
   makes 0.35 ms and the whole products beat torch.sparse; the CSR SpMV
   on the whole matrix as one DeviceCsr; the sweep of the CSR kernels' row-split thresholds
   (LONG_ROW 16, 32, 64, 128 by BLOCK_ROW 256, 1024, 4096, and no split)
   on the COO part's SpMV and SpMM and the whole matrix's SpMV; and on
   the AMG path (the SA hierarchy of poisson2d(256, 256)) at each
   LONG_ROW: its operators' SpMVs in one CUDA graph and PCG's iterations.
26. The traffic split (the six variants' launch counts are zeroed just
   before): the CLI's --profile 5 --traffic-split at poisson2d(256, 256)
   on csr, coo, ell, hybrid and well (each report's traffic_split
   section), its refusals (dia, wellcw, bsr, --triad, --spmm 8: exit 1
   with the message), then measure_traffic_split at full width, float32:
   ELL and CSR at poisson2d(4096, 4096), WELL there (K5b) and at
   poisson2d(1024, 1024) (K5a), the hybrid of phase 25; the counts are
   read after it, each variant must have launched.  Then, not counted,
   each case's variants against their plain versions (1e-5), twice
   bitwise, each leg (full, regular, irregular) launching its own
   kernels and nothing else of the port, each leg alone (a CUDA graph,
   L2 flushed) and eagerly beside its bound (traffic_variant_bytes over
   the data sheet's rate and the triad), its plain version's ms and one
   PyTorch call for the same function (torch.sparse for the full leg,
   torch.sum of the ELL slots or torch.segment_reduce of the entries for
   the regular leg, torch.sparse with unit values for the irregular
   leg), and the additivity (regular + irregular) / full; last the
   variants in float64 at poisson2d(1024, 1024) (1e-12).
27. Simulation mode through the CLI (host only): --profile 0
   --trace-config configs/cpu-2thread.json with -s csr, ell, well and dia
   at poisson2d(256, 256) and -s csr at poisson2d(512, 512): the misses
   per thread and NUMA domain of each cache, the wall seconds, and the
   native replay core (csrc/simcache.cpp under _build/host/) it ran on;
   without --trace-config the CLI exits 1.
28. The other solvers (the tri_solve and K1 launch counts are zeroed
   just before): the CLI at poisson2d(256, 256), --cg-tol 1e-5, in
   float32 and in float64: --solver bicgstab --precondition ilu0,
   --solver gmres --restart 32 --precondition ic0, --solver chebyshev,
   --precondition ic0-sweeps and -s dia --reorder color --solver
   bicgstab --precondition ilu0, each converged (rms error against ones
   within 1e-2), tri_solve launched where ic0 / ilu0 ran, and its
   iterations against the port's own CPU run of the same command (two
   child processes, one a dtype, with SPMV_TPU_TORCH_DEVICE=cpu, beside
   the card's work): in float64 within 2; in float32 within 2,
   Chebyshev's within one check interval (20), BiCGSTAB's within a
   tenth; then -s dia --reorder color --solver bicgstab --precondition
   ilu0 --cg 20 at poisson2d(2048, 2048) and -s csr --solver cg
   --precondition ic0 --cg 50 at poisson2d(1024, 1024), natural order,
   float32, through the CLI's main (its Matrix Market reader handed the
   generated matrix): seconds (host ms an iteration at 1024), host
   set-up, K1 and tri_solve launches; the counts are read after them
   (the native ic0.cpp library must load first).  Then, not counted,
   the tri_solve kernel against its plain version (float64 and float32,
   twice bitwise, the mode tri_solve_plan picks and 6 sweeps, the CLI's
   count; the level and chained modes bitwise equal) on IC(0)'s L and
   L^T of poisson2d(1024, 1024) at natural order (2,047 levels each,
   chained) and on the full-width run's ILU(0) unit L and U (2 levels,
   the level mode); each triangle solve alone in both modes (float32, a
   CUDA graph, L2 flushed) beside its bound (the bytes it must move: no
   level_rows where the levels are contiguous row ranges, no diag_inv
   for a unit diagonal; with the z reads and the container's bytes
   beside; the levels times the least launch and times the chained
   mode's hand-off, both measured on a chain of one-row levels), its
   plain version's ms and cuSPARSE's SpSV on the same CSR triangle
   (profile/tri_study.cu, the analysis once; in a child process) and
   torch.triangular_solve on it as a sparse CSR tensor (in another child
   process, since on an H100 with torch 2.11 it ended its process with
   SIGFPE); last, the plan's line: layered triangles of 2^21 rows in
   levels of 16,384 to 262,144 rows and of 2^16 rows in 2 and 4 levels,
   each in both modes.
29. The eigensolver (the K2, CSR SpMM and CSR SpMV counts are zeroed
   just before): -s dia --eigs 8 --which smallest --precondition amg at
   poisson2d(1024, 1024) through the CLI's main (its reader handed the
   generated matrix), float32 at --eigs-tol 1e-4 and float64 at 1e-8,
   against the analytic eigenvalues (float64 at rtol 1e-6; float32
   within ||R||_F + 8 eps of each, R the residual block: Kahan's bound),
   K2 launched 2 + iterations a solve (plus the symmetry probe's 2 and
   the one-step warm-up's 3), the CSR SpMM a whole number of 11-launch
   V-cycle levels an apply, the CSR SpMV never (the block apply has no
   column loop); then --eigs 4 --precondition amg at poisson2d(128, 128)
   on dia, csr, ell, hybrid, well and wellcw in float32 (1e-4) and
   float64 (1e-8), each converged, within the analytic bound, its
   format's SpMM launched, and against the port's CPU run of the same
   command (a child process a dtype): float64 eigenvalues at rtol 1e-9,
   float32 within the two runs' bounds (iterations reported, not held:
   no column is locked, so converged columns' rounding noise moves the
   step that crosses the tolerance).  Then, not counted: host and device ms a step of the
   full-width solves (fixed-length solves under torch.profiler), the
   host set-up seconds, K2 at k = 8 alone (float32, a CUDA graph, L2
   flushed) beside its plain version, torch.sparse and its bound, and
   the Rayleigh-Ritz step with its (24, 24) algebra on the host (the
   port's) against all on the card (cuSOLVER's eigh), with one eigh
   alone at each place.
30. The sharded paths (``parallel``) on 4 virtual shards of the card
   (the K1, K2, CSR SpMV and CSR SpMM launches of the sharded calls
   make the path's counts; the unsharded products they are held against
   and the timing runs do not): at poisson2d(4096, 4096) in float32 the
   DIA halo SpMV (K1 a shard), the all-gather CSR SpMV (the CSR SpMV a
   shard) and the halo CSR SpMV (neighbor: an interior and a boundary
   launch a shard), at powerlaw(2^22, 2^22, 8.0, alpha 1.5, seed 5) the
   halo CSR SpMV forced to all2all; at poisson2d(512, 512) the same
   in float64, the halo CSR forced to all2all too, and the DIA SpMM (K2
   a shard) and halo CSR SpMM at k = 4 in float64 and float32.  Each
   product against the unsharded kernel of its format on the same x
   (max|dy| / max|y|: float32 1e-5, float64 1e-12; whether the bits
   agree), its launches held exactly (P a product, 2P for the halo
   path, every shard reading a halo), ms a product beside the
   unsharded kernel's (20 back to back, CUDA events, eager; the halo
   exchange alone; the DIA SpMM's two transposes and its K2 launches
   alone).  Then CG over each strategy and batched CG over the DIA
   matmat (k = 4) at poisson2d(512, 512), float64 to 1e-8 and float32
   to 1e-5, b = A ones from the fp64 host product: iterations within 2
   of the unsharded CG (the port's generic CG over the unsharded kernel;
   ``dia_batched_conjugate_gradient`` for the batched solve), the
   solution's error, host us an iteration, K2 launched 4 a matmat.
   Then ``python -m spmv_tpu_torch --scaling 4`` in a child process
   that loads no JAX (its reader handed the generated matrices):
   poisson2d(4096, 4096) with -s dia and the powerlaw matrix with -s csr,
   each ``halo_elements_measured`` held equal to the worst shard's
   off-shard reads, counted from each shard's run of entries; last
   ``dryrun_multichip(4)`` on the card (every error below 1e-3).
31. The sharded formats on the same 4 virtual shards (the K5a/b,
   K3a-c, K4a-c, CSR SpMV / SpMM, K7 and tri_solve launches of the
   sharded calls make the path's counts): at poisson2d(4096, 4096),
   window rows 4, float32, the WELL all-gather SpMV (one K5b launch a
   shard on the flat stacked x) and the WELL halo SpMV (K5b over a
   shard's own columns, the CSR SpMV over its halo), beside phase 12's
   unsharded K5b; at phase 7's banded_random(2^20, 2048, 8) the WELL-CW
   halo SpMV and SpMM (k = 8), the neighbor exchange and all2all forced
   (each shard's interior WELL-CW product and its boundary CSR launch),
   beside the unsharded WELL-CW SpMV / SpMM; at phase 18's
   block_random(131072, 131072, 8), k = 128, the BSR halo SpMM (one K7
   launch a shard on its extended X) in float32 (SIMT) and bf16 (tensor
   cores), beside the unsharded K7.  Each against the unsharded kernel
   and the fp64 product (torch.sparse, or a batched product a block, in
   float64 on the card; max|dy| / max|y| within 1e-5), its launches
   exactly the container's ``launches_a_product``, whether it is bitwise
   the unsharded kernel's, ms a product beside the unsharded kernel's
   and the exchange alone (20 back to back, CUDA events, eager), the
   exchange's elements (tiles) a step and the host build seconds.  Then
   Jacobi-PCG against block-Jacobi IC(0) PCG over the halo CSR matvec at
   poisson2d(1024, 1024), float64 to 1e-8 and float32 to 1e-5: the
   block-IC(0) one in fewer iterations, tri_solve launched exactly
   ``launches_an_apply`` an apply, host us an iteration; at
   poisson2d(256, 256) float32 Chebyshev on 300-step ``lanczos_bounds``
   (within 20 iterations of the unsharded CSR kernel's Chebyshev on the
   same bounds) and, in float64 to 1e-8, LOBPCG at k = 4 with the
   padding rows masked and the block-IC(0) apply a column as its
   preconditioner (the analytic eigenvalues within 1e-6 relative); last
   ``dryrun_multichip(4)``.
32. The process mesh (``parallel.distributed``, ``parallel.comm``; the
   K1, K2 and CSR SpMV launches of the process-mesh runs make the
   path's counts).  This process makes every product below on 4 virtual
   shards (the rows to equal) and then joins a one-rank NCCL job over a
   file store: the DIA halo SpMV at poisson2d(4096, 4096) float32 and
   the halo CSR SpMV at poisson2d(2048, 2048) bitwise the virtual
   shards' rows, CG over the DIA halo at poisson2d(1024, 1024) at their
   count (every dot all-reduced through NCCL).  Two child processes,
   started first, make a Gloo job (Gloo asked for by name, both on
   cuda:0, the tensors it moves staged through pinned host memory), 2
   shards a rank: the DIA halo SpMV and SpMM (k = 4) at poisson2d(4096,
   4096), the all-gather CSR and the halo CSR SpMV (neighbor and
   all2all forced) at poisson2d(2048, 2048), each rank's rows bitwise
   the virtual shards' rows of its shards (sha256), ms a product and the
   exchange alone (host clock, 10 back to back; host-staged Gloo on one
   card, not NVLink); CG float32 to 1e-5 over the DIA halo and the halo
   CSR at poisson2d(1024, 1024) within 2% of the virtual shards' count,
   batched CG float64 to 1e-8 over the DIA matmat (k = 4) at
   poisson2d(256, 256) at it.  A rank that fails or outlasts 420 s
   fails the run.
33. The second half across ranks (the K5, K3, K4, K7, CSR and
   tri_solve launches of the process-mesh runs make the path's counts).
   Phase 18's block_random goes to files every rank maps.  Four jobs
   start first, each rank a child process on the card: a one-rank NCCL
   job and a two-rank Gloo job (Gloo asked for by name) of the
   products, which build their host matrices and containers (each rank
   only its own shards') while this process, on the same inputs, makes
   every product and solver on 4 virtual shards; a second two-rank Gloo
   job of the solvers, which runs at once; and
   examples/03_multichip_torch.py as a one-rank NCCL job (it must print
   the JAX example's two lines).  The NCCL rank, and after it the Gloo
   products ranks (beside the solvers job), make, float32: the WELL
   all-gather and halo SpMV at poisson2d(2048, 2048), the WELL-CW halo
   SpMV and SpMM (k = 8) at phase 7's banded_random(2^20, 2048, 8), the
   BSR halo SpMM at phase 18's block_random, k = 128, in float32 and
   bf16, and the block-IC(0) apply at poisson2d(1024, 1024): each rank's
   rows bitwise the virtual shards' rows of its shards (sha256), its
   launches its containers' count, its envelope and exchange numbers the
   virtual containers', ms a product and the exchange alone (host clock,
   10 back to back; host-staged Gloo on one card, not NVLink); then
   block-IC(0) PCG float32 to 1e-5 at poisson2d(1024, 1024), within 2%
   of the virtual count.  The solvers job: Chebyshev on 300-step
   lanczos_bounds, GMRES(32) with the block-IC(0) apply as its
   preconditioner and BiCGSTAB, float64 to 1e-8 at poisson2d(256, 256)
   (Chebyshev and GMRES at the virtual counts, BiCGSTAB within 2%),
   masked LOBPCG float64 at k = 4 to 1e-6 with the block-IC(0) apply a
   column (the analytic eigenvalues within 1e-6), and
   dryrun_multichip(4) over its two ranks (the same dict on both).  A
   child that fails or outlasts 420 s fails the run.
34. The profiler capture, through the CLI's main in a child process
   whose first captures they are, started before phase 31 (its
   ``--matrix`` paths stand for host matrices: phase 3's
   poisson2d(4096, 4096) DIA and phase 7's WELL-CW, pickled for it, and
   poisson2d(1024, 1024) DIA, which it makes while phases 31-33 run;
   it takes its captures when phase 34 starts): ``-s dia --profile 10
   --jax-profile DIR --flush-caches`` at poisson2d(4096, 4096), and at poisson2d(1024, 1024) with and
   without the flush (the runs' median wall and the timed runs' own K1
   events printed), ``-s wellcw --profile 5 --jax-profile`` at phase
   7's banded_random: each report's profiling_events without error, the
   /device:GPU:0 plane's busy time between its longest event and the
   sum of its events, no launch record without its device record
   (``events_lost`` 0), K1's (and K3c's, K3b's and the CSR remainder's)
   events exactly the launches the window made (its wrappers' counts),
   the flush kernel once a timed run; K1's median event beside phase
   5's time; ``--list-profile-events`` from a probe and from a capture
   (a stream line whose events carry stats); K1's y bitwise equal with
   and without a capture, and the chained K1 with and without one.
   Then examples/01-02 on the card (and 02 on the CPU): 01's formats
   and rel_err, 02's CG and IC(0)-PCG counts within 2 of the CPU run's,
   its eigenvalues within 1e-5 of the analytic ones.  The examples start
   after the captures, so the captured times have the card and the host
   to themselves.

``python3 chip_smoke.py --wellcw-kernels-beside DIR`` runs phase 10
alone (with phases 1-2 and the matrix) for the checkout at DIR, say a
parent commit unpacked with ``git archive``, and for this one, each in
a process of its own, in the order DIR, this, this, DIR on one card, and
prints each kernel's device ms from the four runs and whether the main
path's outputs are bitwise equal across the checkouts;
``--well-spmm-kernels-beside DIR`` does the same for phase 19's K6a and
K6b (with the WELL matrices of phase 12), and ``--fused-vcycle-beside
DIR`` for phase 22's K8 (with PCG to 1e-6 with K8, host ms an iteration;
the first run's poisson2d(2048, 2048) hierarchy is pickled for the
others); phase 10's runs also time K4c adding into Y as the main path
calls it and as a product's first launch, the CSR SpMM adding the
remainder into Y and on the whole matrix as one DeviceCsr, and the
whole k = 8 SpMM chained in a CUDA graph.  ``--csr-kernels-beside DIR``
does the same for the CSR kernels: phase 25's COO launches and whole
hybrid products, the whole-matrix CSR SpMV legs of phases 10 and 24, the
WELL-CW remainder's SpMV and SpMM adding into y and Y, the CSR SpMM on
the whole bench matrix, and PCG with the generic V-cycle at
poisson2d(256, 256) (host ms an iteration and iterations); it compares
the outputs of the rows with no long row bit for bit.
``--ell-kernels-beside DIR`` does the same for the ELL SpMV: the ELL
SpMV and SpMM (k = 8) at poisson2d(4096, 4096) and the hybrid's ELL
launch, SpMV and SpMM at phase 25's matrix, each output compared bit for
bit.  ``--well-kernels-beside DIR`` does the same for K5a and K5b: the
WELL SpMV at phase 13's poisson2d(1024, 1024) and poisson2d(4096, 4096)
in float32 and float64, and at poisson2d(1000, 1000) in float64 (K5a,
whose float64 x still fits whole), each output compared bit for bit.
``--tri-kernels-beside DIR`` does the same for the triangular solve:
phase 28's natural-order IC(0) L and L^T of poisson2d(1024, 1024) and
the colored ILU(0) unit L and U of poisson2d(2048, 2048) (the first run
pickles the colored factors for the others), each solve alone in
float32 and float64, and the CLI's --solver gmres --restart 32
--precondition ic0 at poisson2d(256, 256) in float32 and float64 (host
ms an iteration, iterations), every z and residual compared bit for bit.

The second-to-last lines are the kernels' JSON summary (26 kernels, the
six traffic variants and tri_solve last, each with its launches on the
main path, max error, ms against
plain ms, bound and library ms; K7's rows also its launches by path;
the CSR SpMV's its whole-matrix times; the CSR kernels' and the ELL
SpMV's their times at the hybrid's shape, beside torch.sparse of that
part's own entries; the K1, K2, K3a-c, K4a-c, K5a/b, K7, CSR and
tri_solve rows their launches on the sharded paths (phases 30 and 31),
the K1, K2, K3a-c, K4a-c, K5a/b, K7, CSR and tri_solve rows theirs on
the distributed path (phases 32 and 33);
and summaries of each path,
`formats`, `amg`, `traffic_split`, `simulate`, `solvers`, `eigs`,
`sharded`, with phase 31's under ``formats``, `distributed`, with
phase 33's under ``formats``, and `profile_capture` the last, phase
34's)
and nvidia-smi's
``name, power.limit``; the last line is the run's result.  Imports no JAX and nothing of the JAX
package: the machine with the card need not have it.  Bounds take the
data sheet's 3.35 TB/s, 67 TFLOP/s float32 and 989 TFLOP/s bfloat16
(H100 SXM, 700 W).
"""

from __future__ import annotations

import atexit
import contextlib
import functools
import io
import json
import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np

# Relative max-norm bounds of each comparison (see _compare).
TOL_F64 = 1e-12          # float64 kernel vs plain version
TOL_F32_HOST = 1e-5      # float32 kernel vs the fp64 host product
TOL_F32 = 1e-5           # float32 kernel vs plain version (FMA vs two roundings)
TOL_BF16 = 1e-2          # bf16 storage vs plain version, both f32-accumulated
TOL_DOT = {"float64": 1e-10, "float32": 1e-4, "bfloat16": 1e-4}
CHECKSUM_RTOL = 1e-4     # bench.py's fp64 host checksum gate
CG_RMS_ERR = 1e-2        # CG solution against all-ones, float32

SMALL_GRID = 512
CLI_GRID = 1024
FULL_GRID = 4096
SPMM_K = 4
CLI_NRHS = 3                  # right-hand sides of the CLI's --nrhs runs
CW_FULL_ROWS = 1 << 20        # bench.py's WELL-CW leg on the TPU
CW_FULL_HALF_BW = 2048
CW_CLI_ROWS = 1 << 16
CW_CG_GRID = 256
PROFILE_CHAIN = 50            # chained SpMVs in the traced window
CW_SPMM_K = 8                 # bench.py's WELL-CW SpMM leg
SPMM_CHAIN = 20               # chained SpMMs in the traced window
COMPARE_KS = (3, 8)           # right-hand sides of the K4 comparisons
CG_GRID = 1024                # bench.py's solver leg (batched CG)
CG_K = 4
CG_ITERS = (25, 125)          # fixed-length solves for the slope
CG_ROUNDS = 5                 # rounds of those solves, for the spread
WELL_CLI_GRID = 256           # the WELL CLI phase's poisson2d
WELL_WHOLE_GRID = 1024        # K5a: x fits whole in float32
WELL_SEG_GRID = FULL_GRID     # K5b: x past 8 MiB, segmented mode
WELL_SPMM_K = 8               # the WELL SpMM legs' right-hand sides
BSR_K = 128                   # bench.py's BSR leg (bench.py:487-545)
BSR_ROWS = 1 << 17            # block_random(131072, 131072, 8): X 67 MB
BSR_FAR_ROWS = 1 << 18        # block_random(262144, 262144, 2): X 134 MB
BSR_WHOLEX_BYTES = 80 * 1024 * 1024  # the JAX bsr_spmm's K7a / K7b line
BSR_CLI_GRID = 128            # the BSR CLI phase's poisson2d
BSR_CLI_BLOCK_ROWS = 2048     # the -s auto run's block_random
TOL_BSR_BF16 = 1e-5           # K7, bf16 blocks, vs plain: same products, f32 sums
TOL_BF16_HOST = 3e-2          # bf16 blocks vs the fp64 host (tests/test_bsr.py)
BF16_CHECKSUM_RTOL = 1e-2     # bench.py's bf16 BSR checksum gate
HBM_BPS = 3.35e12             # H100 SXM data sheet, at 700 W
PEAK_F32_FLOPS = 67e12        # H100 SXM float32 outside the tensor cores
PEAK_BF16_FLOPS = 989e12      # H100 SXM bfloat16, dense tensor cores
# K8 (the fused V-cycle): (poisson2d grid, smooth_levels, block) of the
# phase 3 comparisons: aligned with 1 and 0 smoothed levels, identity
# padding, an offset past the JAX lane chunk, three levels, aggregates of
# three rows, and 65,536 rows (seven levels)
FUSED_CASES = (((16, 128), 1, 4), ((16, 128), 0, 4), ((16, 120), 1, 4),
               ((64, 16), 1, 4), ((32, 512), 1, 4), ((48, 64), 1, 3),
               ((256, 256), 1, 4))
TOL_K8_F32 = 5e-6             # tests/test_fused_vcycle.py:65, relative 2-norm
AMG_CLI_GRID = 256            # the AMG CLI phase's poisson2d
AMG_FULL_GRID = 2048          # the full-size AMG leg: 178.8 MB of DIA levels
AMG_TOL = 1e-6
AMG_MAX_ITERS = 100
AMG_GRAPH_REPS = 10
FORMATS = ("csr", "xla-csr", "coo", "coo-atomic", "ell", "hybrid")
FORMATS_CLI_GRID = 256        # the formats' CLI phase's poisson2d
FORMATS_SKEW_ROWS = 1 << 16   # hybrid's CLI matrix with a COO part
FORMATS_SPMM_K = 8
FORMATS_CG_ITERS = 2000      # plain CG at poisson2d(256²) needs about 400
FORMATS_NRHS = 4
ELL_F64_GRID = 1024           # the ELL kernels' float64 comparison
HYBRID_ROWS = 1 << 22         # hybrid at a skewed matrix: 35.6M entries
HYBRID_COO_LIMIT_MS = 0.35    # the COO launch's goal at that shape
# the CSR kernels' row-split thresholds swept in phase 25 (LONG_ROW,
# BLOCK_ROW), and a threshold no row passes (no split)
SWEEP_LONG_ROW = (16, 32, 64, 128)
SWEEP_BLOCK_ROW = (256, 1024, 4096)
NO_SPLIT = (1 << 31) - 1


def _fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def _say(msg: str) -> None:
    print(msg, flush=True)


def _walled(phase):
    """Print a phase function's wall seconds on a line of its own when it
    returns."""
    @functools.wraps(phase)
    def run(*args, **kw):
        t0 = time.perf_counter()
        out = phase(*args, **kw)
        _say(f"[wall] {phase.__name__}: {time.perf_counter() - t0:.1f} s")
        return out
    return run


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()


def _rel(got, want) -> float:
    got, want = got.double(), want.double()
    return float((got - want).abs().max() /
                 max(float(want.abs().max()), 1e-300))


def _time_launches(fn, reps: int) -> float:
    """Milliseconds per call of fn, by CUDA events around reps calls
    after one warm-up call: the eager time, host launch cost included."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def _graph_replay_ms(fn, reps: int) -> float:
    """Device milliseconds per call of fn: reps calls captured in one
    CUDA graph, replayed between CUDA events (no host launch cost; the
    fastest of three replays).  fn must not allocate."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="relaxed"):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    del graph
    return best


def _cold_graph_ms(fn, flush, reps: int) -> float:
    """Device milliseconds per call of fn with the L2 cache flushed
    before each call, as a chained caller finds it: graphs of (flush,
    fn) and of flush alone, the difference per call."""
    def both():
        flush()
        fn()

    return _graph_replay_ms(both, reps) - _graph_replay_ms(flush, reps)


def _cold_eager_ms(fn, flush, reps: int) -> float:
    """As ``_cold_graph_ms``, for a call that a CUDA graph cannot capture:
    eager (flush, fn) against eager flush, by CUDA events."""
    def both():
        flush()
        fn()

    return _time_launches(both, reps) - _time_launches(flush, reps)


def _nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


@contextlib.contextmanager
def _patched(obj, name, value):
    """Set ``obj.name`` to value for the block, then restore it."""
    keep = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, keep)


def _bound(nbytes: int, flops: int, triad_gbps: float,
           peak: float = PEAK_F32_FLOPS) -> dict:
    """The least time the card could take: the larger of the bytes the
    function must move (each input read once, each output written once)
    over the data sheet's memory rate and its operations over the peak
    rate for its inputs' type (float32 unless ``peak`` says otherwise:
    the bfloat16 BSR blocks take the bfloat16 peak); beside it, the
    bytes over the triad rate measured on this card."""
    t_bytes, t_ops = nbytes / HBM_BPS, flops / peak
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_triad_ms": nbytes / (triad_gbps * 1e9) * 1e3,
            "bytes": nbytes, "flops": flops}


def _torch_csr(row_ptr, column_index, value, shape):
    """A ``torch.sparse_csr_tensor`` with 32-bit indices: the card's own
    CSR product (cuSPARSE) as a yardstick, which the port never calls."""
    import torch

    return torch.sparse_csr_tensor(row_ptr.to(torch.int32),
                                   column_index.to(torch.int32), value,
                                   size=shape)


def _float64_product(R, v):
    """The fp64 product of the ``DeviceCsr`` R's entries with v (torch.sparse
    in float64): the reference of a float32 kernel on long rows, where the
    float32 plain version's sums move with their order (on the card it
    adds with atomics, in no fixed order)."""
    import torch

    S = _torch_csr(R.row_ptr, R.column_index, R.value.double(),
                   (R.num_rows, R.num_columns))
    return S @ v.to(torch.float64)


def _csr_of_coo(rows, cols, vals, shape):
    import torch

    S = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                size=shape).coalesce()
    S = S.to_sparse_csr()
    return _torch_csr(S.crow_indices(), S.col_indices(), S.values(), shape)


def _csr_of_mm(mm, device, dtype):
    """The Matrix Market matrix as a torch CSR on the card."""
    import torch

    def t(a):
        return torch.from_numpy(np.asarray(a, np.int64) - 1).to(device)

    return _csr_of_coo(t(mm.rows_1based), t(mm.cols_1based),
                       torch.from_numpy(np.asarray(mm.values)).to(
                           device, dtype), (mm.num_rows, mm.num_columns))


def _library_ms(S, v, reps: int = 20) -> float:
    """Milliseconds of ``S @ v`` (cuSPARSE through torch.sparse)."""
    return _time_launches(lambda: S @ v, reps)


def _yardstick(fn, flush, reps: int = 20) -> dict:
    """One PyTorch call timed as the kernels are: a CUDA graph with the L2
    flushed before each call (both eager, ``timing`` "eager", where it
    cannot be captured), and the eager call beside it."""
    import torch

    try:
        ms, timing = _cold_graph_ms(fn, flush, reps), "graph"
    except RuntimeError:
        torch.cuda.synchronize()
        ms, timing = _cold_eager_ms(fn, flush, reps), "eager"
    return {"library_ms": ms, "library_eager_ms": _time_launches(fn, reps),
            "library_timing": timing}


def _library_cold(S, v, flush, reps: int = 20) -> dict:
    """``S @ v`` (cuSPARSE through torch.sparse) as a yardstick."""
    return _yardstick(lambda: S @ v, flush, reps)


def _library_line(lib: dict) -> str:
    how = ("a CUDA graph, L2 flushed" if lib["library_timing"] == "graph"
           else "eager, L2 flushed")
    return (f"{lib['library_ms']:.4f} ms ({how}), "
            f"{lib['library_eager_ms']:.4f} ms eager")


@_walled
def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    smi_line = smi.stdout.strip().splitlines()[0].strip()
    _say(f"[1 device] nvidia-smi: {smi_line}")
    _say(f"[1 device] torch {torch.__version__}, CUDA "
         f"{torch.version.cuda}, device 0: "
         f"{torch.cuda.get_device_name(0)} "
         f"(capability {torch.cuda.get_device_capability(0)}), "
         f"count {torch.cuda.device_count()}")
    return torch.device("cuda", 0), smi_line


# ---------------------------------------------------------------- phase 2
@_walled
def phase_build():
    from spmv_tpu_torch.ops._build import (
        build_library,
        load_library,
        nvcc_version,
    )

    _say(f"[2 build] {nvcc_version()}")
    t0 = time.perf_counter()
    path, log = build_library()
    load_library()
    secs = time.perf_counter() - t0
    _say(f"[2 build] {os.path.relpath(path)} in {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            _say(f"[2 build]   {line.strip()}")


# ---------------------------------------------------------------- phase 3
def _banded_dia(n: int, offsets, seed: int):
    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import DiaMatrix

    rng = np.random.default_rng(seed)
    rows, cols = [], []
    for off in offsets:
        i = np.arange(max(0, -off), min(n, n - off))
        rows.append(i)
        cols.append(i + off)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    return DiaMatrix.from_matrix_market(from_coo_arrays(
        n, n, rows, cols, rng.standard_normal(rows.size)))


def _rect_dia():
    # the 4 x 5 matrix of tests/conftest.py TINY_MTX
    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import DiaMatrix

    rows = np.array([0, 0, 1, 2, 3, 3, 3])
    cols = np.array([0, 1, 1, 2, 0, 3, 4])
    vals = np.array([1.0, 2.0, 1.0, 3.0, -1.0, 2.0, 1.0])
    return DiaMatrix.from_matrix_market(
        from_coo_arrays(4, 5, rows, cols, vals))


def _compare(name, dia, dtype, device, k=SPMM_K):
    """K1 (plain and fused dot) and K2 (``k`` columns) against the plain
    versions on the same CUDA tensors; float32 also against the fp64 host
    product.
    Returns the max abs errors of K1 and K2 against the plain versions."""
    import torch

    from spmv_tpu_torch.models import DeviceDia
    from spmv_tpu_torch.ops import (
        dia_spmm_core,
        dia_spmm_reference,
        dia_spmv_core,
        dia_spmv_reference,
    )

    dtn = str(dtype).replace("torch.", "")
    A = DeviceDia.from_host(dia, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(0)
    wide = torch.float64 if dtype == torch.float64 else torch.float32
    x = torch.randn(A.num_columns, generator=g, device=device,
                    dtype=wide).to(dtype)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=wide).to(dtype)

    y = dia_spmv_core(A, x)
    Y = dia_spmm_core(A, X)
    _sync(device)
    y_plain = dia_spmv_reference(A, x)
    Y_plain = dia_spmm_reference(A, X)
    tol = {"float64": TOL_F64, "float32": TOL_F32,
           "bfloat16": TOL_BF16}[dtn]
    e1, e2 = _rel(y, y_plain), _rel(Y, Y_plain)
    line = f"[3 compare] {name} {dtn}: K1 {e1:.3e}, K2(k={k}) {e2:.3e}"
    if e1 > tol or e2 > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(dia.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", K1 vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    y2, dot = dia_spmv_core(A, x, with_dot=True)
    _sync(device)
    if _rel(y2, y) > tol:
        _fail(f"{name} {dtn}: with_dot changed y")
    r = min(A.num_rows, A.num_columns)
    if dtype == torch.bfloat16:
        _, want = dia_spmv_reference(A, x, with_dot=True)
    else:
        want = torch.dot(x[:r], y[:r])
    scale = float((x[:r].double() * y[:r].double()).abs().sum())
    ed = abs(float(dot) - float(want)) / scale
    line += f", fused dot {ed:.3e}"
    if ed > TOL_DOT[dtn]:
        _fail(f"{line} > {TOL_DOT[dtn]}")
    _say(line)
    return (float((y.double() - y_plain.double()).abs().max()),
            float((Y.double() - Y_plain.double()).abs().max()))


@_walled
def phase_compare(device, full):
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix

    cases = [
        (f"poisson2d({SMALL_GRID},{SMALL_GRID})",
         DiaMatrix.from_matrix_market(poisson2d(SMALL_GRID, SMALL_GRID))),
        ("banded(200000, offsets -300..300)",
         _banded_dia(200_000, (-300, -129, -128, -3, 0, 1, 127, 128, 300),
                     seed=1)),
        ("rectangular 4x5", _rect_dia()),
    ]
    for name, dia in cases:
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            _compare(name, dia, dtype, device)
    errs = {}
    for dtype in (torch.float32, torch.bfloat16):
        errs[dtype] = _compare(f"poisson2d({FULL_GRID},{FULL_GRID})", full,
                               dtype, device)
    _sync(device)
    return errs


def _cw_parts(A, spmm: bool = False):
    """(kernel name, kernel call, plain call, part) of each launch that
    ``wellcw_spmv_core`` (``wellcw_spmm_core`` with ``spmm``) makes for
    A; each call takes x or X (and an optional out buffer for the
    kernel), and ``part`` is the container the kernel reads."""
    from spmv_tpu_torch import ops

    n = A.num_rows
    sfx = "_spmm" if spmm else ""

    def part(kind, plain, p):
        core = getattr(ops, f"wellcw_{kind}{sfx}_core")
        return (f"wellcw_{kind}{sfx}",
                lambda x, out=None: core(p, x, n, out=out),
                lambda x: plain(p, x, n), p)

    parts = []
    if A.merged is not None:
        parts.append(part("merged", ops.cw_merged_reference, A.merged))
    parts += [part("level", ops.cw_level_reference, lv) for lv in A.levels]
    pools = ([A.pool] if A.pool is not None else []) + list(A.tail_pools)
    parts += [part("pool", ops.cw_pool_reference, p) for p in pools]
    if A.remainder is not None:
        R = A.remainder
        core = ops.csr_spmm_core if spmm else ops.csr_spmv_core
        parts.append(("csr_spmm" if spmm else "csr_spmv",
                      lambda x, out=None: core(R, x, out=out),
                      lambda x: ops.csr_spmv_reference(R, x), R))
    return parts


def _compare_cw(name, w, dev_kw, dtype, device):
    """Each WELL-CW / CSR kernel launch of the product, twice (bitwise
    equal) and against its plain version; the whole product against the
    plain composition and, in float32, the fp64 host product."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops import wellcw_spmv_core, wellcw_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWellCw.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(A.num_columns, generator=g, device=device, dtype=dtype)
    errs = []
    for kname, run, plain, part in _cw_parts(A):
        y1, y2 = run(x), run(x)
        _sync(device)
        if not torch.equal(y1, y2):
            _fail(f"{kname} on {name} {dtn}: two launches differ")
        e = _rel(y1, plain(x))
        errs.append(f"{kname} {e:.3e}")
        if e > tol:
            _fail(f"{kname} on {name} {dtn}: rel err {e} > {tol}")
        if kname == "wellcw_level" and part.local_index16 is not None:
            # K3a's other path: the int32 indices, the same sums
            with _patched(part, "local_index16", None):
                y3, y4 = run(x), run(x)
            _sync(device)
            if not (torch.equal(y3, y4) and torch.equal(y3, y1)):
                _fail(f"{kname} int32 path on {name} {dtn}: two launches "
                      "differ, or differ from the int16 path")
            errs[-1] += " (int16 index; int32 bitwise equal)"
    y = wellcw_spmv_core(A, x)
    _sync(device)
    e = _rel(y, wellcw_spmv_reference(A, x))
    line = (f"[3 compare] {name} {dtn}: " + ", ".join(errs)
            + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")


def _compare_cw_spmm(name, w, dev_kw, dtype, k, device, bitwise):
    """Each K4 / CSR SpMM kernel launch of the product, twice (bitwise
    equal), against its plain version and, column by column, against the
    SpMV kernel on that column; the whole product against the plain
    composition and, in float32, the fp64 host product.  ``bitwise``
    records per kernel whether every column equalled the SpMV kernel's
    bit for bit."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops import wellcw_spmm_core, wellcw_spmv_reference

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWellCw.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=dtype)
    errs = []
    for (kname, run, plain, _), (_, run1, _, _) in zip(
            _cw_parts(A, spmm=True), _cw_parts(A)):
        Y1, Y2 = run(X), run(X)
        cols = torch.stack([run1(X[:, j].contiguous()) for j in range(k)],
                           dim=1)
        _sync(device)
        if not torch.equal(Y1, Y2):
            _fail(f"{kname} on {name} {dtn} k={k}: two launches differ")
        e, ec = _rel(Y1, plain(X)), _rel(Y1, cols)
        same = torch.equal(Y1, cols)
        bitwise[kname] = bitwise.get(kname, True) and same
        errs.append(f"{kname} {e:.3e} (vs SpMV kernel {ec:.3e}"
                    f"{', bitwise' if same else ''})")
        if e > tol or ec > tol:
            _fail(f"{kname} on {name} {dtn} k={k}: rel err {e} / {ec} "
                  f"> {tol}")
    Y = wellcw_spmm_core(A, X)
    _sync(device)
    e = _rel(Y, wellcw_spmv_reference(A, X))
    line = (f"[3 compare] {name} {dtn} k={k}: " + ", ".join(errs)
            + f"; whole {e:.3e}")
    if e > tol:
        _fail(f"{line} > {tol}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmm(X.double().cpu().numpy()))
        eh = _rel(Y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (each kernel twice, bitwise equal)")


@_walled
def phase_compare_wellcw(device, cg_mats):
    """The WELL-CW SpMV kernels, then the SpMM kernels, on four matrices,
    then K2 and the K4 kernels at the batched-CG leg's shape (``cg_mats``,
    k = CG_K, float32) and at the CLI's --nrhs shapes (k = CLI_NRHS);
    returns per SpMM kernel whether its columns equalled the SpMV
    kernel's bit for bit in every case."""
    import torch

    from spmv_tpu_torch.io.generate import banded_random, poisson2d, random_sparse
    from spmv_tpu_torch.models import DiaMatrix, WellCwMatrix

    merged = WellCwMatrix.from_matrix_market(
        banded_random(16384, 512, 6, seed=20))
    cases = [
        ("banded_random(16384,512,6) merged", merged, {}),
        ("banded_random(4096,128,8) fallback", WellCwMatrix.from_matrix_market(
            banded_random(4096, 128, 8, seed=1)), {}),
        ("banded_random(16384,512,6) chunks_per_step=32", merged,
         {"chunks_per_step": 32}),
        ("random_sparse(256,256,12) remainder", WellCwMatrix.from_matrix_market(
            random_sparse(256, 256, 12, seed=7), levels=[(2, 1, 0.0)],
            pool_cap=0), {}),
    ]
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            _compare_cw(name, w, dev_kw, dtype, device)
    bitwise = {}
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            for k in COMPARE_KS:
                _compare_cw_spmm(name, w, dev_kw, dtype, k, device, bitwise)
    name = f"poisson2d({CG_GRID},{CG_GRID})"
    _compare(name, cg_mats["dia"], torch.float32, device)
    _compare_cw_spmm(name, cg_mats["wellcw"], {}, torch.float32, CG_K,
                     device, bitwise)
    # the CLI's --nrhs runs (phases 4 and 6) solve for a B built by the
    # SpMM under test, so their rms gate cannot see a wrong SpMM: hold it
    # here at their shapes
    name = f"poisson2d({CLI_GRID},{CLI_GRID})"
    _compare(name, DiaMatrix.from_matrix_market(
        poisson2d(CLI_GRID, CLI_GRID)), torch.float32, device, k=CLI_NRHS)
    name = f"poisson2d({CW_CG_GRID},{CW_CG_GRID})"
    _compare_cw_spmm(name, WellCwMatrix.from_matrix_market(
        poisson2d(CW_CG_GRID, CW_CG_GRID)), {}, torch.float32, CLI_NRHS,
        device, bitwise)
    _say("[3 compare] SpMM columns bitwise equal to the SpMV kernel's in "
         "every case: " + ", ".join(f"{n} {'yes' if b else 'no'}"
                                    for n, b in bitwise.items()))
    _sync(device)
    return bitwise


# ---------------------------------------------------------------- phase 4
def _run_cli(tag, runs):
    """Run the port's CLI in process; each run is (name, argv, wrappers
    that must launch).  Checks GPU timing, or CG convergence.  Returns
    the reports."""
    from spmv_tpu_torch.cli import main

    docs = []
    for name, argv, wrappers in runs:
        before = [w.launches for w in wrappers]
        buf = io.StringIO()
        t0 = time.perf_counter()
        rc = main(argv, out=buf)
        secs = time.perf_counter() - t0
        if rc != 0:
            _fail(f"CLI {' '.join(argv)} exited {rc}")
        doc = json.loads(buf.getvalue())
        for w, b in zip(wrappers, before):
            if w.launches <= b:
                _fail(f"CLI {name}: {w.__name__} was not launched")
        launched = "".join(f", {w.__name__} launches +{w.launches - b}"
                           for w, b in zip(wrappers, before))
        if "cg" in doc and "nrhs" in doc["cg"]:
            cg = doc["cg"]
            errs = cg["solution_rms_error_vs_ones"]
            _say(f"[{tag}] {name}: nrhs {cg['nrhs']}, iterations "
                 f"{cg['iterations']}, residuals "
                 f"{[f'{r:.3e}' for r in cg['residual_norms']]}, rms "
                 f"errors vs (j+1)*ones {[f'{e:.3e}' for e in errs]}, "
                 f"{cg['seconds']:.4f} s "
                 f"({cg['seconds'] / max(max(cg['iterations']), 1) * 1e6:.1f}"
                 f" us/iteration){launched}")
            if len(errs) != cg["nrhs"] or not all(
                    np.isfinite(e) and e <= CG_RMS_ERR for e in errs):
                _fail(f"CLI {name}: rms errors {errs} > {CG_RMS_ERR}")
        elif "cg" in doc:
            cg = doc["cg"]
            err = cg["solution_rms_error_vs_ones"]
            _say(f"[{tag}] {name}: {cg['iterations']} iterations, "
                 f"residual {cg['residual_norm']:.3e}, rms error vs ones "
                 f"{err:.3e}, {cg['seconds']:.4f} s "
                 f"({cg['seconds'] / max(cg['iterations'], 1) * 1e6:.1f}"
                 f" us/iteration){launched}")
            if not (np.isfinite(err) and err <= CG_RMS_ERR):
                _fail(f"CLI {name}: rms error {err} > {CG_RMS_ERR}")
        else:
            t = doc["device_seconds_per_iteration"]
            frac = doc["achieved"]["fraction_of_roofline"]
            _say(f"[{tag}] {name}: device_seconds_per_iteration {t:.6e}, "
                 f"fraction_of_roofline {frac:.4f} (roofline on "
                 f"{doc['roofline']['machine']}), "
                 f"{secs:.1f} s wall{launched}")
            if doc["device"]["platform"] != "gpu" or not t > 0:
                _fail(f"CLI {name}: not a GPU timing: {doc['device']}")
        docs.append(doc)
    return docs


@_walled
def phase_cli(device):
    import torch

    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmv_core

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"poisson2d_{CLI_GRID}.mtx")
        t0 = time.perf_counter()
        write_matrix_market(poisson2d(CLI_GRID, CLI_GRID), path)
        _say(f"[4 cli] wrote {path} ({os.path.getsize(path) >> 20} MiB) in "
             f"{time.perf_counter() - t0:.1f} s")
        mat = ["--matrix", path, "--spmv-format", "dia"]
        _run_cli("4 cli", [
            ("profile", mat + ["--profile", "10"], (dia_spmv_core,)),
            ("spmm", mat + ["--profile", "5", "--spmm", str(SPMM_K)],
             (dia_spmm_core,)),
            ("cg", mat + ["--cg", "2000", "--cg-tol", "1e-5"],
             (dia_spmv_core,)),
            ("cg_jacobi", mat + ["--cg", "2000", "--cg-tol", "1e-5",
                                 "--precondition", "jacobi"],
             (dia_spmv_core,)),
            ("cg_nrhs", mat + ["--cg", "2000", "--cg-tol", "1e-5",
                               "--nrhs", str(CLI_NRHS)], (dia_spmm_core,)),
            ("triad", ["--triad", "100000000", "--profile", "5"], ()),
        ])
    _sync(device)


# ---------------------------------------------------------------- phase 5
@_walled
def phase_profile(device, full, full_mm, smi_line):
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import dia_spmm_reference, dia_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    _say(f"[5 profile] machine: {machine.name}, triad {machine.hbm_gbps:.1f} "
         f"GB/s measured (data sheet {machine.datasheet_hbm_gbps} GB/s), "
         f"card {smi_line}")
    times, extra = {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        dtn = str(dtype).replace("torch.", "")
        kernel = make_kernel("dia", matrix=full, device=device, dtype=dtype)
        kernel.init()
        step, args = kernel.run_fn()
        A = args[1]
        if dtype == torch.float32:
            # bench.py's gate: |A x| summed in f32 on the card against
            # the fp64 host product, through the profiled step
            x = np.random.default_rng(0).standard_normal(
                full.num_columns).astype(np.float32)
            y = step(torch.from_numpy(x).to(device), A)
            got = float(y.abs().sum(dtype=torch.float32))
            want = float(np.abs(full.spmv(x.astype(np.float64))).sum())
            rel = abs(got - want) / want
            _say(f"[5 profile] checksum rel err {rel:.3e} (gate "
                 f"{CHECKSUM_RTOL})")
            if rel > CHECKSUM_RTOL:
                _fail(f"checksum gate: {rel} > {CHECKSUM_RTOL}")
        timing = time_kernel(step, args, k_small=8, k_large=136, runs=6)
        runs = profile_kernel_fn(step, args, runs=5)
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device)
        t_plain = time_kernel(lambda v, A: dia_spmv_reference(A, v),
                              (args[0], A), k_small=2, k_large=12,
                              runs=3).seconds_per_iteration
        t = doc["device_seconds_per_iteration"]
        frac = doc["achieved"]["fraction_of_roofline"]
        times[("spmv", dtn)] = (t, t_plain)
        _say(f"[5 profile] K1 {dtn}: kernel {t * 1e3:.4f} ms "
             f"({doc['achieved']['gb_per_s_modeled']:.1f} GB/s modeled, "
             f"fraction_of_roofline {frac:.4f}), plain {t_plain * 1e3:.4f}"
             f" ms, on {smi_line}")
        if not (np.isfinite(t) and t > 0):
            _fail(f"K1 {dtn}: bad timing {t}")

        step, args = kernel.spmm_fn(SPMM_K)
        t = time_kernel(step, args, k_small=4, k_large=40,
                        runs=6).seconds_per_iteration
        t_plain = time_kernel(lambda V, A: dia_spmm_reference(A, V),
                              args, k_small=2, k_large=8,
                              runs=3).seconds_per_iteration
        times[("spmm", dtn)] = (t, t_plain)
        _say(f"[5 profile] K2 {dtn} k={SPMM_K}: kernel {t * 1e3:.4f} ms, "
             f"plain {t_plain * 1e3:.4f} ms, on {smi_line}")
        if dtype == torch.float32:
            # the yardstick: the card's CSR product of the same matrix,
            # and each kernel's bound at this shape
            S = _csr_of_mm(full_mm, device, dtype)
            x, X = args[0][:, 0].contiguous(), args[0]
            nnz = full.num_entries
            for key, v, k in (("spmv", x, 1), ("spmm", X, SPMM_K)):
                lib = _library_ms(S, v)
                b = _bound(_nbytes(A.data, A.offsets_dev)
                           + (A.num_columns + A.num_rows) * k * 4,
                           2 * nnz * k, machine.hbm_gbps)
                extra[key] = {"library_ms": lib, **b}
                _say(f"[5 profile] {'K1' if k == 1 else f'K2 k={k}'} "
                     f"float32: torch.sparse CSR (cuSPARSE) {lib:.4f} ms; "
                     f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                     f"{b['bytes']} B at {HBM_BPS / 1e12} TB/s), "
                     f"{b['bound_triad_ms']:.4f} ms at the triad rate")
            del S, x, X
        del kernel, step, args, A
        _sync(device)
    return times, extra


# ---------------------------------------------------------------- phase 6
@_walled
def phase_cli_wellcw(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import banded_random, poisson2d
    from spmv_tpu_torch.ops import (
        wellcw_level_core,
        wellcw_level_spmm_core,
        wellcw_merged_core,
        wellcw_merged_spmm_core,
        wellcw_pool_core,
        wellcw_pool_spmm_core,
    )

    with tempfile.TemporaryDirectory() as tmp:
        mats = {
            "banded": (banded_random(CW_CLI_ROWS, 512, 8, seed=3),
                       f"banded_random({CW_CLI_ROWS},512,8)"),
            "fallback": (banded_random(4096, 128, 8, seed=1),
                         "banded_random(4096,128,8)"),
            "poisson": (poisson2d(CW_CG_GRID, CW_CG_GRID),
                        f"poisson2d({CW_CG_GRID},{CW_CG_GRID})"),
        }
        paths = {}
        for key, (mm, label) in mats.items():
            paths[key] = os.path.join(tmp, f"{key}.mtx")
            write_matrix_market(mm, paths[key])
            _say(f"[6 wellcw cli] wrote {label} ({mm.num_entries} entries)")

        def argv(key, *rest):
            return ["--matrix", paths[key], "--spmv-format", "wellcw", *rest]

        _run_cli("6 wellcw cli", [
            (f"profile {mats['banded'][1]}", argv("banded", "--profile", "3"),
             (wellcw_merged_core, wellcw_pool_core)),
            (f"profile {mats['fallback'][1]}",
             argv("fallback", "--profile", "3"),
             (wellcw_level_core, wellcw_pool_core)),
            (f"cg {mats['poisson'][1]}", argv("poisson", "--cg", "2000"),
             (wellcw_merged_core,)),
            (f"spmm k=4 {mats['banded'][1]}",
             argv("banded", "--profile", "3", "--spmm", "4"),
             (wellcw_merged_spmm_core, wellcw_pool_spmm_core)),
            (f"spmm k=4 {mats['fallback'][1]}",
             argv("fallback", "--profile", "3", "--spmm", "4"),
             (wellcw_level_spmm_core, wellcw_pool_spmm_core)),
            (f"cg nrhs={CLI_NRHS} {mats['poisson'][1]}",
             argv("poisson", "--cg", "2000", "--nrhs", str(CLI_NRHS)),
             (wellcw_merged_spmm_core,)),
        ])
    _sync(device)


# ---------------------------------------------------------------- phase 7
def _cw_stream_bytes(A) -> int:
    """bench.py's stored stream of a WELL-CW product (bench.py:413-428):
    the merged grid's or the levels' value + index, the pools' value +
    index + rowmap.  x and y are priced separately."""
    b = sum(lv.value.numel() * (lv.value.element_size() + 4)
            for lv in A.levels)
    if A.merged is not None:
        b += A.merged.value.numel() * (A.merged.value.element_size() + 4)
    for p in ([A.pool] if A.pool is not None else []) + list(A.tail_pools):
        b += p.value.numel() * (p.value.element_size() + 8)
    return b


@_walled
def phase_profile_wellcw(device, cw, cw_mm, smi_line):
    import torch

    from spmv_tpu_torch.perfmodel.tiling import roofline_time
    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import wellcw_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    kernel = make_kernel("wellcw", matrix=cw, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.run_fn()
    A = args[1]
    mg = A.merged
    _say(f"[7 wellcw profile] layout: "
         + (f"merged grid {mg.num_blocks} blocks x {mg.kl} chunks "
            f"(cap {mg.cap}, pool {mg.pool_per_block})" if mg is not None
            else f"fallback, {len(A.levels)} level(s)")
         + f", tail pools {[(p.out_rows, p.num_chunks) for p in A.tail_pools]}"
         + f", remainder {0 if A.remainder is None else A.remainder.num_entries}"
         + " entries")
    # bench.py's gate: |A x| summed in f32 on the card against the fp64
    # host product, through the profiled step
    x = np.random.default_rng(0).standard_normal(
        cw.num_columns).astype(np.float32)
    y = step(torch.from_numpy(x).to(device), A)
    got = float(y.abs().sum(dtype=torch.float32))
    want = float(np.abs(cw.spmv(x.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[7 wellcw profile] checksum rel err {rel:.3e} (gate "
         f"{CHECKSUM_RTOL})")
    if not rel <= CHECKSUM_RTOL:
        _fail(f"wellcw checksum gate: {rel} > {CHECKSUM_RTOL}")
    timing = time_kernel(step, args, k_small=8, k_large=136, runs=6)
    runs = profile_kernel_fn(step, args, runs=5)
    doc = profiling_report(kernel, runs, timing.seconds_per_iteration, 5,
                           True, machine=machine, device=device)
    t = doc["device_seconds_per_iteration"]
    if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
        _fail(f"wellcw: bad timing {t} on {doc['device']}")
    stream = _cw_stream_bytes(A)
    roof = roofline_time(stream, 2 * cw.num_entries, machine=machine,
                         dtype="float32",
                         resident_rw_bytes=2 * 4 * cw.num_rows)
    frac = roof["time_roofline_s"] / t
    t_plain = time_kernel(lambda v, A: wellcw_spmv_reference(A, v),
                          (args[0], A), k_small=1, k_large=4,
                          runs=3).seconds_per_iteration
    _say(f"[7 wellcw profile] SpMV {t * 1e3:.4f} ms "
         f"({cw.num_entries / t / 1e9:.2f} Gnnz/s), plain {t_plain * 1e3:.4f}"
         f" ms; bench stream {stream} B + x, y {2 * 4 * cw.num_rows} B, "
         f"roofline {roof['time_roofline_s'] * 1e3:.4f} ms at "
         f"{machine.hbm_gbps:.1f} GB/s triad: fraction {frac:.4f} "
         f"(report's own count {doc['achieved']['fraction_of_roofline']:.4f})"
         f", on {smi_line}")
    # where the time goes: the kernels' device time in a traced chain
    from spmv_tpu_torch.profile.cg_breakdown import traced

    def chain():
        v = args[0]
        for _ in range(PROFILE_CHAIN):
            v = step(v, A)

    chain()
    wall, dev, table = traced(chain, device)
    _say(f"[7 wellcw profile] torch.profiler, {PROFILE_CHAIN} chained "
         f"SpMVs: device {dev / PROFILE_CHAIN * 1e6:.2f} us per SpMV, wall "
         f"{wall / PROFILE_CHAIN * 1e6:.2f} us, busy share {dev / wall:.3f}")
    for line in table.splitlines():
        _say(f"[7 wellcw profile]   {line}")
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=device)
    lib = _library_cold(_csr_of_mm(cw_mm, device, torch.float32), args[0],
                        lambda: scratch.fill_(0.0))
    _say(f"[7 wellcw profile] torch.sparse CSR (cuSPARSE) of the same "
         f"matrix: {_library_line(lib)} per SpMV, against the chained "
         f"SpMV's {t * 1e3:.4f} ms, on {smi_line}")
    del kernel, step, args, A, y, scratch
    _sync(device)
    return {"ms": t * 1e3, "plain_ms": t_plain * 1e3, **lib,
            "roofline_fraction": frac, "checksum_rel_err": rel,
            "device_busy_share": dev / wall}


# ---------------------------------------------------------------- phase 8
@_walled
def phase_profile_wellcw_spmm(device, cw, cw_mm, smi_line, t_spmv):
    """The bench's WELL-CW SpMM leg (bench.py:433-468) at k = 8 through
    ``make_kernel("wellcw").spmm_fn``; ``t_spmv`` is phase 7's seconds
    per SpMV."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import wellcw_spmv_reference
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    k = CW_SPMM_K
    machine = measured_machine(device)
    kernel = make_kernel("wellcw", matrix=cw, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.spmm_fn(k)
    A = args[1]
    # bench.py's gate: |A X| summed in f32 on the card against the fp64
    # host product, through the profiled step
    X = np.random.default_rng(0).standard_normal(
        (cw.num_columns, k)).astype(np.float32)
    Y = step(torch.from_numpy(X).to(device), A)
    got = float(Y.abs().sum(dtype=torch.float32))
    want = float(np.abs(cw.spmm(X.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[8 wellcw spmm] k={k}: checksum rel err {rel:.3e} (gate "
         f"{CHECKSUM_RTOL})")
    if not rel <= CHECKSUM_RTOL:
        _fail(f"wellcw spmm checksum gate: {rel} > {CHECKSUM_RTOL}")
    timing = time_kernel(step, args, k_small=4, k_large=40, runs=6)
    runs = profile_kernel_fn(step, args, runs=5)
    # the CLI's --spmm count (spmv_tpu_torch/cli.py _profile): one matrix
    # stream, the x / y volume k times
    m = kernel.matrix
    flops = k * kernel.flops_per_run()
    nbytes = kernel.bytes_per_run() + (k - 1) * (
        m.num_columns + m.num_rows) * kernel.value_bytes
    doc = profiling_report(kernel, runs, timing.seconds_per_iteration, 5,
                           True, machine=machine, device=device,
                           op_info={"kind": "spmm", "k": k},
                           flops_per_run=flops, bytes_per_run=nbytes)
    t = doc["device_seconds_per_iteration"]
    if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
        _fail(f"wellcw spmm: bad timing {t} on {doc['device']}")
    frac = doc["achieved"]["fraction_of_roofline"]
    t_plain = time_kernel(lambda V, A: wellcw_spmv_reference(A, V),
                          (args[0], A), k_small=1, k_large=3,
                          runs=2).seconds_per_iteration
    per_nnz = (t / k) / t_spmv
    _say(f"[8 wellcw spmm] SpMM k={k} {t * 1e3:.4f} ms "
         f"({cw.num_entries * k / t / 1e9:.2f} effective Gnnz/s), plain "
         f"{t_plain * 1e3:.4f} ms; CLI byte count {nbytes} B, roofline "
         f"{nbytes / (machine.hbm_gbps * 1e9) * 1e3:.4f} ms at "
         f"{machine.hbm_gbps:.1f} GB/s triad: fraction {frac:.4f}; per nnz "
         f"against the SpMV {per_nnz:.4f} ((t / {k}) / {t_spmv * 1e3:.4f}"
         f" ms), on {smi_line}")
    from spmv_tpu_torch.profile.cg_breakdown import traced

    def chain():
        V = args[0]
        for _ in range(SPMM_CHAIN):
            V = step(V, A)

    chain()
    wall, dev, table = traced(chain, device)
    _say(f"[8 wellcw spmm] torch.profiler, {SPMM_CHAIN} chained SpMMs: "
         f"device {dev / SPMM_CHAIN * 1e6:.2f} us per SpMM, wall "
         f"{wall / SPMM_CHAIN * 1e6:.2f} us, busy share {dev / wall:.3f}")
    for line in table.splitlines():
        _say(f"[8 wellcw spmm]   {line}")
    lib = _library_ms(_csr_of_mm(cw_mm, device, torch.float32), args[0])
    _say(f"[8 wellcw spmm] torch.sparse CSR (cuSPARSE) of the same matrix "
         f"times X (k={k}): {lib:.4f} ms")
    del kernel, step, args, A, Y
    _sync(device)
    return {"k": k, "ms": t * 1e3, "plain_ms": t_plain * 1e3,
            "library_ms": lib,
            "roofline_fraction": frac, "checksum_rel_err": rel,
            "per_nnz_vs_spmv": per_nnz, "device_busy_share": dev / wall}


# ---------------------------------------------------------------- phase 9
def _spread(xs) -> dict:
    return {"median": float(np.median(xs)), "min": float(min(xs)),
            "max": float(max(xs))}


def _solve_slopes(solves, device) -> dict:
    """Host seconds per iteration of each ``solves[name](n)``: in each of
    CG_ROUNDS rounds every solve runs at both lengths of CG_ITERS, one
    after the other, so that the solves of a round see the same state of
    the machine; the round's slope is the difference of the two times
    over the difference of the lengths (host clock around work that ends
    in a synchronise).  Returns name -> one slope per round."""
    import torch

    def timed(solve, n):
        t0 = time.perf_counter()
        solve(n)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return time.perf_counter() - t0

    for solve in solves.values():
        for n in CG_ITERS:
            timed(solve, n)
    span = CG_ITERS[1] - CG_ITERS[0]
    slopes = {name: [] for name in solves}
    for _ in range(CG_ROUNDS):
        for name, solve in solves.items():
            short = timed(solve, CG_ITERS[0])
            slopes[name].append((timed(solve, CG_ITERS[1]) - short) / span)
    return slopes


def _device_slope(solve, device) -> float:
    """Device seconds per iteration of ``solve(n)``: the summed device
    time of the kernels torch.profiler traced in the solve of CG_ITERS[1]
    iterations, less that of CG_ITERS[0], over the difference."""
    from spmv_tpu_torch.profile.cg_breakdown import traced

    dev = [traced(lambda: solve(n), device)[1] for n in CG_ITERS]
    return (dev[1] - dev[0]) / (CG_ITERS[1] - CG_ITERS[0])


@_walled
def phase_batched_cg(device, mats, smi_line, tag="9 batched cg"):
    """bench.py's solver leg (bench.py:694-712) on the port: batched CG
    (k = CG_K) against single-RHS CG at poisson2d(CG_GRID²), float32, on
    each format of ``mats``: DIA (K1 / K2), WELL-CW (K3 / K4) or WELL
    (K5 / K6 and the spill), all at tol 0 for fixed iteration counts;
    then a solve to tol 1e-5 of B = A ((j + 1) ones), B from the fp64
    host product."""
    import torch

    from spmv_tpu_torch.models import DeviceDia, DeviceWell, DeviceWellCw
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        conjugate_gradient,
        dia_batched_conjugate_gradient,
        dia_conjugate_gradient,
        spmm,
        spmv,
    )

    f32 = torch.float32
    n = next(iter(mats.values())).num_rows
    g = torch.Generator(device=device).manual_seed(3)
    b = torch.randn(n, generator=g, device=device, dtype=f32)
    B = torch.randn(n, CG_K, generator=g, device=device, dtype=f32)
    out = {}
    for fmt, host in mats.items():
        if fmt == "dia":
            A = DeviceDia.from_host(host, dtype=f32, device=device)

            def single(it, rhs=b):
                return dia_conjugate_gradient(A, rhs, tol=0.0,
                                              max_iterations=it)

            def batched(it, rhs=B, tol=0.0):
                return dia_batched_conjugate_gradient(
                    A, rhs, tol=tol, max_iterations=it)
        else:
            cls = DeviceWellCw if fmt == "wellcw" else DeviceWell
            A = cls.from_host(host, dtype=f32, device=device)

            def single(it, rhs=b):
                return conjugate_gradient(lambda v: spmv(A, v), rhs,
                                          tol=0.0, max_iterations=it)

            def batched(it, rhs=B, tol=0.0):
                return batched_conjugate_gradient(
                    lambda V: spmm(A, V), rhs, tol=tol, max_iterations=it)
        slopes = _solve_slopes({"single": single, "batched": batched},
                               device)
        thr = [CG_K * t1 / tk
               for t1, tk in zip(slopes["single"], slopes["batched"])]
        d1, dk = _device_slope(single, device), _device_slope(batched, device)
        t1, tk, th = (_spread(slopes["single"]), _spread(slopes["batched"]),
                      _spread(thr))
        # B from the fp64 host product, so that a wrong SpMM fails the
        # rms gate instead of solving its own operator
        # A ((j + 1) ones) = (j + 1) A ones: one host product
        rhs = torch.from_numpy(host.spmv(np.ones(n))[:, None]
                               * np.arange(1, CG_K + 1))
        res = batched(3000, rhs=rhs.to(device, f32).contiguous(), tol=1e-5)
        X = res.x.double().cpu().numpy()
        errs = [float(np.linalg.norm(X[:, j] - (j + 1)) / np.sqrt(n)
                      / (j + 1)) for j in range(CG_K)]
        its = [int(i) for i in res.iterations.cpu()]

        def us(st):
            return (f"{st['median'] * 1e6:.1f} [{st['min'] * 1e6:.1f}, "
                    f"{st['max'] * 1e6:.1f}]")

        _say(f"[{tag}] {fmt} poisson2d({CG_GRID}^2) float32, host "
             f"clock, median [min, max] of {CG_ROUNDS} rounds: single "
             f"{us(t1)} us/iteration, batched k={CG_K} {us(tk)} "
             f"us/iteration, throughput vs sequential {th['median']:.3f} "
             f"[{th['min']:.3f}, {th['max']:.3f}]; device (torch.profiler "
             f"kernel time): single {d1 * 1e6:.2f} us/iteration, batched "
             f"{dk * 1e6:.2f} us/iteration, throughput vs sequential "
             f"{CG_K * d1 / dk:.3f}; tol 1e-5 solve: iterations {its}, rms "
             f"errors vs (j+1)*ones {[f'{e:.3e}' for e in errs]}, on "
             f"{smi_line}")
        if not all(np.isfinite(e) and e <= CG_RMS_ERR for e in errs):
            _fail(f"batched cg {fmt}: rms errors {errs} > {CG_RMS_ERR}")
        if not (t1["median"] > 0 and tk["median"] > 0 and d1 > 0 and dk > 0):
            _fail(f"batched cg {fmt}: bad timing {t1}, {tk}, {d1}, {dk}")
        out[fmt] = {"single_us_per_iteration":
                    {key: v * 1e6 for key, v in t1.items()},
                    "batched_us_per_iteration":
                    {key: v * 1e6 for key, v in tk.items()},
                    "throughput_vs_sequential": th,
                    "rounds": CG_ROUNDS,
                    "device_single_us_per_iteration": d1 * 1e6,
                    "device_batched_us_per_iteration": dk * 1e6,
                    "device_throughput_vs_sequential": CG_K * d1 / dk,
                    "iterations": its, "rms_errors": errs}
        del A
        _sync(device)
    return out


# --------------------------------------------------------------- phase 10
def _cw_coo(kind, p, num_rows, num_columns):
    """(rows, cols, values) on the card of the cells of one WELL-CW part
    (``kind`` merged, level or pool) that hold a nonzero, a row below
    num_rows and a column below num_columns, decoded as the plain
    versions read them (``ops/spmv.py``: ``_cw_products`` and
    ``cw_{level,pool,merged}_reference``)."""
    import torch

    loc = p.local_index.long()
    w = loc >> 7
    if kind == "merged":
        w = w & (8 * p.d - 1)
    col = (p.anchor4.reshape(-1, 1, 1).long() * p.d + w) * 128 + (loc & 127)
    dev = col.device
    lanes = torch.arange(128, device=dev)
    if kind == "level":
        row = p.group_of_chunk.reshape(-1, 1, 1).long() * 128 + lanes
    elif kind == "pool":
        row = p.rowmap.long() * 128 + lanes
    else:
        S, kl, lvl = p.num_blocks, p.kl, p.lvl_per_block
        b = torch.arange(S, device=dev).reshape(S, 1, 1, 1)
        kk = torch.arange(kl, device=dev).reshape(1, kl, 1, 1)
        level_row = ((b * lvl + kk) // p.cap) * 128 + lanes
        pool_row = (b * 64 + (loc.reshape(S, kl, 8, 128) >> 14)) * 128 \
            + lanes
        row = torch.where(kk < lvl, level_row, pool_row).reshape(col.shape)
    row = row.expand_as(col)
    keep = (p.value != 0) & (row < num_rows) & (col < num_columns)
    return row[keep], col[keep], p.value[keep]


# buffers that K3a, K4a-c and the CSR SpMM read in place of the JAX
# container's arrays
DERIVED_BUFFERS = ("local_index16", "level_index16", "pool_ptr",
                   "pool_col", "pool_value", "list_rows", "list_len",
                   "list_slice", "list_col", "list_value", "row_list")


def _part_bytes(kname, part) -> tuple:
    """(read, full) bytes of a WELL-CW part: what kernel ``kname`` reads
    on its path, and the container as earlier runs counted it, every
    buffer but the ones K3a, K4a-c and the CSR SpMM derive."""
    full = _nbytes(*(b for name, b in part.named_buffers(recurse=False)
                     if name not in DERIVED_BUFFERS))
    if kname in ("wellcw_level", "wellcw_level_spmm"):
        index = part.local_index16
        if index is None:
            index = part.local_index
        return _nbytes(part.value, index, part.anchor4,
                       part.group_ptr), full
    if kname == "wellcw_merged":
        return _nbytes(part.value, part.local_index, part.anchor4,
                       part.x_window), full
    if kname == "wellcw_merged_spmm":
        cells = part.level_index16.numel()
        read = (cells * part.value.element_size() + cells // 1024 * 4
                + _nbytes(part.level_index16, part.pool_ptr, part.pool_col,
                          part.pool_value))
        return read, full
    if kname == "wellcw_pool_spmm":
        return _nbytes(part.list_rows, part.list_len, part.list_slice,
                       part.list_col, part.list_value), full
    return full, full


def _csr_spmm_bytes(R, k: int) -> dict:
    """What the CSR SpMM must move for R and X of k columns: its row
    list and the listed rows' two pointers (the whole row_ptr without a
    list), the entries, once each X row they read, and the Y rows: every
    row written by a product's first launch (``first``), the listed rows
    read and written adding into Y (``accumulate``)."""
    listed = R.num_rows if R.row_list is None else R.row_list.numel()
    col = R.column_index
    xrows = col[(col >= 0) & (col < R.num_columns)].unique().numel()
    ptr = (_nbytes(R.row_ptr) if R.row_list is None
           else _nbytes(R.row_list) + 8 * listed)
    if R.row_list is not None and R.long_rows is not None:
        # the long rows, listed apart, and their pointers
        listed += R.long_rows.numel()
        ptr += _nbytes(R.long_rows) + 8 * R.long_rows.numel()
    row = k * R.value.element_size()
    head = ptr + _nbytes(R.column_index, R.value) + xrows * row
    return {"first": head + R.num_rows * row,
            "accumulate": head + 2 * listed * row,
            "listed_rows": listed, "x_rows_read": xrows}


def _pool_spmm_rows(part, num_rows, num_columns) -> tuple:
    """(listed rows, X rows) of K4c's row list: the Y rows below
    ``num_rows`` that own a cell, and the X rows its cells read."""
    rows = int((part.list_rows < num_rows).sum())
    col = part.list_col
    return rows, col[(col >= 0) & (col < num_columns)].unique().numel()


LIST_NAMES = ("list_rows", "list_len", "list_slice", "list_col",
              "list_value")


def _pool_spmm_parts(part, X, num_rows, out, flush) -> dict:
    """K4c adding into Y as the main path calls it, on the pool's rows of
    at most 8 cells alone and on its longer rows alone (each a row list
    of those rows of the container's own, laid out as the container lays
    out its list): {part: (rows, cells, ms)}."""
    import torch

    from spmv_tpu_torch.models.device import sliced_row_list
    from spmv_tpu_torch.ops import wellcw_pool_spmm_core

    rows, lens, start, col, val = (getattr(part, a).cpu().numpy()
                                   for a in LIST_NAMES)
    # each row's run in order, the rows in the list's order
    t = np.repeat(np.arange(lens.size), lens)
    i = np.arange(t.size) - np.repeat(np.cumsum(lens) - lens, lens)
    where = start[t // 32] + 32 * i + t % 32
    col, val = col[where], val[where]
    found = {}
    for what, keep in (("rows of at most 8 cells", lens <= 8),
                       ("longer rows", lens > 8)):
        cells = np.repeat(keep, lens)
        sub_ptr = np.concatenate([[0], np.cumsum(lens[keep])])
        lists = [torch.from_numpy(a).to(X.device) for a in sliced_row_list(
            rows[keep], sub_ptr, col[cells], val[cells])]
        with contextlib.ExitStack() as stack:
            for name, a in zip(LIST_NAMES, lists):
                stack.enter_context(_patched(part, name, a))
            ms = _cold_graph_ms(lambda: wellcw_pool_spmm_core(
                part, X, num_rows, out=out, accumulate=True), flush, 50)
        found[what] = (int(keep.sum()), int(lens[keep].sum()), ms)
    return found


def _merged_spmm_shape(part, plan, k) -> str:
    """K4a's grid and pool list, as a phase 10 line says them."""
    threads = part.num_blocks * 64 * 128
    blocks = -(-k // plan["kb"])
    pool = ("no pool list" if part.pool_ptr is None else
            f"pool list of {part.pool_col.numel()} cells "
            f"({_nbytes(part.pool_col, part.pool_value)} B) and "
            f"{part.pool_ptr.numel()} pointers "
            f"({_nbytes(part.pool_ptr)} B)")
    return (f"grid of {threads // 256} CTAs x {blocks} column blocks, one "
            f"thread a row ({threads} rows), {plan['kb']} columns a block, "
            f"int16 level indices, "
            f"{'16-byte' if plan['vector_x'] else 'scalar'} X loads, "
            f"{pool}")


def _variants(kname, part, v, out, run, y_main, flush):
    """The other paths of K3a and K4b (the int32 indices) and of K4a and
    K4b (scalar X loads, X and Y one element off a 16-byte boundary) at
    full size: launched on the same input, bitwise equal to the main
    path's output, and timed as it is.  Returns {label: ms}."""
    import torch

    def shifted(t):
        return torch.empty(t.numel() + 1, dtype=t.dtype,
                           device=t.device)[1:].view(t.shape)

    cases = []
    if kname in ("wellcw_level", "wellcw_level_spmm") and \
            part.local_index16 is not None:
        cases.append(("int32 index",
                      lambda: _patched(part, "local_index16", None), v, out))
    if kname in ("wellcw_merged_spmm", "wellcw_level_spmm"):
        cases.append(("scalar X loads", contextlib.nullcontext,
                      shifted(v).copy_(v), shifted(out)))
    found = {}
    for label, ctx, vv, oo in cases:
        with ctx():
            y = run(vv)
            _sync(v.device)
            if not torch.equal(y, y_main):
                _fail(f"{kname} ({label}) at full size differs from the "
                      "main path")
            found[label] = _cold_graph_ms(lambda: run(vv, out=oo), flush, 50)
    return found


@_walled
def phase_kernels_wellcw(device, cw, smi_line, triad_gbps):
    """Each WELL-CW / CSR kernel alone at the full-size matrix: K3c, K3b
    and CSR, and K4a, K4c and the CSR SpMM at k = CW_SPMM_K, on its
    merged layout; K3a and K4b on its fallback layout.  Beside each, the
    torch.sparse CSR product (cuSPARSE) of that part's own entries,
    timed as the kernels are (a CUDA graph, the L2 flushed) and eagerly,
    and its bound from the bytes it reads beside the container's; K4c
    and the CSR SpMM also adding into Y, as the main path calls them;
    K3a's, K4a's and K4b's other paths timed the same way."""
    import torch

    from spmv_tpu_torch.models import DeviceWellCw
    from spmv_tpu_torch.ops import csr_spmm_core
    from spmv_tpu_torch.ops import wellcw_kernels as wk
    from spmv_tpu_torch.ops.wellcw_kernels import column_block, launch_plan

    f32 = torch.float32
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    g = torch.Generator(device=device).manual_seed(1)
    x = torch.randn(cw.num_columns, device=device, dtype=f32, generator=g)
    X = torch.randn(cw.num_columns, CW_SPMM_K, device=device, dtype=f32,
                    generator=g)
    # 64 MiB written between launches evicts the 50 MB L2
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    found = {}
    for dev_kw in ({}, {"chunks_per_step": 64}):
        A = DeviceWellCw.from_host(cw, dtype=f32, device=device, **dev_kw)
        for spmm in (False, True):
            v = X if spmm else x
            for kname, run, plain, part in _cw_parts(A, spmm=spmm):
                if kname in found or (dev_kw and "level" not in kname):
                    continue
                out = torch.empty((A.num_rows,) + tuple(v.shape[1:]),
                                  dtype=f32, device=device)
                y1, y2 = run(v), run(v)
                _sync(device)
                if not torch.equal(y1, y2):
                    _fail(f"{kname} at full size: two launches differ")
                want = plain(v)
                err = float((y1.double() - want.double()).abs().max())
                rel = _rel(y1, want)
                if rel > TOL_F32:
                    _fail(f"{kname} at full size: rel err {rel} > "
                          f"{TOL_F32}")
                ms = _cold_graph_ms(lambda: run(v, out=out), flush, 50)
                eager_ms = _time_launches(lambda: run(v, out=out), 50)
                if kname in ("wellcw_pool_spmm", "csr_spmm"):
                    # K4c and the CSR SpMM as the main path calls them
                    # after a product's first part: adding into Y
                    acc_ms = _cold_graph_ms(
                        (lambda: wk.wellcw_pool_spmm_core(
                            part, v, A.num_rows, out=out, accumulate=True))
                        if kname == "wellcw_pool_spmm" else
                        (lambda: csr_spmm_core(part, v, out=out,
                                               accumulate=True)),
                        flush, 50)
                plain_ms = _time_launches(lambda: plain(v), 3)
                k = CW_SPMM_K if spmm else 1
                shape = (A.num_rows, A.num_columns)
                # one torch.sparse call computes the same product
                if kname.startswith("csr"):
                    S = _torch_csr(part.row_ptr, part.column_index,
                                   part.value, shape)
                    nnz, rows = part.num_entries, A.num_rows
                else:
                    S = _csr_of_coo(*_cw_coo(kname.split("_")[1], part,
                                             *shape), shape)
                    nnz = int((part.value != 0).sum())
                    rows = A.num_rows if not hasattr(part, "rowmap") else \
                        min(A.num_rows, 128 * int(part.rowmap.unique().numel()))
                lib_rel = _rel(S @ v, want)
                if lib_rel > TOL_F32:
                    _fail(f"{kname}: torch.sparse of its entries differs "
                          f"from the plain version by {lib_rel}")
                lib = _library_cold(S, v, flush)
                del S, want
                read, full = _part_bytes(kname, part)
                vec = (A.num_columns + rows) * k * 4
                b_full = _bound(full + vec, 2 * nnz * k, triad_gbps)
                if kname == "wellcw_pool_spmm":
                    # the X rows its cells read once; a product's first
                    # launch writes every Y row, adding into Y reads and
                    # writes the listed rows
                    listed, xrows = _pool_spmm_rows(part, A.num_rows,
                                                    A.num_columns)
                    vec = (xrows + A.num_rows) * k * 4
                    b_acc = _bound(read + (xrows + 2 * listed) * k * 4,
                                   2 * nnz * k, triad_gbps)
                b = _bound(read + vec, 2 * nnz * k, triad_gbps)
                if kname == "csr_spmm":
                    # what it needs (_csr_spmm_bytes), as a first launch
                    # and adding into Y
                    cb = _csr_spmm_bytes(part, k)
                    b = _bound(cb["first"], 2 * nnz * k, triad_gbps)
                    b_acc = _bound(cb["accumulate"], 2 * nnz * k,
                                   triad_gbps)
                found[kname] = {"max_abs_err": err, "ms": ms,
                                "plain_ms": plain_ms, "eager_ms": eager_ms,
                                **lib, **b,
                                "bound_full_ms": b_full["bound_ms"],
                                "bound_full_triad_ms":
                                    b_full["bound_triad_ms"],
                                "bytes_full": b_full["bytes"]}
                what = ""
                if kname in ("wellcw_merged", "wellcw_pool"):
                    plan = launch_plan(part, 4, sms)
                    found[kname].update(plan)
                    what = (f" ({plan['cluster']} CTAs a cluster, "
                            f"{plan['lanes']} lanes, {plan['stages']} "
                            f"stages, {plan['x_window_columns']} columns "
                            "of x staged)")
                if kname in ("wellcw_level", "wellcw_level_spmm"):
                    bits = 16 if part.local_index16 is not None else 32
                    found[kname]["index_bits"] = bits
                    what = f" ({bits}-bit indices)"
                if spmm:
                    kb = column_block(CW_SPMM_K)
                    found[kname]["columns_per_block"] = kb
                    if kname == "wellcw_level_spmm":
                        plan = wk.spmm_plan(k, f32, v.data_ptr(),
                                            out.data_ptr())
                        found[kname].update(plan)
                        what = (f" ({bits}-bit indices, "
                                f"{'16-byte' if plan['vector_x'] else 'scalar'}"
                                " X loads)")
                    what = f", {kb} columns a block{what}"
                    if kname == "csr_spmm":
                        plan = wk.spmm_plan(k, f32, v.data_ptr(),
                                            out.data_ptr())
                        _say("[10 wellcw kernels] csr_spmm adding into Y: "
                             f"{acc_ms:.4f} ms (CUDA graph, L2 flushed), "
                             f"bound {b_acc['bound_ms']:.4f} ms "
                             f"({b_acc['bytes']} B: the list and its "
                             f"pointers, {part.num_entries} entries, "
                             f"{cb['x_rows_read']} X rows, "
                             f"{cb['listed_rows']} Y rows read and "
                             f"written), on {smi_line}")
                        found[kname].update(
                            plan, accumulate_ms=acc_ms,
                            accumulate_bound_ms=b_acc["bound_ms"],
                            accumulate_bytes=b_acc["bytes"],
                            listed_rows=cb["listed_rows"],
                            x_rows_read=cb["x_rows_read"])
                        what = (f", {kb} columns a block (one thread a "
                                f"listed row: {cb['listed_rows']} rows of "
                                f"{A.num_rows} own {part.num_entries} "
                                "entries; "
                                f"{'16-byte' if plan['vector_x'] else 'scalar'}"
                                f" X loads, {cb['x_rows_read']} X rows "
                                "read; a product's first launch: Y zeroed, "
                                "then its listed rows written)")
                    if kname == "wellcw_merged_spmm":
                        plan = wk.spmm_plan(k, f32, v.data_ptr(),
                                            out.data_ptr())
                        found[kname].update(plan)
                        what = f" ({_merged_spmm_shape(part, plan, k)})"
                    if kname == "wellcw_pool_spmm":
                        plan = wk.spmm_plan(k, f32, v.data_ptr(),
                                            out.data_ptr())
                        parts = _pool_spmm_parts(part, v, A.num_rows, out,
                                                 flush)
                        _say("[10 wellcw kernels] wellcw_pool_spmm adding "
                             f"into Y: {acc_ms:.4f} ms (CUDA graph, L2 "
                             f"flushed), bound {b_acc['bound_ms']:.4f} ms "
                             f"({b_acc['bytes']} B: the list, {xrows} X "
                             f"rows, {listed} Y rows read and written); by "
                             "part: " + ", ".join(
                                 f"{what}: {r} rows, {c} cells, {t:.4f} ms"
                                 for what, (r, c, t) in parts.items())
                             + f", on {smi_line}")
                        found[kname].update(
                            plan, accumulate_ms=acc_ms,
                            accumulate_bound_ms=b_acc["bound_ms"],
                            accumulate_bytes=b_acc["bytes"], by_part=parts,
                            list_cells=int(part.list_len.sum()),
                            list_slots=part.list_col.numel(),
                            list_bytes=read, listed_rows=listed,
                            x_rows_read=xrows)
                        what = (f" (one thread a row: {listed} rows of "
                                f"{A.num_rows} own "
                                f"{int(part.list_len.sum())} cells, a row "
                                f"list of {part.list_col.numel()} places "
                                f"in slices of 32 rows, {read} B; "
                                f"{'16-byte' if plan['vector_x'] else 'scalar'}"
                                f" X loads, {xrows} X rows read; a product's "
                                "first launch: Y zeroed, then its listed "
                                "rows written)")
                    what = f" k={CW_SPMM_K}{what}"
                _say(f"[10 wellcw kernels] {kname}{what}"
                     f"{' (chunks_per_step=64)' if dev_kw else ''}: "
                     f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
                     f"{eager_ms:.4f} ms a call through the wrapper, plain "
                     f"{plain_ms:.4f} ms, torch.sparse CSR of its entries "
                     f"{_library_line(lib)}, "
                     f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, "
                     f"{b['bytes']} B read; full container "
                     f"{b_full['bound_ms']:.4f} ms, {b_full['bytes']} B), "
                     f"max abs err {err:.3e} (rel "
                     f"{rel:.3e}), bitwise repeatable, on {smi_line}")
                if kname in ("wellcw_level", "wellcw_merged_spmm",
                             "wellcw_level_spmm"):
                    other = _variants(kname, part, v, out, run, y1, flush)
                    found[kname]["variants_ms"] = other
                    _say(f"[10 wellcw kernels] {kname} other paths, each "
                         "bitwise equal to the main path (CUDA graph, L2 "
                         "flushed): " + ", ".join(
                             f"{label} {t:.4f} ms"
                             for label, t in other.items())
                         + f"; main path {ms:.4f} ms")
        del A
        _sync(device)
    missing = {"wellcw_merged", "wellcw_level", "wellcw_pool", "csr_spmv",
               "wellcw_merged_spmm", "wellcw_level_spmm",
               "wellcw_pool_spmm", "csr_spmm"} - set(found)
    if missing:
        _fail(f"full-size matrix did not reach {sorted(missing)}")
    return found


@_walled
def phase_csr_whole(device, mm, smi_line, triad_gbps):
    """The CSR SpMM on a whole matrix held as one ``DeviceCsr`` (the CSR
    format's own path: every row owns an entry, so no row list) at k =
    CW_SPMM_K, float32, alone (not counted): bitwise repeat, against its
    plain version, column by column against the CSR SpMV kernel, device
    ms (a CUDA graph, the L2 flushed) as a product's first launch, its
    bound, and the torch.sparse CSR product of the same entries timed
    the same way and eagerly; then the CSR SpMV on the same matrix alike
    (``_csr_spmv_whole``).  Returns the SpMM's numbers and the SpMV's."""
    import torch

    from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        csr_spmv_core,
        csr_spmv_reference,
    )

    f32, k = torch.float32, CW_SPMM_K
    R = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm), dtype=f32,
                            device=device)
    g = torch.Generator(device=device).manual_seed(2)
    X = torch.randn(R.num_columns, k, device=device, dtype=f32, generator=g)
    Y = torch.empty(R.num_rows, k, device=device, dtype=f32)
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    Y1, Y2 = csr_spmm_core(R, X), csr_spmm_core(R, X)
    cols = torch.stack([csr_spmv_core(R, X[:, j].contiguous())
                        for j in range(k)], dim=1)
    want = csr_spmv_reference(R, X)
    _sync(device)
    if not (torch.equal(Y1, Y2) and torch.equal(Y1, cols)):
        _fail("csr_spmm on the whole matrix: two launches differ, or a "
              "column differs from the CSR SpMV kernel's")
    err = float((Y1.double() - want.double()).abs().max())
    rel = _rel(Y1, want)
    if rel > TOL_F32:
        _fail(f"csr_spmm on the whole matrix: rel err {rel} > {TOL_F32}")
    ms = _cold_graph_ms(lambda: csr_spmm_core(R, X, out=Y), flush, 50)
    eager_ms = _time_launches(lambda: csr_spmm_core(R, X, out=Y), 50)
    plain_ms = _time_launches(lambda: csr_spmv_reference(R, X), 3)
    S = _torch_csr(R.row_ptr, R.column_index, R.value,
                   (R.num_rows, R.num_columns))
    lib = _library_cold(S, X, flush)
    b = _bound(_csr_spmm_bytes(R, k)["first"], 2 * R.num_entries * k,
               triad_gbps)
    _say(f"[10 wellcw kernels] csr_spmm k={k} on the whole matrix "
         f"({R.num_rows} rows, {R.num_entries} entries, "
         f"{'no row list' if R.row_list is None else 'a row list'}): "
         f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
         f"{eager_ms:.4f} ms a call through the wrapper, plain "
         f"{plain_ms:.4f} ms, torch.sparse CSR {_library_line(lib)}, bound "
         f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bytes']} B), max "
         f"abs err {err:.3e} (rel {rel:.3e}), bitwise repeatable and "
         f"bitwise the CSR SpMV's columns, on {smi_line}")
    spmv = _csr_spmv_whole(
        R, S, X[:, 0].contiguous(), flush,
        f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8) float32",
        "10 wellcw kernels", smi_line, triad_gbps)
    del R, S, X, Y, Y1, Y2, cols, want, scratch
    _sync(device)
    return {"ms": ms, "eager_ms": eager_ms, "plain_ms": plain_ms,
            "max_abs_err": err, **lib, **b}, spmv


# ------------------------------------------------------- WELL (3, 11-13)
def _k1_seconds(dia, device) -> float:
    """K1's seconds per chained float32 SpMV on the host DIA matrix (the
    DIA yardstick of a WELL size that phase 5 does not run)."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.profile import time_kernel

    kernel = make_kernel("dia", matrix=dia, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.run_fn()
    return time_kernel(step, args, k_small=8, k_large=136,
                       runs=6).seconds_per_iteration


def _well_mm(kind, mod, *args):
    """The JAX WELL tests' hand-made matrices (tests/test_well.py): a
    near and a far diagonal in one row group (:192), two empty 8-group
    output blocks (:312), and a random band with unique entries
    (:163)."""
    if kind == "two_clusters":
        r = np.concatenate([np.arange(128)] * 2)
        c = np.concatenate([np.arange(128), np.arange(128) + 3000])
        n, m, v = 128, 4000, np.ones(r.size)
    elif kind == "empty_blocks":
        r = np.concatenate([np.arange(128), np.arange(2176, 2304)])
        c, n, m, v = r, 2304, 2304, np.ones(r.size)
    else:
        n, bw, per, seed = args
        rng = np.random.default_rng(seed)
        rows = np.repeat(np.arange(n), per)
        cols = np.clip(rows + rng.integers(-bw, bw + 1, rows.size), 0,
                       n - 1)
        key = np.unique(rows * n + cols)
        r, c, m = key // n, key % n, n
        v = rng.standard_normal(r.size)
    return mod.MatrixMarket("matrix", "coordinate", "real", "general", n, m,
                            r.size, r + 1, c + 1, v)


def _well_part(A):
    """(kernel name, kernel call, plain call) of the one launch that
    ``well_spmv_core`` makes for A: K5a or K5b, the spill folded in."""
    from spmv_tpu_torch import ops

    seg = A.segment_of_step is not None
    core = ops.well_seg_core if seg else ops.well_whole_core
    return ("well_seg" if seg else "well_whole",
            lambda x, out=None: core(A, x, out=out),
            lambda x: ops.well_spmv_reference(A, x))


@contextlib.contextmanager
def _spill_taken_away(A):
    """A with its spill (the CSR and the lane-ordered copy) taken away:
    K5 and its plain version then add the chunks alone (what K6 adds,
    and what K5 added before the spill was folded in)."""
    names = ("spill", "spill_ptr", "spill_row", "spill_col", "spill_value")
    saved = {n: getattr(A, n) for n in names}
    for n in names:
        setattr(A, n, None)
    try:
        yield A
    finally:
        for n, t in saved.items():
            setattr(A, n, t)


def _live_slots(A) -> int:
    """The slots K5 reads: the set bits of A.slot_mask."""
    import torch

    bits = 1 << torch.arange(8, device=A.slot_mask.device)
    return int(((A.slot_mask.long()[:, None] & bits) != 0).sum())


def _compare_well(name, w, dev_kw, dtype, device):
    """K5a / K5b, the spill folded in, twice (bitwise equal) and against
    its plain version; ``well_spmv_core`` makes that one launch and no
    other, and in float32 its product is held against the fp64 host
    product."""
    import torch

    from spmv_tpu_torch.models import DeviceWell
    from spmv_tpu_torch.ops import csr_spmv_core, well_spmv_core

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWell.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    x = torch.randn(A.num_columns, generator=g, device=device, dtype=dtype)
    kname, run, plain = _well_part(A)
    y1, y2 = run(x), run(x)
    _sync(device)
    if not torch.equal(y1, y2):
        _fail(f"{kname} on {name} {dtn}: two launches differ")
    e = _rel(y1, plain(x))
    if e > tol:
        _fail(f"{kname} on {name} {dtn}: rel err {e} > {tol}")
    before = csr_spmv_core.launches
    y = well_spmv_core(A, x)
    _sync(device)
    if not torch.equal(y, y1) or csr_spmv_core.launches != before:
        _fail(f"well_spmv_core on {name} {dtn}: not the one K5 launch")
    mode = ("whole x" if A.segment_rows is None else
            f"segment_rows {A.segment_rows}")
    line = (f"[3 compare] {name} {dtn} ({mode}, blocks_per_out "
            f"{A.blocks_per_out}, spill "
            f"{0 if A.spill is None else A.spill.num_entries}, live slots "
            f"{_live_slots(A)} of {8 * A.num_chunks}): {kname} {e:.3e}")
    if dtype == torch.float32:
        host = torch.from_numpy(w.spmv(x.double().cpu().numpy()))
        eh = _rel(y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (twice, bitwise equal; well_spmv_core the same one "
         "launch)")
    return A.segment_rows is not None


@_walled
def phase_compare_well(device, cg_well):
    """K5a and K5b against their plain versions on the JAX WELL tests'
    kinds of matrix: whole x, forced segments of 4 and 2 rows (escaping
    slots spill), blocks_per_out 2 and 4, the empty-block matrix, a
    rectangular matrix and a banded matrix with a CSR spill; then K6a and
    K6b (and the spill's CSR SpMM) on the same matrices at k = 3 and 8,
    and at the batched-CG leg's shape (``cg_well``, k = CG_K, float32).
    Returns per SpMM kernel whether its columns equalled the SpMV
    kernel's bit for bit in every case."""
    import torch

    from spmv_tpu_torch import io as pio
    from spmv_tpu_torch.io.generate import (
        banded_random,
        poisson2d,
        random_sparse,
    )
    from spmv_tpu_torch.models import WellMatrix

    def well(mm, window_rows):
        return WellMatrix.from_matrix_market(mm, window_rows=window_rows)

    p = well(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), 4)
    cases = [
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})", p, {}),
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID}) blocks_per_out=2", p,
         {"blocks_per_out": 2}),
        ("band(2000,60,5) segment_rows=4",
         well(_well_mm("band", pio, 2000, 60, 5, 30), 2),
         {"segment_rows": 4}),
        ("two clusters segment_rows=2",
         well(_well_mm("two_clusters", pio), 1), {"segment_rows": 2}),
        (f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID}) segment_rows=8 "
         "blocks_per_out=4", p, {"segment_rows": 8, "blocks_per_out": 4}),
        ("empty blocks segment_rows=4",
         well(_well_mm("empty_blocks", pio), 1), {"segment_rows": 4}),
        ("random_sparse(200,150,5) rectangular",
         well(random_sparse(200, 150, 5, seed=6), 2), {}),
        ("banded_random(65536,512,8) spill",
         well(banded_random(65536, 512, 8, seed=3), 4), {}),
    ]
    seen = set()
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            seen.add(_compare_well(name, w, dev_kw, dtype, device))
    if seen != {False, True}:
        _fail("the WELL comparisons did not reach both K5a and K5b")
    seen, bitwise = set(), {}
    for name, w, dev_kw in cases:
        for dtype in (torch.float64, torch.float32):
            for k in COMPARE_KS:
                seen.add(_compare_well_spmm(name, w, dev_kw, dtype, k,
                                            device, bitwise))
    if seen != {False, True}:
        _fail("the WELL SpMM comparisons did not reach both K6a and K6b")
    _compare_well_spmm(f"poisson2d({CG_GRID},{CG_GRID})", cg_well, {},
                       torch.float32, CG_K, device, bitwise)
    _say("[3 compare] WELL SpMM columns bitwise equal to the SpMV kernel's "
         "in every case: " + ", ".join(f"{n} {'yes' if b else 'no'}"
                                       for n, b in bitwise.items()))
    _sync(device)
    return bitwise


@_walled
def phase_cli_well(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import csr_spmv_core, well_whole_core

    spill_before = csr_spmv_core.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        write_matrix_market(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), path)
        label = f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})"
        _say(f"[11 well cli] wrote {label}")
        argv = ["--matrix", path, "--spmv-format", "well"]
        _run_cli("11 well cli", [
            (f"profile {label}", argv + ["--profile", "5"],
             (well_whole_core,)),
            (f"cg {label}", argv + ["--cg", "2000"], (well_whole_core,)),
        ])
    _sync(device)
    if csr_spmv_core.launches != spill_before:
        _fail("well cli: the CSR kernel was launched (the spill belongs "
              "to K5's one launch)")


@_walled
def phase_profile_well(device, mats, smi_line):
    """make_kernel("well").run_fn at each size of ``mats`` (label ->
    (host WellMatrix, whether K5b is expected, K1's seconds per SpMV on
    the same matrix)): the fp64 host checksum gate, seconds per chained
    SpMV (CUDA events) with the launch count equal to the chain length,
    the plain version's time and the fraction of the triad roofline.
    Returns per size its numbers and its DeviceWell."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        well_seg_core,
        well_spmv_reference,
        well_whole_core,
    )
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    machine = measured_machine(device)
    out = {}
    for label, (w, segmented, t_k1) in mats.items():
        kernel = make_kernel("well", matrix=w, device=device,
                             dtype=torch.float32)
        kernel.init()
        t0 = time.perf_counter()
        step, args = kernel.run_fn()
        _sync(device)
        t_dev = time.perf_counter() - t0
        A = args[1]
        if (A.segment_of_step is not None) != segmented:
            _fail(f"well {label}: segmented mode is "
                  f"{A.segment_of_step is not None}, expected {segmented}")
        core = well_seg_core if segmented else well_whole_core
        _say(f"[12 well profile] {label} float32: {A.num_chunks} chunks, "
             f"segment_rows {A.segment_rows}, blocks_per_out "
             f"{A.blocks_per_out}, chunks_per_step {A.chunks_per_step}, "
             f"{A.num_out_blocks} output blocks, spill "
             f"{0 if A.spill is None else A.spill.num_entries} entries; "
             f"device packing and copy {t_dev:.1f} s")
        x = np.random.default_rng(0).standard_normal(
            w.num_columns).astype(np.float32)
        y = step(torch.from_numpy(x).to(device), A)
        got = float(y.abs().sum(dtype=torch.float32))
        want = float(np.abs(w.spmv(x.astype(np.float64))).sum())
        rel = abs(got - want) / want
        _say(f"[12 well profile] {label}: checksum rel err {rel:.3e} (gate "
             f"{CHECKSUM_RTOL})")
        if not rel <= CHECKSUM_RTOL:
            _fail(f"well {label} checksum gate: {rel} > {CHECKSUM_RTOL}")
        calls = [0]

        def counted(v, A, step=step):
            calls[0] += 1
            return step(v, A)

        before = (core.launches, csr_spmv_core.launches)
        timing = time_kernel(counted, args, k_small=8, k_large=136, runs=6)
        _sync(device)
        launched = (core.launches - before[0],
                    csr_spmv_core.launches - before[1])
        if launched != (calls[0], 0):
            _fail(f"well {label}: {launched} launches (K5, CSR) for "
                  f"{calls[0]} chained SpMVs: expected one K5 launch each")
        runs = profile_kernel_fn(step, args, runs=5)
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device)
        t = doc["device_seconds_per_iteration"]
        if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
            _fail(f"well {label}: bad timing {t} on {doc['device']}")
        frac = doc["achieved"]["fraction_of_roofline"]
        t_plain = time_kernel(lambda v, A: well_spmv_reference(A, v),
                              (args[0], A), k_small=1, k_large=4,
                              runs=3).seconds_per_iteration
        _say(f"[12 well profile] {label}: SpMV {t * 1e3:.4f} ms "
             f"({w.num_entries / t / 1e9:.2f} Gnnz/s; {calls[0]} chained "
             f"SpMVs launched {core.__name__} {launched[0]} times and the "
             f"CSR kernel {launched[1]} times), plain {t_plain * 1e3:.4f}"
             f" ms, fraction of the triad roofline {frac:.4f} "
             f"({kernel.bytes_per_run()} B at {machine.hbm_gbps:.1f} GB/s);"
             f" K1 (DIA) on the same matrix {t_k1 * 1e3:.4f} ms, on "
             f"{smi_line}")
        out[label] = {"A": A, "ms": t * 1e3, "plain_ms": t_plain * 1e3,
                      "k1_ms": t_k1 * 1e3, "roofline_fraction": frac,
                      "checksum_rel_err": rel, "chained": calls[0],
                      "launches": launched}
        del kernel, step, args, y
        _sync(device)
    return out


def _well_coo(A, spill: bool):
    """(rows, cols, values) on the card of the WELL chunks of A, and of
    its spill with ``spill``."""
    import torch

    k = A.chunks_per_step
    ws = A.window_start.transpose(1, 2).reshape(A.num_chunks, 8).long()
    if A.segment_of_step is not None:
        ws = ws + A.segment_of_step.long().repeat_interleave(k)[:, None]
    col = ws[:, :, None] * 128 + A.local_index.long()
    row = (A.group_of_chunk.reshape(-1).long()[:, None, None] * 128
           + torch.arange(128, device=col.device)).expand_as(col)
    keep = A.value != 0
    rows, cols, vals = [row[keep]], [col[keep]], [A.value[keep]]
    del col, row, keep
    if spill and A.spill is not None:
        R = A.spill
        rows.append(torch.repeat_interleave(
            torch.arange(R.num_rows, device=R.value.device),
            (R.row_ptr[1:] - R.row_ptr[:-1]).long()))
        cols.append(R.column_index.long())
        vals.append(R.value)
    return torch.cat(rows), torch.cat(cols), torch.cat(vals)


def _k5_bytes(A) -> tuple:
    """(live, full) bytes of K5's product on A, x and y included.  Live:
    what K5 must read, value + index of each slot whose mask bit is set,
    a window start per such slot, the mask, a group per chunk with a set
    bit, the step and segment pointers and the lane-ordered spill.  Full:
    every chunk array of the container, as K5 was priced before it read
    only the live slots (the spill then had a launch and a bound of its
    own)."""
    live = _live_slots(A)
    vb = A.value.element_size()
    vec = (A.num_columns + A.num_rows) * vb
    live_bytes = (live * 128 * (vb + 4) + live * 4 + A.slot_mask.numel()
                  + int((A.slot_mask != 0).sum()) * 4
                  + _nbytes(A.segment_of_step, A.step_ptr, A.spill_ptr,
                            A.spill_row, A.spill_col, A.spill_value) + vec)
    full_bytes = _nbytes(A.value, A.local_index, A.window_start,
                         A.group_of_chunk, A.segment_of_step,
                         A.step_ptr) + vec
    return live_bytes, full_bytes


def _compacted(R):
    """The spill ``R`` (a DeviceCsr over every row) cut to its nonempty
    rows: what a separate launch over a row-compacted spill would walk."""
    import torch

    from spmv_tpu_torch.models import DeviceCsr

    counts = (R.row_ptr[1:] - R.row_ptr[:-1]).long()
    rows = counts.nonzero().reshape(-1)
    ptr = torch.zeros(rows.numel() + 1, dtype=torch.long,
                      device=counts.device)
    ptr[1:] = counts[rows].cumsum(0)
    return DeviceCsr(rows.numel(), R.num_columns, R.num_entries, ptr,
                     R.column_index, R.value)


@_walled
def phase_kernels_well(device, profiled, smi_line, triad_gbps):
    """K5a and K5b alone on the DeviceWell of each profiled size, the
    spill folded in: bitwise repeat, max error against the plain version,
    device ms (50 launches in a CUDA graph, the L2 flushed before each),
    ms a call through the wrapper, plain ms, the torch.sparse CSR product
    of the same entries, which are the whole matrix's (cuSPARSE, timed
    the same way and eagerly), and the bound from the live bytes beside
    the full container's.  Then what the fold costs: K5 with its spill
    arrays taken away, and the CSR kernel over the spill cut to its
    nonempty rows (a separate launch's alternative to the fold), both
    timed alike.  Not counted: the main path's counts were read
    before."""
    import torch

    from spmv_tpu_torch.ops import csr_spmv_core

    f32 = torch.float32
    scratch = torch.empty(16 << 20, dtype=f32, device=device)

    def flush():
        scratch.fill_(0.0)

    found = {}
    for label, res in profiled.items():
        A = res["A"]
        g = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(A.num_columns, generator=g, device=device, dtype=f32)
        out = torch.empty(A.num_rows, dtype=f32, device=device)
        kname, run, plain = _well_part(A)
        y1, y2 = run(x), run(x)
        _sync(device)
        if not torch.equal(y1, y2):
            _fail(f"{kname} on {label}: two launches differ")
        want = plain(x)
        err = float((y1.double() - want.double()).abs().max())
        rel = _rel(y1, want)
        if rel > TOL_F32:
            _fail(f"{kname} on {label}: rel err {rel} > {TOL_F32}")
        del y1, y2
        ms = _cold_graph_ms(lambda: run(x, out=out), flush, 50)
        eager_ms = _time_launches(lambda: run(x, out=out), 20)
        plain_ms = _time_launches(lambda: plain(x), 3)
        S = _csr_of_coo(*_well_coo(A, spill=True),
                        (A.num_rows, A.num_columns))
        lib_rel = _rel(S @ x, want)
        if lib_rel > TOL_F32:
            _fail(f"{kname} on {label}: torch.sparse of its entries differs "
                  f"from the plain version by {lib_rel}")
        del want
        nnz = int(S.values().numel())
        live, full = _k5_bytes(A)
        b = _bound(live, 2 * nnz, triad_gbps)
        bf = _bound(full, 2 * nnz, triad_gbps)
        lib = _library_cold(S, x, flush)
        del S
        fold = {}
        if A.spill is not None:
            with _spill_taken_away(A):
                ms_chunks = _cold_graph_ms(lambda: run(x, out=out), flush, 50)
            Rc = _compacted(A.spill)
            yc = torch.empty(Rc.num_rows, dtype=f32, device=device)
            ms_compact = _cold_graph_ms(
                lambda: csr_spmv_core(Rc, x, out=yc), flush, 50)
            fold = {"spill_entries": A.spill.num_entries,
                    "spill_rows": Rc.num_rows,
                    "ms_without_spill": ms_chunks,
                    "fold_ms": ms - ms_chunks,
                    "compacted_spill_ms": ms_compact}
            del Rc, yc
        row = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
               "eager_ms": eager_ms, **lib, **b,
               "bound_full_ms": bf["bound_ms"],
               "bound_full_triad_ms": bf["bound_triad_ms"],
               "bytes_full": full, "live_slots": _live_slots(A),
               "slots": 8 * A.num_chunks, **fold,
               "shape": f"{label} float32"}
        _say(f"[13 well kernels] {kname} on {label} (spill folded in): "
             f"{ms:.4f} ms on the device (CUDA graph, L2 flushed), "
             f"{eager_ms:.4f} ms a call through the wrapper, plain "
             f"{plain_ms:.4f} ms, torch.sparse CSR of the same entries (the "
             f"whole matrix) {_library_line(lib)}, bound {b['bound_ms']:.4f}"
             f" ms ({b['bound_by']}, {b['bytes']} B live: "
             f"{row['live_slots']} of {row['slots']} slots; "
             f"{b['bound_triad_ms']:.4f} ms at the triad rate), the full "
             f"container's {bf['bound_ms']:.4f} ms ({full} B; "
             f"{bf['bound_triad_ms']:.4f} at the triad), max abs err "
             f"{err:.3e} (rel {rel:.3e}), bitwise repeatable, on {smi_line}")
        if fold:
            _say(f"[13 well kernels] {kname} on {label}: the fold of "
                 f"{fold['spill_entries']} spill entries ({fold['spill_rows']}"
                 f" rows) costs {fold['fold_ms']:.4f} ms (K5 without them "
                 f"{fold['ms_without_spill']:.4f} ms); the CSR kernel over "
                 f"the row-compacted spill alone {fold['compacted_spill_ms']:.4f}"
                 f" ms, timed alike, on {smi_line}")
        found[(kname, label)] = row
        res.update(lib)
        _say(f"[13 well kernels] {label}: torch.sparse CSR SpMV of the whole"
             f" matrix {_library_line(lib)} against the chained WELL SpMV's "
             f"{res['ms']:.4f} ms and K5's {ms:.4f} ms alone")
        del A, res["A"]
        _sync(device)
    return found


# ------------------------------------------------ WELL SpMM (3, 14-16)
def _well_spmm_part(A):
    """(kernel name, kernel call, plain call, SpMV kernel call) of the one
    launch that ``well_spmm_core`` makes for A: K6a or K6b, the spill
    folded in; its SpMV kernel is K5.  The kernel call takes X and an
    optional out buffer."""
    from spmv_tpu_torch import ops

    seg = A.segment_of_step is not None
    core = ops.well_seg_spmm_core if seg else ops.well_whole_spmm_core
    spmv_core = ops.well_seg_core if seg else ops.well_whole_core
    return ("well_seg_spmm" if seg else "well_whole_spmm",
            lambda X, out=None: core(A, X, out=out),
            lambda X: ops.well_spmv_reference(A, X),
            lambda x: spmv_core(A, x))


def _host_spmm(host, X):
    """The fp64 host product of a host matrix with each column of X."""
    X = np.asarray(X, np.float64)
    return np.stack([host.spmv(X[:, j]) for j in range(X.shape[1])], 1)


def _compare_well_spmm(name, w, dev_kw, dtype, k, device, bitwise):
    """K6a / K6b, the spill folded in, twice (bitwise equal), against its
    plain version and, column by column, against K5 on that column;
    ``well_spmm_core`` makes that one launch and no CSR launch; in
    float32 the product is held against the fp64 host product.
    ``bitwise`` records per kernel whether every column equalled K5's
    bit for bit."""
    import torch

    from spmv_tpu_torch.models import DeviceWell
    from spmv_tpu_torch.ops import csr_spmm_core, well_spmm_core

    dtn = str(dtype).replace("torch.", "")
    tol = TOL_F64 if dtype == torch.float64 else TOL_F32
    A = DeviceWell.from_host(w, dtype=dtype, device=device, **dev_kw)
    g = torch.Generator(device=device).manual_seed(0)
    X = torch.randn(A.num_columns, k, generator=g, device=device,
                    dtype=dtype)
    kname, run, plain, run1 = _well_spmm_part(A)
    Y1, Y2 = run(X), run(X)
    cols = torch.stack([run1(X[:, j].contiguous()) for j in range(k)],
                       dim=1)
    _sync(device)
    if not torch.equal(Y1, Y2):
        _fail(f"{kname} on {name} {dtn} k={k}: two launches differ")
    e, ec = _rel(Y1, plain(X)), _rel(Y1, cols)
    same = torch.equal(Y1, cols)
    bitwise[kname] = bitwise.get(kname, True) and same
    if e > tol or ec > tol:
        _fail(f"{kname} on {name} {dtn} k={k}: rel err {e} / {ec} > {tol}")
    before = csr_spmm_core.launches
    Y = well_spmm_core(A, X)
    _sync(device)
    if not torch.equal(Y, Y1) or csr_spmm_core.launches != before:
        _fail(f"well_spmm_core on {name} {dtn} k={k}: not the one K6 "
              "launch")
    line = (f"[3 compare] {name} {dtn} k={k}: {kname} {e:.3e} (vs K5 "
            f"{ec:.3e}{', bitwise' if same else ''})")
    if dtype == torch.float32:
        host = torch.from_numpy(_host_spmm(w, X.double().cpu().numpy()))
        eh = _rel(Y.cpu(), host)
        line += f", vs fp64 host {eh:.3e}"
        if eh > TOL_F32_HOST:
            _fail(f"{line} > {TOL_F32_HOST}")
    _say(line + " (twice, bitwise equal; well_spmm_core the same one "
         "launch)")
    return A.segment_rows is not None


def _bsr_blocklets(bh: int, n: int = 1024):
    """Dense 8 x 128 blocklets at random (tests/test_bsr.py:172), packed
    at block height bh."""
    from spmv_tpu_torch.io.generate import random_sparse
    from spmv_tpu_torch.models import BsrMatrix

    rng = np.random.default_rng(bh)
    base = random_sparse(n // 8, n // 128, 2, seed=bh)
    rows = np.repeat((base.rows_1based - 1) * 8, 8 * 128) \
        + np.tile(np.repeat(np.arange(8), 128), base.num_entries)
    cols = np.repeat((base.cols_1based - 1) * 128, 8 * 128) \
        + np.tile(np.arange(128), 8 * base.num_entries)
    return BsrMatrix._build(n, n, rows, cols, rng.standard_normal(rows.size),
                            None, bh)


def _bsr_dense_blocks(bh, num_rows, num_columns, per_row, seed):
    """Dense (bh, 128) blocks at random, per_row a block row, cut to a
    ragged (num_rows, num_columns) shape (tests/test_torch_cuda.py)."""
    from spmv_tpu_torch.models import BsrMatrix

    rng = np.random.default_rng(seed)
    nbr, nbc = -(-num_rows // bh), -(-num_columns // 128)
    rows, cols = [], []
    for br in range(nbr):
        for bc in rng.choice(nbc, size=min(per_row, nbc), replace=False):
            r, c = np.meshgrid(br * bh + np.arange(bh), bc * 128
                               + np.arange(128), indexing="ij")
            rows.append(r.ravel())
            cols.append(c.ravel())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    keep = (rows < num_rows) & (cols < num_columns)
    return BsrMatrix._build(num_rows, num_columns, rows[keep], cols[keep],
                            rng.standard_normal(int(keep.sum())), None, bh)


def _bsr_path_counts() -> dict:
    from spmv_tpu_torch.ops import bsr_spmm_core

    return {"tensor_core": bsr_spmm_core.tensor_core_launches,
            "simt": bsr_spmm_core.simt_launches}


def _bsr_path_delta(before: dict) -> dict:
    return {p: n - before[p] for p, n in _bsr_path_counts().items()}


@_walled
def phase_compare_bsr(device):
    """K7 against its plain version on block matrices: block heights 8,
    32, 64 and 128, blocks_per_step 1, 3 and 8, an empty block row, a 300
    x 200 shape and ragged bh 64 / 128 matrices (num_rows not a multiple
    of bh, num_columns not a multiple of 128); float64, float32 and bf16
    blocks; k = 1, 3, 8, BSR_K and 136: each on the path its shape
    selects (bf16 at bh 64 / 128 with k a multiple of 8: the tensor
    cores), twice (bitwise equal), and float32 / float64 against the fp64
    host product, bf16 within the JAX test's bound of it."""
    import torch

    from spmv_tpu_torch.io.generate import random_sparse
    from spmv_tpu_torch.io.matrix_market import MatrixMarket
    from spmv_tpu_torch.models import BsrMatrix, DeviceBsr
    from spmv_tpu_torch.ops import bsr_path, bsr_spmm_core, bsr_spmm_reference

    empty = BsrMatrix.from_matrix_market(MatrixMarket(
        "matrix", "coordinate", "real", "general", 384, 384, 2,
        np.array([1, 384]), np.array([1, 384]), np.array([2.0, 3.0])))
    cases = [("bh 8, blocks_per_step 8", _bsr_blocklets(8), 8),
             ("bh 32, blocks_per_step 3", _bsr_blocklets(32), 3),
             ("bh 128, blocks_per_step 1", _bsr_blocklets(128), 1),
             ("empty block row", empty, 8),
             ("random_sparse(300,200,4)", BsrMatrix.from_matrix_market(
                 random_sparse(300, 200, 4, seed=3)), 8),
             ("bh 64, ragged 1000 x 900", _bsr_dense_blocks(
                 64, 1000, 900, 3, 3), 1),
             ("bh 128, ragged 1000 x 900", _bsr_dense_blocks(
                 128, 1000, 900, 3, 4), 1)]
    for name, b, kb in cases:
        for dtype in (torch.float64, torch.float32, torch.bfloat16):
            dtn = str(dtype).replace("torch.", "")
            A = DeviceBsr.from_host(b, dtype=dtype, blocks_per_step=kb,
                                    device=device)
            errs = []
            for k in (1, 3, 8, BSR_K, 136):
                g = torch.Generator(device=device).manual_seed(k)
                X = torch.randn(A.num_columns, k, generator=g,
                                device=device).to(dtype)
                path = bsr_path(dtype, A.block_rows, k, X.data_ptr())
                before = _bsr_path_counts()
                Y1, Y2 = bsr_spmm_core(A, X), bsr_spmm_core(A, X)
                _sync(device)
                moved = _bsr_path_delta(before)
                if moved[path] != 2:
                    _fail(f"bsr_spmm on {name} {dtn} k={k}: the {path} path"
                          f" did not take both launches ({moved})")
                if not torch.equal(Y1, Y2):
                    _fail(f"bsr_spmm on {name} {dtn} k={k}: two launches "
                          "differ")
                tol = {"float64": TOL_F64, "float32": TOL_F32,
                       "bfloat16": TOL_BSR_BF16}[dtn]
                e = _rel(Y1, bsr_spmm_reference(A, X))
                host = torch.from_numpy(b.spmm(X.double().cpu().numpy()))
                eh = _rel(Y1.cpu(), host)
                th = TOL_BF16_HOST if dtype == torch.bfloat16 else tol
                errs.append(f"k={k} {path} {e:.3e} (fp64 host {eh:.3e})")
                if e > tol or eh > th:
                    _fail(f"bsr_spmm on {name} {dtn} k={k}: rel err {e} > "
                          f"{tol} or vs host {eh} > {th}")
            _say(f"[3 compare] bsr {name} {dtn} (Y "
                 f"{str(Y1.dtype).replace('torch.', '')}): "
                 + ", ".join(errs) + " (each twice, bitwise equal)")
            del A
    _sync(device)


@_walled
def phase_cli_well_spmm(device):
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import csr_spmm_core, well_whole_spmm_core

    spill_before = csr_spmm_core.launches
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        write_matrix_market(poisson2d(WELL_CLI_GRID, WELL_CLI_GRID), path)
        label = f"poisson2d({WELL_CLI_GRID},{WELL_CLI_GRID})"
        _say(f"[14 well spmm cli] wrote {label}")
        argv = ["--matrix", path, "--spmv-format", "well"]
        _run_cli("14 well spmm cli", [
            (f"spmm k={WELL_SPMM_K} {label}",
             argv + ["--profile", "5", "--spmm", str(WELL_SPMM_K)],
             (well_whole_spmm_core,)),
            (f"cg nrhs={CLI_NRHS} {label}",
             argv + ["--cg", "2000", "--nrhs", str(CLI_NRHS)],
             (well_whole_spmm_core,)),
        ])
    _sync(device)
    if csr_spmm_core.launches != spill_before:
        _fail("well spmm cli: the CSR SpMM was launched (the spill belongs "
              "to K6's one launch)")


@_walled
def phase_profile_well_spmm(device, mats, smi_line):
    """make_kernel("well").spmm_fn(WELL_SPMM_K) on each host matrix of
    ``mats`` (label -> (host WellMatrix, whether K6b is expected, its DIA
    host matrix for the fp64 checksum, the SpMV's seconds of phase 12)):
    the fp64 host checksum gate, seconds per chained SpMM (CUDA events)
    with one K6 launch a SpMM and no CSR launch, the plain version's
    time, the fraction of the triad roofline with the CLI's byte count
    (``spmm_bytes_per_run``: the slots K6 reads) and the per-nnz cost
    against the SpMV.  Returns per size its numbers and its
    DeviceWell."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        well_seg_spmm_core,
        well_spmv_reference,
        well_whole_spmm_core,
    )
    from spmv_tpu_torch.ops.well_kernels import well_spmm_plan
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import (
        profile_kernel_fn,
        profiling_report,
        time_kernel,
    )

    k = WELL_SPMM_K
    machine = measured_machine(device)
    out = {}
    for label, (w, segmented, dia, t_spmv) in mats.items():
        kernel = make_kernel("well", matrix=w, device=device,
                             dtype=torch.float32)
        kernel.init()
        step, args = kernel.spmm_fn(k)
        A = args[1]
        if (A.segment_of_step is not None) != segmented:
            _fail(f"well spmm {label}: segmented mode is "
                  f"{A.segment_of_step is not None}, expected {segmented}")
        core = well_seg_spmm_core if segmented else well_whole_spmm_core
        X = np.random.default_rng(0).standard_normal(
            (w.num_columns, k)).astype(np.float32)
        Xd = torch.from_numpy(X).to(device)
        Y = step(Xd, A)
        plan = well_spmm_plan(k, torch.float32, Xd.data_ptr(), Y.data_ptr())
        got = float(Y.abs().sum(dtype=torch.float32))
        want = float(np.abs(_host_spmm(dia, X)).sum())
        rel = abs(got - want) / want
        _say(f"[15 well spmm] {label} float32 k={k}: {A.num_out_blocks} "
             f"output blocks of {A.out_rows} groups, K6 path {plan}; "
             f"checksum rel err {rel:.3e} against the fp64 host product "
             f"(gate {CHECKSUM_RTOL})")
        if not rel <= CHECKSUM_RTOL:
            _fail(f"well spmm {label} checksum gate: {rel} > "
                  f"{CHECKSUM_RTOL}")
        calls = [0]

        def counted(V, A, step=step):
            calls[0] += 1
            return step(V, A)

        before = (core.launches, csr_spmm_core.launches)
        timing = time_kernel(counted, args, k_small=4, k_large=40, runs=6)
        _sync(device)
        launched = (core.launches - before[0],
                    csr_spmm_core.launches - before[1])
        if launched != (calls[0], 0):
            _fail(f"well spmm {label}: {launched} launches (K6, CSR) for "
                  f"{calls[0]} chained SpMMs")
        runs = profile_kernel_fn(step, args, runs=5)
        nbytes = kernel.spmm_bytes_per_run(k)
        doc = profiling_report(kernel, runs, timing.seconds_per_iteration,
                               5, True, machine=machine, device=device,
                               op_info={"kind": "spmm", "k": k},
                               flops_per_run=k * kernel.flops_per_run(),
                               bytes_per_run=nbytes)
        t = doc["device_seconds_per_iteration"]
        if not (np.isfinite(t) and t > 0) or doc["device"]["platform"] != "gpu":
            _fail(f"well spmm {label}: bad timing {t} on {doc['device']}")
        frac = doc["achieved"]["fraction_of_roofline"]
        t_plain = time_kernel(lambda V, A: well_spmv_reference(A, V),
                              (args[0], A), k_small=1, k_large=3,
                              runs=2).seconds_per_iteration
        per_nnz = (t / k) / t_spmv
        _say(f"[15 well spmm] {label}: SpMM k={k} {t * 1e3:.4f} ms "
             f"({w.num_entries * k / t / 1e9:.2f} effective Gnnz/s; "
             f"{calls[0]} chained SpMMs launched {core.__name__} "
             f"{launched[0]} times and the CSR SpMM {launched[1]} "
             f"times), plain {t_plain * 1e3:.4f} ms, fraction of the triad "
             f"roofline {frac:.4f} ({nbytes} B at {machine.hbm_gbps:.1f} "
             f"GB/s); per nnz against the SpMV {per_nnz:.4f} ((t / {k}) / "
             f"{t_spmv * 1e3:.4f} ms), on {smi_line}")
        out[label] = {"A": A, "k": k, "columns_per_block": plan["kb"],
                      "path": plan,
                      "ms": t * 1e3, "plain_ms": t_plain * 1e3,
                      "roofline_fraction": frac, "checksum_rel_err": rel,
                      "per_nnz_vs_spmv": per_nnz, "chained": calls[0],
                      "launches": launched}
        del kernel, step, args, Y
        _sync(device)
    return out


# ------------------------------------------------------ BSR (17-18)
def _bsr_regime(num_columns: int, k: int, itemsize: int) -> str:
    """Which Pallas kernel the JAX ``bsr_spmm`` would take for k columns
    of X over num_columns (padded to whole blocks) in blocks of
    ``itemsize`` bytes: K7b (``bsr_spmm_wholex``) while X fits its 80 MB,
    K7a (``bsr_spmm``) past it.  One CUDA kernel serves both."""
    x_bytes = -(-num_columns // 128) * 128 * k * itemsize
    return "bsr_spmm_wholex" if x_bytes <= BSR_WHOLEX_BYTES else "bsr_spmm"


@_walled
def phase_cli_bsr(device):
    """-s bsr (--profile with --spmm, and --cg) on a small poisson2d, and
    -s auto --spmm on a small block_random, whose report must name bsr.
    Returns the K7 launches by regime (all K7b, which is checked for each
    run's X in the CLI's value dtype) and by path (the CLI's float32
    blocks: all SIMT)."""
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import block_random, poisson2d
    from spmv_tpu_torch.models import default_value_dtype
    from spmv_tpu_torch.ops import bsr_spmm_core

    itemsize = default_value_dtype().itemsize
    for n, k in ((BSR_CLI_GRID ** 2, 16), (BSR_CLI_GRID ** 2, 1),
                 (BSR_CLI_BLOCK_ROWS, BSR_K)):
        if _bsr_regime(n, k, itemsize) != "bsr_spmm_wholex":
            _fail(f"the BSR CLI's X ({n} x {k}) passes the 80 MB line: its "
                  "launches would not all be K7b's")
    before = bsr_spmm_core.launches
    before_paths = _bsr_path_counts()
    with tempfile.TemporaryDirectory() as tmp:
        paths = {"poisson": os.path.join(tmp, "poisson.mtx"),
                 "blocks": os.path.join(tmp, "blocks.mtx")}
        write_matrix_market(poisson2d(BSR_CLI_GRID, BSR_CLI_GRID),
                            paths["poisson"])
        write_matrix_market(block_random(BSR_CLI_BLOCK_ROWS,
                                         BSR_CLI_BLOCK_ROWS, 4, seed=5),
                            paths["blocks"])
        p = f"poisson2d({BSR_CLI_GRID},{BSR_CLI_GRID})"
        b = f"block_random({BSR_CLI_BLOCK_ROWS},{BSR_CLI_BLOCK_ROWS},4)"
        _say(f"[17 bsr cli] wrote {p} and {b}")
        docs = _run_cli("17 bsr cli", [
            (f"bsr spmm k=16 {p}", ["--matrix", paths["poisson"], "-s", "bsr",
                                    "--profile", "5", "--spmm", "16"],
             (bsr_spmm_core,)),
            (f"bsr cg {p}", ["--matrix", paths["poisson"], "-s", "bsr",
                             "--cg", "500"], (bsr_spmm_core,)),
            (f"auto spmm k={BSR_K} {b}",
             ["--matrix", paths["blocks"], "-s", "auto", "--profile", "3",
              "--spmm", str(BSR_K)], (bsr_spmm_core,)),
        ])
    fmt = docs[-1]["kernel"]["matrix_format"]
    _say(f"[17 bsr cli] -s auto --spmm {BSR_K} chose {fmt}")
    if fmt != "bsr":
        _fail(f"-s auto --spmm on {b} chose {fmt}, not bsr")
    _sync(device)
    by_path = _bsr_path_delta(before_paths)
    _say(f"[17 bsr cli] K7 launches by path: {by_path}")
    return {"bsr_spmm_wholex": bsr_spmm_core.launches - before}, by_path


def _bsr_library(A, X):
    """One ``torch.sparse`` BSR product of A's stored blocks with X (a
    yardstick the port never calls): (a function of no arguments, None),
    or (None, why torch refused the dtype or block shape)."""
    import torch

    try:
        S = torch.sparse_bsr_tensor(
            A.row_ptr, A.block_col, A.blocks,
            size=(A.num_block_rows * A.block_rows, A.num_block_cols * 128))
        Xp = X.new_zeros((A.num_block_cols * 128, X.shape[1]))
        Xp[: X.shape[0]] = X
        S @ Xp
        _sync(X.device)
        return (lambda: S @ Xp), None
    except (RuntimeError, NotImplementedError, ValueError) as e:
        return None, f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def _bsr_leg(tag, host, dtype, device, smi_line, triad_gbps, gate):
    """make_kernel("bsr", matrix=host).spmm_fn(BSR_K) in ``dtype`` blocks:
    the fp64 host checksum gate, seconds per chained SpMM (CUDA events)
    with one launch a step, TFLOP/s, the bound, the plain version's ms and
    the library's.  Returns its numbers, its DeviceBsr, its X and its
    launches by regime."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import bsr_path, bsr_spmm_core, bsr_spmm_reference
    from spmv_tpu_torch.profile import time_kernel

    k = BSR_K
    dtn = str(dtype).replace("torch.", "")
    kernel = make_kernel("bsr", matrix=host, device=device, dtype=dtype)
    kernel.init()
    step, args = kernel.spmm_fn(k)
    A = args[1]
    regime = _bsr_regime(A.num_columns, k, A.blocks.element_size())
    X = np.random.default_rng(0).standard_normal(
        (host.num_columns, k)).astype(np.float32)
    Xd = torch.from_numpy(X).to(device)
    path = bsr_path(dtype, A.block_rows, k)   # the step's X, Y are fresh
    before = bsr_spmm_core.launches
    before_paths = _bsr_path_counts()
    Y = step(Xd, A)
    got = float(Y.abs().sum(dtype=torch.float32))
    want = float(np.abs(host.spmm(X.astype(np.float64))).sum())
    rel = abs(got - want) / want
    _say(f"[{tag}] {dtn} blocks (bh {A.block_rows}, {A.num_blocks} stored "
         f"blocks, the host's {host.num_blocks}: no zero padding, "
         f"{A.num_block_rows} block rows), k={k}, X "
         f"{A.num_block_cols * 128 * k * A.blocks.element_size()} B ({regime}"
         f" regime, the {path} path): checksum rel err {rel:.3e} (gate "
         f"{gate})")
    if A.num_blocks != host.num_blocks or A.blocks_per_step != 1:
        _fail(f"bsr {dtn}: make_kernel('bsr') stored {A.num_blocks} blocks "
              f"for the host's {host.num_blocks}")
    if not rel <= gate:
        _fail(f"bsr {dtn} checksum gate: {rel} > {gate}")
    calls = [1]                  # the checksum's step

    def counted(V, A):
        calls[0] += 1
        return step(V, A)

    t = time_kernel(counted, args, k_small=4, k_large=24,
                    runs=6).seconds_per_iteration
    _sync(device)
    launched = bsr_spmm_core.launches - before
    by_path = _bsr_path_delta(before_paths)
    if launched != calls[0]:
        _fail(f"bsr {dtn}: {launched} launches for {calls[0]} SpMMs")
    if by_path[path] != launched:
        _fail(f"bsr {dtn}: {by_path} launches by path, not all {launched} "
              f"on the {path} path")
    if dtype == torch.bfloat16 and path != "tensor_core":
        _fail(f"bsr bf16 at bh {A.block_rows}, k={k}: the {path} path, "
              "not the tensor cores")
    if not (np.isfinite(t) and t > 0):
        _fail(f"bsr {dtn}: bad timing {t}")
    Xb = Xd.to(dtype)
    plain_ms = _time_launches(lambda: bsr_spmm_reference(A, Xb), 3)
    nb = A.num_blocks
    flops = 2 * nb * A.block_rows * 128 * k
    acc = 4 if dtype == torch.bfloat16 else A.blocks.element_size()
    b = _bound(nb * (A.block_rows * 128 * A.blocks.element_size() + 4)
               + _nbytes(A.row_ptr, Xb) + A.num_rows * k * acc, flops,
               triad_gbps,
               peak=PEAK_BF16_FLOPS if dtype == torch.bfloat16
               else PEAK_F32_FLOPS)
    cast = (" (the chained step casts X from float32 to bf16 each step; "
            "phase 19 times K7 alone)" if dtype == torch.bfloat16 else "")
    _say(f"[{tag}] {dtn}: SpMM k={k} {t * 1e3:.4f} ms chained{cast} "
         f"({flops / t / 1e12:.2f} TFLOP/s; {calls[0]} SpMMs, the checksum"
         f"'s included, {launched} launches, {by_path}), bound "
         f"{b['bound_ms']:.4f} ms ({b['bound_by']}: {b['bytes']} B, {flops} "
         f"flops), plain {plain_ms:.4f} ms, on {smi_line}")
    res = {"ms": t * 1e3, "tflops": flops / t / 1e12, "plain_ms": plain_ms,
           "checksum_rel_err": rel, **b, "chained": calls[0], "path": path,
           "launches_by_path": by_path}
    del kernel, step, args, Y, Xb
    _sync(device)
    return res, A, Xd, {regime: launched}


@_walled
def phase_bsr_legs(device, smi_line, triad_gbps):
    """The JAX bench's BSR leg (bench.py:487-545): block_random(131072,
    131072, 8, seed=2) through the port's auto_format(workload="spmm"),
    which must pick bsr, then K7 at k = 128 with float32 and bf16 blocks;
    and K7 past the 80 MB line: block_random(262144, 262144, 2, seed=3),
    float32.  Returns the numbers, the containers and X for the kernels
    alone, and the K7 launches by regime."""
    import torch

    from spmv_tpu_torch.io.generate import block_random
    from spmv_tpu_torch.models import BsrMatrix, auto_format

    t0 = time.perf_counter()
    mm = block_random(BSR_ROWS, BSR_ROWS, 8, seed=2)
    t1 = time.perf_counter()
    host, why = auto_format(mm, workload="spmm")
    t2 = time.perf_counter()
    label = f"block_random({BSR_ROWS},{BSR_ROWS},8)"
    _say(f"[18 bsr] host {label}: {mm.num_entries} entries, generated in "
         f"{t1 - t0:.1f} s; auto_format(workload='spmm') chose "
         f"{why['format']} (fill {why.get('bsr_fill', float('nan')):.3f}, "
         f"block_rows {why.get('bsr_block_rows')}) in {t2 - t1:.1f} s")
    if why["format"] != "bsr":
        _fail(f"auto_format chose {why['format']} for {label}, not bsr")
    del mm
    out, launches, keep = {"shape": f"{label}, k={BSR_K}"}, {}, {}
    for dtype, gate in ((torch.float32, CHECKSUM_RTOL),
                        (torch.bfloat16, BF16_CHECKSUM_RTOL)):
        dtn = str(dtype).replace("torch.", "")
        res, A, X, n = _bsr_leg("18 bsr", host, dtype, device, smi_line,
                                triad_gbps, gate)
        out[dtn] = res
        keep[dtn] = (A, X)
        for r, c in n.items():
            launches[r] = launches.get(r, 0) + c
    out["bf16_speedup_vs_f32"] = out["float32"]["ms"] / out["bfloat16"]["ms"]
    keep["host"] = host          # phase 31 shards it
    t0 = time.perf_counter()
    far_label = f"block_random({BSR_FAR_ROWS},{BSR_FAR_ROWS},2)"
    far = BsrMatrix.from_matrix_market(
        block_random(BSR_FAR_ROWS, BSR_FAR_ROWS, 2, seed=3),
        block_rows="auto")
    _say(f"[18 bsr] host {far_label}: {far.num_entries} entries, BSR at "
         f"block_rows {far.block_rows} in {time.perf_counter() - t0:.1f} s")
    res, A, X, n = _bsr_leg("18 bsr far", far, torch.float32, device,
                            smi_line, triad_gbps, CHECKSUM_RTOL)
    for r, c in n.items():
        launches[r] = launches.get(r, 0) + c
    out["far"] = {**res, "shape": f"{far_label}, k={BSR_K}"}
    keep["far"] = (A, X)
    del far
    _sync(device)
    return out, keep, launches


# ------------------------------------------------------------ phase 19
def _k6_bytes(A, k: int) -> tuple:
    """(live, full) bytes of K6's product on A at k columns: K5's
    (``_k5_bytes``) with X and Y k times.  Live is what K6 must read and
    write; full prices every chunk array of the container, as K6 was
    priced before it read only the live slots (its spill then had a
    launch of its own)."""
    live, full = _k5_bytes(A)
    vec = (k - 1) * (A.num_columns + A.num_rows) * A.value.element_size()
    return live + vec, full + vec


@_walled
def phase_kernels_spmm(device, well_profiled, bsr_keep, smi_line,
                       triad_gbps):
    """K6a / K6b, the spill folded in, on the DeviceWell of each size of
    phase 15 (k = WELL_SPMM_K), and K7 on the bench's BSR leg (float32
    and bf16 blocks) and
    past the 80 MB line: bitwise repeat, max error against the plain
    version, device ms (a CUDA graph, the L2 flushed before each launch),
    ms a call through the wrapper, plain ms, one torch.sparse product of
    the same entries (cuSPARSE; for K6 the whole matrix, timed the same
    way and eagerly) and the bound (K6: from the live bytes, beside the
    full container's).  Not counted: the main path's counts were read
    before."""
    import torch

    from spmv_tpu_torch.ops import bsr_path, bsr_spmm_core, bsr_spmm_reference
    from spmv_tpu_torch.ops.well_kernels import well_spmm_plan

    f32 = torch.float32
    k = WELL_SPMM_K
    scratch = torch.empty(16 << 20, dtype=f32, device=device)

    def flush():
        scratch.fill_(0.0)

    found = {}
    for label, res in well_profiled.items():
        A = res["A"]
        g = torch.Generator(device=device).manual_seed(2)
        X = torch.randn(A.num_columns, k, generator=g, device=device,
                        dtype=f32)
        out = torch.empty(A.num_rows, k, dtype=f32, device=device)
        kname, run, plain, _ = _well_spmm_part(A)
        want = plain(X)
        plain_ms = _time_launches(lambda: plain(X), 2)
        S = _csr_of_coo(*_well_coo(A, spill=True),
                        (A.num_rows, A.num_columns))
        lib_rel = _rel(S @ X, want)
        if lib_rel > TOL_F32:
            _fail(f"{kname} on {label}: torch.sparse of its entries differs "
                  f"from the plain version by {lib_rel}")
        nnz = int(S.values().numel())
        lib = _library_cold(S, X, flush, reps=10)
        del S
        live, full = _k6_bytes(A, k)
        b = _bound(live, 2 * nnz * k, triad_gbps)
        bf = _bound(full, 2 * nnz * k, triad_gbps)
        plan = well_spmm_plan(k, f32, X.data_ptr(), out.data_ptr())
        _say(f"[19 spmm kernels] {kname} on {label} k={k}: path {plan} "
             "(a thread's column sums in registers, Y the store of a row "
             "the block comes back to; no shared tile), spill folded in, "
             f"live slots {_live_slots(A)} of {8 * A.num_chunks}")
        Y1, Y2 = run(X), run(X)
        _sync(device)
        if not torch.equal(Y1, Y2):
            _fail(f"{kname} on {label}: two launches differ")
        err = float((Y1.double() - want.double()).abs().max())
        rel = _rel(Y1, want)
        if rel > TOL_F32:
            _fail(f"{kname} on {label}: rel err {rel} > {TOL_F32}")
        del Y1, Y2
        ms = _cold_graph_ms(lambda: run(X, out=out), flush, 20)
        eager_ms = _time_launches(lambda: run(X, out=out), 10)
        _say(f"[19 spmm kernels] {kname} on {label} k={k}: {ms:.4f} ms on "
             f"the device (CUDA graph, L2 flushed), {eager_ms:.4f} ms a call "
             f"through the wrapper, plain {plain_ms:.4f} ms, torch.sparse "
             "CSR of the same entries (the whole matrix) "
             f"{_library_line(lib)}, bound {b['bound_ms']:.4f} ms "
             f"({b['bound_by']}, {live} B live; {b['bound_triad_ms']:.4f} ms "
             f"at the triad rate), the full container's {bf['bound_ms']:.4f}"
             f" ms ({full} B; {bf['bound_triad_ms']:.4f} at the triad), max "
             f"abs err {err:.3e} (rel {rel:.3e}), bitwise repeatable, on "
             f"{smi_line}")
        found[kname] = {"ms": ms, "eager_ms": eager_ms, "max_abs_err": err,
                        "plain_ms": plain_ms, **lib, **b,
                        "bound_full_ms": bf["bound_ms"],
                        "bound_full_triad_ms": bf["bound_triad_ms"],
                        "bytes_full": full, "live_slots": _live_slots(A),
                        "slots": 8 * A.num_chunks, "path": plan,
                        "shape": f"{label} float32, k={k}"}
        del want, out, X, A, res["A"]
        _sync(device)
    for key, (A, X) in bsr_keep.items():
        dtype = A.blocks.dtype
        kname = _bsr_regime(A.num_columns, X.shape[1],
                            A.blocks.element_size())
        Xb = X.to(dtype)
        path = bsr_path(dtype, A.block_rows, Xb.shape[1], Xb.data_ptr())
        before = _bsr_path_counts()
        Y1, Y2 = bsr_spmm_core(A, Xb), bsr_spmm_core(A, Xb)
        _sync(device)
        if _bsr_path_delta(before)[path] != 2:
            _fail(f"bsr_spmm {key}: not launched on the {path} path")
        if not torch.equal(Y1, Y2):
            _fail(f"bsr_spmm {key}: two launches differ")
        want = bsr_spmm_reference(A, Xb)
        err = float((Y1.double() - want.double()).abs().max())
        rel = _rel(Y1, want)
        tol = TOL_BSR_BF16 if dtype == torch.bfloat16 else TOL_F32
        if rel > tol:
            _fail(f"bsr_spmm {key}: rel err {rel} > {tol}")
        out = torch.empty_like(Y1)
        del Y1, Y2, want
        lib, why = _bsr_library(A, Xb)
        k7 = lambda: bsr_spmm_core(A, Xb, out=out)  # noqa: E731
        ms, lib_ms, timing = _cold_graph_ms(k7, flush, 10), None, "graph"
        if lib is not None:
            try:
                lib_ms = _cold_graph_ms(lib, flush, 10)
            except RuntimeError as e:
                # torch's product cannot be captured: both eager
                _sync(device)
                why = f"not captured ({str(e).splitlines()[0][:120]})"
                timing = "eager"
                ms = _cold_eager_ms(k7, flush, 10)
                lib_ms = _cold_eager_ms(lib, flush, 10)
        eager_ms = _time_launches(k7, 5)
        found[(kname, key)] = {"max_abs_err": err, "ms": ms,
                               "eager_ms": eager_ms, "library_ms": lib_ms,
                               "timing": timing, "path": path}
        if why is not None:
            found[(kname, key)]["library_note"] = why
        how = ("a CUDA graph, L2 flushed" if timing == "graph" else
               "eager, L2 flushed")
        _say(f"[19 spmm kernels] K7 ({kname} regime, {path} path) on the "
             f"{'far' if key == 'far' else 'bench'} matrix, "
             f"{str(dtype).replace('torch.', '')} blocks, k={X.shape[1]}: "
             f"{ms:.4f} ms on the device ({how}), one torch.sparse BSR "
             f"product of the same blocks "
             + (f"{lib_ms:.4f} ms ({how})" if lib_ms is not None
                else f"refused ({why})")
             + f", {eager_ms:.4f} ms a call through the wrapper, max abs "
             f"err {err:.3e} (rel {rel:.3e}), bitwise repeatable, on "
             f"{smi_line}")
        del out, Xb, lib
        _sync(device)
    return found


# ------------------------------------------------------- AMG and K8
def _fused_case(shape, smooth, block, dtype, device):
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix
    from spmv_tpu_torch.ops import fused_block_setup, fused_vcycle_device

    hier = fused_block_setup(CsrMatrix.from_matrix_market(poisson2d(*shape)),
                             smooth_levels=smooth, block=block)
    return hier, fused_vcycle_device(hier, dtype=dtype, device=device)


def _norm_rel(got, want) -> float:
    import torch

    got, want = got.double(), want.double()
    return float(torch.linalg.norm(got - want) /
                 max(float(torch.linalg.norm(want)), 1e-300))


@_walled
def phase_compare_amg(device):
    """K8 against fused_vcycle_reference on the FUSED_CASES hierarchies,
    float64 and float32, each launched twice (bitwise equal); the block
    V-cycle (K1 per level) and the generic V-cycle (the CSR kernel) on
    the card against their CPU runs."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix
    from spmv_tpu_torch.ops import (
        amg_preconditioner,
        fused_vcycle_core,
        fused_vcycle_reference,
        smoothed_aggregation_setup,
    )
    from spmv_tpu_torch.ops.amg import block_amg_device, block_vcycle

    for shape, smooth, block in FUSED_CASES:
        for dtype in (torch.float64, torch.float32):
            hier, fv = _fused_case(shape, smooth, block, dtype, device)
            g = torch.Generator(device=device).manual_seed(3)
            b = torch.randn(fv.padded_rows, generator=g, device=device,
                            dtype=torch.float64).to(dtype)
            y1, y2 = fused_vcycle_core(fv, b), fused_vcycle_core(fv, b)
            _sync(device)
            dtn = str(dtype).replace("torch.", "")
            name = (f"K8 poisson2d{shape} smooth_levels {smooth} block "
                    f"{block} {dtn} (levels {list(fv.rows)}, diagonals "
                    f"{[len(o) for o in fv.offsets]})")
            if not torch.equal(y1, y2):
                _fail(f"{name}: two launches differ")
            err = _norm_rel(y1, fused_vcycle_reference(fv, b))
            tol = TOL_F64 if dtype == torch.float64 else TOL_K8_F32
            if not (err <= tol and bool(torch.isfinite(y1).all())):
                _fail(f"{name}: relative 2-norm error {err} > {tol}")
            _say(f"[3 compare] {name}: {err:.3e} against the plain version, "
                 "bitwise repeatable")
            if dtype == torch.float64 and shape == (32, 512):
                blocks = {d: block_amg_device(hier, dtype=dtype, device=d)
                          for d in ("cpu", device)}
                bc = b.cpu()
                e = _norm_rel(block_vcycle(blocks[device], b).cpu(),
                              block_vcycle(blocks["cpu"], bc))
                if e > TOL_F64:
                    _fail(f"block V-cycle on the card: {e} > {TOL_F64}")
                _say(f"[3 compare] block V-cycle (K1 per level) poisson2d"
                     f"{shape} float64 on the card against its CPU run: "
                     f"{e:.3e}")
    m = CsrMatrix.from_matrix_market(poisson2d(48, 48))
    hier = smoothed_aggregation_setup(m, coarse_size=64)
    r = torch.from_numpy(np.random.default_rng(4).standard_normal(m.num_rows))
    want = amg_preconditioner(hierarchy=hier, dtype=torch.float64,
                              device="cpu")[0](r)
    got = amg_preconditioner(hierarchy=hier, dtype=torch.float64,
                             device=device)[0](r.to(device))
    e = _norm_rel(got.cpu(), want)
    if e > TOL_F64:
        _fail(f"generic V-cycle on the card: {e} > {TOL_F64}")
    _say(f"[3 compare] generic V-cycle (the CSR kernel) poisson2d(48, 48) "
         f"float64 on the card against its CPU run: {e:.3e}")
    _sync(device)


@_walled
def phase_cli_amg(device):
    """--cg 200 --precondition amg on poisson2d(AMG_CLI_GRID²), -s dia and
    -s wellcw: the generic V-cycle's CSR kernel launches, and K1 or K3c
    for the operator."""
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        dia_spmv_core,
        wellcw_merged_core,
    )

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"poisson2d_{AMG_CLI_GRID}.mtx")
        write_matrix_market(poisson2d(AMG_CLI_GRID, AMG_CLI_GRID), path)
        docs = _run_cli("20 amg cli", [
            (f"-s {fmt} --cg 200 --precondition amg",
             ["--matrix", path, "--spmv-format", fmt, "--cg", "200",
              "--precondition", "amg"], (csr_spmv_core, op))
            for fmt, op in (("dia", dia_spmv_core),
                            ("wellcw", wellcw_merged_core))])
    out = {}
    for fmt, doc in zip(("dia", "wellcw"), docs):
        cg = doc["cg"]
        f = cg["factorization"]
        _say(f"[20 amg cli] -s {fmt}: hierarchy {f['level_rows']}, "
             f"operator complexity {f['operator_complexity']:.3f}")
        out[fmt] = {k: cg[k] for k in ("iterations", "residual_norm",
                                       "solution_rms_error_vs_ones",
                                       "seconds")}
        out[fmt]["level_rows"] = f["level_rows"]
    _sync(device)
    return out


def _pcg(A, b, apply, tol, device):
    """PCG to tol with ``apply`` as M^-1, one untimed iteration first:
    (the timed solve's result, the applies of both, its seconds)."""
    from spmv_tpu_torch.ops import preconditioned_conjugate_gradient, spmv

    count = [0]

    def counted(r):
        count[0] += 1
        return apply(r)

    preconditioned_conjugate_gradient(lambda v: spmv(A, v), b, counted,
                                      tol=tol, max_iterations=1)
    _sync(device)
    t0 = time.perf_counter()
    res = preconditioned_conjugate_gradient(lambda v: spmv(A, v), b,
                                            counted, tol=tol,
                                            max_iterations=AMG_MAX_ITERS)
    float(res.residual_norm)                       # synchronises
    return res, count[0], time.perf_counter() - t0


@_walled
def phase_amg_full(device, smi_line):
    """The full-size leg, poisson2d(AMG_FULL_GRID²) in float32: the host
    setup, PCG to AMG_TOL with K8 (fused_vcycle_preconditioner) and with
    the block V-cycle (block_amg_preconditioner) on the same hierarchy,
    the operator K1.  K8's launches must equal its applies."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix, DeviceDia, DiaMatrix
    from spmv_tpu_torch.ops import (
        block_amg_preconditioner,
        fused_block_setup,
        fused_vcycle_core,
        fused_vcycle_preconditioner,
    )

    f32 = torch.float32
    t0 = time.perf_counter()
    mm = poisson2d(AMG_FULL_GRID, AMG_FULL_GRID)
    host = CsrMatrix.from_matrix_market(mm)
    dia = DiaMatrix.from_matrix_market(mm)
    t_host = time.perf_counter() - t0
    t0 = time.perf_counter()
    hier = fused_block_setup(host)
    t_setup = time.perf_counter() - t0
    del host, mm
    label = f"poisson2d({AMG_FULL_GRID},{AMG_FULL_GRID})"
    _say(f"[21 amg] host {label}: built in {t_host:.1f} s; "
         f"fused_block_setup {t_setup:.1f} s: levels "
         f"{[lv.n_pad for lv in hier.levels]} + coarse "
         f"{hier.coarse_inv.shape[0]}, operator complexity "
         f"{hier.operator_complexity:.3f}")
    A = DeviceDia.from_host(dia, dtype=f32, device=device)
    b = A(torch.ones(A.num_columns, dtype=f32, device=device))
    out = {"shape": f"{label} float32", "host_setup_s": t_setup,
           "level_rows": [lv.n_pad for lv in hier.levels]
           + [hier.coarse_inv.shape[0]]}
    t0 = time.perf_counter()
    preconds = {
        "fused": fused_vcycle_preconditioner(hierarchy=hier, dtype=f32,
                                             device=device),
        "block": block_amg_preconditioner(hierarchy=hier, dtype=f32,
                                          device=device),
    }
    out["device_setup_s"] = time.perf_counter() - t0
    out["num_diagonals"] = preconds["fused"][1]["num_diagonals"]
    out["level_formats"] = preconds["block"][1]["level_formats"]
    for kind, (apply, _) in preconds.items():
        before = fused_vcycle_core.launches
        res, applies, secs = _pcg(A, b, apply, AMG_TOL, device)
        launched = fused_vcycle_core.launches - before
        x = res.x.double()
        rms = float(torch.linalg.norm(x - 1.0) / np.sqrt(x.numel()))
        it = int(res.iterations)
        out[kind] = {"iterations": it, "applies": applies,
                     "residual_norm": float(res.residual_norm),
                     "solution_rms_error_vs_ones": rms, "seconds": secs,
                     "us_per_iteration": secs / max(it, 1) * 1e6}
        _say(f"[21 amg] PCG {kind} V-cycle to {AMG_TOL}: {it} iterations, "
             f"{applies} applies, residual {float(res.residual_norm):.3e}, "
             f"rms error vs ones {rms:.3e}, {secs * 1e3:.2f} ms "
             f"({out[kind]['us_per_iteration']:.1f} us/iteration, host "
             f"clock), K8 launches +{launched}, on {smi_line}")
        if not (np.isfinite(rms) and rms <= CG_RMS_ERR
                and float(res.residual_norm) <= AMG_TOL * float(
                    torch.linalg.norm(b.double()))):
            _fail(f"PCG {kind}: did not converge (rms {rms})")
        if kind == "fused" and launched != applies:
            _fail(f"K8 launched {launched} times for {applies} applies")
        if kind == "block" and launched != 0:
            _fail("the block V-cycle launched K8")
    if abs(out["fused"]["iterations"] - out["block"]["iterations"]) > 1:
        _fail(f"K8's PCG took {out['fused']['iterations']} iterations, the "
              f"block V-cycle's {out['block']['iterations']}")
    del preconds, A, b, dia
    _sync(device)
    return hier, out


@_walled
def phase_kernel_fused(device, hier, smi_line, triad_gbps):
    """K8 alone at the full-size leg's shape (not counted): bitwise
    repeat, max error against the plain version, device ms (a CUDA graph
    of AMG_GRAPH_REPS launches, the L2 flushed before each), the grid
    barriers of one launch (the advance of the barrier's generation
    word), ms a call through the wrapper, the plain version's ms, and the
    yardstick: the port's block_vcycle (K1 per level and torch
    element-wise ops) eager and under one CUDA graph; and K8's time by
    level (the V-cycle from each level down, timed alike).  The bound:
    each input read once and y written once (bytes), and the flops of
    the matvecs K8 runs."""
    import torch

    from spmv_tpu_torch.ops import (
        fused_vcycle_core,
        fused_vcycle_device,
        fused_vcycle_reference,
    )
    from spmv_tpu_torch.ops.amg import block_amg_device, block_vcycle
    from spmv_tpu_torch.ops.fused_vcycle import FusedVcycle

    f32 = torch.float32
    fv = fused_vcycle_device(hier, dtype=f32, device=device)
    bd = block_amg_device(hier, dtype=f32, device=device)
    g = torch.Generator(device=device).manual_seed(5)
    b = torch.randn(fv.padded_rows, generator=g, device=device, dtype=f32)
    y1, y2 = fused_vcycle_core(fv, b), fused_vcycle_core(fv, b)
    _sync(device)
    if not torch.equal(y1, y2):
        _fail("K8 at full size: two launches differ")
    want = fused_vcycle_reference(fv, b)
    err = float((y1.double() - want.double()).abs().max())
    rel = _norm_rel(y1, want)
    if rel > TOL_K8_F32:
        _fail(f"K8 at full size: relative error {rel} > {TOL_K8_F32}")
    e_block = _norm_rel(block_vcycle(bd, b), want)
    if e_block > TOL_K8_F32:
        _fail(f"block V-cycle at full size: {e_block} > {TOL_K8_F32}")
    del y1, y2, want
    # the grid barriers of one launch: the generation word advances once
    # a barrier, and the arrival counter is back at 0 after each launch
    gen = int(fv.barrier[1])
    fused_vcycle_core(fv, b)
    _sync(device)
    barriers = int(fv.barrier[1]) - gen
    if int(fv.barrier[0]) != 0 or barriers <= 0:
        _fail(f"K8's grid barrier after a launch: {fv.barrier.tolist()}")
    out = torch.empty_like(b)
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    ms = _cold_graph_ms(lambda: fused_vcycle_core(fv, b, out=out),
                        lambda: scratch.fill_(0.0), AMG_GRAPH_REPS)
    # where the time goes: the V-cycle from level k down, timed alike
    from_level = []
    for k in range(len(fv.levels)):
        sub = FusedVcycle(list(fv.levels)[k:], list(fv.dinv)[k:], fv.coarse,
                          fv.omegas[k:], fv.los[k:], fv.his[k:],
                          fv.wscales[k:], fv.smoothed[k:], fv.block,
                          fv.degree, fv.rows[k], fv.rows[k])
        bk = torch.randn(fv.rows[k], generator=g, device=device, dtype=f32)
        yk = torch.empty_like(bk)
        from_level.append(_cold_graph_ms(
            lambda: fused_vcycle_core(sub, bk, out=yk),
            lambda: scratch.fill_(0.0), AMG_GRAPH_REPS))
    by_level = [a - b for a, b in zip(from_level, from_level[1:])] \
        + from_level[-1:]
    _say("[22 k8] by level (the V-cycle from level k down, less the one "
         "from k + 1; the last with the coarse solve): " + ", ".join(
             f"level {k} ({n} rows) {t:.4f} ms" for k, (n, t) in
             enumerate(zip(fv.rows, by_level))) + f", on {smi_line}")
    eager_ms = _time_launches(lambda: fused_vcycle_core(fv, b, out=out), 10)
    plain_ms = _time_launches(lambda: fused_vcycle_reference(fv, b), 2)
    block_eager = _time_launches(lambda: block_vcycle(bd, b), 5)
    block_graph = _cold_graph_ms(lambda: block_vcycle(bd, b),
                                 lambda: scratch.fill_(0.0), AMG_GRAPH_REPS)
    nbytes = (_nbytes(*fv.data, *fv.dinv, fv.coarse, b, out)
              + sum(a.offsets_dev.numel() * 4 for a in fv.levels))
    # the matvecs K8 runs (degree 3: 8 at a smoothed level, 6 at a plain
    # one) and the dense coarse product
    mvs = sum((8 if s else 6) * 2 * len(o) * n
              for s, o, n in zip(fv.smoothed, fv.offsets, fv.rows))
    bound = _bound(nbytes, mvs + 2 * fv.coarse.numel(), triad_gbps)
    res = {"max_abs_err": err, "max_rel_err_2norm": rel, "ms": ms,
           "eager_ms": eager_ms, "plain_ms": plain_ms,
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "bound_triad_ms": bound["bound_triad_ms"],
           "bytes": bound["bytes"], "flops": bound["flops"],
           "library_ms": None, "block_vcycle_eager_ms": block_eager,
           "block_vcycle_graph_ms": block_graph,
           "block_vcycle_rel_err": e_block, "grid_barriers": barriers,
           "ms_by_level": by_level,
           "shape": f"poisson2d({AMG_FULL_GRID},{AMG_FULL_GRID}) float32, "
                    f"levels {list(fv.rows)} + {fv.coarse.shape[0]}"}
    _say(f"[22 k8] K8 at {res['shape']}, {barriers} grid barriers a "
         f"launch: {ms:.4f} ms on the device (CUDA "
         f"graph, L2 flushed), {eager_ms:.4f} ms a call through the wrapper, "
         f"plain {plain_ms:.3f} ms, bound {bound['bound_ms']:.4f} ms "
         f"({bound['bound_by']}, {nbytes} B, {bound['flops']} flop); block "
         f"V-cycle (K1 + torch) {block_eager:.3f} ms eager, {block_graph:.4f}"
         f" ms under one CUDA graph (L2 flushed); max abs err {err:.3e} "
         f"(rel {rel:.3e}), bitwise repeatable, on {smi_line}")
    del fv, bd, b, out, scratch
    _sync(device)
    return res


# ------------------------------------------- the reference formats (23-25)
def _port_wrappers() -> dict:
    """Every launch counter of the port, by wrapper name."""
    from spmv_tpu_torch import ops

    return {name: getattr(ops, name) for name in (
        "dia_spmv_core", "dia_spmm_core", "wellcw_merged_core",
        "wellcw_level_core", "wellcw_pool_core", "wellcw_merged_spmm_core",
        "wellcw_level_spmm_core", "wellcw_pool_spmm_core", "csr_spmv_core",
        "csr_spmm_core", "ell_spmv_core", "ell_spmm_core", "well_whole_core",
        "well_seg_core", "well_whole_spmm_core", "well_seg_spmm_core",
        "bsr_spmm_core", "fused_vcycle_core", "csr_regular_core",
        "csr_irregular_core", "ell_regular_core", "ell_irregular_core",
        "well_regular_core", "well_irregular_core")}


def _formats_cli_runs(poisson, skewed):
    """(name, argv, wrappers that must launch, wrappers that must not) of
    the formats' CLI phase: each format's profile, SpMM and CG runs on
    poisson2d(FORMATS_CLI_GRID²) (a stencil: the hybrid split leaves its
    COO part empty, so hybrid launches no CSR kernel there) and hybrid's
    profile and SpMM on a skewed matrix, where it launches both."""
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        csr_spmv_core,
        ell_spmm_core,
        ell_spmv_core,
    )

    spmv_k = {"csr": (csr_spmv_core,), "coo": (csr_spmv_core,),
              "coo-atomic": (csr_spmv_core,), "ell": (ell_spmv_core,),
              "hybrid": (ell_spmv_core,), "xla-csr": ()}
    spmm_k = {"csr": (csr_spmm_core,), "coo": (csr_spmm_core,),
              "coo-atomic": (csr_spmm_core,), "ell": (ell_spmm_core,),
              "hybrid": (ell_spmm_core,), "xla-csr": ()}
    every = tuple(_port_wrappers().values())

    def quiet(want):
        return tuple(w for w in every if w not in want)

    runs = []
    for fmt in FORMATS:
        mat = ["--matrix", poisson, "-s", fmt]
        runs += [
            (f"{fmt} profile", mat + ["--profile", "5"], spmv_k[fmt],
             quiet(spmv_k[fmt])),
            (f"{fmt} spmm k={FORMATS_SPMM_K}",
             mat + ["--profile", "5", "--spmm", str(FORMATS_SPMM_K)],
             spmm_k[fmt], quiet(spmm_k[fmt])),
            (f"{fmt} cg", mat + ["--cg", str(FORMATS_CG_ITERS), "--cg-tol",
                                 "1e-5"], spmv_k[fmt], quiet(spmv_k[fmt])),
        ]
        if fmt in ("ell", "hybrid"):
            runs += [
                (f"{fmt} cg jacobi", mat + [
                    "--cg", str(FORMATS_CG_ITERS), "--cg-tol", "1e-5",
                    "--precondition", "jacobi"], spmv_k[fmt],
                 quiet(spmv_k[fmt])),
                (f"{fmt} cg nrhs {FORMATS_NRHS}", mat + [
                    "--cg", str(FORMATS_CG_ITERS), "--cg-tol", "1e-5",
                    "--nrhs", str(FORMATS_NRHS)], spmm_k[fmt],
                 quiet(spmm_k[fmt])),
            ]
    mat = ["--matrix", skewed, "-s", "hybrid"]
    both = (ell_spmv_core, csr_spmv_core)
    both_mm = (ell_spmm_core, csr_spmm_core)
    runs += [
        ("hybrid profile (skewed)", mat + ["--profile", "5"], both,
         quiet(both)),
        (f"hybrid spmm k={FORMATS_SPMM_K} (skewed)",
         mat + ["--profile", "5", "--spmm", str(FORMATS_SPMM_K)], both_mm,
         quiet(both_mm)),
        ("csr profile --reorder rcm", ["--matrix", poisson, "-s", "csr",
                                        "--reorder", "rcm", "--profile", "5"],
         (csr_spmv_core,), quiet((csr_spmv_core,))),
    ]
    return runs


def _format_checksums(fmt, mm, device):
    """The fp64 host checksum gate of A x and A X (k = FORMATS_SPMM_K)
    through ``make_kernel(fmt)``'s chained steps on the card: |A x| summed
    in float32 on the card against the fp64 host product."""
    import torch

    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.models import CsrMatrix

    host = CsrMatrix.from_matrix_market(mm)
    kernel = make_kernel(fmt, mm=mm, device=device, dtype=torch.float32)
    kernel.init()
    rng = np.random.default_rng(7)
    rels = {}
    for what, shape, fn in (
            ("spmv", (mm.num_columns,), kernel.run_fn),
            ("spmm", (mm.num_columns, FORMATS_SPMM_K),
             lambda: kernel.spmm_fn(FORMATS_SPMM_K))):
        x = rng.standard_normal(shape).astype(np.float32)
        step, args = fn()
        y = step(torch.from_numpy(x).to(device), args[1])
        got = float(y.abs().sum(dtype=torch.float32))
        xd = x.astype(np.float64)
        want = float(np.abs(host.spmv(xd) if xd.ndim == 1 else np.stack(
            [host.spmv(xd[:, j]) for j in range(xd.shape[1])], 1)).sum())
        rels[what] = abs(got - want) / want
        if not rels[what] <= CHECKSUM_RTOL:
            _fail(f"{fmt} {what} checksum gate: {rels[what]} > "
                  f"{CHECKSUM_RTOL}")
    return rels


@_walled
def phase_cli_formats(device):
    """The reference tool's formats through the CLI (phase 23): each
    format's runs, the wrappers each must launch and those it must not
    (none of the port's kernels for xla-csr, no CSR kernel for hybrid
    where its COO part is empty), CG to (j + 1) * ones, and each format's
    fp64 host checksum of A x and A X through ``make_kernel``."""
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d, powerlaw
    from spmv_tpu_torch.models import HybridMatrix

    tag = "23 formats cli"
    pmm = poisson2d(FORMATS_CLI_GRID, FORMATS_CLI_GRID)
    smm = powerlaw(FORMATS_SKEW_ROWS, FORMATS_SKEW_ROWS, 8.0, seed=5)
    h = HybridMatrix.from_matrix_market(smm)
    if h.num_coo_entries == 0:
        _fail("the skewed CLI matrix has no COO part")
    with tempfile.TemporaryDirectory() as tmp:
        poisson = os.path.join(tmp, "poisson.mtx")
        skewed = os.path.join(tmp, "skewed.mtx")
        write_matrix_market(pmm, poisson)
        write_matrix_market(smm, skewed)
        _say(f"[{tag}] poisson2d({FORMATS_CLI_GRID}, {FORMATS_CLI_GRID}) "
             f"and powerlaw({FORMATS_SKEW_ROWS}, {FORMATS_SKEW_ROWS}, 8.0) "
             f"(hybrid: ELL width {h.ell_row_length}, "
             f"{h.num_coo_entries} COO entries)")
        for name, argv, must, must_not in _formats_cli_runs(poisson, skewed):
            before = [w.launches for w in must_not]
            _run_cli(tag, [(name, argv, must)])
            moved = [w.__name__ for w, b in zip(must_not, before)
                     if w.launches != b]
            if moved:
                _fail(f"CLI {name}: launched {moved}, which its path does "
                      "not run")
    checksums = {}
    for fmt in FORMATS:
        mm = smm if fmt == "hybrid" else pmm
        checksums[fmt] = _format_checksums(fmt, mm, device)
        _say(f"[{tag}] {fmt}: checksum rel err A x "
             f"{checksums[fmt]['spmv']:.3e}, A X "
             f"{checksums[fmt]['spmm']:.3e} (gate {CHECKSUM_RTOL})")
    _sync(device)
    return checksums


def _ell_bytes(A, k: int = 1) -> int:
    """The bytes an ELL product must move: the slots once, x (X) and y
    (Y) once."""
    vb = A.value.element_size()
    return (_nbytes(A.column_index, A.value)
            + (A.num_columns + A.num_rows) * k * vb)


def _csr_bytes(R, k: int = 1, rows_written: int = None,
               add: bool = False) -> int:
    """The bytes a CSR product must move: the entries, ``row_ptr``, X once
    and the rows of Y written (every row, or ``rows_written``; read too
    with ``add``)."""
    vb = R.value.element_size()
    n = R.num_rows if rows_written is None else rows_written
    return (_nbytes(R.row_ptr, R.column_index, R.value)
            + (R.num_columns + n * (2 if add else 1)) * k * vb)


def _alone(fn, flush) -> dict:
    """Device ms (a CUDA graph of 50, the L2 flushed before each) and
    eager ms a call through the wrapper."""
    return {"ms": _cold_graph_ms(fn, flush, 50),
            "eager_ms": _time_launches(fn, 50)}


def _ell_compare(A, k, tol, tag, label):
    """ELL SpMV and SpMM (k columns) on A against their plain versions,
    twice bitwise, the SpMM's columns bitwise the SpMV kernel's; returns
    (x, X, max abs err SpMV, max abs err SpMM)."""
    import torch

    from spmv_tpu_torch.ops import (
        ell_spmm_core,
        ell_spmv_core,
        ell_spmv_reference,
    )

    dt, dev = A.value.dtype, A.value.device
    g = torch.Generator(device=dev).manual_seed(21)
    x = torch.randn(A.num_columns, generator=g, device=dev, dtype=dt)
    X = torch.randn(A.num_columns, k, generator=g, device=dev, dtype=dt)
    y1, y2 = ell_spmv_core(A, x), ell_spmv_core(A, x)
    Y1, Y2 = ell_spmm_core(A, X), ell_spmm_core(A, X)
    cols = torch.stack([ell_spmv_core(A, X[:, j].contiguous())
                        for j in range(k)], dim=1)
    want, Want = ell_spmv_reference(A, x), ell_spmv_reference(A, X)
    _sync(dev)
    if not (torch.equal(y1, y2) and torch.equal(Y1, Y2)):
        _fail(f"ELL {label}: two launches differ")
    if not torch.equal(Y1, cols):
        _fail(f"ELL {label}: an SpMM column differs from the SpMV kernel's")
    errs = []
    for what, got, ref in (("spmv", y1, want), (f"spmm k={k}", Y1, Want)):
        rel = _rel(got, ref)
        errs.append(float((got.double() - ref.double()).abs().max()))
        _say(f"[{tag}] ELL {what} {label}: rel err {rel:.3e} against the "
             f"plain version (tol {tol}), max abs err {errs[-1]:.3e}, "
             "twice bitwise equal")
        if not rel <= tol:
            _fail(f"ELL {what} {label}: rel err {rel} > {tol}")
    _say(f"[{tag}] ELL spmm {label}: columns bitwise the SpMV kernel's")
    return x, X, errs[0], errs[1]


@_walled
def phase_profile_ell(device, smi_line):
    """ELL at full width on the main path (phase 24, counted):
    make_kernel("ell")'s chained SpMV and SpMM (k = FORMATS_SPMM_K) at
    poisson2d(FULL_GRID²) in float32, seconds per step and the launches
    of each.  Returns the matrix, its host ELL, its DeviceEll and the
    numbers."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.models import EllMatrix
    from spmv_tpu_torch.ops import ell_spmm_core, ell_spmv_core
    from spmv_tpu_torch.profile import time_kernel

    tag = "24 ell profile"
    t0 = time.perf_counter()
    mm = poisson2d(FULL_GRID, FULL_GRID)
    host = EllMatrix.from_matrix_market(mm)
    _say(f"[{tag}] host poisson2d({FULL_GRID},{FULL_GRID}): "
         f"{host.num_entries} entries, row_length {host.row_length}, "
         f"{host.num_padding_entries} padding slots, built in "
         f"{time.perf_counter() - t0:.1f} s")
    kernel = make_kernel("ell", matrix=host, device=device,
                         dtype=torch.float32)
    kernel.init()
    chained = {}
    for what, (step, args) in (("spmv", kernel.run_fn()),
                               ("spmm", kernel.spmm_fn(FORMATS_SPMM_K))):
        wrapper = ell_spmv_core if what == "spmv" else ell_spmm_core
        before = wrapper.launches
        t = time_kernel(step, args, k_small=8, k_large=72,
                        runs=5).seconds_per_iteration
        if not (np.isfinite(t) and t > 0):
            _fail(f"ELL chained {what}: bad timing {t}")
        chained[what] = {"ms": t * 1e3, "launches": wrapper.launches - before}
        _say(f"[{tag}] make_kernel('ell') chained {what}"
             f"{'' if what == 'spmv' else f' k={FORMATS_SPMM_K}'}: "
             f"{t * 1e3:.4f} ms ({wrapper.__name__} launched "
             f"{chained[what]['launches']} times), on {smi_line}")
        del step, args
    A = kernel.device_matrix()
    del kernel
    _sync(device)
    return mm, host, A, chained


@_walled
def phase_kernels_ell(device, mm, host, A, chained, smi_line, triad_gbps):
    """The ELL kernels alone (phase 24, not counted): against their plain
    versions (float64 at poisson2d(ELL_F64_GRID²), float32 at the main
    path's shape), twice bitwise, the SpMM's columns the SpMV kernel's,
    device ms (a CUDA graph, L2 flushed) and eager, bound, plain ms,
    torch.sparse CSR of the same entries timed the same way and eagerly;
    then the CSR SpMV kernel on the whole matrix as one DeviceCsr (the
    path of -s csr) beside it."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DeviceCsr, DeviceEll, EllMatrix
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        csr_spmv_reference,
        ell_spmm_core,
        ell_spmv_core,
        ell_spmv_reference,
    )

    tag = "24 ell kernels"
    f32, k = torch.float32, FORMATS_SPMM_K
    small = DeviceEll.from_host(EllMatrix.from_matrix_market(
        poisson2d(ELL_F64_GRID, ELL_F64_GRID)), dtype=torch.float64,
        device=device)
    _ell_compare(small, k, TOL_F64, tag,
                 f"poisson2d({ELL_F64_GRID},{ELL_F64_GRID}) float64")
    del small
    label = f"poisson2d({FULL_GRID},{FULL_GRID}) float32"
    x, X, err, err_mm = _ell_compare(A, k, TOL_F32, tag, label)
    y = torch.empty(A.num_rows, device=device, dtype=f32)
    Y = torch.empty(A.num_rows, k, device=device, dtype=f32)
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    S = _csr_of_mm(mm, device, f32)
    out = {}
    for name, fn, plain, v, kk, nbytes, err_k in (
            ("ell_spmv", lambda: ell_spmv_core(A, x, out=y),
             lambda: ell_spmv_reference(A, x), x, 1, _ell_bytes(A), err),
            ("ell_spmm", lambda: ell_spmm_core(A, X, out=Y),
             lambda: ell_spmv_reference(A, X), X, k, _ell_bytes(A, k),
             err_mm)):
        t = _alone(fn, flush)
        plain_ms = _time_launches(plain, 3)
        lib = _library_cold(S, v, flush)
        b = _bound(nbytes, 2 * host.num_entries * kk, triad_gbps)
        out[name] = {**t, "plain_ms": plain_ms, **lib, **b,
                     "max_abs_err": err_k,
                     "chained_ms": chained["spmv" if kk == 1 else "spmm"]["ms"],
                     "shape": label + ("" if kk == 1 else f", k={kk}")}
        _say(f"[{tag}] {name} alone at {out[name]['shape']}: "
             f"{t['ms']:.4f} ms on the device (CUDA graph, L2 flushed), "
             f"{t['eager_ms']:.4f} ms a call through the wrapper, plain "
             f"{plain_ms:.4f} ms, torch.sparse CSR {_library_line(lib)}, "
             f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bytes']} "
             f"B), {b['bound_triad_ms']:.4f} ms at the triad, on {smi_line}")
    out["ell_spmv"]["plan"] = _ell_plan(A, tag, label)
    del Y, X
    R = DeviceCsr(A.num_rows, A.num_columns, host.num_entries,
                  S.crow_indices(), S.col_indices(), S.values())
    out["csr_spmv_whole"] = _csr_spmv_whole(R, S, x, flush, label, tag,
                                            smi_line, triad_gbps)
    del R, S, x, y, scratch
    _sync(device)
    return out


def _ell_plan(A, tag, label) -> dict:
    """The ELL SpMV's path on A (``ell_spmv_plan``), printed."""
    from spmv_tpu_torch.ops._launch import ell_spmv_plan

    plan = ell_spmv_plan(A.padded_row_length)
    _say(f"[{tag}] ell_spmv path at {label}: {plan} (row length "
         f"{A.padded_row_length}, {A.num_rows} rows, a thread a row)")
    return plan


def _csr_spmv_whole(R, S, x, flush, label, tag, smi_line, triad_gbps):
    """The CSR SpMV kernel on a whole matrix held as one ``DeviceCsr``
    (the path of -s csr), alone: against the fp64 product of its entries,
    twice bitwise, device ms and eager, bound, plain ms and ``S``
    (torch.sparse of the same entries) timed the same way and eagerly."""
    import torch

    from spmv_tpu_torch.ops import csr_spmv_core, csr_spmv_reference

    y1, y2 = csr_spmv_core(R, x), csr_spmv_core(R, x)
    want = _float64_product(R, x)
    _sync(x.device)
    rel = _rel(y1, want)
    if not torch.equal(y1, y2) or not rel <= TOL_F32_HOST:
        _fail(f"csr_spmv on {label}: two launches differ or rel err "
              f"{rel} > {TOL_F32_HOST} against the fp64 product")
    y = torch.empty_like(y1)
    t = _alone(lambda: csr_spmv_core(R, x, out=y), flush)
    plain_ms = _time_launches(lambda: csr_spmv_reference(R, x), 3)
    b = _bound(_csr_bytes(R), 2 * R.num_entries, triad_gbps)
    lib = _library_cold(S, x, flush)
    _say(f"[{tag}] csr_spmv on the whole matrix ({label}, one DeviceCsr, "
         f"{R.num_entries} entries): {t['ms']:.4f} ms alone (CUDA graph, L2 "
         f"flushed), {t['eager_ms']:.4f} ms eager, plain {plain_ms:.4f} ms, "
         f"torch.sparse CSR {_library_line(lib)}, bound {b['bound_ms']:.4f} "
         f"ms ({b['bound_by']}, {b['bytes']} B), rel err {rel:.3e}, twice "
         f"bitwise equal, on {smi_line}")
    return {**t, "plain_ms": plain_ms, **lib, **b, "shape": label,
            "max_abs_err": float((y1.double() - want.double()).abs().max())}


def _ell_part_csr(host, lengths, device, dtype):
    """The hybrid's ELL part's own entries (slot s of row i for s <
    min(length_i, ell_row_length)) as a torch CSR on the card."""
    import torch

    L = host.ell_row_length
    keep = np.arange(L)[None, :] < np.minimum(lengths, L)[:, None]
    ptr = np.zeros(host.num_rows + 1, np.int64)
    np.cumsum(keep.sum(axis=1), out=ptr[1:])

    def t(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device, dt)

    return _torch_csr(t(ptr), t(host.ell_column_index[keep]),
                      t(host.ell_value[keep], dtype),
                      (host.num_rows, host.num_columns))


def _split_of(R) -> dict:
    """A DeviceCsr's row split: its warp rows and block rows."""
    n = 0 if R.long_rows is None else R.long_rows.numel()
    return {"long_row": R.long_row_entries, "warp_rows": n - R.num_block_rows,
            "block_rows": R.num_block_rows}


def _long_row_sweep(R, W, x, X, y, Y, flush, tag):
    """The CSR kernels' thresholds (LONG_ROW x BLOCK_ROW, and no split,
    the thread-a-row walk alone) on the hybrid's COO part ``R`` (SpMV
    and SpMM adding into y / Y, as the hybrid calls them) and on the
    whole matrix ``W`` as one DeviceCsr (SpMV): device ms, a CUDA graph of
    20, the L2 flushed before each."""
    from spmv_tpu_torch.models import DeviceCsr
    from spmv_tpu_torch.models import device as device_module
    from spmv_tpu_torch.ops import csr_spmm_core, csr_spmv_core

    def rebuilt(A):
        return DeviceCsr(A.num_rows, A.num_columns, A.num_entries,
                         A.row_ptr, A.column_index, A.value)

    rows = []
    for long_row, block_row in [(t, b) for t in SWEEP_LONG_ROW
                                for b in SWEEP_BLOCK_ROW] + [(NO_SPLIT,
                                                              NO_SPLIT)]:
        with _patched(device_module, "LONG_ROW", long_row), \
                _patched(device_module, "BLOCK_ROW", block_row):
            coo, whole = rebuilt(R), rebuilt(W)
        row = {"long_row": long_row, "block_row": block_row,
               "coo": _split_of(coo), "whole": _split_of(whole)}
        for name, fn in (
                ("coo_spmv_ms", lambda: csr_spmv_core(coo, x, out=y,
                                                      accumulate=True)),
                ("coo_spmm_ms", lambda: csr_spmm_core(coo, X, out=Y,
                                                      accumulate=True)),
                ("whole_spmv_ms", lambda: csr_spmv_core(whole, x, out=y))):
            row[name] = _cold_graph_ms(fn, flush, 20)
        rows.append(row)
        _say(f"[{tag}] sweep LONG_ROW {long_row}, BLOCK_ROW {block_row}: "
             f"COO part {row['coo']}, SpMV {row['coo_spmv_ms']:.4f} ms, "
             f"SpMM k={X.shape[1]} {row['coo_spmm_ms']:.4f} ms; whole "
             f"matrix {row['whole']}, SpMV {row['whole_spmv_ms']:.4f} ms")
        del coo, whole
    return rows


def _amg_sweep(device, tag):
    """The generic V-cycle's CSR operators (A, P, P^T of every level of
    the SA hierarchy of poisson2d(AMG_CLI_GRID²), the CLI's AMG path) at
    each LONG_ROW of the sweep and with no split, float32: their long
    rows, every operator's SpMV once in one CUDA graph (device ms, L2
    warm), and PCG to AMG_TOL with the V-cycle (iterations)."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
    from spmv_tpu_torch.models import device as device_module
    from spmv_tpu_torch.ops import (
        amg_preconditioner,
        csr_spmv_core,
        smoothed_aggregation_setup,
        spmv,
    )

    f32 = torch.float32
    host = CsrMatrix.from_matrix_market(poisson2d(AMG_CLI_GRID,
                                                  AMG_CLI_GRID))
    hier = smoothed_aggregation_setup(host)
    A = DeviceCsr.from_host(host, dtype=f32, device=device)
    b = spmv(A, torch.ones(A.num_columns, dtype=f32, device=device))
    rows = []
    for long_row in SWEEP_LONG_ROW + (NO_SPLIT,):
        with _patched(device_module, "LONG_ROW", long_row):
            apply, _ = amg_preconditioner(hierarchy=hier, dtype=f32,
                                          device=device)
            ops = [DeviceCsr.from_host(CsrMatrix(r, c, len(t[2]), 1, *t),
                                       dtype=f32, device=device)
                   for lv in hier.levels
                   for r, c, t in ((lv.n, lv.n, lv.a),
                                   (lv.n, lv.n_coarse, lv.p),
                                   (lv.n_coarse, lv.n, lv.pt))]
        vs = [(torch.ones(R.num_columns, dtype=f32, device=device),
               torch.empty(R.num_rows, dtype=f32, device=device))
              for R in ops]

        def all_ops():
            for R, (v, out) in zip(ops, vs):
                csr_spmv_core(R, v, out=out)

        res, _, secs = _pcg(A, b, apply, AMG_TOL, device)
        it = int(res.iterations)
        row = {"long_row": long_row,
               "long_rows": sum(0 if R.long_rows is None
                                else R.long_rows.numel() for R in ops),
               "operators_ms": _graph_replay_ms(all_ops, 20),
               "pcg_iterations": it,
               "pcg_ms_per_iteration": secs / max(it, 1) * 1e3}
        rows.append(row)
        _say(f"[{tag}] AMG sweep LONG_ROW {long_row}: {row['long_rows']} "
             f"long rows in {len(ops)} operators, all operators' SpMV "
             f"{row['operators_ms']:.4f} ms (one CUDA graph, L2 warm), PCG "
             f"{it} iterations ({row['pcg_ms_per_iteration']:.3f} ms an "
             "iteration, host clock)")
        del apply, ops, vs
    return rows


@_walled
def phase_hybrid(device, smi_line, triad_gbps):
    """Hybrid at a skewed matrix (phase 25; not counted):
    powerlaw(HYBRID_ROWS, HYBRID_ROWS, 8.0, alpha 1.5, seed 5) in float32:
    the SpMV and SpMM (k = FORMATS_SPMM_K) against their plain versions;
    the COO part's CSR kernels (warp and block rows) against their plain
    versions, twice bitwise, the SpMM's columns bitwise the SpMV's; then
    the ELL launch, the COO launches (the CSR kernels adding into y and
    Y) and the whole SpMV and SpMM alone, each with its bound, beside
    torch.sparse of the whole matrix and of each part's own entries; the
    CSR SpMV on the whole matrix as one DeviceCsr; and the sweep of the
    CSR kernels' row-split thresholds here and on the AMG path."""
    import torch

    from spmv_tpu_torch.io.generate import powerlaw
    from spmv_tpu_torch.models import DeviceCsr, DeviceHybrid, HybridMatrix
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        csr_spmv_core,
        csr_spmv_reference,
        ell_spmv_core,
        ell_spmv_reference,
        hybrid_spmm_core,
        hybrid_spmv_core,
        hybrid_spmv_reference,
    )

    tag = "25 hybrid"
    f32, k = torch.float32, FORMATS_SPMM_K
    t0 = time.perf_counter()
    mm = powerlaw(HYBRID_ROWS, HYBRID_ROWS, 8.0, alpha=1.5, seed=5)
    host = HybridMatrix.from_matrix_market(mm)
    lengths = np.bincount(np.asarray(mm.rows_1based) - 1,
                          minlength=mm.num_rows)
    H = DeviceHybrid.from_host(host, dtype=f32, device=device)
    R = H.coo
    coo_lengths = np.diff(R.row_ptr.cpu().numpy())
    coo_rows = int((coo_lengths > 0).sum())
    label = (f"powerlaw({HYBRID_ROWS}, {HYBRID_ROWS}, 8.0, alpha 1.5, "
             "seed 5) float32")
    shape = {"entries": host.num_entries, "longest_row": int(lengths.max()),
             "ell_row_length": host.ell_row_length,
             "ell_slots": host.ell_value.size,
             "coo_entries": host.num_coo_entries, "coo_rows": coo_rows,
             "longest_coo_row": int(coo_lengths.max()),
             "coo_split": _split_of(R)}
    _say(f"[{tag}] host {label}: {shape}, built in "
         f"{time.perf_counter() - t0:.1f} s")
    g = torch.Generator(device=device).manual_seed(22)
    x = torch.randn(H.num_columns, generator=g, device=device, dtype=f32)
    X = torch.randn(H.num_columns, k, generator=g, device=device, dtype=f32)
    errs = {}
    S64 = _csr_of_mm(mm, device, torch.float64)
    for what, got, ref in (
            ("spmv", hybrid_spmv_core(H, x), S64 @ x.double()),
            (f"spmm k={k}", hybrid_spmm_core(H, X), S64 @ X.double())):
        rel = _rel(got, ref)
        errs[what] = float((got.double() - ref).abs().max())
        _say(f"[{tag}] hybrid {what}: rel err {rel:.3e} against the fp64 "
             f"product (tol {TOL_F32_HOST})")
        if not rel <= TOL_F32_HOST:
            _fail(f"hybrid {what}: rel err {rel} > {TOL_F32_HOST}")
    del S64
    # the COO part's CSR kernels alone, on their warp, block and short rows
    yc = (csr_spmv_core(R, x), csr_spmv_core(R, x))
    Yc = (csr_spmm_core(R, X), csr_spmm_core(R, X))
    cols = torch.stack([csr_spmv_core(R, X[:, j].contiguous())
                        for j in range(k)], dim=1)
    _sync(device)
    if not (torch.equal(*yc) and torch.equal(*Yc)):
        _fail("the COO part's CSR kernels: two launches differ")
    if not torch.equal(Yc[0], cols):
        _fail("the COO part's CSR SpMM: a column differs from the CSR "
              "SpMV kernel's")
    for what, got, ref in (("spmv", yc[0], _float64_product(R, x)),
                           (f"spmm k={k}", Yc[0], _float64_product(R, X))):
        rel = _rel(got, ref)
        errs[f"coo {what}"] = float((got.double() - ref).abs().max())
        _say(f"[{tag}] the COO part's csr {what} ({shape['coo_split']}): "
             f"rel err {rel:.3e} against the fp64 product (tol "
             f"{TOL_F32_HOST}), twice bitwise equal"
             + (", columns bitwise the SpMV kernel's" if what != "spmv"
                else ""))
        if not rel <= TOL_F32_HOST:
            _fail(f"the COO part's csr {what}: rel err {rel} > "
                  f"{TOL_F32_HOST}")
    del yc, Yc, cols
    y = torch.empty(H.num_rows, device=device, dtype=f32)
    Y = torch.empty(H.num_rows, k, device=device, dtype=f32)
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    S = _csr_of_mm(mm, device, f32)
    nnz = host.num_entries
    coo_mm = _csr_spmm_bytes(R, k)
    parts = {
        "ell_launch": (lambda: ell_spmv_core(H.ell, x, out=y),
                       _ell_bytes(H.ell), 2 * host.num_ell_entries),
        "coo_launch": (lambda: csr_spmv_core(R, x, out=y, accumulate=True),
                       _csr_bytes(R, rows_written=coo_rows, add=True),
                       2 * host.num_coo_entries),
        f"coo_launch_spmm_k{k}": (
            lambda: csr_spmm_core(R, X, out=Y, accumulate=True),
            coo_mm["accumulate"], 2 * host.num_coo_entries * k),
        "whole_spmv": (lambda: hybrid_spmv_core(H, x, out=y),
                       _ell_bytes(H.ell) + _nbytes(
                           R.row_ptr, R.column_index, R.value),
                       2 * nnz),
        f"whole_spmm_k{k}": (lambda: hybrid_spmm_core(H, X, out=Y),
                             _ell_bytes(H.ell, k) + _nbytes(
                                 R.row_ptr, R.column_index, R.value),
                             2 * nnz * k),
    }
    out = {"shape": label, **shape, "max_abs_err": errs["spmv"],
           "max_abs_err_spmm": errs[f"spmm k={k}"],
           "max_abs_err_coo": errs["coo spmv"],
           "max_abs_err_coo_spmm": errs[f"coo spmm k={k}"]}
    for name, (fn, nbytes, flops) in parts.items():
        t = _alone(fn, flush)
        b = _bound(nbytes, flops, triad_gbps)
        out[name] = {**t, **b}
        _say(f"[{tag}] {name}: {t['ms']:.4f} ms alone (CUDA graph, L2 "
             f"flushed), {t['eager_ms']:.4f} ms eager, bound "
             f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {b['bytes']} B), "
             f"on {smi_line}")
    out["ell_launch"]["plain_ms"] = _time_launches(
        lambda: ell_spmv_reference(H.ell, x), 3)
    out["ell_launch"]["plan"] = _ell_plan(H.ell, tag, label + ", ELL part")
    out["coo_launch"]["plain_ms"] = _time_launches(
        lambda: csr_spmv_reference(R, x), 3)
    out[f"coo_launch_spmm_k{k}"]["plain_ms"] = _time_launches(
        lambda: csr_spmv_reference(R, X), 3)
    # torch.sparse of the whole matrix and of each part's own entries
    S_coo = _torch_csr(R.row_ptr, R.column_index, R.value,
                       (R.num_rows, R.num_columns))
    S_ell = _ell_part_csr(host, lengths, device, f32)
    for name, M, v in (("library_spmv", S, x), (f"library_spmm_k{k}", S, X),
                       ("library_coo_spmv", S_coo, x),
                       (f"library_coo_spmm_k{k}", S_coo, X),
                       ("library_ell_spmv", S_ell, x),
                       (f"library_ell_spmm_k{k}", S_ell, X)):
        out[name] = _library_cold(M, v, flush)
        _say(f"[{tag}] torch.sparse CSR ({name}, {M._nnz()} entries): "
             f"{_library_line(out[name])}")
    for what, mine, lib in (
            ("the COO launch", out["coo_launch"]["ms"], None),
            ("the whole SpMV", out["whole_spmv"]["ms"],
             out["library_spmv"]["library_ms"]),
            (f"the whole SpMM k={k}", out[f"whole_spmm_k{k}"]["ms"],
             out[f"library_spmm_k{k}"]["library_ms"])):
        limit = HYBRID_COO_LIMIT_MS if lib is None else lib
        _say(f"[{tag}] {what}: {mine:.4f} ms against "
             + ("the 0.35 ms goal" if lib is None else
                f"torch.sparse's {lib:.4f} ms")
             + (": met" if mine <= limit else ": missed"))
    out["plain_ms"] = _time_launches(lambda: hybrid_spmv_reference(H, x), 3)
    # the whole matrix as one DeviceCsr (the path of -s csr)
    W = DeviceCsr(H.num_rows, H.num_columns, nnz, S.crow_indices(),
                  S.col_indices(), S.values())
    out["csr_spmv_whole"] = {**_csr_spmv_whole(
        W, S, x, flush, label, tag, smi_line, triad_gbps), **_split_of(W)}
    out["sweep"] = _long_row_sweep(R, W, x, X, y, Y, flush, tag)
    del H, R, W, S, S_coo, S_ell, x, X, y, Y, scratch
    _sync(device)
    out["amg_sweep"] = _amg_sweep(device, tag)
    return out, mm, host


# ----------------------------------------------------------------- main
@_walled
def phase_bsr_path(device, smi_line, triad_gbps):
    """The BSR path's run (CLI, the bench's leg in float32 and bf16, the
    leg past the 80 MB line): K7's counts start from zero here; each
    launch is tallied under the Pallas kernel its X size selects and
    under the path (tensor cores or SIMT) its shape selects."""
    from spmv_tpu_torch.ops import bsr_spmm_core

    bsr_spmm_core.launches = 0
    bsr_spmm_core.tensor_core_launches = 0
    bsr_spmm_core.simt_launches = 0
    launches, cli_paths = phase_cli_bsr(device)
    times, keep, leg_launches = phase_bsr_legs(device, smi_line, triad_gbps)
    host = keep.pop("host")
    for r, n in leg_launches.items():
        launches[r] = launches.get(r, 0) + n
    if sum(launches.values()) != bsr_spmm_core.launches:
        _fail(f"K7 launches {launches} do not add up to the wrapper's "
              f"{bsr_spmm_core.launches}")
    paths = {"bsr_spmm_wholex": {
        p: cli_paths[p] + sum(times[d]["launches_by_path"][p]
                              for d in ("float32", "bfloat16"))
        for p in cli_paths}, "bsr_spmm": times["far"]["launches_by_path"]}
    if {p: sum(v[p] for v in paths.values()) for p in cli_paths} \
            != _bsr_path_counts():
        _fail(f"K7 launches by path {paths} do not add up to the wrapper's "
              f"{_bsr_path_counts()}")
    _say("[18 bsr] launches on the BSR path: " + ", ".join(
        f"{k} {n} ({paths[k]})" for k, n in launches.items()))
    for name in ("bsr_spmm_wholex", "bsr_spmm"):
        if launches.get(name, 0) <= 0:
            _fail(f"{name} was never launched on the BSR path")
    return {"launches": launches, "paths": paths, "times": times,
            "keep": keep, "host": host}


def _bsr_rows(run, spmm_kernels) -> list:
    """The K7 rows of the kernels' JSON line: K7b on the bench's leg
    (float32 on the SIMT path, bf16 on the tensor cores) and K7a past the
    80 MB line (float32)."""
    times = run["times"]
    keys = ("plain_ms", "bound_ms", "bound_by", "bound_triad_ms", "bytes",
            "flops")
    rows = []
    for name, line, key, leg, shape, extra in (
            ("bsr_spmm_wholex", 918, "float32", times["float32"],
             times["shape"], {
                 f"{f}_bf16": v for f, v in
                 {**times["bfloat16"],
                  **spmm_kernels[("bsr_spmm_wholex", "bfloat16")]}.items()
                 if f in ("ms", "max_abs_err", "plain_ms", "library_ms",
                          "bound_ms", "bound_by", "tflops", "path",
                          "timing")} | {
                 "source_bf16": "spmv_tpu_torch/csrc/bsr_spmm_tc.cu"}),
            ("bsr_spmm", 896, "far", times["far"], times["far"]["shape"],
             {})):
        rows.append({
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/bsr_spmm.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": run["launches"][name],
            "launches_by_path": run["paths"][name],
            **{k: leg[k] for k in keys},
            **spmm_kernels[(name, key)],
            "chained_ms": leg["ms"],
            "tflops_chained": leg["tflops"],
            **extra,
            "shape": f"{shape} float32",
        })
    return rows


# --------------------------------------------------- traffic split (26, 27)
TRAFFIC_FORMATS = ("csr", "coo", "ell", "hybrid", "well")
TRAFFIC_CLI_GRID = 256        # the CLI's --traffic-split runs' poisson2d
TRAFFIC_F64_GRID = 1024       # the variants' float64 checks
SIM_CONFIG = "configs/cpu-2thread.json"
SIM_RUNS = (("csr", 256), ("ell", 256), ("well", 256), ("dia", 256),
            ("csr", 512))


def _traffic_wrappers() -> dict:
    """The six traffic variants' launch counters, by name."""
    from spmv_tpu_torch import ops

    return {name: getattr(ops, f"{name}_core") for name in (
        "csr_regular", "csr_irregular", "ell_regular", "ell_irregular",
        "well_regular", "well_irregular")}


def _traffic_legs(A):
    """(full, regular, irregular) of A as functions of (x, out), and the
    wrappers each must launch."""
    from spmv_tpu_torch import ops
    from spmv_tpu_torch.models import DeviceCsr, DeviceEll, DeviceWell

    if isinstance(A, DeviceCsr):
        kind, full = "csr", (ops.csr_spmv_core,)
    elif isinstance(A, DeviceEll):
        kind, full = "ell", (ops.ell_spmv_core,)
    elif isinstance(A, DeviceWell):
        kind = "well"
        full = ((ops.well_seg_core,) if A.segment_of_step is not None
                else (ops.well_whole_core,))
    else:
        coo = A.coo.value.numel() > 0
        pick = lambda *w: w if coo else w[:1]  # noqa: E731
        return ({"full": (lambda x, y: ops.hybrid_spmv_core(A, x, out=y),
                          pick(ops.ell_spmv_core, ops.csr_spmv_core)),
                 "regular": (lambda x, y: ops.hybrid_regular_core(A, out=y),
                             pick(ops.ell_regular_core,
                                  ops.csr_regular_core)),
                 "irregular": (lambda x, y: ops.hybrid_irregular_core(
                     A, x, out=y), pick(ops.ell_irregular_core,
                                        ops.csr_irregular_core))})
    core = {"csr": ops.csr_spmv_core, "ell": ops.ell_spmv_core,
            "well": ops.well_spmv_core}[kind]
    reg = getattr(ops, f"{kind}_regular_core")
    irr = getattr(ops, f"{kind}_irregular_core")
    return {"full": (lambda x, y: core(A, x, out=y), full),
            "regular": (lambda x, y: reg(A, out=y), (reg,)),
            "irregular": (lambda x, y: irr(A, x, out=y), (irr,))}


def _traffic_plain(A, x, leg):
    """The plain version of A's ``leg`` ("regular" or "irregular"); the
    hybrid's adds its COO part's to its ELL part's."""
    from spmv_tpu_torch import ops
    from spmv_tpu_torch.models import DeviceCsr, DeviceEll, DeviceHybrid

    if isinstance(A, DeviceHybrid):
        y = _traffic_plain(A.ell, x, leg)
        return (y + _traffic_plain(A.coo, x, leg) if A.coo.value.numel()
                else y)
    kind = ("csr" if isinstance(A, DeviceCsr) else
            "ell" if isinstance(A, DeviceEll) else "well")
    plain = getattr(ops, f"{kind}_{leg}_reference")
    return plain(A) if leg == "regular" else plain(A, x)


def _traffic_check(A, tol, tag, label) -> dict:
    """Each variant of A against its plain version, launched twice (bitwise
    equal), and each leg launching its own kernels and nothing else of
    the port; returns the max abs errors."""
    import torch

    every = _port_wrappers()
    dev = A.ell.value.device if hasattr(A, "ell") else A.value.device
    dt = A.ell.value.dtype if hasattr(A, "ell") else A.value.dtype
    g = torch.Generator(device=dev).manual_seed(26)
    x = torch.randn(A.num_columns, generator=g, device=dev, dtype=dt)
    legs = _traffic_legs(A)
    outs = {}
    for leg, (fn, wrappers) in legs.items():
        before = {n: w.launches for n, w in every.items()}
        y1 = fn(x, None)
        moved = {n: w.launches - before[n] for n, w in every.items()
                 if w.launches != before[n]}
        want = {w.__name__: 1 for w in wrappers}
        if moved != want:
            _fail(f"{label} {leg} leg launched {moved}, expected {want}")
        y2 = fn(x, None)
        _sync(dev)
        if not torch.equal(y1, y2):
            _fail(f"{label} {leg} leg: two launches differ")
        outs[leg] = y1
    errs = {}
    for leg in ("regular", "irregular"):
        ref = _traffic_plain(A, x, leg)
        rel = _rel(outs[leg], ref)
        errs[leg] = float((outs[leg].double() - ref.double()).abs().max())
        _say(f"[{tag}] {label} {leg}: rel err {rel:.3e} against the plain "
             f"version (tol {tol}), max abs err {errs[leg]:.3e}, twice "
             "bitwise equal, launched only its own kernels")
        if not rel <= tol:
            _fail(f"{label} {leg}: rel err {rel} > {tol}")
    return errs


def _traffic_yardsticks(A, S, x, flush) -> dict:
    """Per leg, one PyTorch call for the same function: torch.sparse of
    the whole matrix (full), its value sums (regular: torch.sum over the
    ELL slots, else torch.segment_reduce over the entries' CSR) and
    torch.sparse with unit values (irregular)."""
    import torch

    from spmv_tpu_torch.models import DeviceEll

    ptr = S.crow_indices().long()
    vals = S.values()
    U = _torch_csr(S.crow_indices(), S.col_indices(), torch.ones_like(vals),
                   tuple(S.shape))
    if isinstance(A, DeviceEll):
        reg = lambda: torch.sum(A.value, 0)  # noqa: E731
        reg_name = "torch.sum(value, 0)"
    else:
        reg = lambda: torch.segment_reduce(  # noqa: E731
            vals, "sum", offsets=ptr)
        reg_name = "torch.segment_reduce(values, 'sum', offsets=row_ptr)"
    return {"full": {**_library_cold(S, x, flush),
                     "library_call": "torch.sparse CSR @ x"},
            "regular": {**_yardstick(reg, flush), "library_call": reg_name},
            "irregular": {**_library_cold(U, x, flush),
                          "library_call": "torch.sparse CSR of unit "
                                          "values @ x"}}


def _traffic_case(A, S, label, tag, smi_line, triad_gbps) -> dict:
    """The traffic split of A at full width (not counted): the variants
    against their plain versions, then each leg alone (a CUDA graph, L2
    flushed) and eagerly, beside its bound (``traffic_variant_bytes``
    over the data sheet's rate and over the triad), its plain version's
    time and its one-call yardstick; the additivity of the legs alone."""
    import torch

    from spmv_tpu_torch.ops import traffic_variant_bytes

    errs = _traffic_check(A, TOL_F32, tag, label)
    dev = A.ell.value.device if hasattr(A, "ell") else A.value.device
    dt = torch.float32
    g = torch.Generator(device=dev).manual_seed(27)
    x = torch.randn(A.num_columns, generator=g, device=dev, dtype=dt)
    y = torch.empty(A.num_rows, device=dev, dtype=dt)
    scratch = torch.empty(16 << 20, dtype=dt, device=dev)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    model = traffic_variant_bytes(A, dt)
    stored = model["stored_entries"]
    lib = _traffic_yardsticks(A, S, x, flush)
    out = {"shape": label, "analytic": model}
    for leg, (fn, wrappers) in _traffic_legs(A).items():
        t = _alone(lambda: fn(x, y), flush)
        nbytes = model[f"{leg}_bytes"]
        b = _bound(nbytes, (2 if leg == "full" else 1) * stored, triad_gbps)
        out[leg] = {**t, **b, **lib[leg],
                    "kernels": [w.__name__ for w in wrappers]}
        if leg in errs:
            out[leg]["plain_ms"] = _time_launches(
                lambda: _traffic_plain(A, x, leg), 3)
            out[leg]["max_abs_err"] = errs[leg]
        _say(f"[{tag}] {label} {leg} leg alone: {t['ms']:.4f} ms (CUDA "
             f"graph, L2 flushed), {t['eager_ms']:.4f} ms eager, bound "
             f"{b['bound_ms']:.4f} ms ({b['bound_by']}, {nbytes} B), "
             f"{b['bound_triad_ms']:.4f} ms at the triad; "
             f"{lib[leg]['library_call']} {lib[leg]['library_ms']:.4f} ms "
             f"({lib[leg]['library_timing']}); on {smi_line}")
    out["additivity_alone"] = ((out["regular"]["ms"]
                                + out["irregular"]["ms"]) / out["full"]["ms"])
    out["additivity_of_bounds"] = ((out["regular"]["bound_ms"]
                                    + out["irregular"]["bound_ms"])
                                   / out["full"]["bound_ms"])
    _say(f"[{tag}] {label}: additivity (regular + irregular) / full "
         f"{out['additivity_alone']:.3f} alone, bounds "
         f"{out['additivity_of_bounds']:.3f}")
    del scratch, x, y
    return out


def _traffic_cli(device, tag) -> dict:
    """--profile 5 --traffic-split through the CLI at
    poisson2d(TRAFFIC_CLI_GRID²) on each format (counted), and the
    refusals, each exiting 1 with its message."""
    from spmv_tpu_torch.cli import main
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d

    want_keys = {"format", "rows", "columns", "stored_entries",
                 "seconds_full", "seconds_regular", "seconds_irregular",
                 "regular_fraction_of_full", "irregular_fraction_of_full",
                 "additivity", "analytic", "achieved_gbps",
                 "roofline_fraction"}
    out = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poisson.mtx")
        write_matrix_market(poisson2d(TRAFFIC_CLI_GRID, TRAFFIC_CLI_GRID),
                            path)
        mat = ["--matrix", path]
        for fmt in TRAFFIC_FORMATS:
            buf = io.StringIO()
            rc = main(mat + ["-s", fmt, "--profile", "5",
                             "--traffic-split"], out=buf)
            if rc != 0:
                _fail(f"CLI -s {fmt} --traffic-split exited {rc}")
            ts = json.loads(buf.getvalue())["traffic_split"]
            if set(ts) != want_keys or not all(
                    np.isfinite(ts[k]) and ts[k] > 0 for k in (
                        "seconds_full", "seconds_regular",
                        "seconds_irregular")):
                _fail(f"CLI -s {fmt} --traffic-split: bad section {ts}")
            out[fmt] = {k: ts[k] for k in (
                "seconds_full", "seconds_regular", "seconds_irregular",
                "additivity")}
            _say(f"[{tag}] CLI -s {fmt} --profile 5 --traffic-split at "
                 f"poisson2d({TRAFFIC_CLI_GRID},{TRAFFIC_CLI_GRID}): full "
                 f"{ts['seconds_full'] * 1e3:.4f} ms, regular "
                 f"{ts['seconds_regular'] * 1e3:.4f} ms, irregular "
                 f"{ts['seconds_irregular'] * 1e3:.4f} ms, additivity "
                 f"{ts['additivity']:.3f} (all in the 50 MB L2)")
        for name, argv, says in (
                ("dia", mat + ["-s", "dia"], "not defined for DeviceDia"),
                ("wellcw", mat + ["-s", "wellcw"],
                 "not defined for DeviceWellCw"),
                ("bsr", mat + ["-s", "bsr"], "not defined for DeviceBsr"),
                ("triad", ["--triad", "4096"],
                 "not supported by the triad kernel"),
                ("spmm 8", mat + ["-s", "csr", "--spmm", "8"],
                 "not --spmm")):
            err = io.StringIO()
            with contextlib.redirect_stderr(err):
                rc = main(argv + ["--profile", "5", "--traffic-split"],
                          out=io.StringIO())
            if rc != 1 or says not in err.getvalue():
                _fail(f"CLI --traffic-split {name}: exit {rc}, "
                      f"{err.getvalue()!r}")
            _say(f"[{tag}] CLI --traffic-split {name}: exit 1, "
                 f"{err.getvalue().strip()}")
    return out


@_walled
def phase_traffic(device, ell, well_hosts, hybrid_mm, hybrid_host,
                  smi_line, triad_gbps):
    """The traffic split (phase 26).  The main path, counted (the variant
    counts zeroed just before): the CLI's --profile 5 --traffic-split at
    poisson2d(TRAFFIC_CLI_GRID²), then measure_traffic_split at full
    width, float32: -s ell and -s csr at poisson2d(FULL_GRID²), -s well at
    poisson2d(FULL_GRID²) (K5b) and poisson2d(WELL_WHOLE_GRID²) (K5a), the
    hybrid at powerlaw(HYBRID_ROWS).  Then, not counted, each case's
    variants against their plain versions and each leg alone beside its
    bound and yardstick (``_traffic_case``), and the variants in float64
    at poisson2d(TRAFFIC_F64_GRID²)."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import (
        CsrMatrix,
        DeviceCsr,
        DeviceEll,
        DeviceWell,
        EllMatrix,
        device_put_matrix,
    )
    from spmv_tpu_torch.perfmodel import measured_machine
    from spmv_tpu_torch.profile import measure_traffic_split

    tag = "26 traffic split"
    f32 = torch.float32
    wrappers = _traffic_wrappers()
    for w in wrappers.values():
        w.launches = 0
    cli = _traffic_cli(device, tag)
    ell_mm, ell_host, ell_A = ell
    S_full = _csr_of_mm(ell_mm, device, f32)
    grid = f"poisson2d({FULL_GRID},{FULL_GRID})"
    cases = {
        f"ell {grid}": (ell_A, S_full),
        f"csr {grid}": (DeviceCsr(ell_A.num_rows, ell_A.num_columns,
                                  ell_host.num_entries, S_full.crow_indices(),
                                  S_full.col_indices(), S_full.values()),
                        S_full),
    }
    for label, (w, segmented) in well_hosts.items():
        W = DeviceWell.from_host(w, dtype=f32, device=device)
        if (W.segment_of_step is not None) != segmented:
            _fail(f"well {label}: not in the expected mode")
        S = (S_full if label == grid else
             _csr_of_mm(poisson2d(WELL_WHOLE_GRID, WELL_WHOLE_GRID), device,
                        f32))
        cases[f"well {label} ({'K5b' if segmented else 'K5a'})"] = (W, S)
    hlabel = f"hybrid powerlaw({HYBRID_ROWS}, {HYBRID_ROWS}, 8.0, alpha 1.5)"
    cases[hlabel] = (device_put_matrix(hybrid_host, dtype=f32, device=device),
                     _csr_of_mm(hybrid_mm, device, f32))
    machine = measured_machine(device)
    chained = {}
    for label, (A, _) in cases.items():
        t0 = time.perf_counter()
        ts = measure_traffic_split(A, machine=machine)
        chained[label] = {k: ts[k] for k in (
            "seconds_full", "seconds_regular", "seconds_irregular",
            "additivity", "roofline_fraction")}
        _say(f"[{tag}] measure_traffic_split {label}: full "
             f"{ts['seconds_full'] * 1e3:.4f} ms, regular "
             f"{ts['seconds_regular'] * 1e3:.4f} ms, irregular "
             f"{ts['seconds_irregular'] * 1e3:.4f} ms chained, additivity "
             f"{ts['additivity']:.3f}, roofline fractions "
             + ", ".join(f"{k} {v:.3f}" for k, v in
                         ts["roofline_fraction"].items())
             + f" ({time.perf_counter() - t0:.1f} s)")
    launches = {n: w.launches for n, w in wrappers.items()}
    _say(f"[{tag}] launches on the traffic-split path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the traffic-split path")
    alone = {label: _traffic_case(A, S, label, tag, smi_line, triad_gbps)
             for label, (A, S) in cases.items()}
    del cases, S_full
    _sync(device)
    f64 = torch.float64
    mm = poisson2d(TRAFFIC_F64_GRID, TRAFFIC_F64_GRID)
    flabel = f"poisson2d({TRAFFIC_F64_GRID},{TRAFFIC_F64_GRID}) float64"
    whole = [w for w, seg in well_hosts.values() if not seg][0]
    errs64 = {}
    for kind, A in (
            ("csr", DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm),
                                        dtype=f64, device=device)),
            ("ell", DeviceEll.from_host(EllMatrix.from_matrix_market(mm),
                                        dtype=f64, device=device)),
            ("well", DeviceWell.from_host(whole, dtype=f64, device=device))):
        errs64[kind] = _traffic_check(A, TOL_F64, tag, f"{kind} {flabel}")
    _sync(device)
    return {"cli": cli, "chained": chained, "alone": alone,
            "launches": launches, "max_abs_err_f64": errs64}


@_walled
def phase_simulate(device):
    """Simulation mode through the CLI (phase 27, host only): --profile 0
    --trace-config SIM_CONFIG on each of SIM_RUNS, the misses per thread
    of each cache, the wall seconds and whether the native replay core
    (csrc/simcache.cpp built under _build/host/) ran; a missing
    --trace-config exits 1."""
    from spmv_tpu_torch.cli import main
    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.perfmodel import native

    tag = "27 simulate"
    repo = os.path.dirname(os.path.abspath(__file__))
    config = os.path.join(repo, SIM_CONFIG)
    out = {"native_core": native.library_path()}
    _say(f"[{tag}] native replay core: {out['native_core']}")
    if out["native_core"] is None:
        _fail("the native replay core (csrc/simcache.cpp) did not build")
    with tempfile.TemporaryDirectory() as tmp:
        for fmt, grid in SIM_RUNS:
            path = os.path.join(tmp, f"poisson{grid}.mtx")
            if not os.path.exists(path):
                write_matrix_market(poisson2d(grid, grid), path)
            buf = io.StringIO()
            t0 = time.perf_counter()
            rc = main(["--matrix", path, "-s", fmt, "--profile", "0",
                       "--trace-config", config], out=buf)
            secs = time.perf_counter() - t0
            if rc != 0:
                _fail(f"simulate -s {fmt} at {grid}: exit {rc}")
            misses = json.loads(buf.getvalue())["cache_misses"]
            if not misses or not all(
                    sum(map(sum, m)) > 0 for m in misses.values()):
                _fail(f"simulate -s {fmt} at {grid}: no misses {misses}")
            key = f"{fmt} poisson2d({grid},{grid})"
            out[key] = {"cache_misses": misses, "seconds": secs}
            _say(f"[{tag}] --profile 0 -s {fmt} at poisson2d({grid},{grid})"
                 f": misses per thread (rows) and NUMA domain {misses}, "
                 f"{secs:.2f} s wall")
        err = io.StringIO()
        with contextlib.redirect_stderr(err):
            rc = main(["--matrix", path, "-s", "csr"], out=io.StringIO())
        if rc != 1 or "requires --trace-config" not in err.getvalue():
            _fail(f"simulate without --trace-config: exit {rc}, "
                  f"{err.getvalue()!r}")
        _say(f"[{tag}] no --trace-config: exit 1, {err.getvalue().strip()}")
    return out


# ------------------------------------------------------- the solvers (28)
SOLVER_CLI_GRID = 256         # the solvers' CLI runs' poisson2d
# Chebyshev there needs about 5,900 (float32, to 1e-5): 30 Lanczos steps
# put lambda_min at 0.0136, 45x the spectrum's 3.0e-4, and the bounds
# clip it, as in the JAX CLI
SOLVER_CLI_ITERS = 10000
SOLVER_CLI_TOL = "1e-5"       # in reach of float32, as phase 4's CG
SOLVER_NATURAL_GRID = 1024    # IC(0) at natural order: 2,047 levels
SOLVER_FULL_GRID = 2048       # ILU(0) after --reorder color, 4.2M rows
SOLVER_FULL_ITERS = 20
SOLVER_GRAPH_REPS = 5         # solves in one CUDA graph
SOLVER_CHAIN_ROWS = 300       # the one-row-a-level chain: least launch,
                              # and the chained mode's hand-off
SOLVER_NATURAL_CG_ITERS = 50  # -s csr --cg 50 --precondition ic0, natural
# the plan's line: layered triangles (rows, rows a level); the fifth has
# the colored CLI triangles' shape (2 levels of 32,768 rows)
PLAN_LINE = ((1 << 21, 16384), (1 << 21, 65536), (1 << 21, 131072),
             (1 << 21, 262144), (1 << 16, 32768), (1 << 16, 16384))
SOLVER_SWEEPS = 6             # the CLI's *-sweeps count a triangle
# The tri_solve kernel against its plain version (relative max-norm), as
# the other kernels (the kernel fuses multiply-add where the plain version
# rounds twice); an error made at one level feeds every later level, and
# 2,047 levels measured 1.7e-7 in float32 and 1.5e-16 in float64 on an
# H100.
TOL_TRI = {"float64": TOL_F64, "float32": TOL_F32}
SOLVER_CLI_RUNS = (
    ("bicgstab ilu0", ["--solver", "bicgstab", "--precondition", "ilu0"]),
    ("gmres(32) ic0", ["--solver", "gmres", "--restart", "32",
                       "--precondition", "ic0"]),
    ("chebyshev", ["--solver", "chebyshev"]),
    ("cg ic0-sweeps", ["--precondition", "ic0-sweeps"]),
    ("dia color bicgstab ilu0", ["-s", "dia", "--reorder", "color",
                                 "--solver", "bicgstab", "--precondition",
                                 "ilu0"]),
)


SOLVER_CLI_DTYPES = ("float32", "float64")


def _cli_doc(argv, what, dtype="float32", key="cg"):
    """The CLI's report under ``key`` ("cg", or "eigs" for --eigs) and
    wall seconds; ``dtype`` is the CLI's value type (torch's default
    dtype while it runs)."""
    import torch

    from spmv_tpu_torch.cli import main

    buf = io.StringIO()
    keep = torch.get_default_dtype()
    torch.set_default_dtype(getattr(torch, dtype))
    try:
        t0 = time.perf_counter()
        rc = main(argv, out=buf)
        secs = time.perf_counter() - t0
    finally:
        torch.set_default_dtype(keep)
    if rc != 0:
        _fail(f"{what}: CLI {' '.join(argv)} exited {rc}")
    return json.loads(buf.getvalue())[key], secs


def _solver_cli_runs(path):
    """(name, argv) of the five CLI runs on the Matrix Market file."""
    return [(name, ["--matrix", path, "-s", "csr", "--cg",
                    str(SOLVER_CLI_ITERS), "--cg-tol", SOLVER_CLI_TOL]
             + extra) for name, extra in SOLVER_CLI_RUNS]


def _solver_cli_cpu(path, dtype) -> dict:
    """The five CLI runs on the CPU (the port's plain versions) in
    ``dtype``, in a child process phase 28 starts with
    SPMV_TPU_TORCH_DEVICE=cpu: each run's report."""
    import torch

    torch.set_num_threads(3)
    return {name: _cli_doc(argv, f"{name} on the CPU, {dtype}", dtype)[0]
            for name, argv in _solver_cli_runs(path)}


# phase 28's CPU runs, in processes of their own beside the card's work
_SOLVER_CPU = """
import json, sys
import chip_smoke as c
print(json.dumps(c._solver_cli_cpu(sys.argv[1], sys.argv[2])))
"""


def _start_solver_cpu(path, dtype):
    from spmv_tpu_torch.models.device import DEVICE_ENV

    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", _SOLVER_CPU, path, dtype], cwd=repo,
        env={**os.environ, DEVICE_ENV: "cpu"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def _solver_cli(device, path, tag, dtype):
    """The five CLI runs at poisson2d(SOLVER_CLI_GRID²) on the card in
    ``dtype``: each converges (rms error against ones within CG_RMS_ERR),
    moves the tri_solve count where ic0 / ilu0 runs and K1 where -s dia
    does.  Returns each run's report."""
    from spmv_tpu_torch.ops import dia_spmv_core, tri_solve_core

    out = {}
    for name, argv in _solver_cli_runs(path):
        tri0, k10 = tri_solve_core.launches, dia_spmv_core.launches
        cg, _ = _cli_doc(argv, f"{name}, {dtype}", dtype)
        tri, k1 = (tri_solve_core.launches - tri0,
                   dia_spmv_core.launches - k10)
        incomplete = any(a.startswith(("ic0", "ilu0")) for a in argv)
        err = cg["solution_rms_error_vs_ones"]
        _say(f"[{tag}] {name}, {dtype}: {cg['iterations']} iterations on "
             f"the card, residual {cg['residual_norm']:.3e}, rms error vs "
             f"ones {err:.3e}, {cg['seconds']:.3f} s, tri_solve launches "
             f"+{tri}, dia_spmv +{k1}"
             + (f", factorization {cg['factorization']}"
                if "factorization" in cg else "")
             + (f", bounds {cg['spectral_bounds']}"
                if "spectral_bounds" in cg else ""))
        if not (np.isfinite(err) and err <= CG_RMS_ERR
                and cg["iterations"] < SOLVER_CLI_ITERS):
            _fail(f"solver CLI {name}, {dtype}: did not converge ({cg})")
        if incomplete != (tri > 0):
            _fail(f"solver CLI {name}, {dtype}: tri_solve launches +{tri}")
        if "dia" in argv and k1 <= 0:
            _fail(f"solver CLI {name}, {dtype}: K1 was not launched")
        out[name] = {"iterations": cg["iterations"],
                     "residual_norm": cg["residual_norm"],
                     "solution_rms_error_vs_ones": err,
                     "seconds": cg["seconds"], "tri_solve_launches": tri,
                     **({"factorization": cg["factorization"]}
                        if "factorization" in cg else {})}
    return out


def _solver_cli_against_cpu(cli, proc, dtype, tag):
    """Each card run's iterations against the port's CPU run of the same
    command in the same dtype (the child process).  In float64 within 2
    (the two orders of summation differ by far less than the tolerance
    the counts hinge on).  In float32 within 2; Chebyshev's within one
    check interval of 20 (its counts' step); BiCGSTAB's within 2 or a
    tenth of the CPU's count, the larger (its residual wanders, and
    float32 sums in another order move where it crosses the tolerance:
    83 iterations on an H100 against 78 on its host's CPU at
    poisson2d(256²))."""
    try:
        stdout, stderr = proc.communicate(timeout=900)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        _fail(f"the solvers' CPU runs ({dtype}) did not end in 900 s")
    if proc.returncode != 0:
        _fail(f"the solvers' CPU runs ({dtype}) exited {proc.returncode}: "
              f"{(stdout + stderr)[-2000:]}")
    cpu = json.loads(stdout.strip().splitlines()[-1])
    for name, extra in SOLVER_CLI_RUNS:
        got, want = cli[name]["iterations"], cpu[name]["iterations"]
        slack = (2 if dtype == "float64" else
                 20 if "chebyshev" in extra else
                 max(2, want // 10) if "bicgstab" in extra else 2)
        _say(f"[{tag}] {name}, {dtype}: {got} iterations on the card, "
             f"{want} on the CPU ({cpu[name]['seconds']:.2f} s there), "
             f"residual {cpu[name]['residual_norm']:.3e} there")
        if abs(got - want) > slack:
            _fail(f"solver CLI {name}, {dtype}: {got} iterations on the "
                  f"card, {want} on the CPU (within {slack} asked)")
        cli[name].update(cpu_iterations=want,
                         cpu_seconds=cpu[name]["seconds"])


def _full_width_cli(device, mm, tag):
    """-s dia --reorder color --solver bicgstab --precondition ilu0 --cg
    SOLVER_FULL_ITERS at poisson2d(SOLVER_FULL_GRID²) through the CLI's
    main, in process, its Matrix Market reader handed the generated
    matrix (84M lines of text would take minutes to write and parse);
    the triangles the CLI factors are kept for the kernel checks."""
    from spmv_tpu_torch.io import matrix_market
    from spmv_tpu_torch.ops import dia_spmv_core, incomplete, tri_solve_core

    grid = SOLVER_FULL_GRID
    kept = []
    cls = incomplete.DeviceTriSolve
    build = cls.__dict__["from_host"]

    def keep(t, lower=True, unit_diag=False, dtype=None, device=None):
        T = build.__func__(cls, t, lower=lower, unit_diag=unit_diag,
                           dtype=dtype, device=device)
        kept.append((t, lower, unit_diag, T))
        return T

    tri0, k10 = tri_solve_core.launches, dia_spmv_core.launches
    cls.from_host = keep
    try:
        with _patched(matrix_market, "load_matrix", lambda path, **kw: mm):
            cg, wall = _cli_doc(
                ["--matrix", f"poisson2d_{grid}.mtx", "-s", "dia",
                 "--reorder", "color", "--solver", "bicgstab",
                 "--precondition", "ilu0", "--cg", str(SOLVER_FULL_ITERS)],
                "full width")
    finally:
        cls.from_host = build
    tri, k1 = (tri_solve_core.launches - tri0,
               dia_spmv_core.launches - k10)
    f = cg["factorization"]
    _say(f"[{tag}] -s dia --reorder color --solver bicgstab --precondition "
         f"ilu0 --cg {SOLVER_FULL_ITERS} at poisson2d({grid},{grid}): "
         f"{cg['iterations']} iterations, residual {cg['residual_norm']:.3e}"
         f", rms error vs ones {cg['solution_rms_error_vs_ones']:.3e}, "
         f"{cg['seconds']:.3f} s solving ({wall:.1f} s with the host set-up: "
         f"coloring, DIA, ILU(0), levels), launches: dia_spmv +{k1}, "
         f"tri_solve +{tri}; factorization {f}")
    if len(kept) != 2 or tri <= 0 or k1 <= 0:
        _fail(f"full width: {len(kept)} triangles, tri_solve +{tri}, "
              f"dia_spmv +{k1}")
    res = {k: cg[k] for k in ("iterations", "residual_norm",
                              "solution_rms_error_vs_ones", "seconds")}
    res.update(wall_seconds=wall, dia_spmv_launches=k1,
               tri_solve_launches=tri, factorization=f,
               shape=f"poisson2d({grid},{grid}) after --reorder color, "
                     "float32")
    return res, kept


def _natural_cli(device, mm, tag):
    """-s csr --solver cg --precondition ic0 --cg SOLVER_NATURAL_CG_ITERS
    at poisson2d(SOLVER_NATURAL_GRID²), natural order, float32, through
    the CLI's main with its reader handed the generated matrix: host ms
    an iteration and the tri_solve launches (two triangles an apply)."""
    from spmv_tpu_torch import kernels
    from spmv_tpu_torch.io import matrix_market
    from spmv_tpu_torch.ops import tri_solve_core

    grid = SOLVER_NATURAL_GRID
    tri0 = tri_solve_core.launches
    load = lambda path, **kw: mm  # noqa: E731
    with _patched(matrix_market, "load_matrix", load), \
            _patched(kernels, "load_matrix", load):
        cg, wall = _cli_doc(
            ["--matrix", f"poisson2d_{grid}.mtx", "-s", "csr", "--solver",
             "cg", "--precondition", "ic0", "--cg",
             str(SOLVER_NATURAL_CG_ITERS)], "natural order IC(0)")
    tri = tri_solve_core.launches - tri0
    it = cg["iterations"]
    ms = cg["seconds"] / max(it, 1) * 1e3
    f = cg["factorization"]
    _say(f"[{tag}] -s csr --solver cg --precondition ic0 --cg "
         f"{SOLVER_NATURAL_CG_ITERS} at poisson2d({grid},{grid}), natural "
         f"order, float32: {it} iterations, residual "
         f"{cg['residual_norm']:.3e}, {cg['seconds']:.4f} s solving, "
         f"{ms:.4f} host ms an iteration ({wall:.1f} s with the host "
         f"set-up), tri_solve launches +{tri}; factorization {f}")
    if tri <= 0 or not np.isfinite(cg["residual_norm"]):
        _fail(f"natural order IC(0) CLI: tri_solve +{tri}, {cg}")
    return {"iterations": it, "residual_norm": cg["residual_norm"],
            "seconds": cg["seconds"], "host_ms_an_iteration": ms,
            "wall_seconds": wall, "tri_solve_launches": tri,
            "factorization": f,
            "shape": f"poisson2d({grid},{grid}), natural order, float32"}


def _tri_check(T, label, tag, sweeps=None):
    """The kernel against its plain version on T (twice bitwise), in the
    mode the plan picks, and the other exact mode bitwise equal to it:
    the max abs and relative errors."""
    import torch

    from spmv_tpu_torch.ops import (
        tri_solve_core,
        tri_solve_plan,
        tri_solve_reference,
        tri_sweeps_reference,
    )

    dt = str(T.dep_vals.dtype).removeprefix("torch.")
    g = torch.Generator(device=T.dep_vals.device).manual_seed(81)
    b = torch.randn(T.n, generator=g, device=T.dep_vals.device,
                    dtype=T.dep_vals.dtype)
    z1 = tri_solve_core(T, b, sweeps=sweeps)
    z2 = tri_solve_core(T, b, sweeps=sweeps)
    plan = tri_solve_plan(T)
    other = None
    if sweeps is None:
        other = "levels" if plan == "chained" else "chained"
        z3 = tri_solve_core(T, b, mode=other)
    want = (tri_solve_reference(T, b) if sweeps is None
            else tri_sweeps_reference(T, b, sweeps))
    torch.cuda.synchronize()
    if not torch.equal(z1, z2):
        _fail(f"tri_solve {label} {dt}: two launches differ")
    if other is not None and not torch.equal(z1, z3):
        _fail(f"tri_solve {label} {dt}: the {plan} and {other} modes "
              f"differ in {int((z1 != z3).sum())} of {T.n} values")
    err = float((z1.double() - want.double()).abs().max())
    rel = _rel(z1, want)
    mode = plan if sweeps is None else f"{sweeps} sweep(s)"
    _say(f"[{tag}] tri_solve {label}, {dt}, {mode}: {T.num_levels} levels, "
         f"{T.n} rows, {T.num_deps} dependencies; max abs err {err:.3e} "
         f"(rel {rel:.3e}) against the plain version, bitwise repeatable"
         + (f", bitwise equal to the {other} mode" if other else ""))
    if not rel <= TOL_TRI[dt]:
        _fail(f"tri_solve {label} {dt} {mode}: relative error {rel} > "
              f"{TOL_TRI[dt]}")
    return err, rel


def _tri_case_arrays(path):
    """A saved case's triangle (host CSR arrays), b and the kernel's z on
    the card, and whether it is upper and unit."""
    import types

    import torch

    d = np.load(path)
    t = types.SimpleNamespace(num_rows=int(d["shape"][0]),
                              row_ptr=d["row_ptr"], column_index=d["cols"],
                              value=d["vals"])
    dev = torch.device("cuda")
    return (t, torch.from_numpy(d["b"]).to(dev),
            torch.from_numpy(d["z"]), bool(d["upper"]), bool(d["unit"]))


def _tri_spsv_case(path) -> dict:
    """cuSPARSE's SpSV (profile/tri_study.cu; the analysis once, then the
    solve) on one saved triangle, timed as the kernel is, and its
    agreement with the kernel's z."""
    import torch

    from spmv_tpu_torch.errors import KernelError
    from spmv_tpu_torch.profile.tri_study import Spsv

    t, b, want, upper, unit = _tri_case_arrays(path)
    z = torch.empty_like(b)
    try:
        solve = Spsv(t, lower=not upper, unit=unit, b=b, z=z)
    except (RuntimeError, KernelError) as e:
        return {"library_ms": None,
                "library_error": f"{type(e).__name__}: {e}"[:300]}
    got = solve().cpu()
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=b.device)
    lib = _yardstick(solve, lambda: scratch.fill_(0.0), reps=5)
    lib["library_rel_err_vs_kernel"] = _rel(got, want)
    lib["library_call"] = ("cusparseSpSV_solve, the analysis done once "
                           "(spmv_tpu_torch/profile/tri_study.cu)")
    solve.close()
    return lib


def _tri_library_case(path) -> dict:
    """torch.triangular_solve on one saved triangle as a sparse CSR tensor
    (int64 indices, B of (n, 1)), timed as the kernel is, and its
    agreement with the kernel's z."""
    import torch

    t, b, want, upper, unit = _tri_case_arrays(path)
    try:
        S = torch.sparse_csr_tensor(
            torch.from_numpy(t.row_ptr).long(),
            torch.from_numpy(t.column_index).long(),
            torch.from_numpy(t.value),
            size=(t.num_rows, t.num_rows)).to(b.device)
        B = b[:, None].contiguous()

        def call():
            return torch.triangular_solve(B, S, upper=upper,
                                          unitriangular=unit)

        got = call()[0][:, 0].cpu()
        scratch = torch.empty(16 << 20, dtype=torch.float32, device=b.device)
        lib = _yardstick(call, lambda: scratch.fill_(0.0), reps=5)
        lib["library_rel_err_vs_kernel"] = _rel(got, want)
        return lib
    except (RuntimeError, NotImplementedError, TypeError) as e:
        return {"library_ms": None,
                "library_error": f"{type(e).__name__}: {e}"[:300]}


# phase 28's yardsticks on the saved triangles, each in a process of its
# own: torch.triangular_solve on sparse CSR factors ended its process with
# SIGFPE on an H100 with torch 2.11 (int32 indices and int64 alike)
_TRI_LIBRARY = """
import json, sys
import chip_smoke as c
case = getattr(c, sys.argv[1])
for path in sys.argv[2:]:
    print(json.dumps(case(path)), flush=True)
"""


def _tri_library_runs(how, paths, cases) -> dict:
    """``how`` (a function of this module) on each saved case in one child
    process, in order; a case whose call ends the process is recorded
    with its exit code, and the cases after it as not run."""
    repo = os.path.dirname(os.path.abspath(__file__))
    r = subprocess.run([sys.executable, "-c", _TRI_LIBRARY, how, *paths],
                       cwd=repo, capture_output=True, text=True, timeout=900)
    done = [json.loads(ln) for ln in r.stdout.splitlines()
            if ln.startswith("{")]
    out = {}
    for i, case in enumerate(cases):
        if i < len(done):
            out[case[0]] = done[i]
        elif i == len(done):
            out[case[0]] = {"library_ms": None, "library_error": (
                f"{how} ended its process with exit code {r.returncode}"
                + (f" (signal {-r.returncode})" if r.returncode < 0 else "")
                + f": {r.stderr.strip()[-300:]}")}
        else:
            out[case[0]] = {"library_ms": None, "library_error":
                            "not run: the call ended the process on an "
                            "earlier triangle"}
    return out


def _tri_libraries(cases, tag) -> dict:
    """The yardsticks of each (key, host triangle, lower, unit, b, z)
    case: cuSPARSE's SpSV through profile/tri_study.cu (the row's
    library_ms) and torch.triangular_solve on the sparse CSR triangle
    (under "torch_triangular_solve"), each in a child process."""
    tmp = tempfile.mkdtemp()
    try:
        paths = []
        for i, (key, t, lower, unit, b, z) in enumerate(cases):
            path = os.path.join(tmp, f"tri{i}.npz")
            np.savez(path, row_ptr=np.asarray(t.row_ptr, np.int32),
                     cols=np.asarray(t.column_index, np.int32),
                     vals=np.asarray(t.value, np.float32),
                     shape=np.array([t.num_rows, t.num_columns]),
                     upper=not lower, unit=unit,
                     b=b.cpu().numpy(), z=z.cpu().numpy())
            paths.append(path)
        spsv = _tri_library_runs("_tri_spsv_case", paths, cases)
        torch_call = _tri_library_runs("_tri_library_case", paths, cases)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out = {}
    for case in cases:
        lib, tc = spsv[case[0]], torch_call[case[0]]
        out[case[0]] = {**lib, "torch_triangular_solve": tc}
        _say(f"[{tag}] {case[0]}: " + (
            f"cuSPARSE SpSV {_library_line(lib)}, rel err vs the kernel "
            f"{lib['library_rel_err_vs_kernel']:.2e}"
            if lib["library_ms"] is not None
            else f"cuSPARSE SpSV not timed: {lib['library_error']}")
            + "; " + (
            f"torch.triangular_solve {_library_line(tc)}"
            if tc["library_ms"] is not None
            else f"torch.triangular_solve not timed: {tc['library_error']}"))
    return out


def _tri_alone(t, lower, unit, T, label, tag, smi_line, triad_gbps,
               chain):
    """One triangle solve alone (a CUDA graph of SOLVER_GRAPH_REPS
    solves, the L2 flushed before each) in the mode the plan picks and in
    the other one, beside its bound (bytes over the data sheet's rate;
    with its levels x the least launch and x the chained mode's hand-off
    beside), the plain version's ms; the yardsticks come after."""
    import torch

    from spmv_tpu_torch.ops import (
        tri_solve_core,
        tri_solve_plan,
        tri_solve_reference,
    )

    dev = T.dep_vals.device
    g = torch.Generator(device=dev).manual_seed(82)
    b = torch.randn(T.n, generator=g, device=dev, dtype=T.dep_vals.dtype)
    z = torch.empty_like(b)
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    plan = tri_solve_plan(T)
    modes = {m: _cold_graph_ms(
        lambda m=m: tri_solve_core(T, b, out=z, mode=m), flush,
        SOLVER_GRAPH_REPS) for m in ("levels", "chained")}
    ms = modes[plan]
    eager_ms = _time_launches(lambda: tri_solve_core(T, b, out=z), 3)
    plain_ms = _time_launches(lambda: tri_solve_reference(T, b), 2)
    tri_solve_core(T, b, out=z)
    nbytes, z_reads, container = _tri_bytes(T, b, z)
    flops = 2 * T.num_deps + (1 if T.unit_diag else 2) * T.n
    bound = _bound(nbytes, flops, triad_gbps)
    with_z = _bound(nbytes + z_reads, flops, triad_gbps)
    res = {"ms": ms, "mode": plan, "levels_ms": modes["levels"],
           "chained_ms": modes["chained"], "eager_ms": eager_ms,
           "plain_ms": plain_ms,
           "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
           "bound_triad_ms": bound["bound_triad_ms"],
           "bytes": bound["bytes"], "flops": bound["flops"],
           "bound_with_z_reads_ms": with_z["bound_ms"],
           "z_read_bytes": z_reads, "container_bytes": container,
           "launch_bound_ms": T.num_levels * chain["least_launch_ms"],
           "handoff_bound_ms": T.num_levels * chain["handoff_ms"],
           "levels": T.num_levels, "rows": T.n,
           "dependencies": T.num_deps,
           "reads_level_rows": T.level_shift is None,
           "reads_diag_inv": not T.unit_diag}
    _say(f"[{tag}] tri_solve alone, {label}: {ms:.4f} ms in the {plan} "
         f"mode (CUDA graph, L2 flushed; levels {modes['levels']:.4f}, "
         f"chained {modes['chained']:.4f}), {eager_ms:.4f} ms eager, plain "
         f"{plain_ms:.3f} ms; bound {bound['bound_ms']:.4f} ms "
         f"({bound['bound_by']}, {nbytes} B needed; "
         f"{bound['bound_triad_ms']:.4f} at the triad), "
         f"{with_z['bound_ms']:.4f} ms with one read of each z a dependency "
         f"reads (+{z_reads} B); the container holds {container} B; the "
         f"kernel reads level_rows: {res['reads_level_rows']}, diag_inv: "
         f"{res['reads_diag_inv']}; {T.num_levels} levels x "
         f"{chain['least_launch_ms'] * 1e3:.3f} us a launch = "
         f"{res['launch_bound_ms']:.4f} ms, x "
         f"{chain['handoff_ms'] * 1e3:.3f} us a hand-off = "
         f"{res['handoff_bound_ms']:.4f} ms; on {smi_line}")
    del scratch
    return res, (t, lower, unit, b, z)


def _tri_bytes(T, b, z):
    """(the bytes one level solve must move, the z values its dependencies
    read, the container's bytes).  It must read dep_ptr, dep_cols,
    dep_vals and b once and write z once; level_rows only where the
    levels are not contiguous row ranges (``level_shift`` is None) and
    diag_inv only where the diagonal is not 1, as the kernel does.  The
    z reads (one of each distinct dependency column) are an output read
    back, which may stay in L2: they are counted beside the bound."""
    import torch

    needed = _nbytes(T.dep_ptr, T.dep_cols, T.dep_vals, b, z,
                     T.level_rows if T.level_shift is None else None,
                     None if T.unit_diag else T.diag_inv)
    z_reads = int(torch.unique(T.dep_cols).numel()) * z.element_size()
    container = _nbytes(T.level_rows, T.dep_ptr, T.dep_cols, T.dep_vals,
                        T.diag_inv, b, z)
    return needed, z_reads, container


def _chain_ms(device, tag) -> dict:
    """On a chain of SOLVER_CHAIN_ROWS levels of one row each, solved in
    a CUDA graph: the least time of one tri_solve launch (the level mode,
    a launch a level) and the chained mode's hand-off from one level to
    the next (its one launch over the levels), each a level."""
    import torch

    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import CsrMatrix
    from spmv_tpu_torch.ops import DeviceTriSolve, tri_solve_core

    n = SOLVER_CHAIN_ROWS
    i = np.arange(1, n)
    chain = CsrMatrix.from_matrix_market(from_coo_arrays(
        n, n, np.concatenate([np.arange(n), i]),
        np.concatenate([np.arange(n), i - 1]),
        np.concatenate([np.full(n, 2.0), np.full(n - 1, -0.5)])))
    T = DeviceTriSolve.from_host(chain, dtype=torch.float32, device=device)
    b = torch.ones(n, dtype=torch.float32, device=device)
    z = torch.empty_like(b)
    out = {}
    for key, mode in (("least_launch_ms", "levels"),
                      ("handoff_ms", "chained")):
        out[key] = _graph_replay_ms(
            lambda: tri_solve_core(T, b, out=z, mode=mode),
            SOLVER_GRAPH_REPS) / T.num_levels
    _say(f"[{tag}] {T.num_levels} one-row levels in a CUDA graph: the "
         f"least launch {out['least_launch_ms'] * 1e3:.3f} us a level (a "
         f"launch a level), the chained mode's hand-off "
         f"{out['handoff_ms'] * 1e3:.3f} us a level (one launch)")
    return out


def _layered(n: int, width: int):
    """A lower triangle of n rows in levels of ``width`` rows: each row
    past the first level depends on two rows of the level before (the
    one above it and its neighbour), diagonal 4, off-diagonal -1."""
    from spmv_tpu_torch.io.generate import from_coo_arrays
    from spmv_tpu_torch.models import CsrMatrix

    r = np.arange(n)
    dep = r[r >= width]
    up = dep - width
    side = np.where(dep % width + 1 < width, up + 1, up - 1)
    return CsrMatrix.from_matrix_market(from_coo_arrays(
        n, n, np.concatenate([r, dep, dep]), np.concatenate([r, up, side]),
        np.concatenate([np.full(n, 4.0), np.full(2 * dep.size, -1.0)])))


def _plan_line(device, tag) -> dict:
    """Both modes on the layered triangles of PLAN_LINE (float32, a CUDA
    graph, L2 flushed), beside the mode tri_solve_plan picks: where its
    line should lie."""
    import torch

    from spmv_tpu_torch.ops import (
        DeviceTriSolve,
        tri_solve_core,
        tri_solve_plan,
    )

    scratch = torch.empty(16 << 20, dtype=torch.float32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    out = {}
    for rows, width in PLAN_LINE:
        T = DeviceTriSolve.from_host(_layered(rows, width),
                                     dtype=torch.float32, device=device)
        g = torch.Generator(device=device).manual_seed(83)
        b = torch.randn(T.n, generator=g, device=device)
        z = torch.empty_like(b)
        got = {m: tri_solve_core(T, b, mode=m) for m in ("levels",
                                                         "chained")}
        if not torch.equal(got["levels"], got["chained"]):
            _fail(f"plan line, levels of {width} rows: the modes differ")
        ms = {m: _cold_graph_ms(
            lambda m=m: tri_solve_core(T, b, out=z, mode=m), flush,
            SOLVER_GRAPH_REPS) for m in ("levels", "chained")}
        plan = tri_solve_plan(T)
        faster = min(ms, key=ms.get)
        out[f"{T.num_levels}x{width}"] = {"levels": T.num_levels, **{
            f"{m}_ms": v for m, v in ms.items()}, "plan": plan,
            "faster": faster}
        _say(f"[{tag}] plan line: {T.num_levels} levels of {width} rows, "
             f"levels {ms['levels']:.4f} ms, chained {ms['chained']:.4f} "
             f"ms; the plan picks {plan}, the faster is {faster}")
        del T, got
    del scratch
    return out


@_walled
def phase_solvers(device, smi_line, triad_gbps):
    """The other solvers (phase 28): the CLI's five runs at
    poisson2d(SOLVER_CLI_GRID²) against the port's CPU runs, the
    full-width run and CG + IC(0) at natural order (the tri_solve and K1
    counts zeroed just before, read just after); then, not counted, the
    tri_solve kernel against its plain version (float64 and float32,
    forward and backward, the planned mode, the other exact mode bitwise
    and SOLVER_SWEEPS sweeps) on IC(0) of poisson2d(SOLVER_NATURAL_GRID²)
    at natural order and on the full-width run's ILU(0) triangles, one
    triangle solve alone at both shapes in both modes with its
    yardsticks, and the plan's line."""
    import torch

    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix
    from spmv_tpu_torch.ops import (
        DeviceTriSolve,
        _ic_native,
        dia_spmv_core,
        ic0_factor,
        tri_solve_core,
        tri_solve_plan,
    )
    from spmv_tpu_torch.ops.incomplete import _transpose_csr

    tag = "28 solvers"
    t_phase = time.perf_counter()
    if not _ic_native.available():
        _fail("the native incomplete factorizers (csrc/ic0.cpp, built "
              "with the host C++ compiler into spmv_tpu_torch/_build/host/) "
              "did not load; the Python loops would not factor 16.8M rows "
              "in the time limit")
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, f"poisson2d_{SOLVER_CLI_GRID}.mtx")
    write_matrix_market(poisson2d(SOLVER_CLI_GRID, SOLVER_CLI_GRID), path)
    procs = {dt: _start_solver_cpu(path, dt) for dt in SOLVER_CLI_DTYPES}
    try:
        tri_solve_core.launches = 0
        dia_spmv_core.launches = 0
        cli = {dt: _solver_cli(device, path, tag, dt)
               for dt in SOLVER_CLI_DTYPES}
        t0 = time.perf_counter()
        mm = poisson2d(SOLVER_FULL_GRID, SOLVER_FULL_GRID)
        _say(f"[{tag}] host poisson2d({SOLVER_FULL_GRID},{SOLVER_FULL_GRID})"
             f" in {time.perf_counter() - t0:.1f} s")
        full, kept = _full_width_cli(device, mm, tag)
        del mm
        natural_mm = poisson2d(SOLVER_NATURAL_GRID, SOLVER_NATURAL_GRID)
        natural_cli = _natural_cli(device, natural_mm, tag)
        launches = {"tri_solve": tri_solve_core.launches,
                    "dia_spmv": dia_spmv_core.launches}
        _say(f"[{tag}] launches on the solvers path: tri_solve "
             f"{launches['tri_solve']}, dia_spmv {launches['dia_spmv']}")
        if launches["tri_solve"] <= 0:
            _fail("tri_solve was never launched on the solvers path")
        _sync(device)

        # the kernel against its plain version
        f32, f64 = torch.float32, torch.float64
        t0 = time.perf_counter()
        L = ic0_factor(CsrMatrix.from_matrix_market(natural_mm))
        del natural_mm
        natural = [(L, True, False, "IC(0) L"),
                   (_transpose_csr(L), False, False, "IC(0) L^T")]
        _say(f"[{tag}] IC(0) of poisson2d({SOLVER_NATURAL_GRID},"
             f"{SOLVER_NATURAL_GRID}) at natural order in "
             f"{time.perf_counter() - t0:.1f} s")
        grid_n = f"poisson2d({SOLVER_NATURAL_GRID},{SOLVER_NATURAL_GRID})"
        errs = {}
        dev_n = {}
        for t, lower, unit, name in natural:
            for dt in (f64, f32):
                T = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                             dtype=dt, device=device)
                label = f"{name} of {grid_n}, natural order"
                key = (name, str(dt).removeprefix("torch."))
                errs[key] = _tri_check(T, label, tag)
                errs[key + ("sweeps",)] = _tri_check(T, label, tag,
                                                      sweeps=SOLVER_SWEEPS)
                if dt == f32:
                    dev_n[name] = T
                else:
                    del T
        grid_c = (f"poisson2d({SOLVER_FULL_GRID},{SOLVER_FULL_GRID}) after "
                  "--reorder color")
        names = {True: "ILU(0) unit L", False: "ILU(0) U"}
        for t, lower, unit, T in kept:
            label = f"{names[lower]} of {grid_c}"
            errs[(names[lower], "float32")] = _tri_check(T, label, tag)
            errs[(names[lower], "float32", "sweeps")] = _tri_check(
                T, label, tag, sweeps=SOLVER_SWEEPS)
            T64 = DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                           dtype=f64, device=device)
            errs[(names[lower], "float64")] = _tri_check(T64, label, tag)
            errs[(names[lower], "float64", "sweeps")] = _tri_check(
                T64, label, tag, sweeps=SOLVER_SWEEPS)
            del T64
            _sync(device)

        # one triangle solve alone at both shapes
        chain = _chain_ms(device, tag)
        alone, cases = {}, []
        for t, lower, unit, T in kept:
            key = f"{names[lower]} {grid_c}"
            alone[key], case = _tri_alone(
                t, lower, unit, T, f"{names[lower]} of {grid_c}, float32", tag,
                smi_line, triad_gbps, chain)
            cases.append((key,) + case)
        for t, lower, unit, name in natural:
            key = f"{name} {grid_n} natural"
            alone[key], case = _tri_alone(
                t, lower, unit, dev_n[name], f"{name} of {grid_n}, natural "
                "order, float32", tag, smi_line, triad_gbps, chain)
            cases.append((key,) + case)
        for key, lib in _tri_libraries(cases, tag).items():
            alone[key].update(lib)
        del cases
        apply = {grid_n + " natural, IC(0)": sum(
                     1 if tri_solve_plan(T) == "chained" else T.num_levels
                     for T in dev_n.values()),
                 grid_c + ", ILU(0)": sum(
                     1 if tri_solve_plan(k[3]) == "chained" else k[3].num_levels
                     for k in kept)}
        _say(f"[{tag}] tri_solve launches a preconditioner apply: {apply}")
        del dev_n, kept, natural, L
        _sync(device)
        plan_line = _plan_line(device, tag)
        _sync(device)
        # the port's CPU runs, read last: they ran beside all of the above
        for dt, proc in procs.items():
            _solver_cli_against_cpu(cli[dt], proc, dt, tag)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    return {"launches": launches, "cli": cli, "full_width": full,
            "natural_cli": natural_cli,
            "errors": {" ".join(k): {"max_abs_err": e, "max_rel_err": r}
                       for k, (e, r) in errs.items()},
            "alone": alone, "launches_an_apply": apply, **chain,
            "plan_line": plan_line, "seconds": secs}


# ---------------------------------------------------- the eigensolver (29)
EIGS_GRID = 1024              # the full-width runs: poisson2d(1024²), 1M rows
EIGS_K = 8
EIGS_MAXITER = 200
EIGS_TOL = {"float32": "1e-4", "float64": "1e-8"}
EIGS_F64_RTOL = 1e-6          # float64 against the analytic eigenvalues
# float32 against the analytic eigenvalues: each Ritz value lies within
# ||R||_2 <= ||R||_F of an eigenvalue (Kahan's bound for an orthonormal
# block, R the block's residual), plus the rounding of a float32
# Rayleigh quotient, about eps * ||A|| (||A|| <= 8 for poisson2d)
EIGS_F32_ROUNDING = 8 * float(np.finfo(np.float32).eps)
EIGS_CLI_GRID = 128           # the CLI's --eigs runs on each format
EIGS_CLI_K = 4
EIGS_CLI_FORMATS = ("dia", "csr", "ell", "hybrid", "well", "wellcw")
# each format's SpMM kernels, one of which must launch (the hybrid's COO
# part is empty on a stencil, so it launches the ELL SpMM alone)
EIGS_CLI_SPMM = {"dia": ("dia_spmm_core",), "csr": ("csr_spmm_core",),
                 "ell": ("ell_spmm_core",), "hybrid": ("ell_spmm_core",),
                 "well": ("well_whole_spmm_core", "well_seg_spmm_core"),
                 "wellcw": ("wellcw_merged_spmm_core",
                            "wellcw_level_spmm_core",
                            "wellcw_pool_spmm_core")}
EIGS_SLOPE_ITERS = (5, 25)    # fixed-length solves for the times a step
EIGS_RR_REPS = 30             # Rayleigh-Ritz steps timed at each place
EIGS_VCYCLE_SPMM = 11         # CSR SpMMs a level of a V-cycle: 4 + 4
                              # smoothing, the residual, P^T and P


def _poisson_eigs(n: int, k: int) -> np.ndarray:
    """The k smallest eigenvalues of poisson2d(n, n), analytic:
    4 - 2 cos(i pi / (n + 1)) - 2 cos(j pi / (n + 1))."""
    c = 2.0 - 2.0 * np.cos(np.arange(1, k + 1) * np.pi / (n + 1))
    return np.sort((c[:, None] + c[None, :]).ravel())[:k]


def _eigs_argv(path, fmt, k, dtype):
    return ["--matrix", path, "-s", fmt, "--eigs", str(k), "--eigs-tol",
            EIGS_TOL[dtype], "--eigs-maxiter", str(EIGS_MAXITER),
            "--precondition", "amg"]


def _eigs_check(eigs, n, dtype, what, tag):
    """The report's eigenvalues against the analytic ones of
    poisson2d(n, n): float64 at EIGS_F64_RTOL, float32 within the
    residual's bound.  Returns the largest relative error."""
    got = np.asarray(eigs["eigenvalues"])
    want = _poisson_eigs(n, len(got))
    rel = float(np.max(np.abs(got - want) / want))
    if dtype == "float64":
        ok, limit = rel <= EIGS_F64_RTOL, f"rtol {EIGS_F64_RTOL}"
    else:
        bound = float(np.sqrt(np.sum(np.square(eigs["residual_norms"])))
                      + EIGS_F32_ROUNDING)
        ok = float(np.max(np.abs(got - want))) <= bound
        limit = f"|error| <= ||R||_F + 8 eps = {bound:.3e}"
    converged = eigs["iterations"] < EIGS_MAXITER
    _say(f"[{tag}] {what}: {eigs['iterations']} iterations, eigenvalues "
         f"{got.tolist()}, max relative error {rel:.3e} against the "
         f"analytic ones ({limit}), residual norms {eigs['residual_norms']}"
         f", {eigs['seconds']:.3f} s solving")
    if not (ok and converged):
        _fail(f"eigs {what}: {eigs}")
    return rel


def _eigs_cli_cpu(path, dtype) -> dict:
    """The CLI's --eigs runs of phase 29 on the CPU in ``dtype`` (a child
    process with SPMV_TPU_TORCH_DEVICE=cpu): each format's report."""
    import torch

    torch.set_num_threads(3)
    return {fmt: _cli_doc(_eigs_argv(path, fmt, EIGS_CLI_K, dtype),
                           f"{fmt} on the CPU, {dtype}", dtype,
                          "eigs")[0]
            for fmt in EIGS_CLI_FORMATS}


_EIGS_CPU = """
import json, sys
import chip_smoke as c
print(json.dumps(c._eigs_cli_cpu(sys.argv[1], sys.argv[2])))
"""


def _eigs_cli(device, path, tag, cpu_procs) -> dict:
    """--eigs EIGS_CLI_K --precondition amg at poisson2d(EIGS_CLI_GRID²)
    on each format of EIGS_CLI_FORMATS, float32 and float64: converged,
    within the analytic bound, the format's SpMM kernels launched, and
    against the port's CPU run of the same command (child processes):
    float64 eigenvalues at rtol 1e-9, float32 within the sum of the two
    runs' residual bounds.  Iterations are reported, not held: LOBPCG
    locks no column, so a column that reached the residual floor early
    feeds rounding noise into the basis and the order of the sums moves
    the step that crosses the tolerance (on an H100 against its host's
    CPU, in one run: 17 against 12 in float32, 19 against 22 in float64;
    tests/test_torch_eigen.py saw the same against the JAX package)."""
    wrappers = _port_wrappers()
    out = {}
    for dtype in EIGS_TOL:
        out[dtype] = {}
        for fmt in EIGS_CLI_FORMATS:
            before = {k: w.launches for k, w in wrappers.items()}
            eigs, wall = _cli_doc(_eigs_argv(path, fmt, EIGS_CLI_K, dtype),
                                  f"{fmt}, {dtype}", dtype, "eigs")
            moved = {k: w.launches - before[k] for k, w in wrappers.items()
                     if w.launches != before[k]}
            rel = _eigs_check(eigs, EIGS_CLI_GRID, dtype, f"-s {fmt} --eigs "
                              f"{EIGS_CLI_K} --precondition amg, {dtype}",
                              tag)
            if not any(moved.get(k, 0) > 0 for k in EIGS_CLI_SPMM[fmt]):
                _fail(f"eigs CLI {fmt}, {dtype}: launches {moved}")
            _say(f"[{tag}] -s {fmt}, {dtype}: launches {moved}, "
                 f"{wall:.2f} s with the host set-up")
            out[dtype][fmt] = {
                "iterations": eigs["iterations"],
                "eigenvalues": eigs["eigenvalues"],
                "residual_norms": eigs["residual_norms"],
                "max_rel_err_vs_analytic": rel, "seconds": eigs["seconds"],
                "wall_seconds": wall, "launches": moved}
    for dtype, proc in cpu_procs.items():
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            _fail(f"the eigs CPU runs ({dtype}) did not end in 600 s")
        if proc.returncode != 0:
            _fail(f"the eigs CPU runs ({dtype}) exited {proc.returncode}: "
                  f"{(stdout + stderr)[-2000:]}")
        cpu = json.loads(stdout.strip().splitlines()[-1])
        for fmt in EIGS_CLI_FORMATS:
            card, want = out[dtype][fmt], cpu[fmt]
            a, b = np.asarray(card["eigenvalues"]), np.asarray(
                want["eigenvalues"])
            if dtype == "float64":
                ok = np.allclose(a, b, rtol=1e-9, atol=0)
            else:
                bound = (np.sqrt(np.sum(np.square(card["residual_norms"])))
                         + np.sqrt(np.sum(np.square(want["residual_norms"])))
                         + 2 * EIGS_F32_ROUNDING)
                ok = float(np.max(np.abs(a - b))) <= bound
            _say(f"[{tag}] -s {fmt}, {dtype}: {card['iterations']} iterations"
                 f" on the card, {want['iterations']} on the CPU; eigenvalues"
                 f" differ by {float(np.max(np.abs(a - b) / b)):.3e} "
                 f"(relative); {want['seconds']:.2f} s solving there")
            if not ok:
                _fail(f"eigs CLI {fmt}, {dtype}: card {card}, CPU {want}")
            card.update(cpu_iterations=want["iterations"],
                        cpu_eigenvalues=want["eigenvalues"])
    return out


def _eigs_full_width(device, mm, dtype, tag) -> tuple:
    """-s dia --eigs EIGS_K --which smallest --precondition amg at
    poisson2d(EIGS_GRID²) through the CLI's main (its reader handed the
    generated matrix) in ``dtype``: eigenvalues against the analytic
    ones, K2 launches = the symmetry probe's 2 + the one-step warm-up's 3
    + 2 + iterations, the CSR SpMM launches a whole number of V-cycles
    (EIGS_VCYCLE_SPMM a level) a preconditioner apply, no CSR SpMV.
    Returns the summary and the captured (matmat, X0, preconditioner)."""
    from spmv_tpu_torch import kernels, ops
    from spmv_tpu_torch.io import matrix_market

    captured = []
    real = ops.lobpcg

    def keep(matmat, X0, preconditioner=None, **kw):
        captured.append((matmat, X0, preconditioner))
        return real(matmat, X0, preconditioner=preconditioner, **kw)

    counts = {k: getattr(ops, k) for k in ("dia_spmm_core", "csr_spmm_core",
                                           "csr_spmv_core")}
    before = {k: w.launches for k, w in counts.items()}
    load = lambda path, **kw: mm  # noqa: E731
    argv = _eigs_argv(f"poisson2d_{EIGS_GRID}.mtx", "dia", EIGS_K, dtype)
    argv += ["--which", "smallest"]
    with _patched(matrix_market, "load_matrix", load), \
            _patched(kernels, "load_matrix", load), \
            _patched(ops, "lobpcg", keep):
        eigs, wall = _cli_doc(argv, f"full width, {dtype}", dtype, "eigs")
    moved = {k: w.launches - before[k] for k, w in counts.items()}
    it = eigs["iterations"]
    rel = _eigs_check(eigs, EIGS_GRID, dtype, f"-s dia --eigs {EIGS_K} "
                      f"--precondition amg at poisson2d({EIGS_GRID},"
                      f"{EIGS_GRID}), {dtype}, --eigs-tol {EIGS_TOL[dtype]}",
                      tag)
    probe = 2 if mm.symmetry == "general" else 0
    applies = 1 + it                 # the warm-up's step and the solve's
    per_apply = moved["csr_spmm_core"] / applies
    _say(f"[{tag}] full width {dtype}: launches {moved} (K2: probe {probe} "
         f"+ warm-up 3 + 2 + {it}; CSR SpMM {per_apply:g} an apply, "
         f"{per_apply / EIGS_VCYCLE_SPMM:g} levels); {wall:.1f} s with the "
         f"host set-up (DIA, SA-AMG hierarchy, probe, warm-up), "
         f"{wall - eigs['seconds']:.1f} s of it set-up; "
         f"{eigs['seconds'] / max(it, 1) * 1e3:.3f} host ms an iteration")
    if (moved["dia_spmm_core"] != probe + 3 + 2 + it
            or moved["csr_spmv_core"] != 0 or per_apply <= 0
            or per_apply != int(per_apply)
            or per_apply % EIGS_VCYCLE_SPMM != 0):
        _fail(f"eigs full width {dtype}: launches {moved}, {it} iterations")
    res = {"iterations": it, "eigenvalues": eigs["eigenvalues"],
           "residual_norms": eigs["residual_norms"],
           "max_rel_err_vs_analytic": rel, "seconds": eigs["seconds"],
           "wall_seconds": wall, "setup_seconds": wall - eigs["seconds"],
           "host_ms_an_iteration": eigs["seconds"] / max(it, 1) * 1e3,
           "launches": moved, "csr_spmm_an_apply": int(per_apply),
           "tolerance": float(EIGS_TOL[dtype])}
    return res, captured[-1]


def _eigs_slopes(device, captured, tag, dtype) -> dict:
    """Host and device ms a step of the full-width solve: fixed-length
    solves (tol 0) of EIGS_SLOPE_ITERS steps under torch.profiler, the
    difference over the difference of the lengths."""
    from spmv_tpu_torch.ops import lobpcg
    from spmv_tpu_torch.profile.cg_breakdown import traced

    matmat, X0, minv = captured

    def solve(n):
        lobpcg(matmat, X0, preconditioner=minv, tol=0.0, max_iterations=n)

    solve(1)
    runs = [traced(lambda: solve(n), device) for n in EIGS_SLOPE_ITERS]
    span = EIGS_SLOPE_ITERS[1] - EIGS_SLOPE_ITERS[0]
    host = (runs[1][0] - runs[0][0]) / span * 1e3
    dev = (runs[1][1] - runs[0][1]) / span * 1e3
    _say(f"[{tag}] full width {dtype}, a step: {host:.3f} host ms, {dev:.3f}"
         f" device ms (busy share {dev / host:.3f}); kernels of the "
         f"{EIGS_SLOPE_ITERS[1]}-step solve:\n{runs[1][2]}")
    return {"host_ms_a_step": host, "device_ms_a_step": dev,
            "busy_share": dev / host}


def _eigs_k2(device, mm, smi_line, triad_gbps, tag) -> dict:
    """K2 at k = EIGS_K on poisson2d(EIGS_GRID²), float32, alone: a CUDA
    graph with the L2 flushed before each launch, beside its plain
    version, torch.sparse's CSR product and its bound."""
    import torch

    from spmv_tpu_torch.models import DeviceDia, DiaMatrix
    from spmv_tpu_torch.ops import dia_spmm_core, dia_spmm_reference

    f32 = torch.float32
    A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm), dtype=f32,
                            device=device)
    g = torch.Generator(device=device).manual_seed(29)
    X = torch.randn(A.num_columns, EIGS_K, device=device, dtype=f32,
                    generator=g)
    Y = torch.empty(A.num_rows, EIGS_K, device=device, dtype=f32)
    scratch = torch.empty(16 << 20, dtype=f32, device=device)
    flush = lambda: scratch.fill_(0.0)  # noqa: E731
    ms = _cold_graph_ms(lambda: dia_spmm_core(A, X, out=Y), flush, 20)
    plain_ms = _time_launches(lambda: dia_spmm_reference(A, X), 5)
    err = _rel(Y, dia_spmm_reference(A, X))
    S = _csr_of_mm(mm, device, f32)
    lib = _yardstick(lambda: S @ X, flush)
    b = _bound(_nbytes(A.data, A.offsets_dev, X, Y),
               2 * mm.num_entries * EIGS_K, triad_gbps)
    _say(f"[{tag}] K2 alone at poisson2d({EIGS_GRID},{EIGS_GRID}) float32, "
         f"k={EIGS_K} (CUDA graph, L2 flushed): {ms:.4f} ms, plain "
         f"{plain_ms:.4f} ms, torch.sparse CSR {lib['library_ms']:.4f} ms, "
         f"bound {b['bound_ms']:.4f} ms ({b['bound_by']}), relative error "
         f"{err:.2e}, on {smi_line}")
    if err > TOL_F32:
        _fail(f"K2 at the eigensolver's shape: relative error {err}")
    del A, X, Y, scratch, S
    return {"ms": ms, "plain_ms": plain_ms, "max_rel_err": err, **lib, **b,
            "shape": f"poisson2d({EIGS_GRID},{EIGS_GRID}) float32, "
                     f"k={EIGS_K}"}


def _eigs_rayleigh_ritz(device, tag) -> dict:
    """Where the Rayleigh-Ritz step runs: the port's way (S^T [S, AS] on
    the card, one copy to the host, the (3k, 3k) algebra and its two
    eigh there, the coefficients back) against the whole step on the card
    (cuSOLVER's eigh), at EIGS_GRID² rows, k = EIGS_K, float32 and
    float64; and one (3k, 3k) eigh alone at each place (the host's with
    its copy).  Median host ms of EIGS_RR_REPS, each ending in a
    synchronise."""
    import torch

    from spmv_tpu_torch.ops.eigen import _mmh, _rayleigh_ritz

    k, n = EIGS_K, EIGS_GRID * EIGS_GRID
    out = {}
    for dt in (torch.float32, torch.float64):
        g = torch.Generator(device=device).manual_seed(3)
        B = torch.randn(n, 6 * k, device=device, dtype=dt, generator=g)
        S = B[:, :3 * k]

        def on_host():
            GS = _mmh(S.T, B).cpu()
            c = _rayleigh_ritz(GS[:, :3 * k], GS[:, 3 * k:], k, 1.0, 1e-4)
            return c.to(device)

        def on_card():
            GS = _mmh(S.T, B)
            return _rayleigh_ritz(GS[:, :3 * k], GS[:, 3 * k:], k, 1.0, 1e-4)

        H = _mmh(S.T, S)

        def eigh_host():
            return torch.linalg.eigh(H.cpu())

        def eigh_card():
            return torch.linalg.eigh(H)

        times = {}
        for name, fn in (("step_host", on_host), ("step_card", on_card),
                         ("eigh_host", eigh_host), ("eigh_card", eigh_card)):
            fn()
            torch.cuda.synchronize(device)
            ts = []
            for _ in range(EIGS_RR_REPS):
                t0 = time.perf_counter()
                fn()
                torch.cuda.synchronize(device)
                ts.append((time.perf_counter() - t0) * 1e3)
            times[name] = float(np.median(ts))
        # eigh fixes each eigenvector up to its sign: align the columns
        card, host = on_card(), on_host()
        diff = _rel(card * torch.sign((card * host).sum(0)), host)
        dtn = str(dt).removeprefix("torch.")
        _say(f"[{tag}] Rayleigh-Ritz step at n={n}, k={k}, {dtn}: "
             f"{times['step_host']:.3f} ms with the small algebra on the "
             f"host (the port's), {times['step_card']:.3f} ms all on the "
             f"card; a ({3 * k},{3 * k}) eigh {times['eigh_host']:.3f} ms "
             f"on the host with its copy, {times['eigh_card']:.3f} ms on "
             f"the card (cuSOLVER); coefficients differ by {diff:.2e} "
             "(up to each column's sign)")
        out[dtn] = {**times, "coeff_rel_diff": diff}
        del B, S, H
    faster = all(v["step_host"] <= v["step_card"] for v in out.values())
    out["eigh_runs_on"] = "host"
    out["host_is_faster"] = faster
    if not faster:
        _say(f"[{tag}] NOTE: the step on the card was faster than on the "
             "host in at least one dtype")
    return out


@_walled
def phase_eigs(device, smi_line, triad_gbps):
    """The eigensolver (phase 29): the CLI's --eigs on six formats at
    poisson2d(EIGS_CLI_GRID²) against the port's CPU runs, and the
    full-width runs at poisson2d(EIGS_GRID²) in float32 and float64 (the
    K2, CSR SpMM and CSR SpMV counts zeroed just before, read just
    after); then, not counted, host and device ms a step, K2 alone at
    k = EIGS_K, and where the Rayleigh-Ritz step runs."""
    import torch

    from spmv_tpu_torch.io import write_matrix_market
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models.device import DEVICE_ENV
    from spmv_tpu_torch.ops import csr_spmm_core, csr_spmv_core, dia_spmm_core

    tag = "29 eigs"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp()
    path = os.path.join(tmp, f"poisson2d_{EIGS_CLI_GRID}.mtx")
    write_matrix_market(poisson2d(EIGS_CLI_GRID, EIGS_CLI_GRID), path)
    repo = os.path.dirname(os.path.abspath(__file__))
    procs = {dt: subprocess.Popen(
        [sys.executable, "-c", _EIGS_CPU, path, dt], cwd=repo,
        env={**os.environ, DEVICE_ENV: "cpu"}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for dt in EIGS_TOL}
    try:
        dia_spmm_core.launches = 0
        csr_spmm_core.launches = 0
        csr_spmv_core.launches = 0
        t0 = time.perf_counter()
        mm = poisson2d(EIGS_GRID, EIGS_GRID)
        _say(f"[{tag}] host poisson2d({EIGS_GRID},{EIGS_GRID}) in "
             f"{time.perf_counter() - t0:.1f} s")
        full, captured = {}, {}
        for dt in EIGS_TOL:
            full[dt], captured[dt] = _eigs_full_width(device, mm, dt, tag)
            _sync(device)
        launches = {"dia_spmm": dia_spmm_core.launches,
                    "csr_spmm": csr_spmm_core.launches,
                    "csr_spmv": csr_spmv_core.launches}
        _say(f"[{tag}] launches on the eigensolver's full-width path: "
             f"{launches}")
        if launches["dia_spmm"] <= 0 or launches["csr_spmm"] <= 0:
            _fail(f"K2 or the CSR SpMM was never launched on the "
                  f"eigensolver's path: {launches}")
        cli = _eigs_cli(device, path, tag, procs)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
        shutil.rmtree(tmp, ignore_errors=True)
    for dt in EIGS_TOL:
        full[dt].update(_eigs_slopes(device, captured[dt], tag, dt))
    del captured
    _sync(device)
    k2 = _eigs_k2(device, mm, smi_line, triad_gbps, tag)
    del mm
    _sync(device)
    rr = _eigs_rayleigh_ritz(device, tag)
    _sync(device)
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    return {"launches": launches, "full_width": full, "cli": cli,
            "k2_alone": k2, "rayleigh_ritz": rr, "seconds": secs,
            "shape": f"poisson2d({EIGS_GRID},{EIGS_GRID}), k={EIGS_K}, "
                     "-s dia --precondition amg"}


# ---------------------------------------------------------------- phase 30
SHARD_P = 4                   # virtual shards of the one card
SHARD_GRID = FULL_GRID        # poisson2d(4096²): DIA, CSR all-gather, halo
SHARD_SKEW_ROWS = HYBRID_ROWS  # powerlaw(2²²): the CSR halo, all2all
SHARD_CG_GRID = 512           # poisson2d(512²): products in float64, CG
SHARD_CG_K = CG_K             # batched CG's right-hand sides
SHARD_CG_TOL = {"float64": 1e-8, "float32": 1e-5}
SHARD_CG_MAX = 20000
SHARD_CG_SLACK = 2            # iterations a sharded CG may differ by
SHARD_REPS = 20               # products a timing
TOL_SHARD = {"float64": 1e-12, "float32": 1e-5}
SHARD_WRAPPERS = ("dia_spmv_core", "dia_spmm_core", "csr_spmv_core",
                  "csr_spmm_core")


def _shard_counts(names=SHARD_WRAPPERS) -> dict:
    from spmv_tpu_torch import ops

    return {name: getattr(ops, name).launches for name in names}


class _ShardPath:
    """The launches the sharded path makes: ``run`` calls fn, adds the
    wrappers' (``names``) launches during it to the path's count and
    returns (fn's result, those launches).  Launches outside ``run`` (the
    unsharded products the sharded ones are held against) are not
    counted."""

    def __init__(self, names=SHARD_WRAPPERS):
        self.names = names
        self.launches = dict.fromkeys(names, 0)

    def run(self, fn):
        before = _shard_counts(self.names)
        out = fn()
        delta = {k: v - before[k]
                 for k, v in _shard_counts(self.names).items()}
        for k, v in delta.items():
            self.launches[k] += v
        return out, delta


def _shard_unstack(kind, A, y):
    """The stacked y of a sharded product as the unsharded one, on the
    device: the DIA layout's first num_rows, the CSR layout's rows of
    each shard (trailing axes ride along)."""
    import torch

    if kind == "dia":
        return y.reshape((-1,) + tuple(y.shape[2:]))[: A.num_rows]
    return torch.cat([y[p, : A.bounds[p + 1] - A.bounds[p]]
                      for p in range(A.num_shards)])


def _shard_case(kind, host, dtype, mesh, path, tag, label, exchange="auto",
                time_it=True) -> dict:
    """One sharded SpMV (``kind``: dia, csr or halo) on ``mesh`` against
    the unsharded kernel of its format on the same x: the launches (P a
    product; P more for the halo path's boundary launches), max|dy| /
    max|y|, and ms a product of each (SHARD_REPS back to back, CUDA
    events, eager: the P launches' host cost and the exchange in)."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.models import DeviceCsr, DeviceDia
    from spmv_tpu_torch.ops import csr_spmv_core, dia_spmv_core

    device = mesh.device
    dtn = str(dtype).removeprefix("torch.")
    t0 = time.perf_counter()
    if kind == "dia":
        A = par.shard_dia(host, SHARD_P, dtype=dtype, mesh=mesh)
        full = DeviceDia.from_host(host, dtype=dtype, device=device)
        stack, product, core = (par.stack_dia_vector, par.sharded_dia_spmv,
                                dia_spmv_core)
    else:
        A = (par.shard_csr(host, SHARD_P, dtype=dtype, mesh=mesh)
             if kind == "csr" else
             par.shard_csr_halo(host, SHARD_P, dtype=dtype, mesh=mesh,
                                exchange=exchange))
        full = DeviceCsr.from_host(host, dtype=dtype, device=device)
        stack = par.stack_vector
        product = (par.sharded_spmv if kind == "csr"
                   else par.sharded_halo_spmv)
        core = csr_spmv_core
    build = time.perf_counter() - t0
    g = torch.Generator(device=device).manual_seed(30)
    x = torch.randn(host.num_rows, generator=g, device=device, dtype=dtype)
    xs = stack(x, A)
    want = core(full, x)
    y, delta = path.run(lambda: product(A, xs, mesh))
    name = "dia_spmv_core" if kind == "dia" else "csr_spmv_core"
    boundary = (sum(b is not None for b in A.boundary) if kind == "halo"
                else 0)
    launches = delta[name]
    if launches != SHARD_P + boundary or sum(delta.values()) != launches:
        _fail(f"[{tag}] {label}: launches {delta} for one product, not "
              f"{SHARD_P} + {boundary} of {name}")
    if kind == "halo" and boundary != SHARD_P:
        _fail(f"[{tag}] {label}: only {boundary} of {SHARD_P} shards read "
              "a halo")
    got = _shard_unstack(kind, A, y)
    err = _rel(got, want)
    if not err <= TOL_SHARD[dtn]:
        _fail(f"[{tag}] {label} {dtn}: max|dy|/max|y| {err} > "
              f"{TOL_SHARD[dtn]}")
    res = {"launches_a_product": launches, "max_rel_err": err,
           "bitwise_equal_to_unsharded": bool(torch.equal(got, want)),
           "host_build_s": build}
    if kind == "halo":
        res.update(exchange=A.exchange, max_distance=A.max_distance,
                   comm_elements_exact=A.comm_elements_exact,
                   comm_elements_padded=A.comm_elements_padded,
                   halo_slots=A.halo_slots)
    if time_it:
        buf = torch.empty_like(want)
        res["ms"] = _time_launches(lambda: product(A, xs, mesh), SHARD_REPS)
        res["unsharded_ms"] = _time_launches(lambda: core(full, x, out=buf),
                                             SHARD_REPS)
        if kind == "halo":
            res["exchange_ms"] = _time_launches(
                lambda: par.halo_shard.exchange_halos(
                    xs, A.recv_index, A.recv_missing), SHARD_REPS)
    _say(f"[{tag}] {label} {dtn}: {launches} launches a product, max|dy|/"
         f"max|y| {err:.3e} against the unsharded kernel (bitwise "
         f"{res['bitwise_equal_to_unsharded']}), host build {build:.1f} s"
         + (f"; {res['ms']:.4f} ms a product against {res['unsharded_ms']:.4f}"
            " unsharded" if time_it else "")
         + (f", the exchange alone {res['exchange_ms']:.4f} ms"
            if "exchange_ms" in res else "")
         + (f"; exchange {A.exchange}, {A.comm_elements_exact} elements "
            f"({A.comm_elements_padded} padded)" if kind == "halo" else ""))
    return res


def _shard_spmm_case(kind, host, dtype, mesh, path, tag, k) -> dict:
    """One sharded SpMM at k columns (dia: K2 a shard on the stacked
    (P, k, Rb) block; halo: the CSR SpMM over interior and boundary a
    shard) against the unsharded SpMM kernel; for DIA also the two
    transposes the product makes beside its K2 launches, timed alone."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.models import DeviceCsr, DeviceDia
    from spmv_tpu_torch.ops import csr_spmm_core, dia_spmm_core

    device = mesh.device
    dtn = str(dtype).removeprefix("torch.")
    g = torch.Generator(device=device).manual_seed(31)
    X = torch.randn(host.num_rows, k, generator=g, device=device,
                    dtype=dtype)
    if kind == "dia":
        A = par.shard_dia(host, SHARD_P, dtype=dtype, mesh=mesh)
        full = DeviceDia.from_host(host, dtype=dtype, device=device)
        Xs, product, core = (par.stack_dia_matrix(X, A),
                             par.sharded_dia_spmm, dia_spmm_core)
        name, want_launches = "dia_spmm_core", SHARD_P
    else:
        A = par.shard_csr_halo(host, SHARD_P, dtype=dtype, mesh=mesh)
        full = DeviceCsr.from_host(host, dtype=dtype, device=device)
        Xs, product, core = (par.stack_block(X, A), par.sharded_halo_spmm,
                             csr_spmm_core)
        name = "csr_spmm_core"
        want_launches = SHARD_P + sum(b is not None for b in A.boundary)
    want = core(full, X)
    Y, delta = path.run(lambda: product(A, Xs, mesh))
    if delta[name] != want_launches or sum(delta.values()) != delta[name]:
        _fail(f"[{tag}] {kind} SpMM k={k}: launches {delta}, not "
              f"{want_launches} of {name}")
    got = _shard_unstack(kind, A, Y.transpose(1, 2) if kind == "dia"
                         else Y)
    err = _rel(got, want)
    if not err <= TOL_SHARD[dtn]:
        _fail(f"[{tag}] {kind} SpMM k={k} {dtn}: max|dY|/max|Y| {err} > "
              f"{TOL_SHARD[dtn]}")
    res = {"launches_a_product": delta[name], "max_rel_err": err}
    if dtype == torch.float32:
        buf = torch.empty_like(want)
        res["ms"] = _time_launches(lambda: product(A, Xs, mesh), SHARD_REPS)
        res["unsharded_ms"] = _time_launches(lambda: core(full, X, out=buf),
                                             SHARD_REPS)
        if kind == "dia":
            Xt = Xs.transpose(1, 2).reshape(A.stacked_size, k).contiguous()
            Yt = torch.empty(SHARD_P, A.rows_per_shard, k, dtype=dtype,
                             device=device)

            def launches():
                for q, (s, e) in enumerate(A.windows):
                    dia_spmm_core(A.blocks[q], Xt[s:e], out=Yt[q])

            def copies():
                Xs.transpose(1, 2).reshape(A.stacked_size, k).contiguous()
                Yt.transpose(1, 2).contiguous()

            res["k2_launches_ms"] = _time_launches(launches, SHARD_REPS)
            res["transposes_ms"] = _time_launches(copies, SHARD_REPS)
    _say(f"[{tag}] {kind} SpMM k={k} {dtn}: {delta[name]} launches, "
         f"max|dY|/max|Y| {err:.3e}"
         + (f"; {res['ms']:.4f} ms against {res['unsharded_ms']:.4f} "
            "unsharded" if "ms" in res else "")
         + (f" (the {SHARD_P} K2 launches alone {res['k2_launches_ms']:.4f}"
            f", the two transposes alone {res['transposes_ms']:.4f})"
            if "k2_launches_ms" in res else ""))
    return res


def _shard_cg(device, mesh, csr, dia, path, tag) -> dict:
    """CG over each strategy and batched CG over the DIA matmat (k =
    SHARD_CG_K) at poisson2d(SHARD_CG_GRID²), float64 to 1e-8 and float32
    to 1e-5, b = A ones from the fp64 host product: iterations within
    SHARD_CG_SLACK of the unsharded CG on the same matrix and kernel,
    the solution's max error against ones, host us an iteration."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.models import DeviceCsr, DeviceDia
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        conjugate_gradient,
        csr_spmv_core,
        dia_batched_conjugate_gradient,
        dia_spmv_core,
    )

    b = csr.spmv(np.ones(csr.num_rows))
    B = np.stack([(j + 1) * b for j in range(SHARD_CG_K)], axis=1)
    want_x = np.arange(1, SHARD_CG_K + 1)[None, :]
    out = {}

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    for dtn, tol in SHARD_CG_TOL.items():
        dt = getattr(torch, dtn)
        Dfull = DeviceDia.from_host(dia, dtype=dt, device=device)
        Cfull = DeviceCsr.from_host(csr, dtype=dt, device=device)
        bt = torch.from_numpy(b).to(device, dt)
        D = par.shard_dia(dia, SHARD_P, dtype=dt, mesh=mesh)
        C = par.shard_csr(csr, SHARD_P, dtype=dt, mesh=mesh)
        H = par.shard_csr_halo(csr, SHARD_P, dtype=dt, mesh=mesh)
        cases = {
            "dia_halo": (par.make_sharded_dia_matvec(D, mesh),
                         par.stack_dia_vector(b, D),
                         lambda v: par.unstack_dia_vector(v, D),
                         lambda v: dia_spmv_core(Dfull, v)),
            "csr_all_gather": (par.make_sharded_matvec(C, mesh),
                               par.stack_vector(b, C),
                               lambda v: par.unstack_vector(v, C),
                               lambda v: csr_spmv_core(Cfull, v)),
            "csr_halo": (par.make_sharded_halo_matvec(H, mesh),
                         par.stack_vector(b, H),
                         lambda v: par.unstack_vector(v, H),
                         lambda v: csr_spmv_core(Cfull, v)),
        }
        res_dt = {}
        for name, (mv, bs, unstack, flat) in cases.items():
            (r, wall), _ = path.run(lambda: timed(lambda: conjugate_gradient(
                mv, bs, tol=tol, max_iterations=SHARD_CG_MAX)))
            u, uwall = timed(lambda: conjugate_gradient(
                flat, bt, tol=tol, max_iterations=SHARD_CG_MAX))
            err = float(np.abs(unstack(r.x) - 1.0).max())
            res_dt[name] = {
                "iterations": r.iterations,
                "unsharded_iterations": u.iterations,
                "max_abs_err_vs_ones": err,
                "unsharded_max_abs_err_vs_ones": float(
                    (u.x.double() - 1.0).abs().max()),
                "host_us_an_iteration": wall / max(r.iterations, 1) * 1e6,
                "unsharded_host_us_an_iteration":
                    uwall / max(u.iterations, 1) * 1e6}
            _say(f"[{tag}] CG {name} {dtn} tol {tol:g}: {r.iterations} "
                 f"iterations (unsharded {u.iterations}), max|x - 1| "
                 f"{err:.3e}, {res_dt[name]['host_us_an_iteration']:.1f} "
                 f"host us an iteration (unsharded "
                 f"{res_dt[name]['unsharded_host_us_an_iteration']:.1f})")
            if (r.iterations >= SHARD_CG_MAX
                    or abs(r.iterations - u.iterations) > SHARD_CG_SLACK):
                _fail(f"[{tag}] CG {name} {dtn}: {r.iterations} iterations "
                      f"against {u.iterations} unsharded")
        matmat = par.make_sharded_dia_matmat(D, mesh)
        Bs = par.stack_dia_matrix(B, D)
        (r, wall), delta = path.run(lambda: timed(
            lambda: batched_conjugate_gradient(
                matmat, Bs, tol=tol, max_iterations=SHARD_CG_MAX)))
        its = [int(i) for i in r.iterations]
        u, uwall = timed(lambda: dia_batched_conjugate_gradient(
            Dfull, torch.from_numpy(B).to(device, dt), tol=tol,
            max_iterations=SHARD_CG_MAX))
        uits = [int(i) for i in u.iterations]
        err = float(np.abs(par.unstack_dia_matrix(r.x, D) - want_x).max())
        res_dt["batched_dia_halo"] = {
            "iterations": its, "unsharded_iterations": uits,
            "max_abs_err_vs_solution": err, "k": SHARD_CG_K,
            "dia_spmm_launches": delta["dia_spmm_core"],
            "host_us_an_iteration": wall / max(max(its), 1) * 1e6,
            "unsharded_host_us_an_iteration":
                uwall / max(max(uits), 1) * 1e6}
        _say(f"[{tag}] batched CG dia_halo k={SHARD_CG_K} {dtn} tol "
             f"{tol:g}: iterations {its} (unsharded {uits}), max|X - X*| "
             f"{err:.3e}, K2 launches {delta['dia_spmm_core']} "
             f"({SHARD_P} a matmat), "
             f"{res_dt['batched_dia_halo']['host_us_an_iteration']:.1f} "
             "host us an iteration (unsharded "
             f"{res_dt['batched_dia_halo']['unsharded_host_us_an_iteration']:.1f})")
        if (delta["dia_spmm_core"] != SHARD_P * max(its)
                or max(its) >= SHARD_CG_MAX
                or max(abs(a - c) for a, c in zip(its, uits))
                > SHARD_CG_SLACK):
            _fail(f"[{tag}] batched CG {dtn}: iterations {its} against "
                  f"{uits}, K2 launches {delta['dia_spmm_core']}")
        out[dtn] = res_dt
        del Dfull, Cfull, D, C, H, cases
        _sync(device)
    return out


# phase 30's --scaling runs, in a process of its own that loads no JAX:
# the triad first, on its own line (the parent does host work only until
# it reads it), then the CLI's main on the two generated matrices (84M
# lines of Matrix Market text would take minutes to write and parse), and
# the modules it loaded
_SCALING_CHILD = """
import io, json, sys, time
from spmv_tpu_torch.models.device import default_device
from spmv_tpu_torch.perfmodel import measured_machine
machine = measured_machine(default_device())
print(json.dumps({"triad_gbps": machine.hbm_gbps}), flush=True)
from spmv_tpu_torch import kernels
from spmv_tpu_torch.cli import main
from spmv_tpu_torch.io import matrix_market
from spmv_tpu_torch.io.generate import poisson2d, powerlaw
grid, rows, parts = map(int, sys.argv[1:4])
out = {}
for name, fmt, make in (
        ("poisson", "dia", lambda: poisson2d(grid, grid)),
        ("powerlaw", "csr",
         lambda: powerlaw(rows, rows, 8.0, alpha=1.5, seed=5))):
    mm = make()
    kernels.load_matrix = matrix_market.load_matrix = lambda p, **kw: mm
    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = main(["--matrix", name + ".mtx", "-s", fmt, "--scaling",
               str(parts)], out=buf)
    if rc:
        sys.exit(rc)
    out[name] = {"doc": json.loads(buf.getvalue()),
                 "seconds": time.perf_counter() - t0}
    del mm
out["jax_modules"] = sorted(
    m for m in sys.modules
    if m in ("jax", "spmv_tpu") or m.startswith(("jax.", "spmv_tpu.")))
print(json.dumps(out))
"""


def _start_scaling_child():
    repo = os.path.dirname(os.path.abspath(__file__))
    return subprocess.Popen(
        [sys.executable, "-c", _SCALING_CHILD, str(SHARD_GRID),
         str(SHARD_SKEW_ROWS), str(SHARD_P)], cwd=repo,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _scaling_triad(proc, tag) -> float:
    """Wait for the --scaling child's first line, its triad rate: until
    then this process keeps off the card."""
    line = proc.stdout.readline()
    if not line:
        _fail(f"[{tag}] --scaling child exited {proc.wait()} before its "
              f"triad: {proc.stderr.read()[-2000:]}")
    return json.loads(line)["triad_gbps"]


def _shard_scaling(proc, halos, triad_gbps, tag) -> dict:
    """The --scaling child's reports: each halo_elements_measured equal to
    the worst shard's off-shard reads (counted
    here, ``halos``), no JAX module loaded."""
    stdout, stderr = proc.communicate(timeout=600)
    if proc.returncode != 0:
        _fail(f"[{tag}] --scaling child exited {proc.returncode}: "
              f"{stderr[-2000:]}")
    got = json.loads(stdout.strip().splitlines()[-1])
    if got.pop("jax_modules"):
        _fail(f"[{tag}] the --scaling child loaded JAX modules")
    out = {"triad_gbps": triad_gbps}
    for name, run in got.items():
        s = run["doc"]["scaling"]
        out[name] = {k: s[k] for k in (
            "halo_elements_measured", "all_gather_elements",
            "rows_per_shard", "comm_bytes_per_shard", "t_local_s",
            "t_comm_s", "t_step_s", "weak_efficiency",
            "interconnect_efficiency_assumed",
            "interconnect_efficiency_breakeven", "hbm_efficiency_measured",
            "interconnect")}
        out[name]["cli_seconds"] = run["seconds"]
        _say(f"[{tag}] --scaling {SHARD_P} on {name} "
             f"({run['doc']['kernel']['name']}): halo_elements_measured "
             f"{s['halo_elements_measured']} (counted here: "
             f"{halos[name]}), all_gather_elements "
             f"{s['all_gather_elements']}, weak_efficiency "
             f"{s['weak_efficiency']:.4f}, interconnect "
             f"{s['interconnect']['name']} at "
             f"{s['interconnect']['gbps_per_direction']} GB/s a direction, "
             f"efficiency {s['interconnect_efficiency_assumed']} assumed "
             f"(breakeven {s['interconnect_efficiency_breakeven']:.4f}), "
             f"t_local {s['t_local_s']:.3e} s, t_comm {s['t_comm_s']:.3e} "
             f"s; {run['seconds']:.1f} s in the CLI")
        if s["halo_elements_measured"] != halos[name]:
            _fail(f"[{tag}] --scaling on {name}: halo_elements_measured "
                  f"{s['halo_elements_measured']} != {halos[name]}")
    return out


def _worst_halo(csr) -> int:
    """The worst shard's distinct off-shard reads over the nnz-balanced
    partition, counted from each shard's own run of entries (what
    communication_volume counts, without its masks over every entry)."""
    from spmv_tpu_torch.models.partition import rows_partition_balanced_nnz

    bounds = rows_partition_balanced_nnz(csr.row_ptr, SHARD_P)
    rp = np.asarray(csr.row_ptr, np.int64)
    worst = 0
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        c = np.asarray(csr.column_index[rp[lo]: rp[hi]])
        worst = max(worst, np.unique(c[(c < lo) | (c >= hi)]).size)
    return int(worst)


def _csr_of_dia(dia):
    """The host CSR of a DIA matrix whose stored zeros are no entries (a
    generated poisson2d's), as ``CsrMatrix.from_matrix_market`` builds it
    from the entries: rows in order, each row's columns ascending (the
    offsets are).  A few seconds at 16.8M rows, where the conversion
    from the 84M entries takes half a minute."""
    from spmv_tpu_torch.models import CsrMatrix

    n = dia.num_rows
    data = np.asarray(dia.data)
    keep = data != 0
    cols = np.arange(n)[None, :] + np.asarray(dia.offsets)[:, None]
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(keep.sum(axis=0), out=row_ptr[1:])
    keep = keep.T
    return CsrMatrix(n, dia.num_columns, int(row_ptr[-1]), 1, row_ptr,
                     cols.T[keep].astype(np.int32), data.T[keep])


@_walled
def phase_sharded(device, smi_line, grid_dia=None, skew_mm=None):
    """The sharded paths (phase 30), on SHARD_P virtual shards of the
    card: every product held against the unsharded kernel, its launches
    counted exactly; CG and batched CG; --scaling in a child process;
    dryrun_multichip.  The launches of the sharded calls (not the
    unsharded ones they are held against, nor the timing runs) make the
    path's counts.  ``grid_dia`` and ``skew_mm`` (optional) are
    poisson2d(SHARD_GRID²)'s DIA host matrix and the skewed matrix's
    entries, made by earlier phases; without them the phase makes them.
    Until the --scaling child has measured its triad, this process does
    host work only."""
    import torch

    from spmv_tpu_torch.io.generate import poisson2d, powerlaw
    from spmv_tpu_torch.models import CsrMatrix, DiaMatrix
    from spmv_tpu_torch.parallel import make_mesh
    from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

    tag = "30 sharded"
    t_phase = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    proc = _start_scaling_child()
    try:
        path = _ShardPath()
        mesh = make_mesh(SHARD_P, devices=[device] * SHARD_P)
        t0 = time.perf_counter()
        dia = (grid_dia if grid_dia is not None else DiaMatrix
               .from_matrix_market(poisson2d(SHARD_GRID, SHARD_GRID)))
        csr = _csr_of_dia(dia)
        if csr.num_entries != dia.num_entries:
            _fail(f"[{tag}] the CSR of the DIA matrix holds {csr.num_entries}"
                  f" entries, not {dia.num_entries}")
        skew = CsrMatrix.from_matrix_market(
            skew_mm if skew_mm is not None else powerlaw(
                SHARD_SKEW_ROWS, SHARD_SKEW_ROWS, 8.0, alpha=1.5, seed=5))
        del grid_dia, skew_mm
        halos = {"poisson": _worst_halo(csr), "powerlaw": _worst_halo(skew)}
        label = f"poisson2d({SHARD_GRID},{SHARD_GRID})"
        skew_label = (f"powerlaw({SHARD_SKEW_ROWS}, {SHARD_SKEW_ROWS}, 8.0, "
                      "alpha 1.5, seed 5)")
        _say(f"[{tag}] host {label} CSR (from its DIA) and {skew_label} CSR "
             f"and both halo counts in {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        triad_gbps = _scaling_triad(proc, tag)
        _say(f"[{tag}] waited {time.perf_counter() - t0:.1f} s for the "
             f"--scaling child's triad ({triad_gbps:.1f} GB/s)")
        products = {label: {
            "dia_halo": _shard_case("dia", dia, f32, mesh, path, tag,
                                    f"{label} DIA halo"),
            "csr_all_gather": _shard_case("csr", csr, f32, mesh, path, tag,
                                          f"{label} CSR all-gather"),
            "csr_halo": _shard_case("halo", csr, f32, mesh, path, tag,
                                    f"{label} CSR halo")}}
        del csr, dia
        _sync(device)
        csr, label = skew, skew_label
        del skew
        products[label] = {"csr_halo": _shard_case(
            "halo", csr, f32, mesh, path, tag, f"{label} CSR halo",
            exchange="all2all")}
        del csr
        _sync(device)
        mm = poisson2d(SHARD_CG_GRID, SHARD_CG_GRID)
        csr, dia = CsrMatrix.from_matrix_market(mm), \
            DiaMatrix.from_matrix_market(mm)
        del mm
        label = f"poisson2d({SHARD_CG_GRID},{SHARD_CG_GRID})"
        products[label] = {
            "dia_halo": _shard_case("dia", dia, f64, mesh, path, tag,
                                    f"{label} DIA halo", time_it=False),
            "csr_all_gather": _shard_case(
                "csr", csr, f64, mesh, path, tag, f"{label} CSR all-gather",
                time_it=False),
            "csr_halo": _shard_case("halo", csr, f64, mesh, path, tag,
                                    f"{label} CSR halo", time_it=False),
            "csr_halo_all2all": _shard_case(
                "halo", csr, f64, mesh, path, tag,
                f"{label} CSR halo (all2all)", exchange="all2all",
                time_it=False)}
        for dt in (f64, f32):
            dtn = str(dt).removeprefix("torch.")
            for kind, host in (("dia", dia), ("halo", csr)):
                products[label][f"{kind}_spmm_k{SHARD_CG_K}_{dtn}"] = \
                    _shard_spmm_case(kind, host, dt, mesh, path, tag,
                                     SHARD_CG_K)
        cg = _shard_cg(device, mesh, csr, dia, path, tag)
        del csr, dia
        _sync(device)
        dry, delta = path.run(lambda: dryrun_multichip(SHARD_P,
                                                       device=device))
        _say(f"[{tag}] dryrun_multichip({SHARD_P}) on {device}: launches "
             f"{delta}")
        scaling = _shard_scaling(proc, halos, triad_gbps, tag)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    launches = {k.removesuffix("_core"): n for k, n in path.launches.items()}
    _say(f"[{tag}] launches on the sharded path: {launches}")
    for name, n in launches.items():
        if n <= 0:
            _fail(f"[{tag}] {name} was never launched on the sharded path")
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    return {"launches": launches, "products": products, "cg": cg,
            "scaling": scaling, "dryrun": dry, "shards": SHARD_P,
            "seconds": secs, "card": smi_line,
            "note": "virtual shards on one card: no interconnect in any "
                    "time"}


# phase 31: the second sharded half (WELL, WELL-CW, BSR, block-Jacobi
# IC(0)), on SHARD_P virtual shards of the card
SHARD_WELL_WINDOW = 4         # phase 12's window rows at poisson2d(4096²)
SHARD_CW_K = CW_SPMM_K        # the WELL-CW halo SpMM's right-hand sides
SHARD_FMT_CG_GRID = CG_GRID   # poisson2d(1024²): block-IC(0) vs Jacobi PCG
SHARD_SMALL_GRID = 256        # Chebyshev and masked LOBPCG
SHARD_LANCZOS_STEPS = 300     # 30 (the dryrun's) put lambda_min 40x high
SHARD_CHEB_CHECK = 10
SHARD_CHEB_MAX = 20000
SHARD_EIG_K = 4
SHARD_EIG_TOL = 1e-8          # float64: float32 at 1e-4 stalled, its 4th
SHARD_EIG_MAX = 2000          # eigenvalue 2.7% off after 1,000 steps
SHARD_EIG_RTOL = 1e-6         # against the analytic eigenvalues
FORMAT_WRAPPERS = ("well_whole_core", "well_seg_core", "wellcw_merged_core",
                   "wellcw_level_core", "wellcw_pool_core",
                   "wellcw_merged_spmm_core", "wellcw_level_spmm_core",
                   "wellcw_pool_spmm_core", "csr_spmv_core", "csr_spmm_core",
                   "bsr_spmm_core", "tri_solve_core")


def _format_product(tag, label, A, product, unsharded, unstack, ref64,
                    exchange, want, path, build_s) -> dict:
    """One sharded product of phase 31 against the unsharded kernel of its
    format (``unsharded(out)``) and the fp64 product ``ref64``: its
    launches exactly ``want`` (the container's ``launches_a_product``),
    max|dy| / max|y| against each within TOL_SHARD's float32, whether it is
    bitwise the unsharded kernel's, ms a product of each and of the
    exchange alone (SHARD_REPS back to back, CUDA events, eager: the
    launches' host cost in), and the exchange's volume."""
    import torch

    base = unsharded(None)
    y, delta = path.run(product)
    moved = {k: v for k, v in delta.items() if v}
    if moved != want:
        _fail(f"[{tag}] {label}: launches {moved} for one product, not "
              f"{want}")
    got = unstack(y)
    err, err64 = _rel(got, base), _rel(got, ref64)
    tol = TOL_SHARD["float32"]
    if not (err <= tol and err64 <= tol):
        _fail(f"[{tag}] {label}: max|dy|/max|y| {err} against the unsharded "
              f"kernel, {err64} against the fp64 product (> {tol})")
    buf = torch.empty_like(base)
    res = {"launches_a_product": moved, "max_rel_err": err,
           "max_rel_err_fp64": err64,
           "bitwise_equal_to_unsharded": bool(torch.equal(got, base)),
           "host_build_s": build_s,
           "ms": _time_launches(product, SHARD_REPS),
           "unsharded_ms": _time_launches(lambda: unsharded(buf), SHARD_REPS),
           "exchange": getattr(A, "exchange", "all-gather")}
    if exchange is not None:
        res["exchange_ms"] = _time_launches(exchange, SHARD_REPS)
        res.update({f: getattr(A, f) for f in (
            "max_distance", "halo_slots", "comm_elements_exact",
            "comm_elements_padded", "comm_blocks_exact") if hasattr(A, f)})
    _say(f"[{tag}] {label}: launches {moved} a product, max|dy|/max|y| "
         f"{err:.3e} against the unsharded kernel (bitwise "
         f"{res['bitwise_equal_to_unsharded']}), {err64:.3e} against fp64; "
         f"{res['ms']:.4f} ms a product against {res['unsharded_ms']:.4f} "
         f"unsharded"
         + (f", the exchange alone {res['exchange_ms']:.4f} ms ({A.exchange},"
            f" {A.comm_elements_exact} elements exact, "
            f"{A.comm_elements_padded} padded"
            + (f", {A.comm_blocks_exact} tiles" if hasattr(
                A, "comm_blocks_exact") else "") + ")"
            if exchange is not None else "")
         + f"; host build {build_s:.1f} s")
    return res


def _fp64_csr(m, device):
    """The host CSR's entries as a float64 torch.sparse matrix on the card:
    the fp64 reference products."""
    import torch

    t = torch.from_numpy
    return _torch_csr(t(np.asarray(m.row_ptr, np.int64)).to(device),
                      t(np.asarray(m.column_index[: m.num_entries],
                                   np.int64)).to(device),
                      t(np.asarray(m.value[: m.num_entries],
                                   np.float64)).to(device),
                      (m.num_rows, m.num_columns))


def _bsr_fp64(host, X, device):
    """Y = A @ X in float64 from the host BSR's blocks (each rounded to
    ``X``'s dtype first, as K7 reads them) on the card: a batched product a
    block, summed by block row."""
    import torch

    bh = host.block_rows
    blocks = torch.from_numpy(np.asarray(host.blocks)).to(device)
    blocks = blocks.to(X.dtype).double()
    col = torch.from_numpy(np.asarray(host.block_col, np.int64)).to(device)
    row = torch.from_numpy(np.repeat(
        np.arange(host.num_block_rows), np.diff(host.block_rowptr))).to(device)
    k = X.shape[1]
    ncb = -(-host.num_columns // 128)
    Xp = torch.zeros(ncb * 128, k, dtype=torch.float64, device=device)
    Xp[: host.num_columns] = X.double()
    prods = torch.bmm(blocks, Xp.reshape(ncb, 128, k)[col])
    Y = torch.zeros(host.num_block_rows, bh, k, dtype=torch.float64,
                    device=device)
    Y.index_add_(0, row, prods)
    return Y.reshape(-1, k)[: host.num_rows]


def _format_products(device, mesh, path, tag, poisson, well_full, cw_mm,
                     cw_host, bsr_host) -> dict:
    """The full-width products: the WELL all-gather and halo SpMV at
    poisson2d(SHARD_GRID²), window rows SHARD_WELL_WINDOW, beside phase
    12's K5b ``well_full``; the WELL-CW halo SpMV and SpMM (k =
    SHARD_CW_K) at phase 7's banded_random, neighbor and all2all forced,
    beside its unsharded kernels; the BSR halo SpMM at phase 18's
    block_random, k = BSR_K, float32 (SIMT) and bf16 (tensor cores),
    beside its unsharded K7."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.models import CsrMatrix, DeviceBsr, DeviceWellCw
    from spmv_tpu_torch.ops import (
        bsr_spmm_core,
        well_spmv_core,
        wellcw_spmm_core,
        wellcw_spmv_core,
    )
    from spmv_tpu_torch.parallel import bsr_shard

    f32 = torch.float32
    out = {}
    g = torch.Generator(device=device).manual_seed(31)
    label = f"poisson2d({SHARD_GRID},{SHARD_GRID})"
    x = torch.randn(poisson.num_rows, generator=g, device=device, dtype=f32)
    ref = _fp64_csr(poisson, device) @ x.double()
    for kind in ("well_all_gather", "well_halo"):
        t0 = time.perf_counter()
        A = (par.shard_well(poisson, SHARD_P, window_rows=SHARD_WELL_WINDOW,
                            dtype=f32, mesh=mesh)
             if kind == "well_all_gather" else
             par.shard_well_halo(poisson, SHARD_P,
                                 window_rows=SHARD_WELL_WINDOW, dtype=f32,
                                 mesh=mesh))
        build = time.perf_counter() - t0
        xs = par.stack_vector(x, A)
        product = (par.sharded_well_spmv if kind == "well_all_gather"
                   else par.sharded_well_halo_spmv)
        out[f"{label} {kind}"] = _format_product(
            tag, f"{label} WELL {kind.split('_', 1)[1].replace('_', '-')}",
            A, lambda: product(A, xs, mesh),
            lambda o: well_spmv_core(well_full, x, out=o),
            lambda y: _shard_unstack("csr", A, y), ref,
            None if kind == "well_all_gather"
            else lambda: par.halo_shard.halo_of(A, xs),
            A.launches_a_product(), path, build)
        del A, xs
        _sync(device)
    del ref

    label = f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8)"
    t0 = time.perf_counter()
    cw = CsrMatrix.from_matrix_market(cw_mm)
    full = DeviceWellCw.from_host(cw_host, dtype=f32, device=device)
    _say(f"[{tag}] host {label} CSR and the unsharded DeviceWellCw in "
         f"{time.perf_counter() - t0:.1f} s")
    S = _fp64_csr(cw, device)
    x = torch.randn(cw.num_rows, generator=g, device=device, dtype=f32)
    X = torch.randn(cw.num_rows, SHARD_CW_K, generator=g, device=device,
                    dtype=f32)
    ref, ref_mm = S @ x.double(), S @ X.double()
    del S
    for exchange in ("neighbor", "all2all"):
        t0 = time.perf_counter()
        A = par.shard_wellcw_halo(cw, SHARD_P, dtype=f32, mesh=mesh,
                                  exchange=exchange)
        build = time.perf_counter() - t0
        xs, Xs = par.stack_vector(x, A), par.stack_block(X, A)
        out[f"{label} wellcw_halo {exchange}"] = _format_product(
            tag, f"{label} WELL-CW halo ({exchange})", A,
            lambda: par.sharded_wellcw_halo_spmv(A, xs, mesh),
            lambda o: wellcw_spmv_core(full, x, out=o),
            lambda y: _shard_unstack("csr", A, y), ref,
            lambda: par.halo_shard.halo_of(A, xs), A.launches_a_product(),
            path, build)
        out[f"{label} wellcw_halo_spmm_k{SHARD_CW_K} {exchange}"] = \
            _format_product(
                tag, f"{label} WELL-CW halo SpMM k={SHARD_CW_K} ({exchange})",
                A, lambda: par.sharded_wellcw_halo_spmm(A, Xs, mesh),
                lambda o: wellcw_spmm_core(full, X, out=o),
                lambda y: _shard_unstack("csr", A, y), ref_mm,
                lambda: par.halo_shard.halo_of(A, Xs),
                A.launches_a_product(spmm=True), path, 0.0)
        del A, xs, Xs
        _sync(device)
    del full, ref, ref_mm, x, X, cw

    label = f"block_random({BSR_ROWS},{BSR_ROWS},8)"
    X32 = torch.randn(bsr_host.num_columns, BSR_K, generator=g,
                      device=device, dtype=f32)
    for dt in (f32, torch.bfloat16):
        dtn = str(dt).removeprefix("torch.")
        X = X32.to(dt)
        full = DeviceBsr.from_host(bsr_host, dtype=dt, blocks_per_step=1,
                                   device=device)
        ref = _bsr_fp64(bsr_host, X, device)
        t0 = time.perf_counter()
        A = par.shard_bsr_halo(bsr_host, SHARD_P, dtype=dt, mesh=mesh)
        build = time.perf_counter() - t0
        Xs = bsr_shard.stack_columns(X, A)
        n = bsr_host.num_rows
        out[f"{label} bsr_halo k={BSR_K} {dtn}"] = _format_product(
            tag, f"{label} BSR halo SpMM k={BSR_K} {dtn}", A,
            lambda: par.sharded_bsr_spmm(A, Xs, mesh),
            lambda o: bsr_spmm_core(full, X, out=o),
            lambda y: y.reshape(-1, BSR_K)[:n], ref,
            lambda: bsr_shard.extend_columns(A, Xs), A.launches_a_product(),
            path, build)
        del A, Xs, full, ref, X
        _sync(device)
    return out


def _format_solvers(device, mesh, path, tag) -> dict:
    """Block-Jacobi IC(0) PCG against Jacobi-PCG over the halo CSR matvec
    at poisson2d(SHARD_FMT_CG_GRID²), float64 and float32 (SHARD_CG_TOL,
    b = A ones): iterations, host us an
    iteration, tri_solve launches an apply; then, at
    poisson2d(SHARD_SMALL_GRID²), Chebyshev with lanczos_bounds in float32
    (beside the unsharded CSR kernel's Chebyshev on the same bounds) and
    LOBPCG at k = SHARD_EIG_K in float64 with the padding rows masked and
    the block-IC(0) apply a column as its preconditioner, against the
    analytic eigenvalues."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
    from spmv_tpu_torch.ops import (
        chebyshev,
        csr_spmv_core,
        extract_diagonal,
        jacobi_preconditioner,
        lanczos_bounds,
        lobpcg,
        preconditioned_conjugate_gradient,
    )

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    out = {}
    m = CsrMatrix.from_matrix_market(poisson2d(SHARD_FMT_CG_GRID,
                                               SHARD_FMT_CG_GRID))
    b = m.spmv(np.ones(m.num_rows))
    label = f"poisson2d({SHARD_FMT_CG_GRID},{SHARD_FMT_CG_GRID})"
    for dtn, tol in SHARD_CG_TOL.items():
        dt = getattr(torch, dtn)
        H = par.shard_csr_halo(m, SHARD_P, dtype=dt, mesh=mesh)
        t0 = time.perf_counter()
        M = par.block_jacobi_ic0(m, H.bounds, H.rows_per_shard, dtype=dt,
                                 mesh=mesh)
        build = time.perf_counter() - t0
        mv = par.make_sharded_halo_matvec(H, mesh)
        bs = par.stack_vector(b, H)
        jac = jacobi_preconditioner(par.stack_vector(extract_diagonal(m), H))
        apply = par.make_sharded_block_ic0_preconditioner(M, mesh)
        applies = [0]

        def counted(r):
            applies[0] += 1
            return apply(r)

        res = {"block_ic0_setup_s": build, "shift_used": M.shift_used,
               "levels_a_triangle": [T.num_levels for T in M.lower],
               "launches_an_apply": M.launches_an_apply()["tri_solve_core"]}
        for name, pre in (("jacobi_pcg", jac), ("block_ic0_pcg", counted)):
            (r, wall), delta = path.run(lambda: timed(
                lambda: preconditioned_conjugate_gradient(
                    mv, bs, pre, tol=tol, max_iterations=SHARD_CG_MAX)))
            err = float(np.abs(par.unstack_vector(r.x, H) - 1.0).max())
            res[name] = {"iterations": r.iterations,
                         "max_abs_err_vs_ones": err,
                         "host_us_an_iteration":
                             wall / max(r.iterations, 1) * 1e6,
                         "tri_solve_launches": delta["tri_solve_core"]}
            if r.iterations >= SHARD_CG_MAX:
                _fail(f"[{tag}] {name} {dtn} did not converge")
        tri = res["block_ic0_pcg"]["tri_solve_launches"]
        if tri != applies[0] * res["launches_an_apply"] or not applies[0]:
            _fail(f"[{tag}] block-IC(0) PCG {dtn}: {tri} tri_solve launches "
                  f"for {applies[0]} applies, not {res['launches_an_apply']} "
                  "each")
        if (res["block_ic0_pcg"]["iterations"]
                >= res["jacobi_pcg"]["iterations"]):
            _fail(f"[{tag}] block-IC(0) PCG {dtn} took no fewer iterations "
                  "than Jacobi-PCG")
        res["tri_solve_launches_an_apply"] = tri / applies[0]
        _say(f"[{tag}] {label} {dtn} tol {tol:g}: Jacobi-PCG "
             f"{res['jacobi_pcg']['iterations']} iterations "
             f"({res['jacobi_pcg']['host_us_an_iteration']:.1f} host us an "
             f"iteration), block-IC(0) PCG "
             f"{res['block_ic0_pcg']['iterations']} "
             f"({res['block_ic0_pcg']['host_us_an_iteration']:.1f} host us, "
             f"{res['tri_solve_launches_an_apply']:g} tri_solve launches an "
             f"apply, levels a shard's L {res['levels_a_triangle']}); "
             f"max|x - 1| {res['jacobi_pcg']['max_abs_err_vs_ones']:.2e} / "
             f"{res['block_ic0_pcg']['max_abs_err_vs_ones']:.2e}; IC(0) of "
             f"the {SHARD_P} blocks and their solves {build:.1f} s")
        out[f"{label} {dtn}"] = res
        del H, M
        _sync(device)

    f32 = torch.float32
    m = CsrMatrix.from_matrix_market(poisson2d(SHARD_SMALL_GRID,
                                               SHARD_SMALL_GRID))
    label = f"poisson2d({SHARD_SMALL_GRID},{SHARD_SMALL_GRID})"
    H = par.shard_csr_halo(m, SHARD_P, dtype=f32, mesh=mesh)
    mv = par.make_sharded_halo_matvec(H, mesh)
    rng = np.random.default_rng(31)
    bs = par.stack_vector(m.spmv(np.ones(m.num_rows)), H)
    v0 = par.stack_vector(rng.standard_normal(m.num_rows), H)
    (lo, hi), _ = path.run(lambda: lanczos_bounds(
        mv, tuple(bs.shape), num_steps=SHARD_LANCZOS_STEPS, dtype=f32, v0=v0,
        device=device))
    (r, wall), _ = path.run(lambda: timed(lambda: chebyshev(
        mv, bs, lo, hi, tol=SHARD_CG_TOL["float32"],
        max_iterations=SHARD_CHEB_MAX, check_every=SHARD_CHEB_CHECK)))
    full = DeviceCsr.from_host(m, dtype=f32, device=device)
    u = chebyshev(lambda v: csr_spmv_core(full, v),
                  torch.from_numpy(m.spmv(np.ones(m.num_rows))).to(device,
                                                                   f32),
                  lo, hi, tol=SHARD_CG_TOL["float32"],
                  max_iterations=SHARD_CHEB_MAX,
                  check_every=SHARD_CHEB_CHECK)
    cheb = {"bounds": [lo, hi], "lanczos_steps": SHARD_LANCZOS_STEPS,
            "iterations": r.iterations, "unsharded_iterations": u.iterations,
            "max_abs_err_vs_ones": float(np.abs(
                par.unstack_vector(r.x, H) - 1.0).max()),
            "host_us_an_iteration": wall / max(r.iterations, 1) * 1e6}
    _say(f"[{tag}] {label} float32 Chebyshev on lanczos_bounds "
         f"({SHARD_LANCZOS_STEPS} steps) [{lo:.4e}, {hi:.4f}]: "
         f"{r.iterations} iterations (unsharded {u.iterations}), max|x - 1| "
         f"{cheb['max_abs_err_vs_ones']:.2e}, "
         f"{cheb['host_us_an_iteration']:.1f} host us an iteration")
    if (r.iterations >= SHARD_CHEB_MAX or abs(r.iterations - u.iterations)
            > SHARD_CG_SLACK * SHARD_CHEB_CHECK):
        _fail(f"[{tag}] Chebyshev: {r.iterations} iterations against "
              f"{u.iterations} unsharded")
    out[f"{label} chebyshev"] = cheb

    f64 = torch.float64
    H = par.shard_csr_halo(m, SHARD_P, dtype=f64, mesh=mesh)
    k, P, R = SHARD_EIG_K, H.num_shards, H.rows_per_shard
    mask = np.zeros((P, R))
    for q in range(P):
        mask[q, : H.bounds[q + 1] - H.bounds[q]] = 1.0
    mask[:, R - 1] = 0.0
    M = par.block_jacobi_ic0(m, H.bounds, R, dtype=f64, mesh=mesh)
    apply = par.make_sharded_block_ic0_preconditioner(M, mesh)
    matmat = par.make_sharded_halo_matmat(H, mesh)
    X0 = par.stack_block(rng.standard_normal((m.num_rows, k)), H)
    (r, wall), delta = path.run(lambda: timed(lambda: lobpcg(
        lambda V: matmat(V.reshape(P, R, k)).reshape(P * R, k),
        X0.reshape(P * R, k),
        preconditioner=lambda W: torch.stack(
            [apply(W[:, j].reshape(P, R)).reshape(-1) for j in range(k)], 1),
        tol=SHARD_EIG_TOL, max_iterations=SHARD_EIG_MAX,
        mask=torch.from_numpy(mask.reshape(-1)).to(device, f64))))
    i = np.arange(1, SHARD_SMALL_GRID + 1)
    want = np.sort((4.0 - 2.0 * np.cos(i * np.pi / (SHARD_SMALL_GRID + 1))
                    [:, None] - 2.0 * np.cos(i * np.pi / (
                        SHARD_SMALL_GRID + 1))[None]).ravel())[:k]
    got = r.eigenvalues.double().cpu().numpy()
    rel = float(np.max(np.abs(got - want) / want))
    its = int(r.iterations)
    eig = {"iterations": its, "k": k, "dtype": "float64",
           "tol": SHARD_EIG_TOL, "eigenvalues": got.tolist(),
           "max_rel_err_vs_analytic": rel,
           "host_ms_an_iteration": wall / max(its, 1) * 1e3,
           "csr_spmm_launches": delta["csr_spmm_core"],
           "tri_solve_launches": delta["tri_solve_core"]}
    _say(f"[{tag}] {label} float64 LOBPCG k={k}, tol {SHARD_EIG_TOL:g}, "
         f"masked, block-IC(0) a column: {its} iterations, eigenvalues "
         f"{got} (analytic {want}, max rel err {rel:.2e}), "
         f"{eig['host_ms_an_iteration']:.2f} host ms an iteration, CSR SpMM "
         f"launches {delta['csr_spmm_core']}, tri_solve "
         f"{delta['tri_solve_core']}")
    if its >= SHARD_EIG_MAX or not rel <= SHARD_EIG_RTOL:
        _fail(f"[{tag}] LOBPCG: {its} iterations, eigenvalue rel err {rel}")
    out[f"{label} lobpcg"] = eig
    return out


@_walled
def phase_sharded_formats(device, smi_line, grid_dia=None, well_full=None,
                          cw_mm=None, cw_host=None, bsr_host=None):
    """The second sharded half (phase 31) on SHARD_P virtual shards of the
    card: the full-width WELL, WELL-CW and BSR products held against the
    unsharded kernel of their format and the fp64 product, launches exact
    (``_format_products``); the solvers over the sharded operators
    (``_format_solvers``); ``dryrun_multichip``.  The wrappers' launches
    of the sharded calls make the path's counts.  The host matrices come
    from earlier phases where given (``grid_dia``: poisson2d(SHARD_GRID²)
    as DIA; ``well_full``: its unsharded DeviceWell, K5b; ``cw_mm`` /
    ``cw_host``: phase 7's banded_random entries and WELL-CW;
    ``bsr_host``: phase 18's block_random BSR), else made here."""
    import torch

    from spmv_tpu_torch.io.generate import banded_random, block_random
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import (
        BsrMatrix,
        DeviceWell,
        DiaMatrix,
        WellCwMatrix,
        WellMatrix,
    )
    from spmv_tpu_torch.parallel import make_mesh
    from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

    tag = "31 sharded formats"
    t_phase = time.perf_counter()
    path = _ShardPath(FORMAT_WRAPPERS)
    mesh = make_mesh(SHARD_P, devices=[device] * SHARD_P)
    t0 = time.perf_counter()
    if grid_dia is None:
        grid_dia = DiaMatrix.from_matrix_market(poisson2d(SHARD_GRID,
                                                          SHARD_GRID))
    poisson = _csr_of_dia(grid_dia)
    del grid_dia
    if well_full is None:
        well_full = DeviceWell.from_host(WellMatrix.from_csr(
            poisson, window_rows=SHARD_WELL_WINDOW), dtype=torch.float32,
            device=device)
    if cw_mm is None:
        cw_mm = banded_random(CW_FULL_ROWS, half_bandwidth=CW_FULL_HALF_BW,
                              nnz_per_row=8, seed=1)
    if cw_host is None:
        cw_host = WellCwMatrix.from_matrix_market(cw_mm)
    if bsr_host is None:
        bsr_host = BsrMatrix.from_matrix_market(
            block_random(BSR_ROWS, BSR_ROWS, 8, seed=2), block_rows=128)
    _say(f"[{tag}] host matrices in {time.perf_counter() - t0:.1f} s")
    products = _format_products(device, mesh, path, tag, poisson, well_full,
                                cw_mm, cw_host, bsr_host)
    del poisson, well_full, cw_mm, cw_host, bsr_host
    _sync(device)
    solvers = _format_solvers(device, mesh, path, tag)
    _sync(device)
    dry, delta = path.run(lambda: dryrun_multichip(SHARD_P, device=device))
    _say(f"[{tag}] dryrun_multichip({SHARD_P}) on {device}: launches "
         f"{ {k: v for k, v in delta.items() if v} }")
    launches = {k.removesuffix("_core"): n for k, n in path.launches.items()}
    _say(f"[{tag}] launches on the sharded formats' path: {launches}")
    # K4b is the fallback level's SpMM: the full-width WELL-CW interiors
    # are merged grids (K4a), and the dryrun takes no WELL-CW SpMM
    for name, n in launches.items():
        if n <= 0 and name != "wellcw_level_spmm":
            _fail(f"[{tag}] {name} was never launched on the sharded "
                  "formats' path")
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    return {"launches": launches, "products": products, "solvers": solvers,
            "dryrun": dry, "shards": SHARD_P, "seconds": secs,
            "card": smi_line,
            "note": "virtual shards on one card: no interconnect in any "
                    "time"}


# phase 32: the process mesh (parallel.distributed, parallel.comm), first
# at one NCCL rank in this process, then in a Gloo job of two child
# processes sharing the card
DIST_P = SHARD_P              # shards: 4, two a rank in the Gloo job
DIST_WORLD = 2                # ranks of the Gloo job
DIST_DIA_GRID = FULL_GRID     # poisson2d(4096²): the DIA halo SpMV / SpMM
DIST_CSR_GRID = 2048          # poisson2d(2048²): the CSR paths
DIST_CG_GRID = CG_GRID        # poisson2d(1024²): CG float32 to 1e-5
DIST_CG_TOL = 1e-5
DIST_CG_SLACK = 0.02          # a rank job's CG count within 2% of one
DIST_BCG_GRID = 256           # batched CG float64 to 1e-8, k = DIST_K
DIST_BCG_TOL = 1e-8
DIST_K = 4
DIST_REPS = 10                # products (exchanges) a host-clock timing
DIST_CHILD_S = 420            # the Gloo job's wall limit: past it, fail
DIST_WRAPPERS = ("dia_spmv_core", "dia_spmm_core", "csr_spmv_core")
DIST_CASES = ("dia_spmv", f"dia_spmm_k{DIST_K}", "csr_all_gather",
              "csr_halo_neighbor", "csr_halo_all2all")
DIST_GLOO_NOTE = ("host-staged Gloo times of two processes on one card, "
                  "not NVLink")

# one rank of phase 32's Gloo job (store, world size, rank, device, the
# grids as JSON): its JSON on the last line
_DIST_CHILD = """
import json, sys
import chip_smoke as c
print(json.dumps(c.distributed_rank(sys.argv[1], int(sys.argv[2]),
                                    int(sys.argv[3]), sys.argv[4],
                                    json.loads(sys.argv[5]))), flush=True)
"""


def _dist_grids() -> dict:
    return {"dia": DIST_DIA_GRID, "csr": DIST_CSR_GRID, "cg": DIST_CG_GRID,
            "bcg": DIST_BCG_GRID}


def _dist_hosts(grids, dia_full=None) -> dict:
    """Phase 32's host matrices, poisson2d of each of ``grids``: ``dia``
    as DIA (the caller's where given), ``csr`` as CSR, ``cg`` as DIA and
    CSR, ``bcg`` as DIA; every CSR from its DIA (``_csr_of_dia``), so
    every process builds the same entries in the same order."""
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix

    def dia(grid):
        return DiaMatrix.from_matrix_market(poisson2d(grid, grid))

    cg = dia(grids["cg"])
    return {"dia": dia_full if dia_full is not None else dia(grids["dia"]),
            "csr": _csr_of_dia(dia(grids["csr"])), "cg_dia": cg,
            "cg_csr": _csr_of_dia(cg), "bcg_dia": dia(grids["bcg"])}


def _rows_hash(t) -> str:
    import hashlib

    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


def _dsync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_ms(fn, reps: int, device) -> float:
    """Host milliseconds a call of fn, synchronized, after one warm-up:
    the Gloo exchanges block the host, so the host clock holds them."""
    fn()
    _dsync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _dsync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def _dist_products(hosts, mesh, path, cases=DIST_CASES,
                   time_it=False) -> dict:
    """Phase 32's float32 products on ``mesh`` (the path's launches
    counted by ``path``): {case: {"rows": this process's stacked rows,
    and with ``time_it`` "ms" a product and "exchange_ms" the exchange
    alone}}; x (X) drawn on the device from a seed a case, whole, so
    every process draws the same."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel import dia_shard, halo_shard

    device, f32 = mesh.device, torch.float32
    out = {}
    for case in cases:
        g = torch.Generator(device=device).manual_seed(
            320 + DIST_CASES.index(case))
        if case.startswith("dia"):
            A = par.shard_dia(hosts["dia"], DIST_P, dtype=f32, mesh=mesh)
            if case == "dia_spmv":
                xs = par.stack_dia_vector(torch.randn(
                    A.num_rows, generator=g, device=device, dtype=f32), A)
                product = par.sharded_dia_spmv
                flat = xs.reshape(-1)
            else:
                xs = par.stack_dia_matrix(torch.randn(
                    A.num_rows, DIST_K, generator=g, device=device,
                    dtype=f32), A)
                product = par.sharded_dia_spmm
                flat = xs.transpose(1, 2).reshape(-1, DIST_K).contiguous()

            def exchange():
                return dia_shard._extended(A, flat)
        else:
            kind = case.removeprefix("csr_")
            A = (par.shard_csr(hosts["csr"], DIST_P, dtype=f32, mesh=mesh)
                 if kind == "all_gather" else par.shard_csr_halo(
                     hosts["csr"], DIST_P, dtype=f32, mesh=mesh,
                     exchange=kind.removeprefix("halo_")))
            xs = par.stack_vector(torch.randn(
                A.num_rows, generator=g, device=device, dtype=f32), A, mesh)
            product = (par.sharded_spmv if kind == "all_gather"
                       else par.sharded_halo_spmv)

            def exchange():
                if kind == "all_gather":
                    return par.all_gather_rows(xs, mesh)
                return halo_shard.halo_of(A, xs)
        rows, _ = path.run(lambda: product(A, xs, mesh))
        res = {"rows": rows}
        if time_it:
            res["ms"] = _host_ms(lambda: product(A, xs, mesh), DIST_REPS,
                                 device)
            res["exchange_ms"] = _host_ms(exchange, DIST_REPS, device)
        out[case] = res
    return out


def _dist_solvers(hosts, mesh, path, cases=("dia_halo", "csr_halo",
                                            "batched_dia_halo")) -> dict:
    """CG float32 to DIST_CG_TOL over the DIA halo and the halo CSR
    matvecs at poisson2d(DIST_CG_GRID²) and batched CG float64 to
    DIST_BCG_TOL over the DIA matmat (k = DIST_K) at
    poisson2d(DIST_BCG_GRID²), on ``mesh`` with ``mesh=`` (its dots summed
    over the ranks of a process mesh), b = A ones from the fp64 host
    product (column j: j + 1 times it): iterations, max|x - x*|, host us
    an iteration."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import (
        batched_conjugate_gradient,
        conjugate_gradient,
    )

    out = {}
    for case in cases:
        if case == "batched_dia_halo":
            b = hosts["bcg_dia"].spmv(np.ones(hosts["bcg_dia"].num_rows))
            B = np.stack([(j + 1) * b for j in range(DIST_K)], axis=1)
            A = par.shard_dia(hosts["bcg_dia"], DIST_P, dtype=torch.float64,
                              mesh=mesh)
            mv, bs = par.make_sharded_dia_matmat(A, mesh), \
                par.stack_dia_matrix(B, A)

            def solve():
                return batched_conjugate_gradient(
                    mv, bs, tol=DIST_BCG_TOL, max_iterations=SHARD_CG_MAX)

            def unstack(v):
                return par.unstack_dia_matrix(v, A) - np.arange(
                    1, DIST_K + 1)[None, :]
        else:
            b = hosts["cg_csr"].spmv(np.ones(hosts["cg_csr"].num_rows))
            if case == "dia_halo":
                A = par.shard_dia(hosts["cg_dia"], DIST_P,
                                  dtype=torch.float32, mesh=mesh)
                mv, bs = par.make_sharded_dia_matvec(A, mesh), \
                    par.stack_dia_vector(b, A)
                unstack = functools.partial(_dist_unstack_err,
                                            par.unstack_dia_vector, A)
            else:
                A = par.shard_csr_halo(hosts["cg_csr"], DIST_P,
                                       dtype=torch.float32, mesh=mesh)
                mv, bs = par.make_sharded_halo_matvec(A, mesh), \
                    par.stack_vector(b, A, mesh)
                unstack = functools.partial(_dist_unstack_err,
                                            par.unstack_vector, A)

            def solve():
                return conjugate_gradient(mv, bs, tol=DIST_CG_TOL,
                                          max_iterations=SHARD_CG_MAX)
        _dsync(mesh.device)
        t0 = time.perf_counter()
        r, _ = path.run(solve)
        _dsync(mesh.device)
        wall = time.perf_counter() - t0
        its = ([int(i) for i in r.iterations] if case.startswith("batched")
               else int(r.iterations))
        out[case] = {"iterations": its,
                     "max_abs_err": float(np.abs(unstack(r.x)).max()),
                     "host_us_an_iteration": wall / max(np.max(its), 1)
                     * 1e6}
    return out


def _dist_unstack_err(unstack, A, x):
    return unstack(x, A) - 1.0


def distributed_rank(store: str, world: int, rank: int, device: str,
                     grids: dict) -> dict:
    """One rank of phase 32's Gloo job: Gloo asked for by name on
    ``device`` (the parent's card, which every rank shares), through the
    ``file://`` store ``store``; builds the host matrices of ``grids``
    (``_dist_hosts``), waits for the file
    ``store + ".go"`` (the parent's runs are done with the card), then
    runs ``_dist_products`` (timed) and ``_dist_solvers`` on the process
    mesh of DIST_P shards and returns its rows' hashes, times, solver
    results and the wrappers' launches."""
    import torch

    from spmv_tpu_torch import parallel as par

    t0 = time.perf_counter()
    par.initialize_distributed(f"file://{store}", world, rank,
                               backend="gloo", device=device)
    mesh = par.global_mesh(DIST_P)
    hosts = _dist_hosts(grids)
    setup = time.perf_counter() - t0
    _await(store + ".go")
    path = _ShardPath(DIST_WRAPPERS)
    products = _dist_products(hosts, mesh, path, time_it=True)
    for case, res in products.items():
        rows = res.pop("rows")
        res["sha256"] = _rows_hash(rows)
        res["finite"] = bool(torch.isfinite(rows).all())
    solvers = _dist_solvers(hosts, mesh, path)
    torch.distributed.destroy_process_group()
    return {"rank": rank, "backend": "gloo", "device": str(mesh.device),
            "local_shards": [mesh.local_shards.start,
                             mesh.local_shards.stop],
            "setup_s": setup, "products": products, "solvers": solvers,
            "launches": path.launches}


def _rank_env() -> dict:
    """This process's environment less torchrun's variables: a child rank
    joins the job its arguments name, not one they point at."""
    env = dict(os.environ)
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT",
                 "LOCAL_RANK"):
        env.pop(name, None)
    return env


def _await(go: str, limit: float = DIST_CHILD_S) -> None:
    """Wait for the parent's file ``go``; past ``limit`` seconds, or once
    the parent is gone, raise."""
    deadline, parent = time.monotonic() + limit, os.getppid()
    while not os.path.exists(go):
        if time.monotonic() > deadline or os.getppid() != parent:
            raise TimeoutError("no go from the parent")
        time.sleep(0.05)


def _start_child(argv, out: str, err: str, env=None):
    """``python argv`` from the repo's root over ``env`` (by default this
    environment less torchrun's variables), its output to the files
    ``out`` and ``err`` (a pipe left unread could stall it, and a peer
    rank with it)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    with open(out, "w") as o, open(err, "w") as e:
        return subprocess.Popen([sys.executable, *argv], cwd=repo,
                                env=_rank_env() if env is None else env,
                                stdout=o, stderr=e)


def _stop(proc) -> None:
    """Kill ``proc`` if it still runs."""
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def _start_rank(child: str, store: str, rank: int, args):
    """A rank of a job: the script ``child`` on ``args``, its output to
    files beside the job's store."""
    return _start_child(["-c", child, *map(str, args)],
                        f"{store}.out{rank}", f"{store}.err{rank}")


def _wait_child(proc, out, err, what, tag, limit=DIST_CHILD_S) -> str:
    """A child's standard output; one that fails, or outlasts ``limit``
    seconds (it is killed then), fails the run."""
    try:
        proc.wait(timeout=limit)
    except subprocess.TimeoutExpired:
        _stop(proc)
        _fail(f"[{tag}] {what} outlasted {limit} s")
    if proc.returncode != 0:
        with open(err) as f:
            _fail(f"[{tag}] {what} exited {proc.returncode}: "
                  f"{f.read()[-3000:]}")
    with open(out) as f:
        return f.read()


def _wait_job(procs, store, what, tag) -> list:
    """Each rank's JSON (its last line) of a job started by
    ``_start_rank``."""
    return [json.loads(_wait_child(
        proc, f"{store}.out{r}", f"{store}.err{r}", f"rank {r} of {what}",
        tag).strip().splitlines()[-1]) for r, proc in enumerate(procs)]


@_walled
def phase_distributed(device, smi_line, dia_full=None):
    """The process mesh (phase 32).  The Gloo job's two ranks start
    first and build their host matrices while this process, on the same
    inputs, makes every product on DIST_P virtual shards (the rows every
    rank's must equal, bitwise) and the solvers there (the counts), then
    joins a one-rank NCCL job: the DIA halo SpMV at poisson2d(4096²) and
    the halo CSR SpMV at poisson2d(2048²) bitwise the virtual shards',
    CG over the DIA halo at the virtual shards' count.  Then the ranks
    run: every product's rows (sha256) bitwise the virtual shards' rows
    of their shards, CG within DIST_CG_SLACK of the virtual count,
    batched CG at it, each product's and each exchange's host ms.  The
    launches of the process-mesh runs (the one-rank job's here, the
    ranks' own) make the path's counts."""
    import torch

    from spmv_tpu_torch import parallel as par

    tag = "32 distributed"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="spmv-dist-")
    store = os.path.join(tmp, "gloo")
    procs = [_start_rank(_DIST_CHILD, store, r,
                         (store, DIST_WORLD, r, device,
                          json.dumps(_dist_grids())))
             for r in range(DIST_WORLD)]
    try:
        hosts = _dist_hosts(_dist_grids(), dia_full)
        del dia_full
        virtual = par.make_mesh(DIST_P, devices=[device] * DIST_P)
        vpath = _ShardPath(DIST_WRAPPERS)     # not the path's launches
        vrows = _dist_products(hosts, virtual, vpath)
        vsolve = _dist_solvers(hosts, virtual, vpath)
        _say(f"[{tag}] on {DIST_P} virtual shards: "
             + ", ".join(f"{k} {v['iterations']}" for k, v in vsolve.items())
             + " iterations")

        path = _ShardPath(DIST_WRAPPERS)
        multi = par.initialize_distributed(
            "file://" + os.path.join(tmp, "nccl"), 1, 0)
        try:
            backend = torch.distributed.get_backend()
            mesh = par.global_mesh(DIST_P)
            if multi or backend != "nccl" or mesh.group is None:
                _fail(f"[{tag}] a one-rank job on {backend}, group "
                      f"{mesh.group}")
            one = _dist_products(hosts, mesh, path,
                                 ("dia_spmv", "csr_halo_neighbor"),
                                 time_it=True)
            one_cg = _dist_solvers(hosts, mesh, path, ("dia_halo",))
            info = par.mesh_info(mesh)
        finally:
            torch.distributed.destroy_process_group()
        nccl = {}
        for case, res in one.items():
            same = bool(torch.equal(res.pop("rows"), vrows[case]["rows"]))
            nccl[case] = {**res, "bitwise_equal_to_virtual": same}
            _say(f"[{tag}] NCCL, one rank, {case}: bitwise equal to the "
                 f"virtual shards' rows {same}; {res['ms']:.4f} ms a "
                 f"product, the exchange alone {res['exchange_ms']:.4f} ms "
                 f"(host clock; one rank, no peer) on {smi_line}")
            if not same:
                _fail(f"[{tag}] NCCL one-rank {case} differs from the "
                      "virtual shards' rows")
        nccl["cg_dia_halo"] = one_cg["dia_halo"]
        if one_cg["dia_halo"]["iterations"] != \
                vsolve["dia_halo"]["iterations"]:
            _fail(f"[{tag}] NCCL one-rank CG {one_cg['dia_halo']} against "
                  f"{vsolve['dia_halo']} on virtual shards")
        _say(f"[{tag}] NCCL, one rank: CG dia_halo "
             f"{one_cg['dia_halo']['iterations']} iterations (virtual "
             f"{vsolve['dia_halo']['iterations']}), mesh {info}")

        with open(store + ".go", "w"):
            pass
        ranks = _wait_job(procs, store, "the Gloo job", tag)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    gloo = {"ranks": DIST_WORLD, "products": {}, "solvers": {},
            "setup_s": [r["setup_s"] for r in ranks]}
    for case in DIST_CASES:
        want = vrows[case]["rows"]
        per = []
        for r in ranks:
            lo, hi = r["local_shards"]
            got = r["products"][case]
            same = got["sha256"] == _rows_hash(want[lo:hi])
            per.append({"bitwise_equal_to_virtual": same,
                        "ms": got["ms"], "exchange_ms": got["exchange_ms"]})
            if not (same and got["finite"]):
                _fail(f"[{tag}] Gloo rank {r['rank']} {case}: its rows are "
                      "not the virtual shards' rows")
        gloo["products"][case] = per
        _say(f"[{tag}] Gloo, {DIST_WORLD} ranks, {case}: every rank's rows "
             "bitwise the virtual shards'; ms a product "
             + " / ".join(f"{p['ms']:.3f}" for p in per)
             + ", the exchange alone "
             + " / ".join(f"{p['exchange_ms']:.3f}" for p in per)
             + f" (rank 0 / 1; {DIST_GLOO_NOTE}; {smi_line})")
    for case, want in vsolve.items():
        its = [r["solvers"][case]["iterations"] for r in ranks]
        gloo["solvers"][case] = {"iterations": its[0],
                                 "virtual_iterations": want["iterations"],
                                 **{k: [r["solvers"][case][k]
                                        for r in ranks]
                                    for k in ("max_abs_err",
                                              "host_us_an_iteration")}}
        if any(i != its[0] for i in its):
            _fail(f"[{tag}] the ranks' {case} counts differ: {its}")
        if case.startswith("batched"):
            ok = its[0] == want["iterations"]
        else:
            ok = abs(its[0] - want["iterations"]) <= DIST_CG_SLACK * \
                want["iterations"]
        _say(f"[{tag}] Gloo, {DIST_WORLD} ranks, {case}: {its[0]} "
             f"iterations (virtual {want['iterations']}), max|x - x*| "
             + " / ".join(f"{r['solvers'][case]['max_abs_err']:.3e}"
                          for r in ranks)
             + ", host us an iteration "
             + " / ".join(f"{r['solvers'][case]['host_us_an_iteration']:.0f}"
                          for r in ranks)
             + f" ({DIST_GLOO_NOTE}; {smi_line})")
        if not ok:
            _fail(f"[{tag}] Gloo {case}: {its[0]} iterations against "
                  f"{want['iterations']} on virtual shards")
    launches = {k.removesuffix("_core"): n + sum(r["launches"][k]
                                                 for r in ranks)
                for k, n in path.launches.items()}
    _say(f"[{tag}] launches on the distributed path (the one-rank job's "
         f"and both ranks'): {launches}")
    for name, n in launches.items():
        if n <= 0:
            _fail(f"[{tag}] {name} was never launched on the distributed "
                  "path")
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    return {"launches": launches, "nccl_one_rank": nccl, "gloo": gloo,
            "virtual": vsolve, "shards": DIST_P, "seconds": secs,
            "card": smi_line, "note": DIST_GLOO_NOTE}


# phase 33: the second half across ranks (WELL, WELL-CW, BSR and
# block-Jacobi IC(0); Chebyshev, GMRES, BiCGSTAB and LOBPCG with the group
# reduction; dryrun_multichip): a one-rank NCCL job and two Gloo jobs of
# two child processes sharing the card
DIST2_WELL_GRID = 2048        # poisson2d(2048²): the WELL all-gather and halo
DIST2_IC0_GRID = CG_GRID      # poisson2d(1024²): block-IC(0) apply, PCG f32
DIST2_SOLVER_GRID = 256       # poisson2d(256²): the float64 solvers
DIST2_RESTART = 32            # GMRES(32)
# LOBPCG's tol: 608 iterations on the CPU, the eigenvalues within 2.1e-8
# of the analytic ones (to 1e-8: 769, 37.6 host s on an H100 beside the
# other jobs)
DIST2_EIG_TOL = 1e-6
DIST2_WRAPPERS = FORMAT_WRAPPERS
DIST2_CASES = ("well_all_gather", "well_halo", "wellcw_halo",
               f"wellcw_halo_spmm_k{SHARD_CW_K}", "bsr_halo_float32",
               "bsr_halo_bfloat16", "block_ic0_apply")
# the solvers whose every reduction is ops.solvers._vdot, held at the
# count of the virtual shards whose dots sum in the ranks' order
# (``_in_rank_order``), x bitwise: an all-reduced dot sums in another
# order than the whole stacked dot, and PCG's and BiCGSTAB's counts move
# with that order (BiCGSTAB with block-IC(0) 146 against the virtual
# shards' 130 on an H100); Chebyshev (tested every 10) and GMRES are
# held at the virtual count
DIST2_RANK_ORDER = ("block_ic0_pcg", "bicgstab", "bicgstab_ic0")
# where the solvers jobs run: the products are timed after they end
DIST2_BESIDE = ("beside the virtual reference, the products jobs' set-up, "
                "the example and each other")
DIST2_ENVELOPE = ("rows_per_shard", "chunks_per_shard", "spill_per_shard",
                  "exchange", "max_distance", "halo_slots",
                  "comm_elements_exact", "comm_elements_padded",
                  "interior_per_shard", "boundary_per_shard",
                  "comm_blocks_exact", "num_levels", "width", "max_deps",
                  "shift_used")

# one rank of phase 33's jobs (its role, store, world size, rank, device,
# backend or "", the go file, the directory of the BSR host arrays, the
# grids as JSON): its JSON on the last line
_DIST2_CHILD = """
import json, sys
import chip_smoke as c
print(json.dumps(c.distributed_formats_rank(
    sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
    sys.argv[5], sys.argv[6] or None, sys.argv[7], sys.argv[8],
    json.loads(sys.argv[9]))), flush=True)
"""


def _dist2_grids() -> dict:
    return {"well": DIST2_WELL_GRID, "ic0": DIST2_IC0_GRID,
            "small": DIST2_SOLVER_GRID, "cw_rows": CW_FULL_ROWS,
            "cw_half_bw": CW_FULL_HALF_BW}


def _save_bsr(host, where: str) -> None:
    """The host BSR's arrays as .npy files in ``where``, which every rank
    maps (``_load_bsr``): one build of block_random's 134M entries, not
    one a process."""
    os.makedirs(where, exist_ok=True)
    for name in ("blocks", "block_col", "block_rowptr"):
        np.save(os.path.join(where, f"{name}.npy"), getattr(host, name))
    with open(os.path.join(where, "meta.json"), "w") as f:
        json.dump({k: int(getattr(host, k)) for k in (
            "num_rows", "num_columns", "num_entries", "block_rows")}, f)


def _load_bsr(where: str):
    """``_save_bsr``'s matrix, its blocks mapped from the file (copy on
    write): a rank reads only its own shards' blocks."""
    from spmv_tpu_torch.models import BsrMatrix

    with open(os.path.join(where, "meta.json")) as f:
        meta = json.load(f)
    arrays = {name: np.load(os.path.join(where, f"{name}.npy"),
                            mmap_mode="c" if name == "blocks" else None)
              for name in ("blocks", "block_col", "block_rowptr")}
    return BsrMatrix(**meta, **arrays)


def _poisson_csr(grid: int):
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix

    return _csr_of_dia(DiaMatrix.from_matrix_market(poisson2d(grid, grid)))


def _dist2_hosts(grids, bsr_dir) -> dict:
    """The products' host matrices: ``well`` and ``ic0`` poisson2d CSRs
    (each from its DIA, ``_csr_of_dia``), ``cw`` the bench's banded_random
    CSR, ``bsr`` the mapped block_random BSR: every process builds the
    same entries in the same order."""
    from spmv_tpu_torch.io.generate import banded_random
    from spmv_tpu_torch.models import CsrMatrix

    return {"well": _poisson_csr(grids["well"]),
            "ic0": _poisson_csr(grids["ic0"]),
            "cw": CsrMatrix.from_matrix_market(banded_random(
                grids["cw_rows"], half_bandwidth=grids["cw_half_bw"],
                nnz_per_row=8, seed=1)),
            "bsr": _load_bsr(bsr_dir)}


def _dist2_build(hosts, mesh) -> dict:
    """Every container of phase 33's products on ``mesh`` (a rank builds
    its own shards), with its build seconds."""
    import torch

    from spmv_tpu_torch import parallel as par

    f32 = torch.float32
    builds = {
        "well_all_gather": lambda: par.shard_well(
            hosts["well"], DIST_P, window_rows=SHARD_WELL_WINDOW, dtype=f32,
            mesh=mesh),
        "well_halo": lambda: par.shard_well_halo(
            hosts["well"], DIST_P, window_rows=SHARD_WELL_WINDOW, dtype=f32,
            mesh=mesh),
        "wellcw_halo": lambda: par.shard_wellcw_halo(
            hosts["cw"], DIST_P, dtype=f32, mesh=mesh),
        "bsr_halo_float32": lambda: par.shard_bsr_halo(
            hosts["bsr"], DIST_P, dtype=f32, mesh=mesh),
        "bsr_halo_bfloat16": lambda: par.shard_bsr_halo(
            hosts["bsr"], DIST_P, dtype=torch.bfloat16, mesh=mesh),
        "block_ic0": lambda: _dist2_ic0(hosts["ic0"], mesh),
    }
    out, secs = {}, {}
    for name, build in builds.items():
        t0 = time.perf_counter()
        out[name] = build()
        secs[name] = time.perf_counter() - t0
    out.update(out.pop("block_ic0"))
    out["build_s"] = secs
    return out


def _dist2_ic0(ic0, mesh) -> dict:
    """Block-IC(0) PCG's containers at poisson2d(DIST2_IC0_GRID²) ``ic0``
    in float32: "ic0_halo", the halo CSR, and "block_ic0" over its
    bounds."""
    import torch

    from spmv_tpu_torch import parallel as par

    f32 = torch.float32
    H = par.shard_csr_halo(ic0, DIST_P, dtype=f32, mesh=mesh)
    return {"ic0_halo": H,
            "block_ic0": par.block_jacobi_ic0(ic0, H.bounds, H.rows_per_shard,
                                              dtype=f32, mesh=mesh)}


def _envelope(A) -> dict:
    return {f: getattr(A, f) for f in DIST2_ENVELOPE if hasattr(A, f)}


def _dist2_products(built, mesh, path, time_it=False) -> dict:
    """Phase 33's products on ``mesh`` (their launches counted by
    ``path``): {case: {"rows": this process's stacked rows, "launches"
    (checked against the container's own count), "envelope", and with
    ``time_it`` "ms" a product and "exchange_ms" the exchange alone on
    the host clock}}; each input drawn whole on the device from a seed
    a case, so every process draws the same."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel import bsr_shard, halo_shard

    device, f32 = mesh.device, torch.float32
    out = {}
    for i, case in enumerate(DIST2_CASES):
        g = torch.Generator(device=device).manual_seed(330 + i)
        exchange = None
        if case.startswith("well_"):
            A = built[case]
            xs = par.stack_vector(torch.randn(
                A.num_rows, generator=g, device=device, dtype=f32), A, mesh)
            fn = (par.sharded_well_spmv if case == "well_all_gather"
                  else par.sharded_well_halo_spmv)

            def product():
                return fn(A, xs, mesh)

            if case == "well_all_gather":
                def exchange():
                    return par.all_gather_rows(xs, mesh)
            else:
                def exchange():
                    return halo_shard.halo_of(A, xs)
            want = A.launches_a_product()
        elif case.startswith("wellcw"):
            A = built["wellcw_halo"]
            spmm = case != "wellcw_halo"
            shape = (A.num_rows, SHARD_CW_K) if spmm else (A.num_rows,)
            xs = (par.stack_block if spmm else par.stack_vector)(torch.randn(
                shape, generator=g, device=device, dtype=f32), A, mesh)
            fn = (par.sharded_wellcw_halo_spmm if spmm
                  else par.sharded_wellcw_halo_spmv)

            def product():
                return fn(A, xs, mesh)

            def exchange():
                return halo_shard.halo_of(A, xs)

            want = A.launches_a_product(spmm=spmm)
        elif case.startswith("bsr"):
            A = built[case]
            xs = bsr_shard.stack_columns(torch.randn(
                A.num_columns, BSR_K, generator=g, device=device,
                dtype=f32), A, mesh)

            def product():
                return par.sharded_bsr_spmm(A, xs, mesh)

            def exchange():
                return bsr_shard.extend_columns(A, xs)

            want = A.launches_a_product()
        else:
            A, H = built["block_ic0"], built["ic0_halo"]
            xs = par.stack_vector(torch.randn(
                H.num_rows, generator=g, device=device, dtype=f32), H, mesh)

            def product():
                return par.sharded_block_ic0_apply(A, xs, mesh)

            want = A.launches_an_apply()
        rows, delta = path.run(product)
        moved = {k: v for k, v in delta.items() if v}
        res = {"rows": rows, "launches": moved,
               "launches_as_counted": moved == want,
               "envelope": _envelope(A)}
        if time_it:
            res["ms"] = _host_ms(product, DIST_REPS, device)
            if exchange is not None:
                res["exchange_ms"] = _host_ms(exchange, DIST_REPS, device)
        out[case] = res
    return out


def _in_rank_order(a, b, mesh=None):
    """``ops.solvers._vdot`` on the virtual shards summed as DIST_WORLD
    ranks of a process mesh sum it: each rank's rows of the stacked
    layout, then the ranks' sums (of two, a + b either way)."""
    import torch

    a, b = a.reshape(DIST_WORLD, -1), b.reshape(DIST_WORLD, -1)
    return sum((torch.dot(a[r], b[r]) for r in range(1, DIST_WORLD)),
               torch.dot(a[0], b[0]))


def _solved(out, name, path, fn, unstack, device) -> None:
    """Run the solve ``fn`` (its launches counted by ``path``) into
    ``out[name]``: iterations, max|x - 1| of the unstacked x, host
    seconds, and "x" the stacked rows."""
    _dsync(device)
    t0 = time.perf_counter()
    r, _ = path.run(fn)
    _dsync(device)
    out[name] = {"iterations": int(r.iterations),
                 "max_abs_err_vs_ones": float(np.abs(unstack(r.x)
                                                     - 1.0).max()),
                 "host_s": time.perf_counter() - t0, "x": r.x}


def _dist2_pcg(built, ic0, mesh, path, out) -> None:
    """Block-IC(0) PCG float32 to 1e-5 at poisson2d(DIST2_IC0_GRID²) on
    the products' containers, b = A ones from the fp64 host product."""
    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import preconditioned_conjugate_gradient

    H, M = built["ic0_halo"], built["block_ic0"]
    mv = par.make_sharded_halo_matvec(H, mesh)
    bs = par.stack_vector(ic0.spmv(np.ones(H.num_rows)), H, mesh)
    _solved(out, "block_ic0_pcg", path,
            lambda: preconditioned_conjugate_gradient(
                mv, bs, par.make_sharded_block_ic0_preconditioner(M, mesh),
                tol=SHARD_CG_TOL["float32"], max_iterations=SHARD_CG_MAX),
            lambda x: par.unstack_vector(x, H), mesh.device)


def _dist2_small_solvers(m, mesh, path, out,
                         which=("chebyshev", "gmres", "bicgstab",
                                "bicgstab_ic0")) -> None:
    """At poisson2d(DIST2_SOLVER_GRID²) ``m`` in float64 to 1e-8, b = A
    ones from the fp64 host product, the solvers of ``which``: Chebyshev
    on SHARD_LANCZOS_STEPS-step ``lanczos_bounds`` (from a global draw),
    GMRES(DIST2_RESTART) with the block-IC(0) apply as its
    preconditioner (without one it took 5,223 iterations), BiCGSTAB
    plain and with the block-IC(0) apply."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import bicgstab, chebyshev, gmres, lanczos_bounds

    f64 = torch.float64
    H = par.shard_csr_halo(m, DIST_P, dtype=f64, mesh=mesh)
    M = par.block_jacobi_ic0(m, H.bounds, H.rows_per_shard, dtype=f64,
                             mesh=mesh)
    mv = par.make_sharded_halo_matvec(H, mesh)
    pre = par.make_sharded_block_ic0_preconditioner(M, mesh)
    bs = par.stack_vector(m.spmv(np.ones(m.num_rows)), H, mesh)
    tol = SHARD_CG_TOL["float64"]

    def unstack(x):
        return par.unstack_vector(x, H)

    if "chebyshev" in which:
        v0 = par.stack_vector(np.random.default_rng(33).standard_normal(
            m.num_rows), H, mesh)
        (lo, hi), _ = path.run(lambda: lanczos_bounds(
            mv, (DIST_P, H.rows_per_shard), num_steps=SHARD_LANCZOS_STEPS,
            dtype=f64, v0=v0))
        _solved(out, "chebyshev", path, lambda: chebyshev(
            mv, bs, lo, hi, tol=tol, max_iterations=SHARD_CHEB_MAX,
            check_every=SHARD_CHEB_CHECK), unstack, mesh.device)
        out["chebyshev"]["bounds"] = [lo, hi]
    if "gmres" in which:
        _solved(out, "gmres", path, lambda: gmres(
            mv, bs, pre, tol=tol, restart=DIST2_RESTART,
            max_iterations=SHARD_CG_MAX), unstack, mesh.device)
    for name, apply in (("bicgstab", None), ("bicgstab_ic0", pre)):
        if name in which:
            _solved(out, name, path, lambda: bicgstab(
                mv, bs, apply, tol=tol, max_iterations=SHARD_CG_MAX),
                unstack, mesh.device)


def _dist2_lobpcg(m, grid, mesh, path) -> dict:
    """LOBPCG float64 at poisson2d(grid²) ``m``, k = SHARD_EIG_K, tol
    DIST2_EIG_TOL, on ``mesh`` (the closure's): the padding rows masked,
    the block-IC(0) apply a column, X0 and P the rank's rows of global
    draws; eigenvalues against the analytic ones."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.ops import lobpcg
    from spmv_tpu_torch.parallel import halo_shard

    f64, k = torch.float64, SHARD_EIG_K
    H = par.shard_csr_halo(m, DIST_P, dtype=f64, mesh=mesh)
    R, local = H.rows_per_shard, len(mesh.local_shards)
    M = par.block_jacobi_ic0(m, H.bounds, R, dtype=f64, mesh=mesh)
    apply = par.make_sharded_block_ic0_preconditioner(M, mesh)
    X0 = par.stack_block(np.random.default_rng(34).standard_normal(
        (m.num_rows, k)), H, mesh)
    _dsync(mesh.device)
    t0 = time.perf_counter()
    r, _ = path.run(lambda: lobpcg(
        halo_shard.make_sharded_halo_flat_matmat(H, mesh), X0.reshape(-1, k),
        preconditioner=lambda W: torch.stack(
            [apply(W[:, j].reshape(local, R)).reshape(-1)
             for j in range(k)], 1),
        tol=DIST2_EIG_TOL, max_iterations=SHARD_EIG_MAX,
        mask=halo_shard.stacked_row_mask(H, mesh)))
    _dsync(mesh.device)
    c = np.cos(np.arange(1, grid + 1) * np.pi / (grid + 1))
    want = np.sort((4.0 - 2.0 * c[:, None] - 2.0 * c[None]).ravel())[:k]
    got = r.eigenvalues.double().cpu().numpy()
    return {"iterations": int(r.iterations), "k": k,
            "eigenvalues": got.tolist(),
            "max_rel_err_vs_analytic": float(np.max(np.abs(got - want)
                                                    / want)),
            "host_s": time.perf_counter() - t0}


def distributed_formats_rank(role: str, store: str, world: int, rank: int,
                             device: str, backend, go: str, bsr_dir: str,
                             grids: dict) -> dict:
    """One rank of a phase 33 job through the ``file://`` store ``store``
    on ``device`` (``backend`` None: NCCL on a card).  ``role``
    "products": builds the host matrices and this rank's containers,
    waits for the file ``go`` (the card and the host are then free of
    every other job), makes the products (their rows' hashes, ms and
    exchange ms on the host clock).  ``role`` "krylov", at once:
    block-IC(0) PCG float32 at poisson2d(DIST2_IC0_GRID²), then
    Chebyshev and GMRES at poisson2d(DIST2_SOLVER_GRID²).  ``role``
    "eigen", at once: BiCGSTAB plain and with block-IC(0) and LOBPCG
    there, then ``dryrun_multichip``."""
    import torch

    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.parallel.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    par.initialize_distributed(f"file://{store}", world, rank,
                               backend=backend, device=device)
    mesh = par.global_mesh(DIST_P)
    path = _ShardPath(DIST2_WRAPPERS)
    out = {"rank": rank, "role": role,
           "backend": torch.distributed.get_backend(), "world": world,
           "device": str(mesh.device),
           "local_shards": [mesh.local_shards.start, mesh.local_shards.stop],
           "solvers": {}}
    if role == "krylov":
        ic0 = _poisson_csr(grids["ic0"])
        _dist2_pcg(_dist2_ic0(ic0, mesh), ic0, mesh, path, out["solvers"])
        _dist2_small_solvers(_poisson_csr(grids["small"]), mesh, path,
                             out["solvers"], ("chebyshev", "gmres"))
    elif role == "eigen":
        m = _poisson_csr(grids["small"])
        _dist2_small_solvers(m, mesh, path, out["solvers"],
                             ("bicgstab", "bicgstab_ic0"))
        out["lobpcg"] = _dist2_lobpcg(m, grids["small"], mesh, path)
        out["dryrun"], _ = path.run(lambda: dryrun_multichip(DIST_P))
    else:
        hosts = _dist2_hosts(grids, bsr_dir)
        out["host_s"] = time.perf_counter() - t0
        built = _dist2_build(hosts, mesh)
        out["build_s"] = built.pop("build_s")
        out["setup_s"] = time.perf_counter() - t0
        _await(go)
        out["products"] = _dist2_products(built, mesh, path, time_it=True)
        for res in out["products"].values():
            rows = res.pop("rows")
            res["sha256"] = _rows_hash(rows)
            res["finite"] = bool(torch.isfinite(rows).all())
    out["seconds"] = time.perf_counter() - t0
    for res in out["solvers"].values():
        res["sha256"] = _rows_hash(res.pop("x"))
    torch.distributed.destroy_process_group()
    out["launches"] = path.launches
    return out


def _dist2_job(role, store, world, device, backend, go, bsr_dir) -> list:
    """The ranks of a phase 33 job (``distributed_formats_rank``)."""
    return [_start_rank(_DIST2_CHILD, store, r,
                        (role, store, world, r, device, backend or "", go,
                         bsr_dir, json.dumps(_dist2_grids())))
            for r in range(world)]


def _start_example(tmp, script, where="gpu", **env):
    """``examples/<script>`` as a child (``_start_child``) with the repo on
    its path and ``env`` over this environment less torchrun's
    variables; ``where`` names the run.  Returns ``_wait_child``'s first
    four arguments."""
    repo = os.path.dirname(os.path.abspath(__file__))
    env = {**_rank_env(), **env}
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    stem = os.path.join(tmp, f"{script}.{where}")
    proc = _start_child([os.path.join(repo, "examples", script)],
                        stem + ".out", stem + ".err", env)
    return proc, stem + ".out", stem + ".err", \
        f"examples/{script} on the {where}"


def _torchrun_example(tmp):
    """``examples/03_multichip_torch.py`` as a one-rank job over the
    environment torchrun would give it (NCCL on the card)."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    return _start_example(tmp, "03_multichip_torch.py", RANK="0",
                          WORLD_SIZE="1", LOCAL_RANK="0",
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def _check_rows(tag, job, ranks, vrows, venv) -> dict:
    """Every rank's rows of every product bitwise the virtual shards' rows
    of its shards, its launches its containers' count, its envelope the
    virtual containers'; printed with ms a product and the exchange
    alone."""
    got = {}
    for case in DIST2_CASES:
        per = []
        for r in ranks:
            lo, hi = r["local_shards"]
            res = r["products"][case]
            same = res["sha256"] == _rows_hash(vrows[case][lo:hi])
            per.append({"bitwise_equal_to_virtual": same,
                        **{k: res.get(k) for k in (
                            "ms", "exchange_ms", "launches")}})
            if not (same and res["finite"]):
                _fail(f"[{tag}] {job} rank {r['rank']} {case}: its rows are "
                      "not the virtual shards' rows")
            if not res["launches_as_counted"]:
                _fail(f"[{tag}] {job} rank {r['rank']} {case}: launches "
                      f"{res['launches']}, not its containers' count")
            if res["envelope"] != venv[case]:
                _fail(f"[{tag}] {job} rank {r['rank']} {case}: envelope "
                      f"{res['envelope']}, the virtual shards' "
                      f"{venv[case]}")
        got[case] = per
        _say(f"[{tag}] {job}, {case}: every rank's rows bitwise the virtual "
             "shards', envelope equal; ms a product "
             + " / ".join(f"{p['ms']:.3f}" for p in per)
             + ("" if per[0]["exchange_ms"] is None else
                ", the exchange alone " + " / ".join(
                    f"{p['exchange_ms']:.3f}" for p in per))
             + f" (rank 0{' / 1' if len(per) > 1 else ''}; host clock)")
    return got


def _check_solvers(tag, ranks, vsolve, vorder, smi_line) -> dict:
    """Every rank's solver counts equal; those of DIST2_RANK_ORDER at the
    count of ``vorder`` (the virtual shards' dots in the ranks' order)
    with each rank's x bitwise its rows there, the others at the virtual
    count; printed with max|x - 1| and host ms an iteration."""
    got = {}
    for case in vsolve:
        per = [r["solvers"][case] for r in ranks]
        its = [p["iterations"] for p in per]
        want = (vorder if case in vorder else vsolve)[case]
        got[case] = {"iterations": its[0],
                     "virtual_iterations": vsolve[case]["iterations"],
                     **{k: [p[k] for p in per]
                        for k in ("max_abs_err_vs_ones", "host_s")}}
        if any(i != its[0] for i in its):
            _fail(f"[{tag}] the ranks' {case} counts differ: {its}")
        same = ""
        if case in vorder:
            got[case]["rank_order_iterations"] = want["iterations"]
            bits = [p["sha256"] == _rows_hash(
                want["x"][r["local_shards"][0]: r["local_shards"][1]])
                for p, r in zip(per, ranks)]
            got[case]["bitwise_equal_to_rank_order"] = all(bits)
            same = (f", summed in the ranks' order {want['iterations']}, "
                    f"x bitwise that run's {all(bits)}")
            if not all(bits):
                _fail(f"[{tag}] Gloo {case}: x is not the virtual shards' "
                      "summed in the ranks' order")
        _say(f"[{tag}] Gloo, {DIST_WORLD} ranks, {case}: {its[0]} iterations "
             f"(virtual {vsolve[case]['iterations']}{same}), max|x - 1| "
             + " / ".join(f"{p['max_abs_err_vs_ones']:.2e}" for p in per)
             + ", host ms an iteration "
             + " / ".join(f"{p['host_s'] / max(its[0], 1) * 1e3:.2f}"
                          for p in per)
             + f" ({DIST_GLOO_NOTE}; {DIST2_BESIDE}; {smi_line})")
        if its[0] != want["iterations"]:
            _fail(f"[{tag}] Gloo {case}: {its[0]} iterations against "
                  f"{want['iterations']} on virtual shards")
    return got


@_walled
def phase_distributed_formats(device, smi_line, bsr_host=None):
    """The second half across ranks (phase 33).  The host BSR's arrays go
    to files every rank maps.  Five jobs start first: two two-rank Gloo
    jobs (Gloo asked for by name on the card) that run at once, "krylov"
    (block-IC(0) PCG, Chebyshev, GMRES) and "eigen" (BiCGSTAB, LOBPCG,
    ``dryrun_multichip``); the port's multichip example as a one-rank
    NCCL job; a one-rank NCCL job and a two-rank Gloo job ("products"),
    which build their host matrices and containers and wait.  Meanwhile
    this process, on the same inputs, makes every product on DIST_P
    virtual shards (the rows every rank's must equal, bitwise) and every
    solver there (the counts), and DIST2_RANK_ORDER's solvers again with
    their dots summed in the ranks' order.  Once the solvers jobs and the
    example have ended, the NCCL rank, and after it the products job's
    ranks, make the products with nothing else running (rows bitwise,
    launches and envelopes as the virtual ones', ms a product and an
    exchange on the host clock).  The launches of the process-mesh runs
    make the path's counts."""
    from spmv_tpu_torch import parallel as par
    from spmv_tpu_torch.io.generate import block_random
    from spmv_tpu_torch.models import BsrMatrix
    from spmv_tpu_torch.ops import solvers as ops_solvers

    tag = "33 distributed formats"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="spmv-dist2-")
    bsr_dir = os.path.join(tmp, "bsr")
    if bsr_host is None:
        bsr_host = BsrMatrix.from_matrix_market(
            block_random(BSR_ROWS, BSR_ROWS, 8, seed=2), block_rows=128)
    _save_bsr(bsr_host, bsr_dir)
    del bsr_host
    stores = {job: os.path.join(tmp, job)
              for job in ("nccl", "products", "krylov", "eigen")}
    jobs = {}
    try:
        for job in ("krylov", "eigen"):
            jobs[job] = _dist2_job(job, stores[job], DIST_WORLD, device,
                                   "gloo", "", bsr_dir)
        example = _torchrun_example(tmp)
        jobs["example"] = [example[0]]
        jobs["nccl"] = _dist2_job("products", stores["nccl"], 1, device,
                                  None, stores["nccl"] + ".go", bsr_dir)
        jobs["products"] = _dist2_job(
            "products", stores["products"], DIST_WORLD, device, "gloo",
            stores["products"] + ".go", bsr_dir)
        t0 = time.perf_counter()
        grids = _dist2_grids()
        hosts = _dist2_hosts(grids, bsr_dir)
        host_s = time.perf_counter() - t0
        virtual = par.make_mesh(DIST_P, devices=[device] * DIST_P)
        vpath = _ShardPath(DIST2_WRAPPERS)    # not the path's launches
        vbuilt = _dist2_build(hosts, virtual)
        vprod = _dist2_products(vbuilt, virtual, vpath)
        vrows = {k: v["rows"] for k, v in vprod.items()}
        venv = {k: v["envelope"] for k, v in vprod.items()}
        vsolve, vorder = {}, {}
        small = _poisson_csr(grids["small"])
        _dist2_pcg(vbuilt, hosts["ic0"], virtual, vpath, vsolve)
        _dist2_small_solvers(small, virtual, vpath, vsolve)
        with _patched(ops_solvers, "_vdot", _in_rank_order):
            _dist2_pcg(vbuilt, hosts["ic0"], virtual, vpath, vorder)
            _dist2_small_solvers(small, virtual, vpath, vorder,
                                 DIST2_RANK_ORDER)
        _say(f"[{tag}] on {DIST_P} virtual shards, done "
             f"{time.perf_counter() - t_phase:.1f} s into the phase: host "
             f"matrices {host_s:.1f} s, builds "
             + ", ".join(f"{k} {v:.1f} s" for k, v in
                         vbuilt.pop("build_s").items())
             + "; " + ", ".join(f"{k} {v['iterations']}"
                                for k, v in vsolve.items())
             + " iterations; summed in the ranks' order "
             + ", ".join(f"{k} {v['iterations']}" for k, v in vorder.items()))
        del vbuilt, hosts
        _sync(device)

        solvers = {job: _wait_job(jobs[job], stores[job],
                                  f"the Gloo {job} job", tag)
                   for job in ("krylov", "eigen")}
        lines = _wait_child(*example, tag).strip().splitlines()
        t_go = time.perf_counter() - t_phase
        with open(stores["nccl"] + ".go", "w"):
            pass
        one = _wait_job(jobs["nccl"], stores["nccl"], "the one-rank NCCL job",
                        tag)[0]
        if one["backend"] != "nccl" and device.type == "cuda":
            _fail(f"[{tag}] the one-rank job ran on {one['backend']}")
        with open(stores["products"] + ".go", "w"):
            pass
        ranks = _wait_job(jobs["products"], stores["products"],
                          "the Gloo products job", tag)
        t_done = time.perf_counter() - t_phase
        _say(f"[{tag}] the krylov and eigen jobs took "
             + ", ".join(" / ".join(f"{r['seconds']:.1f}" for r in rs)
                         for rs in solvers.values())
             + f" s {DIST2_BESIDE}; the products went at {t_go:.1f} s into "
             "the phase, the NCCL rank's and then the Gloo ranks' each with "
             f"nothing else running, and were done at {t_done:.1f} s")
    finally:
        for proc in (p for procs in jobs.values() for p in procs):
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(tmp, ignore_errors=True)
    nccl = _check_rows(tag, "NCCL, one rank", [one], vrows, venv)
    gloo = {"ranks": DIST_WORLD, "note": DIST_GLOO_NOTE,
            "host_s": [r["host_s"] for r in ranks],
            "setup_s": [r["setup_s"] for r in ranks],
            "build_s": [r["build_s"] for r in ranks],
            "products": _check_rows(tag, f"Gloo, {DIST_WORLD} ranks", ranks,
                                    vrows, venv)}
    _say(f"[{tag}] the Gloo ranks' times above are {DIST_GLOO_NOTE} "
         f"({smi_line}); their host set-up "
         + " / ".join(f"{s:.1f}" for s in gloo["setup_s"]) + " s")
    for v in vsolve.values():
        v.pop("x")
    both = [{"local_shards": k["local_shards"],
             "solvers": {**k["solvers"], **e["solvers"]}}
            for k, e in zip(solvers["krylov"], solvers["eigen"])]
    gloo["solvers"] = _check_solvers(tag, both, vsolve, vorder, smi_line)
    eig = [r["lobpcg"] for r in solvers["eigen"]]
    if any(e["eigenvalues"] != eig[0]["eigenvalues"] for e in eig):
        _fail(f"[{tag}] the ranks' LOBPCG eigenvalues differ")
    gloo["lobpcg"] = eig[0]
    _say(f"[{tag}] Gloo, {DIST_WORLD} ranks, LOBPCG float64 k={SHARD_EIG_K}"
         f" tol {DIST2_EIG_TOL:g}: {eig[0]['iterations']} iterations, "
         f"eigenvalues {eig[0]['eigenvalues']}, max rel err "
         f"{eig[0]['max_rel_err_vs_analytic']:.2e} against the analytic "
         f"ones, {eig[0]['host_s']:.1f} host s ({DIST_GLOO_NOTE}; "
         f"{DIST2_BESIDE})")
    if (eig[0]["iterations"] >= SHARD_EIG_MAX
            or not eig[0]["max_rel_err_vs_analytic"] <= SHARD_EIG_RTOL):
        _fail(f"[{tag}] LOBPCG across ranks: {eig[0]}")
    dry = [r["dryrun"] for r in solvers["eigen"]]
    if any(d != dry[0] for d in dry) or len(dry[0]) != 11:
        _fail(f"[{tag}] the ranks' dryrun_multichip dicts differ")
    gloo["dryrun"] = dry[0]
    _say(f"[{tag}] Gloo, {DIST_WORLD} ranks, dryrun_multichip({DIST_P}): "
         "eleven strategies, the same dict on both ranks")
    if len(lines) != 2 or not lines[0].startswith("sharded CG over ") \
            or not lines[1].startswith("block-Jacobi-IC(0) PCG: iters "):
        _fail(f"[{tag}] the example printed {lines}")
    _say(f"[{tag}] examples/03_multichip_torch.py, one NCCL rank: "
         + " | ".join(lines))
    launches = {k.removesuffix("_core"): sum(
        r["launches"][k]
        for r in [one] + ranks + solvers["krylov"] + solvers["eigen"])
        for k in DIST2_WRAPPERS}
    _say(f"[{tag}] launches on the distributed path (the one-rank job's "
         f"and the three Gloo jobs'): {launches}")
    # K4b is the fallback level's SpMM: the full-width WELL-CW interiors
    # are merged grids (K4a), and the dryrun takes no WELL-CW SpMM
    for name, n in launches.items():
        if n <= 0 and name != "wellcw_level_spmm":
            _fail(f"[{tag}] {name} was never launched on the distributed "
                  "path")
    secs = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {secs:.1f} s")
    for v in vorder.values():
        v.pop("x")
    return {"launches": launches, "nccl_one_rank": nccl, "gloo": gloo,
            "virtual": vsolve, "rank_order": vorder, "example": lines,
            "shards": DIST_P, "seconds": secs, "card": smi_line,
            "note": DIST_GLOO_NOTE}


# --------------------------------------------------------------- phase 34
CAPTURE_RUNS = 10             # --profile N of the captured DIA runs
CAPTURE_CW_RUNS = 5           # --profile N of the captured WELL-CW run
CAPTURE_SMALL_GRID = CG_GRID  # poisson2d(1024²): K1's 21 MB fit the L2
CAPTURE_CHAIN = (8, 136)      # time_kernel's chains, with and without
CAPTURE_PLANE = "/device:GPU:0"
CAPTURE_LINE = "stream "      # the device plane's lines: one a stream
# substrings of the demangled kernel names in a capture
CAPTURE_NAMES = {"dia_spmv": "dia_spmv_kernel",
                 "wellcw_merged": "cw_merged_kernel",
                 "wellcw_pool": "cw_pool_kernel",
                 "csr_spmv": "csr_spmv_kernel"}
FLUSH_NAMES = ("reduce_kernel", "sum_functor")   # the flusher's torch.sum
EXAMPLE_WALL_S = 300          # each example's wall limit
CAPTURE_CHILD_S = 300         # the captures' process's wall from its go
CAPTURE_WAIT_S = 900          # its wait for the go, phases 31-33's walls
EXAMPLE_RE = {
    "01": r"(poisson 5-point|scattered banded)\s+-> (\S+)\s+(\S+) Gnnz/s"
          r"  rel_err (\S+)",
    "02": (r"CG        iters (\d+) rel_x (\S+)",
           r"IC\(0\)-PCG iters (\d+) method (\S+)",
           r"smallest eigenvalues \[([^\]]*)\]"),
}
EXAMPLE_FORMATS = {"poisson 5-point": "dia", "scattered banded": "well"}
EXAMPLE_EIG_TOL = 1e-5        # against the analytic poisson2d(64²) spectrum
EXAMPLE_REL_ERR = 1e-5        # example 01's float32 product vs fp64 host


@contextlib.contextmanager
def _premade(matrices):
    """The CLI's ``--matrix`` paths named in ``matrices`` stand for those
    host matrices: make_kernel is handed the matrix itself (a Matrix
    Market file of poisson2d(4096²) would take minutes to write and
    parse), as phase 28 hands its reader the generated matrix."""
    from spmv_tpu_torch import kernels

    make = kernels.make_kernel

    def premade(name, matrix_path=None, **kw):
        if matrix_path in matrices:
            return make(name, matrix=matrices[matrix_path], **kw)
        return make(name, matrix_path=matrix_path, **kw)

    with _patched(kernels, "make_kernel", premade):
        yield


def _captured(tag, argv, wrappers):
    """The CLI's report for ``argv`` (run in process) and each wrapper's
    launches during it."""
    from spmv_tpu_torch.cli import main

    before = {k: w.launches for k, w in wrappers.items()}
    buf = io.StringIO()
    t0 = time.perf_counter()
    rc = main(argv, out=buf)
    wall = time.perf_counter() - t0
    if rc != 0:
        _fail(f"[{tag}] CLI {' '.join(argv)} exited {rc}")
    launched = {k: w.launches - before[k] for k, w in wrappers.items()}
    return json.loads(buf.getvalue()), launched, wall


def _gpu_plane(tag, doc, directory, flush):
    """The report's device plane, checked: no error, the flags as asked,
    every event kind listed, busy time between the longest event and the
    sum of the events."""
    if doc["jax_profile_dir"] != directory or doc["flush_caches"] != flush:
        _fail(f"[{tag}] jax_profile_dir {doc['jax_profile_dir']!r}, "
              f"flush_caches {doc['flush_caches']}: asked {directory!r}, "
              f"{flush}")
    pe = doc["profiling_events"]
    if not isinstance(pe, dict) or "error" in pe:
        _fail(f"[{tag}] profiling_events: {pe}")
    planes = {p["name"]: p for p in pe["planes"]}
    if CAPTURE_PLANE not in planes:
        _fail(f"[{tag}] no {CAPTURE_PLANE} plane in the capture: "
              f"{sorted(planes)}")
    gpu = planes[CAPTURE_PLANE]
    if gpu["events_lost"]:
        _fail(f"[{tag}] the capture lost {gpu['events_lost']} device "
              "records (launch records without theirs)")
    if gpu["events_dropped_below_top_k"]:
        _fail(f"[{tag}] {gpu['events_dropped_below_top_k']} event kinds "
              "past the report's top 25 on the device plane")
    longest = max(e["duration_ns"]["max"] for e in gpu["events"])
    total = sum(e["total_ns"] for e in gpu["events"])
    if not longest * (1 - 1e-9) <= gpu["busy_ns"] <= total * (1 + 1e-9):
        _fail(f"[{tag}] busy_ns {gpu['busy_ns']} outside [{longest}, "
              f"{total}]")
    return gpu


def _named(gpu, *parts):
    """The device plane's events whose names hold every one of parts."""
    return [e for e in gpu["events"] if all(p in e["name"] for p in parts)]


def _count(gpu, *parts) -> int:
    return sum(e["count"] for e in _named(gpu, *parts))


def _k1_capture(tag, path, d, flush, runs):
    """``-s dia --profile runs --jax-profile d [--flush-caches]`` on the
    premade ``path``: K1's events as many as its launches in the window,
    the flush kernel once a timed run (none without the flag).  Returns
    K1's event median (ns), the median of the timed runs' own K1 events
    (ns: the flush precedes only those, not the warm-up nor
    ``time_kernel``'s chains) and the runs' median wall (ns)."""
    from spmv_tpu_torch.ops import dia_spmv_core
    from spmv_tpu_torch.profile.capture import find_capture_file

    argv = (["--matrix", path, "-s", "dia", "--profile", str(runs),
             "--jax-profile", d] + (["--flush-caches"] if flush else []))
    doc, launched, wall = _captured(tag, argv, {"dia_spmv": dia_spmv_core})
    gpu = _gpu_plane(tag, doc, d, flush)
    k1 = _named(gpu, CAPTURE_NAMES["dia_spmv"])
    n_k1, n_flush = _count(gpu, CAPTURE_NAMES["dia_spmv"]), \
        _count(gpu, *FLUSH_NAMES)
    if len(k1) != 1 or n_k1 != launched["dia_spmv"]:
        _fail(f"[{tag}] K1 in the capture: {n_k1} events "
              f"({[e['name'][:60] for e in k1]}), launches in the window "
              f"{launched['dia_spmv']}")
    if n_flush != (runs if flush else 0):
        _fail(f"[{tag}] the flush kernel ran {n_flush} times, not "
              f"{runs if flush else 0}")
    median = k1[0]["duration_ns"]["median"]
    run_ns = doc["execution_time"]["median"]
    with open(find_capture_file(d)) as f:
        ordered = sorted((e for e in json.load(f)["traceEvents"]
                          if e.get("cat") == "kernel"
                          and CAPTURE_NAMES["dia_spmv"] in e["name"]),
                         key=lambda e: e["ts"])
    timed = float(np.median([e["dur"] * 1e3 for e in ordered[1:1 + runs]]))
    _say(f"[{tag}] -s dia --profile {runs}"
         f"{' --flush-caches' if flush else ''} on {path}: "
         f"{len(gpu['events'])} event "
         f"kinds on {CAPTURE_PLANE}, busy {gpu['busy_ns'] / 1e6:.3f} ms; K1 "
         f"{n_k1} events = {launched['dia_spmv']} launches, median "
         f"{median / 1e3:.2f} us ({k1[0]['fraction_of_plane']:.3f} of the "
         f"plane), the timed runs' {timed / 1e3:.2f} us; flush kernel "
         f"{n_flush} events; median run {run_ns / 1e3:.2f} us wall; "
         f"{wall:.1f} s")
    return median, timed, run_ns


def _example_lines(started, tag) -> list:
    """The lines an example started by ``_start_example`` printed."""
    lines = _wait_child(*started, tag, EXAMPLE_WALL_S).strip().splitlines()
    for line in lines:
        _say(f"[{tag}]   {started[3]}: {line}")
    return lines


def _check_examples(started, tag) -> dict:
    """Example 01 on the card picks the JAX example's formats and its
    product agrees with the fp64 host product; example 02 on the card
    takes the CPU run's CG and IC(0)-PCG iterations within 2, and its
    eigenvalues lie within EXAMPLE_EIG_TOL of the analytic ones."""
    import re

    lines = _example_lines(started["01"], tag)
    one = [re.fullmatch(EXAMPLE_RE["01"], line) for line in lines]
    if len(one) != 2 or not all(one):
        _fail(f"[{tag}] example 01 printed {lines}")
    res = {"01": {}}
    for m in one:
        name, fmt, rate, rel = m[1], m[2], float(m[3]), float(m[4])
        if fmt != EXAMPLE_FORMATS[name] or not rel < EXAMPLE_REL_ERR:
            _fail(f"[{tag}] example 01, {name}: format {fmt}, rel_err {rel}")
        res["01"][name] = {"format": fmt, "gnnz_per_s": rate, "rel_err": rel}
    two = {}
    for where in ("gpu", "cpu"):
        lines = _example_lines(started[f"02_{where}"], tag)
        ms = [re.fullmatch(p, line)
              for p, line in zip(EXAMPLE_RE["02"], lines)]
        if len(lines) != 3 or not all(ms):
            _fail(f"[{tag}] example 02 on the {where} printed {lines}")
        two[where] = {"cg": int(ms[0][1]), "rel_x": float(ms[0][2]),
                      "pcg": int(ms[1][1]), "method": ms[1][2],
                      "eigenvalues": [float(v) for v in ms[2][1].split()]}
    gpu, cpu = two["gpu"], two["cpu"]
    want = _poisson_eigs(64, 4)
    err = float(np.max(np.abs(np.array(gpu["eigenvalues"]) - want)))
    if abs(gpu["cg"] - cpu["cg"]) > 2 or abs(gpu["pcg"] - cpu["pcg"]) > 2 \
            or not err < EXAMPLE_EIG_TOL:
        _fail(f"[{tag}] example 02: card {gpu}, CPU {cpu}, eigenvalues "
              f"{err} from the analytic ones")
    _say(f"[{tag}] example 02: CG {gpu['cg']} / IC(0)-PCG {gpu['pcg']} "
         f"iterations on the card, {cpu['cg']} / {cpu['pcg']} on the CPU; "
         f"eigenvalues within {err:.2e} of the analytic ones")
    res["02"] = {**two, "eigenvalue_err": err}
    return res


# phase 34's captures in a process of their own: argv is its staging
# directory, phase 5's K1 seconds and nvidia-smi's line
_CAPTURE_CHILD = """
import sys
import chip_smoke as c
sys.exit(c.capture_child(sys.argv[1], float(sys.argv[2]), sys.argv[3]))
"""


def stage_captures(full, cw, t_k1, smi_line):
    """Start phase 34's captures' process ahead of phase 31, so that it
    loads its host matrices while phases 31-33 run: phase 3's
    poisson2d(4096²) DIA and phase 7's WELL-CW matrix, pickled into a
    staging directory.  It takes its captures when phase 34 writes the
    directory's go file.  Returns (directory, process)."""
    stage = tempfile.mkdtemp(prefix="phase34_")
    with open(os.path.join(stage, "matrices.pkl"), "wb") as f:
        pickle.dump((full, cw), f, protocol=pickle.HIGHEST_PROTOCOL)
    proc = _start_child(["-c", _CAPTURE_CHILD, stage, repr(t_k1), smi_line],
                        os.path.join(stage, "out"),
                        os.path.join(stage, "err"))
    atexit.register(_stop, proc)
    return stage, proc


@_walled
def phase_profile_capture(smi_line, staged):
    """Phase 34: the profiler capture through the CLI (``--jax-profile``,
    ``--flush-caches``, ``--list-profile-events``) in the process
    ``stage_captures`` started, then examples 01-02 on the card.  Those
    are its process's first captures: in this one, 13 minutes after its
    first capture, a capture lost 40 of 83 K1 records (PERF.md §6)."""
    from spmv_tpu_torch.models.device import DEVICE_ENV

    tag = "34 capture"
    t_phase = time.perf_counter()
    stage, child = staged
    tmp = tempfile.mkdtemp(prefix="phase34_examples_")
    # the examples start once the captures are taken, so the captured
    # times have the card and the host to themselves
    started = {}
    res = {"card": smi_line}
    try:
        with open(os.path.join(stage, "go"), "w"):
            pass
        for line in _wait_child(child, os.path.join(stage, "out"),
                                os.path.join(stage, "err"),
                                "the captures' process", tag,
                                CAPTURE_CHILD_S).splitlines():
            _say(line)
        with open(os.path.join(stage, "capture.json")) as f:
            res.update(json.load(f))
        started.update({
            "01": _start_example(tmp, "01_formats_and_spmv_torch.py"),
            "02_gpu": _start_example(tmp, "02_solvers_torch.py"),
            "02_cpu": _start_example(
                tmp, "02_solvers_torch.py", "cpu",
                **{DEVICE_ENV: "cpu", "CUDA_VISIBLE_DEVICES": ""})})
        res["examples"] = _check_examples(started, tag)
    finally:
        for proc, *_ in started.values():
            _stop(proc)
    shutil.rmtree(tmp)
    shutil.rmtree(stage)
    res["seconds"] = time.perf_counter() - t_phase
    _say(f"[{tag}] phase took {res['seconds']:.1f} s")
    return res


def capture_child(stage: str, t_k1: float, smi_line: str) -> int:
    """Phase 34's legs in this process: its host matrices from the
    staging directory, then at its go file the captures, their result as
    JSON in the directory's ``capture.json``."""
    from spmv_tpu_torch.io.generate import poisson2d
    from spmv_tpu_torch.models import DiaMatrix
    from spmv_tpu_torch.models.device import default_device

    tag = "34 capture"
    t0 = time.perf_counter()
    with open(os.path.join(stage, "matrices.pkl"), "rb") as f:
        full, cw = pickle.load(f)
    small = DiaMatrix.from_matrix_market(
        poisson2d(CAPTURE_SMALL_GRID, CAPTURE_SMALL_GRID))
    _say(f"[{tag}] host matrices (phase 3's poisson2d({FULL_GRID}²) DIA "
         f"and phase 7's WELL-CW loaded, poisson2d({CAPTURE_SMALL_GRID}²) "
         f"DIA built) in {time.perf_counter() - t0:.1f} s, ahead of the go")
    _await(os.path.join(stage, "go"), CAPTURE_WAIT_S)
    tmp = tempfile.mkdtemp(prefix="phase34_legs_")
    dirs = {k: os.path.join(tmp, k) for k in ("full", "warm", "flushed",
                                              "wellcw", "y")}
    res = _capture_legs(default_device(), smi_line, full, small, cw, t_k1,
                        dirs, tag)
    shutil.rmtree(tmp)
    with open(os.path.join(stage, "capture.json"), "w") as f:
        json.dump(res, f)
    return 0


def _capture_legs(device, smi_line, full, small, cw, t_k1, dirs, tag):
    """Phase 34's legs (a)-(e) on the card."""
    import torch

    from spmv_tpu_torch.cli import main
    from spmv_tpu_torch.kernels import make_kernel
    from spmv_tpu_torch.ops import (
        csr_spmv_core,
        dia_spmv,
        wellcw_merged_core,
        wellcw_pool_core,
    )
    from spmv_tpu_torch.profile import time_kernel
    from spmv_tpu_torch.profile.capture import trace

    big = f"poisson2d_{FULL_GRID}.mtx"
    little = f"poisson2d_{CAPTURE_SMALL_GRID}.mtx"
    bench = f"banded_random_{CW_FULL_ROWS}.mtx"
    res = {}
    with _premade({big: full, little: small, bench: cw}):
        # (a) the full-size DIA profile, flushed and captured
        median, timed, run_ns = _k1_capture(f"{tag} a", big, dirs["full"],
                                            True, CAPTURE_RUNS)
        _say(f"[{tag} a] K1 at poisson2d({FULL_GRID},{FULL_GRID}): median "
             f"event {median / 1e6:.4f} ms in the capture, the timed runs' "
             f"(L2 flushed before each) {timed / 1e6:.4f} ms, phase 5's "
             f"chained {t_k1 * 1e3:.4f} ms, on {smi_line}")
        res["full"] = {"k1_event_median_ms": median / 1e6,
                       "k1_timed_runs_median_ms": timed / 1e6,
                       "phase5_k1_ms": t_k1 * 1e3,
                       "run_median_us": run_ns / 1e3}
        # (b) where K1's 21 MB fit the L2: with and without the flush
        res["small"] = {}
        for key, flush in (("warm", False), ("flushed", True)):
            median, timed, run_ns = _k1_capture(
                f"{tag} b", little, dirs[key], flush, CAPTURE_RUNS)
            res["small"][key] = {
                "k1_event_median_ms": median / 1e6,
                "k1_timed_runs_median_ms": timed / 1e6,
                "run_median_us": run_ns / 1e3}
        s = res["small"]
        _say(f"[{tag} b] poisson2d({CAPTURE_SMALL_GRID},{CAPTURE_SMALL_GRID})"
             f": median run {s['warm']['run_median_us']:.2f} us wall without "
             f"--flush-caches, {s['flushed']['run_median_us']:.2f} us with; "
             f"the timed runs' K1 events "
             f"{s['warm']['k1_timed_runs_median_ms'] * 1e3:.2f} us and "
             f"{s['flushed']['k1_timed_runs_median_ms'] * 1e3:.2f} us, on "
             f"{smi_line}")
        # (c) the WELL-CW step at the bench matrix: three launches a SpMV
        cw_wrappers = {"wellcw_merged": wellcw_merged_core,
                       "wellcw_pool": wellcw_pool_core,
                       "csr_spmv": csr_spmv_core}
        doc, launched, wall = _captured(
            f"{tag} c", ["--matrix", bench, "-s", "wellcw", "--profile",
                         str(CAPTURE_CW_RUNS), "--jax-profile",
                         dirs["wellcw"]], cw_wrappers)
        gpu = _gpu_plane(f"{tag} c", doc, dirs["wellcw"], False)
        shares = {}
        for name in cw_wrappers:
            evs = _named(gpu, CAPTURE_NAMES[name])
            n = sum(e["count"] for e in evs)
            if len(evs) != 1 or n != launched[name]:
                _fail(f"[{tag} c] {name}: {n} events "
                      f"({[e['name'][:60] for e in evs]}), {launched[name]} "
                      "launches in the window")
            shares[name] = {"events": n,
                            "fraction_of_plane": evs[0]["fraction_of_plane"],
                            "median_ms": evs[0]["duration_ns"]["median"]
                            / 1e6}
        if len({v["events"] for v in shares.values()}) != 1:
            _fail(f"[{tag} c] the three kernels' counts differ: {shares}")
        _say(f"[{tag} c] -s wellcw --profile {CAPTURE_CW_RUNS} at "
             f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8): "
             + ", ".join(f"{k} {v['events']} events, median "
                         f"{v['median_ms'] * 1e3:.2f} us, "
                         f"{v['fraction_of_plane']:.3f} of the plane"
                         for k, v in shares.items())
             + f"; {wall:.1f} s, on {smi_line}")
        res["wellcw"] = shares
    # (d) the namespace, from a probe and from (a)'s capture
    for label, argv in (("probe", ["--list-profile-events"]),
                        ("capture", ["--list-profile-events", dirs["full"]])):
        buf = io.StringIO()
        if main(argv, out=buf) != 0:
            _fail(f"[{tag} d] {' '.join(argv)} failed")
        doc = json.loads(buf.getvalue())
        planes = {p["plane"]: p for p in doc["planes"]}
        lines = [ln for ln in planes.get(CAPTURE_PLANE, {}).get("lines", [])
                 if ln["line"].startswith(CAPTURE_LINE) and ln["event_stats"]]
        if set(doc) != {"capture", "planes", "derived_event_fields"} \
                or not lines:
            _fail(f"[{tag} d] {label}: keys {sorted(doc)}, planes "
                  f"{sorted(planes)}, no stream line with stats")
        _say(f"[{tag} d] --list-profile-events ({label}): planes "
             f"{sorted(planes)}; {lines[0]['line']}: "
             f"{lines[0]['num_events']} events, stats "
             f"{[s['name'] for s in lines[0]['event_stats']]}")
    # (e) K1's y with and without the capture; the capture's overhead
    kernel = make_kernel("dia", matrix=full, device=device,
                         dtype=torch.float32)
    kernel.init()
    step, args = kernel.run_fn()
    A = args[1]
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        A.num_columns).astype(np.float32)).to(device)
    y0 = dia_spmv(A, x)
    k_small, k_large = CAPTURE_CHAIN
    plain = time_kernel(step, args, k_small=k_small, k_large=k_large,
                        runs=6).seconds_per_iteration
    with trace(dirs["y"], device):
        y1 = dia_spmv(A, x)
        traced = time_kernel(step, args, k_small=k_small, k_large=k_large,
                             runs=6).seconds_per_iteration
    same = bool(torch.equal(y0, y1))
    _say(f"[{tag} e] K1's y with and without the capture bitwise equal: "
         f"{'yes' if same else 'no'}; chained {plain * 1e3:.4f} ms a SpMV "
         f"without the capture, {traced * 1e3:.4f} ms inside it "
         f"({traced / plain:.3f}x), on {smi_line}")
    if not same:
        _fail(f"[{tag} e] K1's y differs under the capture")
    res["overhead"] = {"chained_ms": plain * 1e3,
                       "chained_ms_captured": traced * 1e3}
    del kernel, step, args, A, x, y0, y1
    _sync(device)
    return res


def _tri_row(solvers) -> dict:
    """The tri_solve row of the kernels' JSON line: the ILU(0) unit L
    after --reorder color at full width (the full-width run's shape, the
    level mode), its launches on the solvers path; the natural-order
    IC(0) L (the chained mode) beside, with the hand-off."""
    grid_c = (f"poisson2d({SOLVER_FULL_GRID},{SOLVER_FULL_GRID}) after "
              "--reorder color")
    grid_n = f"poisson2d({SOLVER_NATURAL_GRID},{SOLVER_NATURAL_GRID})"
    main = solvers["alone"][f"ILU(0) unit L {grid_c}"]
    keys = ("ms", "mode", "levels_ms", "chained_ms", "eager_ms",
            "plain_ms", "bound_ms", "bound_by", "bound_triad_ms", "bytes",
            "bound_with_z_reads_ms", "z_read_bytes", "container_bytes",
            "reads_level_rows", "reads_diag_inv", "launch_bound_ms",
            "handoff_bound_ms", "levels", "library_ms", "library_call",
            "library_timing", "library_eager_ms")
    err = solvers["errors"]
    natural = solvers["alone"][f"IC(0) L {grid_n} natural"]
    return {
        "name": "tri_solve",
        "route": "cuda",
        "source": "spmv_tpu_torch/csrc/tri_solve.cu",
        "replaces": "XLA `lax.scan` of DeviceTriSolve.solve "
                    "(spmv_tpu/ops/incomplete.py:374) and `fori_loop` of "
                    "tri_solve_sweeps (:418), not a TPU kernel",
        "launches": solvers["launches"]["tri_solve"],
        "max_abs_err": err["ILU(0) unit L float32"]["max_abs_err"],
        **{k: main.get(k) for k in keys},
        "torch_triangular_solve": main.get("torch_triangular_solve"),
        "max_abs_err_f64": max(v["max_abs_err"] for k, v in err.items()
                               if "float64" in k),
        "least_launch_ms": solvers["least_launch_ms"],
        "handoff_ms": solvers["handoff_ms"],
        "natural_order": {
            **{k: natural.get(k) for k in keys},
            "torch_triangular_solve": natural.get("torch_triangular_solve"),
            "max_abs_err": err["IC(0) L float32"]["max_abs_err"],
            "shape": f"IC(0) L of {grid_n}, natural order, float32"},
        "launches_an_apply": solvers["launches_an_apply"],
        "shape": f"ILU(0) unit L of {grid_c}, float32",
    }


def _traffic_rows(traffic) -> list:
    """The six traffic variants' rows of the kernels' JSON line: each at
    poisson2d(FULL_GRID²) float32 (WELL: K5b's mode; K5a's at
    poisson2d(WELL_WHOLE_GRID²) under ``whole_x``), its launches on the
    traffic-split path."""
    grid = f"poisson2d({FULL_GRID},{FULL_GRID})"
    alone = traffic["alone"]
    whole = f"poisson2d({WELL_WHOLE_GRID},{WELL_WHOLE_GRID}) (K5a)"
    rows = []
    for name, line in (("csr_regular", 59), ("csr_irregular", 69),
                       ("ell_regular", 83), ("ell_irregular", 87),
                       ("well_regular", 112), ("well_irregular", 119)):
        kind, leg = name.split("_")
        case = alone[f"{kind} {grid}" + (" (K5b)" if kind == "well"
                                         else "")]
        keys = ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                "bound_triad_ms", "bytes", "library_ms", "library_call",
                "library_timing", "max_abs_err")
        row = {
            "name": name,
            "route": "cuda",
            "source": f"spmv_tpu_torch/csrc/{kind}_spmv.cu",
            "replaces": (f"XLA `_{kind}_{leg}` (spmv_tpu/ops/traffic.py:"
                         f"{line}), not a TPU kernel" if kind != "well" else
                         f"XLA `_well_{leg}` (spmv_tpu/ops/traffic.py:{line})"
                         ", the variant of K5 (spmv_tpu/ops/pallas_kernels"
                         ".py:431, :557)"),
            "launches": traffic["launches"][name],
            **{k: case[leg][k] for k in keys},
            "max_abs_err_f64": traffic["max_abs_err_f64"][kind][leg],
            "full_ms": case["full"]["ms"],
            "shape": case["shape"] + " float32",
        }
        if kind == "well":
            row["whole_x"] = {k: alone[f"well {whole}"][leg][k]
                              for k in keys}
        rows.append(row)
    return rows


def main() -> int:
    t_main = time.perf_counter()
    device, smi_line = phase_device()

    import torch

    from spmv_tpu_torch.io.generate import banded_random, poisson2d
    from spmv_tpu_torch.models import DiaMatrix, WellCwMatrix, WellMatrix
    from spmv_tpu_torch.ops import (
        csr_spmm_core,
        csr_spmv_core,
        dia_spmm_core,
        dia_spmv_core,
        ell_spmm_core,
        ell_spmv_core,
        fused_vcycle_core,
        well_seg_core,
        well_seg_spmm_core,
        well_whole_core,
        well_whole_spmm_core,
        wellcw_level_core,
        wellcw_level_spmm_core,
        wellcw_merged_core,
        wellcw_merged_spmm_core,
        wellcw_pool_core,
        wellcw_pool_spmm_core,
    )

    phase_build()
    from spmv_tpu_torch.perfmodel import measured_machine

    triad_gbps = measured_machine(device).hbm_gbps
    t0 = time.perf_counter()
    full_mm = poisson2d(FULL_GRID, FULL_GRID)
    full = DiaMatrix.from_matrix_market(full_mm)
    _say(f"[3 compare] host poisson2d({FULL_GRID},{FULL_GRID}): "
         f"{full.num_rows} rows, {full.num_entries} entries, "
         f"{full.num_diagonals} diagonals, built in "
         f"{time.perf_counter() - t0:.1f} s")
    errs = phase_compare(device, full)
    t0 = time.perf_counter()
    cg_mm = poisson2d(CG_GRID, CG_GRID)
    cg_mats = {"dia": DiaMatrix.from_matrix_market(cg_mm),
               "wellcw": WellCwMatrix.from_matrix_market(cg_mm)}
    cg_well = WellMatrix.from_matrix_market(cg_mm, window_rows=4)
    _say(f"[3 compare] host poisson2d({CG_GRID},{CG_GRID}): "
         f"{cg_mm.num_rows} rows, {cg_mm.num_entries} entries, DIA, "
         f"WELL-CW and WELL built in {time.perf_counter() - t0:.1f} s")
    del cg_mm
    bitwise = phase_compare_wellcw(device, cg_mats)
    well_bitwise = phase_compare_well(device, cg_well)
    phase_compare_bsr(device)
    phase_compare_amg(device)

    # the DIA path's run: its counts start from zero here
    dia_spmv_core.launches = 0
    dia_spmm_core.launches = 0
    phase_cli(device)
    times, dia_extra = phase_profile(device, full, full_mm, smi_line)
    launches = {"dia_spmv": dia_spmv_core.launches,
                "dia_spmm": dia_spmm_core.launches}

    # the WELL-CW path's run (SpMV, SpMM, batched CG): its counts start
    # from zero here
    cw_wrappers = {"wellcw_merged": wellcw_merged_core,
                   "wellcw_level": wellcw_level_core,
                   "wellcw_pool": wellcw_pool_core,
                   "csr_spmv": csr_spmv_core,
                   "wellcw_merged_spmm": wellcw_merged_spmm_core,
                   "wellcw_level_spmm": wellcw_level_spmm_core,
                   "wellcw_pool_spmm": wellcw_pool_spmm_core,
                   "csr_spmm": csr_spmm_core}
    for w in cw_wrappers.values():
        w.launches = 0
    phase_cli_wellcw(device)
    t0 = time.perf_counter()
    cw_mm = banded_random(CW_FULL_ROWS, half_bandwidth=CW_FULL_HALF_BW,
                          nnz_per_row=8, seed=1)
    cw = WellCwMatrix.from_matrix_market(cw_mm)
    _say(f"[7 wellcw profile] host banded_random({CW_FULL_ROWS}, "
         f"{CW_FULL_HALF_BW}, 8): {cw.num_entries} entries, packed in "
         f"{time.perf_counter() - t0:.1f} s")
    cw_times = phase_profile_wellcw(device, cw, cw_mm, smi_line)
    spmm_times = phase_profile_wellcw_spmm(device, cw, cw_mm, smi_line,
                                           cw_times["ms"] * 1e-3)
    cg_times = phase_batched_cg(device, cg_mats, smi_line)
    launches.update({k: w.launches for k, w in cw_wrappers.items()})
    _say("[9 batched cg] launches on the WELL-CW path: "
         + ", ".join(f"{k} {launches[k]}" for k in cw_wrappers))
    for name, n in launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the main path")
    cw_kernels = phase_kernels_wellcw(device, cw, smi_line, triad_gbps)
    cw_kernels["csr_spmm"]["whole_matrix"], csr_whole = phase_csr_whole(
        device, cw_mm, smi_line, triad_gbps)
    cw_kernels["csr_spmv"]["whole_matrix"] = {"banded_random": csr_whole}
    # cw and cw_mm stay for the sharded formats (phase 31)
    _sync(device)

    # the WELL path's run (CLI, then make_kernel("well") at both sizes):
    # its counts start from zero here; the spill is K5's, so the CSR
    # kernel must not move (phases 11 and 12 check it)
    well_wrappers = {"well_whole": well_whole_core,
                     "well_seg": well_seg_core}
    for w in well_wrappers.values():
        w.launches = 0
    phase_cli_well(device)
    well_mats, dia_of = {}, {}
    for grid, w, dia, segmented, t_k1 in (
            (WELL_WHOLE_GRID, cg_well, cg_mats["dia"], False,
             _k1_seconds(cg_mats["dia"], device)),
            (WELL_SEG_GRID, None, full, True,
             times[("spmv", "float32")][0])):
        label = f"poisson2d({grid},{grid})"
        if w is None:
            t0 = time.perf_counter()
            w = WellMatrix.from_matrix_market(full_mm, window_rows=4)
            _say(f"[12 well profile] host {label}: {w.num_entries} "
                 f"entries, {w.num_chunks} chunks, spill {w.num_spilled} "
                 f"entries, WELL packed on the host in "
                 f"{time.perf_counter() - t0:.1f} s")
        well_mats[label] = (w, segmented, t_k1)
        dia_of[label] = dia
    del full_mm
    profiled = phase_profile_well(device, well_mats, smi_line)
    # phase 31 holds its sharded WELL products against this K5b
    well_seg_full = profiled[f"poisson2d({WELL_SEG_GRID},{WELL_SEG_GRID})"][
        "A"]
    well_launches = {k: w.launches for k, w in well_wrappers.items()}
    _say("[12 well profile] launches on the WELL path: "
         + ", ".join(f"{k} {n}" for k, n in well_launches.items()))
    for name, n in well_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the WELL path")
    well_kernels = phase_kernels_well(device, profiled, smi_line, triad_gbps)

    # the WELL SpMM path's run (CLI, make_kernel("well").spmm_fn at both
    # sizes, batched CG): its counts start from zero here; the spill is
    # K6's, so the CSR SpMM must not move (phases 14-16 check it)
    spmm_wrappers = {"well_whole_spmm": well_whole_spmm_core,
                     "well_seg_spmm": well_seg_spmm_core}
    for w in spmm_wrappers.values():
        w.launches = 0
    csr_spmm_core.launches = 0
    phase_cli_well_spmm(device)
    well_spmm = phase_profile_well_spmm(device, {
        label: (w, segmented, dia_of[label], profiled[label]["ms"] * 1e-3)
        for label, (w, segmented, _) in well_mats.items()}, smi_line)
    spmv_before = (well_whole_core.launches, csr_spmv_core.launches)
    well_cg = phase_batched_cg(device, {"well": cg_well}, smi_line,
                               tag="16 batched cg")["well"]
    if (well_whole_core.launches == spmv_before[0]
            or csr_spmv_core.launches != spmv_before[1]):
        _fail("batched cg well: the single-RHS solves did not take one K5a "
              "launch a SpMV and no CSR launch")
    well_spmm_launches = {k: w.launches for k, w in spmm_wrappers.items()}
    csr_on_well = csr_spmm_core.launches
    _say("[16 batched cg] launches on the WELL SpMM path: "
         + ", ".join(f"{k} {n}" for k, n in well_spmm_launches.items())
         + f", csr_spmm {csr_on_well}")
    for name, n in well_spmm_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the WELL SpMM path")
    if csr_on_well != 0:
        _fail("the CSR SpMM was launched on the WELL SpMM path (the spill "
              "belongs to K6's one launch)")
    # the WELL host matrices, for the traffic split (phase 26)
    well_hosts = {label: (w, segmented)
                  for label, (w, segmented, _) in well_mats.items()}
    # the DIA host matrix of poisson2d(FULL_GRID²) stays for the sharded
    # paths (phase 30)
    del well_mats, dia_of, cg_well
    _sync(device)

    bsr_run = phase_bsr_path(device, smi_line, triad_gbps)
    bsr_host = bsr_run.pop("host")          # for phase 31
    spmm_kernels = phase_kernels_spmm(device, well_spmm, bsr_run.pop("keep"),
                                      smi_line, triad_gbps)

    # the AMG path's run (the CLI's generic V-cycle, then PCG at full size
    # with K8 and with the block V-cycle): its counts start from zero here
    amg_wrappers = {"fused_vcycle": fused_vcycle_core,
                    "csr_spmv": csr_spmv_core, "dia_spmv": dia_spmv_core}
    for w in amg_wrappers.values():
        w.launches = 0
    amg_cli = phase_cli_amg(device)
    amg_hier, amg_full = phase_amg_full(device, smi_line)
    amg_launches = {k: w.launches for k, w in amg_wrappers.items()}
    _say("[21 amg] launches on the AMG path: "
         + ", ".join(f"{k} {n}" for k, n in amg_launches.items()))
    for name, n in amg_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the AMG path")
    if amg_launches["fused_vcycle"] != amg_full["fused"]["applies"]:
        _fail(f"K8 launches {amg_launches['fused_vcycle']} differ from the "
              f"preconditioner's {amg_full['fused']['applies']} applies")
    fused = phase_kernel_fused(device, amg_hier, smi_line, triad_gbps)
    del amg_hier

    # the reference formats' run (the CLI's -s csr, xla-csr, coo,
    # coo-atomic, ell and hybrid, then make_kernel("ell")'s chained SpMV
    # and SpMM at full width): the ELL and CSR counts start from zero here
    fmt_wrappers = {"ell_spmv": ell_spmv_core, "ell_spmm": ell_spmm_core,
                    "csr_spmv": csr_spmv_core, "csr_spmm": csr_spmm_core}
    for w in fmt_wrappers.values():
        w.launches = 0
    fmt_checksums = phase_cli_formats(device)
    ell_mm, ell_host, ell_A, ell_chained = phase_profile_ell(device,
                                                             smi_line)
    fmt_launches = {k: w.launches for k, w in fmt_wrappers.items()}
    _say("[24 ell profile] launches on the formats path: "
         + ", ".join(f"{k} {n}" for k, n in fmt_launches.items()))
    for name, n in fmt_launches.items():
        if n <= 0:
            _fail(f"{name} was never launched on the formats path")
    ell_kernels = phase_kernels_ell(device, ell_mm, ell_host, ell_A,
                                    ell_chained, smi_line, triad_gbps)
    cw_kernels["csr_spmv"]["whole_matrix"]["poisson2d"] = ell_kernels.pop(
        "csr_spmv_whole")
    hybrid, hybrid_mm, hybrid_host = phase_hybrid(device, smi_line,
                                                  triad_gbps)

    # the traffic split's run (the CLI's --traffic-split, then
    # measure_traffic_split at full width): the six variants' counts start
    # from zero in phase_traffic
    traffic = phase_traffic(device, (ell_mm, ell_host, ell_A), well_hosts,
                            hybrid_mm, hybrid_host, smi_line, triad_gbps)
    # the skewed matrix's entries stay for the sharded paths (phase 30)
    del ell_mm, ell_host, ell_A, well_hosts, hybrid_host
    _sync(device)
    simulate = phase_simulate(device)
    solvers = phase_solvers(device, smi_line, triad_gbps)
    eigs = phase_eigs(device, smi_line, triad_gbps)
    _sync(device)
    sharded = phase_sharded(device, smi_line, full, hybrid_mm)
    del hybrid_mm
    _sync(device)
    staged = stage_captures(full, cw, times[("spmv", "float32")][0],
                            smi_line)
    formats = phase_sharded_formats(
        device, smi_line, full, well_seg_full, cw_mm, cw, bsr_host)
    del well_seg_full, cw_mm, cw
    for name, n in formats["launches"].items():
        sharded["launches"][name] = sharded["launches"].get(name, 0) + n
    sharded["formats"] = formats
    _sync(device)
    distributed = phase_distributed(device, smi_line, full)
    del full
    _sync(device)
    # phase 33 maps phase 18's block_random from files, one host build
    dist_formats = phase_distributed_formats(device, smi_line, bsr_host)
    del bsr_host
    for name, n in dist_formats["launches"].items():
        distributed["launches"][name] = \
            distributed["launches"].get(name, 0) + n
    distributed["formats"] = dist_formats
    _sync(device)
    capture = phase_profile_capture(smi_line, staged)

    f32, bf16 = torch.float32, torch.bfloat16
    cw_shape = (f"banded_random({CW_FULL_ROWS}, {CW_FULL_HALF_BW}, 8) "
                "float32")
    mm_shape = f"{cw_shape}, k={CW_SPMM_K}"
    cw_csr = ("XLA `_csr_padded` (spmv_tpu/ops/spmv.py:42), not a TPU "
              "kernel")
    mm_csr = ("XLA `spmm` on DeviceCsr (spmv_tpu/ops/spmv.py:266), not a "
              "TPU kernel")
    cw_rows = {
        "wellcw_merged": ("wellcw_spmv.cu", "pallas_kernels.py:1568",
                          f"{cw_shape}, merged grid"),
        "wellcw_level": ("wellcw_spmv.cu", "pallas_kernels.py:1374",
                         f"{cw_shape}, fallback level (chunks_per_step=64)"),
        "wellcw_pool": ("wellcw_spmv.cu", "pallas_kernels.py:1484",
                        f"{cw_shape}, 128-group tail pool"),
        "csr_spmv": ("csr_spmv.cu", cw_csr, f"{cw_shape}, CSR remainder"),
        "wellcw_merged_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1653",
                               f"{mm_shape}, merged grid"),
        "wellcw_level_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1875",
                              f"{mm_shape}, fallback level "
                              "(chunks_per_step=64)"),
        "wellcw_pool_spmm": ("wellcw_spmm.cu", "pallas_kernels.py:1920",
                             f"{mm_shape}, 128-group tail pool"),
        "csr_spmm": ("csr_spmm.cu", mm_csr, f"{mm_shape}, CSR remainder"),
    }
    summary = {"kernels": [
        {
            "name": "dia_spmv",
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/dia_spmv.cu",
            "replaces": "spmv_tpu/ops/pallas_kernels.py:196",
            "launches": launches["dia_spmv"],
            "max_abs_err": errs[f32][0],
            "ms": times[("spmv", "float32")][0] * 1e3,
            "plain_ms": times[("spmv", "float32")][1] * 1e3,
            "max_abs_err_bf16": errs[bf16][0],
            "ms_bf16": times[("spmv", "bfloat16")][0] * 1e3,
            "plain_ms_bf16": times[("spmv", "bfloat16")][1] * 1e3,
            **dia_extra["spmv"],
            "shape": f"poisson2d({FULL_GRID},{FULL_GRID}) float32",
        },
        {
            "name": "dia_spmm",
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/dia_spmm.cu",
            "replaces": "spmv_tpu/ops/pallas_kernels.py:710",
            "launches": launches["dia_spmm"],
            "max_abs_err": errs[f32][1],
            "ms": times[("spmm", "float32")][0] * 1e3,
            "plain_ms": times[("spmm", "float32")][1] * 1e3,
            "max_abs_err_bf16": errs[bf16][1],
            "ms_bf16": times[("spmm", "bfloat16")][0] * 1e3,
            "plain_ms_bf16": times[("spmm", "bfloat16")][1] * 1e3,
            **dia_extra["spmm"],
            "shape": f"poisson2d({FULL_GRID},{FULL_GRID}) float32, "
                     f"k={SPMM_K}",
        },
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/well_spmv.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": well_launches[name],
            **well_kernels[(name, f"poisson2d({grid},{grid})")],
        }
        for name, line, grid in (("well_whole", 431, WELL_WHOLE_GRID),
                                 ("well_seg", 557, WELL_SEG_GRID))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"spmv_tpu_torch/csrc/{source}",
            "replaces": (replaces if replaces.startswith("XLA")
                         else f"spmv_tpu/ops/{replaces}"),
            "launches": launches[name],
            **cw_kernels[name],
            **({"columns_bitwise_equal_to_spmv_kernel": bitwise[name]}
               if name in bitwise else {}),
            "shape": shape,
        }
        for name, (source, replaces, shape) in cw_rows.items()
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/well_spmm.cu",
            "replaces": f"spmv_tpu/ops/pallas_kernels.py:{line}",
            "launches": well_spmm_launches[name],
            **spmm_kernels[name],
            "columns_bitwise_equal_to_spmv_kernel": well_bitwise[name],
        }
        for name, line in (("well_whole_spmm", 1079),
                           ("well_seg_spmm", 1121))
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": f"spmv_tpu_torch/csrc/{name}.cu",
            "replaces": replaces,
            "launches": fmt_launches[name],
            **ell_kernels[name],
        }
        for name, replaces in (
            ("ell_spmv", "XLA `_ell_padded` (spmv_tpu/ops/spmv.py:52), not "
                         "a TPU kernel"),
            ("ell_spmm", "XLA `spmm` on DeviceEll (spmv_tpu/ops/spmv.py:274)"
                         ", not a TPU kernel"))
    ] + _bsr_rows(bsr_run, spmm_kernels) + [
        {
            "name": "fused_vcycle",
            "route": "cuda",
            "source": "spmv_tpu_torch/csrc/fused_vcycle.cu",
            "replaces": "spmv_tpu/ops/fused_vcycle.py:297",
            "launches": amg_launches["fused_vcycle"],
            **fused,
        }
    ] + _traffic_rows(traffic) + [_tri_row(solvers)],
        "wellcw_spmv": {**cw_times, "shape": cw_shape},
        "wellcw_spmm": {**spmm_times, "shape": mm_shape},
        "batched_cg": {**cg_times, "k": CG_K,
                       "shape": f"poisson2d({CG_GRID},{CG_GRID}) float32"},
        "well_spmv": {
            "launches_on_the_well_path": well_launches,
            **{label: {k: v for k, v in res.items() if k != "A"}
               for label, res in profiled.items()}},
        "well_spmm": {
            "launches_on_the_well_spmm_path": {**well_spmm_launches,
                                               "csr_spmm": csr_on_well},
            **{label: {k: v for k, v in res.items() if k != "A"}
               for label, res in well_spmm.items()},
            "batched_cg": {**well_cg, "k": CG_K,
                           "shape": f"poisson2d({CG_GRID},{CG_GRID}) "
                                    "float32"}},
        "bsr_spmm": {"launches_on_the_bsr_path": bsr_run["launches"],
                     "launches_by_path": bsr_run["paths"],
                     **bsr_run["times"]},
        "formats": {"launches_on_the_formats_path": fmt_launches,
                    "cli_checksum_rel_err": fmt_checksums,
                    "ell_chained": ell_chained, "hybrid": hybrid},
        "amg": {"launches_on_the_amg_path": amg_launches,
                "cli": {**amg_cli, "shape": f"poisson2d({AMG_CLI_GRID},"
                                            f"{AMG_CLI_GRID}) float32"},
                **amg_full},
        "traffic_split": {k: v for k, v in traffic.items()},
        "simulate": simulate,
        "solvers": {k: solvers[k] for k in (
            "launches", "cli", "full_width", "natural_cli", "errors",
            "launches_an_apply", "least_launch_ms", "handoff_ms",
            "plan_line", "seconds")},
        "eigs": eigs,
        "sharded": sharded,
        "distributed": distributed,
        "profile_capture": capture}
    for row in summary["kernels"]:
        # K7a and K7b are one kernel on the card (bsr_spmm_core): its rows
        # both carry the wrapper's count
        key = "bsr_spmm" if row["name"].startswith("bsr_spmm") \
            else row["name"]
        if key in sharded["launches"]:
            row["launches_on_the_sharded_path"] = sharded["launches"][key]
        if key in distributed["launches"]:
            row["launches_on_the_distributed_path"] = \
                distributed["launches"][key]
    # the CSR and ELL kernels at the hybrid's shape (phase 25): the COO
    # part's launches and the ELL part's, each beside torch.sparse of
    # that part's own entries
    k = FORMATS_SPMM_K
    at_hybrid = {"csr_spmv": ("coo_launch", "library_coo_spmv",
                              "max_abs_err_coo"),
                 "csr_spmm": (f"coo_launch_spmm_k{k}",
                              f"library_coo_spmm_k{k}",
                              "max_abs_err_coo_spmm"),
                 "ell_spmv": ("ell_launch", "library_ell_spmv", None)}
    for row in summary["kernels"]:
        if row["name"] in at_hybrid:
            part, lib, err = at_hybrid[row["name"]]
            row["hybrid"] = {
                **{f: hybrid[part].get(f) for f in (
                    "ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                    "bytes")},
                "library_ms": hybrid[lib]["library_ms"],
                "max_abs_err": hybrid[err] if err else None,
                "launches_on_the_formats_path": fmt_launches[row["name"]],
                "shape": hybrid["shape"] + (", COO part" if err else
                                            ", ELL part")}
    _say(f"[wall] chip_smoke: {time.perf_counter() - t_main:.1f} s")
    print(json.dumps(summary), flush=True)
    print(smi_line, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


# phase 10 alone, in the checkout it runs from (this one or another
# commit's): the JSON of its kernels on the last line
_PHASE10 = """
import json
import chip_smoke as c
from spmv_tpu_torch.io.generate import banded_random
from spmv_tpu_torch.models import WellCwMatrix
from spmv_tpu_torch.perfmodel import measured_machine
device, smi = c.phase_device()
c.phase_build()
mm = banded_random(c.CW_FULL_ROWS, half_bandwidth=c.CW_FULL_HALF_BW,
                   nnz_per_row=8, seed=1)
cw = WellCwMatrix.from_matrix_market(mm)
found = c.phase_kernels_wellcw(device, cw, smi,
                               measured_machine(device).hbm_gbps)
# the main path's outputs on phase 10's inputs, for a bitwise comparison
# across checkouts
import sys
import torch
from spmv_tpu_torch import ops
from spmv_tpu_torch.models import DeviceWellCw
f32 = torch.float32
g = torch.Generator(device=device).manual_seed(1)
x = torch.randn(cw.num_columns, device=device, dtype=f32, generator=g)
X = torch.randn(cw.num_columns, c.CW_SPMM_K, device=device, dtype=f32,
                generator=g)
outs = {}
for kw in ({}, {"chunks_per_step": 64}):
    A = DeviceWellCw.from_host(cw, dtype=f32, device=device, **kw)
    n = A.num_rows
    for name, part in (("merged", A.merged), ("level", A.levels[0] if
                                              A.levels else None)):
        if part is not None:
            outs[f"wellcw_{name}"] = getattr(
                ops, f"wellcw_{name}_core")(part, x, n).cpu()
            outs[f"wellcw_{name}_spmm"] = getattr(
                ops, f"wellcw_{name}_spmm_core")(part, X, n).cpu()
    if not kw:
        # K4c on the 128-group tail as a product's first launch and as
        # the main path adds it, and the whole SpMM chained (a CUDA graph
        # of 20, L2 warm), timed alike in every checkout
        pool = A.tail_pools[0]
        outs["wellcw_pool_spmm"] = ops.wellcw_pool_spmm_core(
            pool, X, n).cpu()
        outs["wellcw_spmm"] = ops.wellcw_spmm_core(A, X).cpu()
        Y = torch.zeros(n, c.CW_SPMM_K, device=device, dtype=f32)
        scratch = torch.empty(16 << 20, dtype=f32, device=device)
        flush = lambda: scratch.fill_(0.0)
        for what, acc in (("first_launch", False), ("accumulate", True)):
            found[f"wellcw_pool_spmm_{what}"] = {"library_ms": None,
                "ms": c._cold_graph_ms(lambda: ops.wellcw_pool_spmm_core(
                    pool, X, n, out=Y, accumulate=acc), flush, 50)}
        found["wellcw_spmm_chained"] = {"library_ms": None,
            "ms": c._graph_replay_ms(
                lambda: ops.wellcw_spmm_core(A, X, out=Y), 20)}
        # the CSR SpMM on the remainder as the main path adds it (its
        # first launch is phase 10's csr_spmm)
        R = A.remainder
        outs["csr_spmm"] = ops.csr_spmm_core(R, X).cpu()
        found["csr_spmm_accumulate"] = {"library_ms": None,
            "ms": c._cold_graph_ms(lambda: ops.csr_spmm_core(
                R, X, out=Y, accumulate=True), flush, 50)}
    del A
# the CSR format's own path: the whole matrix as one DeviceCsr, a
# product's first launch
from spmv_tpu_torch.models import CsrMatrix, DeviceCsr
R = DeviceCsr.from_host(CsrMatrix.from_matrix_market(mm), dtype=f32,
                        device=device)
outs["csr_spmm_whole"] = ops.csr_spmm_core(R, X).cpu()
Y = torch.empty(R.num_rows, c.CW_SPMM_K, device=device, dtype=f32)
found["csr_spmm_whole"] = {"library_ms": None, "ms": c._cold_graph_ms(
    lambda: ops.csr_spmm_core(R, X, out=Y), flush, 50)}
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


# phase 19's K6 timings alone, in the checkout it runs from: the JSON of
# its kernels on the last line
_PHASE19 = """
import json
import sys
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import DeviceWell, WellMatrix
from spmv_tpu_torch.ops import well_kernels
from spmv_tpu_torch.perfmodel import measured_machine
device, smi = c.phase_device()
c.phase_build()
f32, k = torch.float32, c.WELL_SPMM_K
profiled, outs = {}, {}
for grid in (c.WELL_WHOLE_GRID, c.WELL_SEG_GRID):
    label = f"poisson2d({grid},{grid})"
    w = WellMatrix.from_matrix_market(poisson2d(grid, grid), window_rows=4)
    A = DeviceWell.from_host(w, dtype=f32, device=device)
    del w
    try:
        # a checkout whose K6 kept a shared tile sized its column block
        kc = well_kernels.well_column_block(f32, k, A.out_rows)
    except TypeError:
        kc = well_kernels.well_column_block(k)
    profiled[label] = {"A": A, "columns_per_block": kc}
    # the main path's output on these inputs, for a bitwise comparison
    # across checkouts
    g = torch.Generator(device=device).manual_seed(1)
    X = torch.randn(A.num_columns, k, device=device, dtype=f32, generator=g)
    outs[label] = ops.well_spmm_core(A, X).cpu()
    del X
found = c.phase_kernels_spmm(device, profiled, {}, smi,
                             measured_machine(device).hbm_gbps)
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


# phase 22's K8 alone (and PCG with K8 as phase 21 runs it) in the
# checkout it runs from; the first run's hierarchy is kept beside the
# outputs for the later runs: the JSON of its kernels on the last line
_PHASE22 = """
import json
import os
import pickle
import sys
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, DeviceDia, DiaMatrix
from spmv_tpu_torch.perfmodel import measured_machine
device, smi = c.phase_device()
c.phase_build()
f32 = torch.float32
mm = poisson2d(c.AMG_FULL_GRID, c.AMG_FULL_GRID)
cache = os.path.join(os.path.dirname(sys.argv[1]), "hierarchy.pkl")
if os.path.exists(cache):
    with open(cache, "rb") as f:
        hier = pickle.load(f)
else:
    hier = ops.fused_block_setup(CsrMatrix.from_matrix_market(mm))
    with open(cache, "wb") as f:
        pickle.dump(hier, f)
found = {"fused_vcycle": c.phase_kernel_fused(
    device, hier, smi, measured_machine(device).hbm_gbps)}
A = DeviceDia.from_host(DiaMatrix.from_matrix_market(mm), dtype=f32,
                        device=device)
b = A(torch.ones(A.num_columns, dtype=f32, device=device))
apply, _ = ops.fused_vcycle_preconditioner(hierarchy=hier, dtype=f32,
                                           device=device)
res, applies, secs = c._pcg(A, b, apply, c.AMG_TOL, device)
it = int(res.iterations)
found["pcg_fused_per_iteration"] = {"ms": secs / max(it, 1) * 1e3,
                                    "iterations": it, "library_ms": None}
print(f"PCG with K8 to {c.AMG_TOL}: {it} iterations, "
      f"{secs / max(it, 1) * 1e3:.4f} ms an iteration (host clock)")
# the main path's output on phase 22's input, for a bitwise comparison
# across checkouts
fv = ops.fused_vcycle_device(hier, dtype=f32, device=device)
g = torch.Generator(device=device).manual_seed(5)
b = torch.randn(fv.padded_rows, generator=g, device=device, dtype=f32)
torch.save({"fused_vcycle": ops.fused_vcycle_core(fv, b).cpu()},
           sys.argv[1])
print(json.dumps(found, default=str))
"""


# phase 25's CSR kernels alone, in the checkout it runs from (this one or
# another commit's), beside the CSR legs of phases 10 and 24: the hybrid's
# COO launches and whole products, the whole-matrix CSR SpMV legs, the
# WELL-CW remainder's SpMV and SpMM as the main path adds them, the CSR
# SpMM on the whole bench matrix, and PCG with the generic V-cycle (the
# CSR kernel) at poisson2d(AMG_CLI_GRID²) (the median of seven solves);
# the JSON of its kernels on the last line.  @LONG_ROW@ is this checkout's threshold: the outputs kept
# for the bitwise comparison are those of rows with no long row here.
_PHASE_CSR = """
import json
import sys
import numpy as np
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io.generate import banded_random, poisson2d, powerlaw
from spmv_tpu_torch.models import (CsrMatrix, DeviceCsr, DeviceHybrid,
                                   DeviceWellCw, HybridMatrix, WellCwMatrix)
device, smi = c.phase_device()
c.phase_build()
f32, k, long_row = torch.float32, c.FORMATS_SPMM_K, @LONG_ROW@
scratch = torch.empty(16 << 20, dtype=f32, device=device)
flush = lambda: scratch.fill_(0.0)
found, outs = {}, {}
def timed(name, fn):
    found[name] = {"ms": c._cold_graph_ms(fn, flush, 50), "library_ms": None}
def vectors(A, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(A.num_columns, generator=g, device=device, dtype=f32),
            torch.randn(A.num_columns, k, generator=g, device=device,
                        dtype=f32))
# the hybrid at phase 25's shape: its rows whose COO part is short here
mm = powerlaw(c.HYBRID_ROWS, c.HYBRID_ROWS, 8.0, alpha=1.5, seed=5)
H = DeviceHybrid.from_host(HybridMatrix.from_matrix_market(mm), dtype=f32,
                           device=device)
del mm
x, X = vectors(H, 1)
y = torch.empty(H.num_rows, device=device, dtype=f32)
Y = torch.empty(H.num_rows, k, device=device, dtype=f32)
R = H.coo
timed("coo_launch", lambda: ops.csr_spmv_core(R, x, out=y, accumulate=True))
timed(f"coo_launch_spmm_k{k}",
      lambda: ops.csr_spmm_core(R, X, out=Y, accumulate=True))
timed("hybrid_spmv", lambda: ops.hybrid_spmv_core(H, x, out=y))
timed(f"hybrid_spmm_k{k}", lambda: ops.hybrid_spmm_core(H, X, out=Y))
short = torch.from_numpy(np.diff(R.row_ptr.cpu().numpy()) <= long_row)
outs["hybrid_spmv_short_rows"] = ops.hybrid_spmv_core(H, x).cpu()[short]
outs[f"hybrid_spmm_k{k}_short_rows"] = ops.hybrid_spmm_core(H, X).cpu()[short]
del H, R, x, X, y, Y
# the whole-matrix CSR SpMV legs (phases 10 and 24)
for name, mm in (("banded_random", banded_random(
        c.CW_FULL_ROWS, half_bandwidth=c.CW_FULL_HALF_BW, nnz_per_row=8,
        seed=1)), ("poisson2d", poisson2d(c.FULL_GRID, c.FULL_GRID))):
    S = c._csr_of_mm(mm, device, f32)
    W = DeviceCsr(mm.num_rows, mm.num_columns, S._nnz(), S.crow_indices(),
                  S.col_indices(), S.values())
    x, X = vectors(W, 2)
    y = torch.empty(W.num_rows, device=device, dtype=f32)
    timed(f"csr_spmv_whole_{name}", lambda: ops.csr_spmv_core(W, x, out=y))
    outs[f"csr_spmv_whole_{name}"] = ops.csr_spmv_core(W, x).cpu()
    if name == "banded_random":
        # the CSR SpMM on the whole bench matrix, a product's first launch
        Y = torch.empty(W.num_rows, k, device=device, dtype=f32)
        timed(f"csr_spmm_whole_k{k}", lambda: ops.csr_spmm_core(W, X, out=Y))
        outs[f"csr_spmm_whole_k{k}"] = ops.csr_spmm_core(W, X).cpu()
        cw = WellCwMatrix.from_matrix_market(mm)
    del S, W, x, X, y, mm
# the WELL-CW remainder as the main path adds it
A = DeviceWellCw.from_host(cw, dtype=f32, device=device)
rem = A.remainder
x, X = vectors(A, 3)
g = torch.Generator(device=device).manual_seed(4)
y0 = torch.randn(A.num_rows, generator=g, device=device, dtype=f32)
Y0 = torch.randn(A.num_rows, k, generator=g, device=device, dtype=f32)
y, Y = y0.clone(), Y0.clone()
timed("csr_spmv_remainder", lambda: ops.csr_spmv_core(rem, x, out=y,
                                                      accumulate=True))
timed(f"csr_spmm_remainder_k{k}", lambda: ops.csr_spmm_core(
    rem, X, out=Y, accumulate=True))
outs["csr_spmv_remainder"] = ops.csr_spmv_core(
    rem, x, out=y0.clone(), accumulate=True).cpu()
outs[f"csr_spmm_remainder_k{k}"] = ops.csr_spmm_core(
    rem, X, out=Y0.clone(), accumulate=True).cpu()
del A, rem, cw
# PCG with the generic V-cycle (the CSR kernel on every level's A, P and
# P^T) at the AMG CLI's poisson2d, float32
host = CsrMatrix.from_matrix_market(poisson2d(c.AMG_CLI_GRID,
                                              c.AMG_CLI_GRID))
A = DeviceCsr.from_host(host, dtype=f32, device=device)
apply, _ = ops.amg_preconditioner(
    hierarchy=ops.smoothed_aggregation_setup(host), dtype=f32, device=device)
b = ops.spmv(A, torch.ones(A.num_columns, dtype=f32, device=device))
solves = [c._pcg(A, b, apply, c.AMG_TOL, device) for _ in range(7)]
it = int(solves[0][0].iterations)
found["amg_pcg"] = {"ms": float(np.median([s / max(it, 1) * 1e3
                                           for _, _, s in solves])),
                    "iterations": it, "library_ms": None}
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


# the ELL SpMV's legs alone, in the checkout it runs from (this one or
# another commit's): the ELL SpMV and SpMM at phase 24's poisson2d, and
# the hybrid's ELL launch, SpMV and SpMM at phase 25's matrix, with their
# outputs for a bitwise comparison across checkouts; the JSON of its
# kernels on the last line
_PHASE_ELL = """
import json
import sys
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io.generate import poisson2d, powerlaw
from spmv_tpu_torch.models import (DeviceEll, DeviceHybrid, EllMatrix,
                                   HybridMatrix)
device, smi = c.phase_device()
c.phase_build()
f32, k = torch.float32, c.FORMATS_SPMM_K
scratch = torch.empty(16 << 20, dtype=f32, device=device)
flush = lambda: scratch.fill_(0.0)
found, outs = {}, {}
def timed(name, fn):
    found[name] = {"ms": c._cold_graph_ms(fn, flush, 50), "library_ms": None}
    outs[name] = fn().cpu()
def vectors(A, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return (torch.randn(A.num_columns, generator=g, device=device, dtype=f32),
            torch.randn(A.num_columns, k, generator=g, device=device,
                        dtype=f32),
            torch.empty(A.num_rows, device=device, dtype=f32),
            torch.empty(A.num_rows, k, device=device, dtype=f32))
A = DeviceEll.from_host(EllMatrix.from_matrix_market(
    poisson2d(c.FULL_GRID, c.FULL_GRID)), dtype=f32, device=device)
x, X, y, Y = vectors(A, 1)
timed("ell_spmv", lambda: ops.ell_spmv_core(A, x, out=y))
timed(f"ell_spmm_k{k}", lambda: ops.ell_spmm_core(A, X, out=Y))
del A, x, X, y, Y
H = DeviceHybrid.from_host(HybridMatrix.from_matrix_market(
    powerlaw(c.HYBRID_ROWS, c.HYBRID_ROWS, 8.0, alpha=1.5, seed=5)),
    dtype=f32, device=device)
x, X, y, Y = vectors(H, 2)
timed("hybrid_ell_launch", lambda: ops.ell_spmv_core(H.ell, x, out=y))
timed("hybrid_spmv", lambda: ops.hybrid_spmv_core(H, x, out=y))
timed(f"hybrid_spmm_k{k}", lambda: ops.hybrid_spmm_core(H, X, out=Y))
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


# K5a and K5b alone, in the checkout it runs from (this one or another
# commit's): the WELL SpMV at phase 13's two matrices, poisson2d(1024²)
# and poisson2d(4096²), in float32 and float64 (K5a at 1024² in float32,
# K5b at the others: float64 x at 1024² switches to segments), and K5a
# in float64 at poisson2d(1000²), whose x still fits whole; each timed
# as phase 13 times it (a CUDA graph of 50, the L2 flushed) and its
# output kept for a bitwise comparison across checkouts; the JSON of its
# kernels on the last line
_PHASE_WELL = """
import json
import sys
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import DeviceWell, WellMatrix
device, smi = c.phase_device()
c.phase_build()
scratch = torch.empty(16 << 20, dtype=torch.float32, device=device)
flush = lambda: scratch.fill_(0.0)
found, outs = {}, {}
f32, f64 = torch.float32, torch.float64
for grid, dtypes in ((c.WELL_WHOLE_GRID, (f32, f64)), (1000, (f64,)),
                     (c.WELL_SEG_GRID, (f32, f64))):
    w = WellMatrix.from_matrix_market(poisson2d(grid, grid), window_rows=4)
    for dt in dtypes:
        A = DeviceWell.from_host(w, dtype=dt, device=device)
        kname = "well_whole" if A.segment_of_step is None else "well_seg"
        name = f"{kname}_poisson2d({grid},{grid})_{str(dt)[6:]}"
        g = torch.Generator(device=device).manual_seed(2)
        x = torch.randn(A.num_columns, generator=g, device=device, dtype=dt)
        y = torch.empty(A.num_rows, device=device, dtype=dt)
        found[name] = {"ms": c._cold_graph_ms(
            lambda: ops.well_spmv_core(A, x, out=y), flush, 50),
            "library_ms": None}
        outs[name] = ops.well_spmv_core(A, x).cpu()
        del A, x, y
    del w
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


# phase 28's triangle solves alone, in the checkout it runs from (this
# one or another commit's): the natural-order IC(0) L and L^T of
# poisson2d(1024²) and the colored ILU(0) unit L and U of poisson2d(2048²)
# (the first run pickles the colored factors for the others), each in
# float32 and float64, timed as phase 28 times them (a CUDA graph, the L2
# flushed) in the mode the checkout picks, its z kept for a bitwise
# comparison across checkouts; then the CLI's GMRES(32) + IC(0) at
# poisson2d(256²) in float32 and float64 (host ms an iteration, its
# iterations and residual); the JSON of its kernels on the last line
_PHASE_TRI = """
import json
import os
import pickle
import sys
import torch
import chip_smoke as c
from spmv_tpu_torch import ops
from spmv_tpu_torch.io import write_matrix_market
from spmv_tpu_torch.io.generate import poisson2d
from spmv_tpu_torch.models import CsrMatrix, reorder
from spmv_tpu_torch.ops.incomplete import _transpose_csr
device, smi = c.phase_device()
c.phase_build()
here = os.path.dirname(sys.argv[1])
scratch = torch.empty(16 << 20, dtype=torch.float32, device=device)
flush = lambda: scratch.fill_(0.0)
found, outs = {}, {}
grid = c.SOLVER_NATURAL_GRID
L = ops.ic0_factor(CsrMatrix.from_matrix_market(poisson2d(grid, grid)))
cache = os.path.join(here, "colored.pkl")
if os.path.exists(cache):
    with open(cache, "rb") as f:
        Lc, Uc = pickle.load(f)
else:
    mm = poisson2d(c.SOLVER_FULL_GRID, c.SOLVER_FULL_GRID)
    mm = mm.permute(reorder.find_new_order_coloring(mm))
    Lc, Uc = ops.ilu0_factor(CsrMatrix.from_matrix_market(mm))
    del mm
    with open(cache, "wb") as f:
        pickle.dump((Lc, Uc), f, protocol=4)
for name, t, lower, unit in (("ic0_L_natural", L, True, False),
                             ("ic0_LT_natural", _transpose_csr(L), False,
                              False),
                             ("ilu0_L_colored", Lc, True, True),
                             ("ilu0_U_colored", Uc, False, False)):
    for dt in (torch.float32, torch.float64):
        T = ops.DeviceTriSolve.from_host(t, lower=lower, unit_diag=unit,
                                         dtype=dt, device=device)
        g = torch.Generator(device=device).manual_seed(84)
        b = torch.randn(T.n, generator=g, device=device, dtype=dt)
        z = torch.empty_like(b)
        key = f"{name}_{str(dt)[6:]}"
        found[key] = {"ms": c._cold_graph_ms(
            lambda: ops.tri_solve_core(T, b, out=z), flush,
            c.SOLVER_GRAPH_REPS), "library_ms": None}
        outs[key] = ops.tri_solve_core(T, b).cpu()
        del T, b, z
path = os.path.join(here, f"poisson2d_{c.SOLVER_CLI_GRID}.mtx")
if not os.path.exists(path):
    write_matrix_market(poisson2d(c.SOLVER_CLI_GRID, c.SOLVER_CLI_GRID),
                        path)
for dt in ("float32", "float64"):
    cg, _ = c._cli_doc(["--matrix", path, "-s", "csr", "--cg",
                        str(c.SOLVER_CLI_ITERS), "--cg-tol",
                        c.SOLVER_CLI_TOL, "--solver", "gmres", "--restart",
                        "32", "--precondition", "ic0"], "gmres(32) ic0", dt)
    it = cg["iterations"]
    key = f"gmres32_ic0_cli_{dt}"
    found[key] = {"ms": cg["seconds"] / max(it, 1) * 1e3, "iterations": it,
                  "seconds": cg["seconds"], "library_ms": None}
    outs[key + "_residual"] = torch.tensor([cg["residual_norm"]],
                                           dtype=torch.float64)
torch.save(outs, sys.argv[1])
print(json.dumps(found, default=str))
"""


def _phase_csr_script() -> str:
    from spmv_tpu_torch.models.device import LONG_ROW

    return _PHASE_CSR.replace("@LONG_ROW@", str(LONG_ROW))


def _beside(other: str, script: str, phase: int) -> int:
    """``script``, one phase alone, in the checkout at ``other`` (another
    commit's files, e.g. the parent's from ``git archive``) and in this
    one, each in a process of its own, in the order other, this, this,
    other, on one card; then each kernel's device ms from the four runs
    and whether the main path's outputs are bitwise equal across the
    checkouts."""
    import torch

    here = os.path.dirname(os.path.abspath(__file__))
    runs, outs = [], {}
    tmp = tempfile.mkdtemp(prefix=f"phase{phase}_", dir=here)
    for i, (label, root) in enumerate((("other", other), ("this", here),
                                       ("this", here), ("other", other))):
        _say(f"[{phase} beside] phase {phase} of {label} "
             f"({os.path.abspath(root)})")
        path = os.path.join(tmp, f"{i}.pt")
        r = subprocess.run([sys.executable, "-c", script, path],
                           cwd=root, capture_output=True, text=True,
                           timeout=1200)
        lines = r.stdout.strip().splitlines()
        for line in lines[:-1]:
            _say(f"  [{label}] {line}")
        if r.returncode != 0 or not lines:
            _say(r.stderr[-4000:])
            _fail(f"phase {phase} of {root} exited with {r.returncode}")
        runs.append((label, json.loads(lines[-1])))
        outs.setdefault(label, torch.load(path))
        os.remove(path)
    shutil.rmtree(tmp)
    same = {name: torch.equal(y, outs["other"][name])
            for name, y in outs["this"].items() if name in outs["other"]}
    _say(f"[{phase} beside] main-path outputs on phase {phase}'s inputs "
         "bitwise equal to the other checkout's: " + ", ".join(
             f"{name} {'yes' if eq else 'no'}" for name, eq in same.items()))
    for name in (n for n, eq in same.items() if not eq):
        y, z = outs["this"][name], outs["other"][name]
        if y.shape == z.shape:
            _say(f"[{phase} beside] {name}: "
                 f"{int((y != z).sum())} of {y.numel()} values differ")
    summary = {}
    for name in runs[1][1]:
        summary[name] = {f"{label}_{i}": run.get(name, {}).get("ms")
                         for i, (label, run) in enumerate(runs)}
        summary[name]["library_ms_this"] = runs[1][1][name]["library_ms"]
        if "iterations" in runs[1][1][name]:
            summary[name]["iterations"] = [run.get(name, {}).get(
                "iterations") for _, run in runs]
        how = ("host ms an iteration" if "iterations" in summary[name]
               else "device ms (CUDA graph, L2 flushed)")
        _say(f"[{phase} beside] {name}: {how} "
             + ", ".join(f"{k} {v}" for k, v in summary[name].items()))
    print(json.dumps({f"phase{phase}_kernels_beside": summary,
                      "bitwise_equal_to_other": same,
                      "runs": [{"label": label, "kernels": run}
                               for label, run in runs]}, default=str),
          flush=True)
    return 0


BESIDE = {"--wellcw-kernels-beside": (_PHASE10, 10),
          "--well-spmm-kernels-beside": (_PHASE19, 19),
          "--fused-vcycle-beside": (_PHASE22, 22),
          "--csr-kernels-beside": (_phase_csr_script, 25),
          "--ell-kernels-beside": (_PHASE_ELL, 24),
          "--well-kernels-beside": (_PHASE_WELL, 13),
          "--tri-kernels-beside": (_PHASE_TRI, 28)}


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in BESIDE:
        script, phase = BESIDE[sys.argv[1]]
        if callable(script):
            script = script()
        sys.exit(_beside(sys.argv[2], script, phase))
    sys.exit(main())
