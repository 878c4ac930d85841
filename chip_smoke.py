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
   lengths; host clock, the median and range of 11 interleaved rounds,
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
   as one DeviceCsr (the path of -s csr) alike.  Phase 10 times the CSR
   SpMV on the whole bench matrix the same way.
25. Hybrid at a skewed matrix, powerlaw(4194304, 4194304, 8.0, alpha 1.5,
   seed 5) in float32 (not counted): the SpMV and SpMM (k = 8) against
   their plain versions; the COO part's CSR kernels (its long rows on
   warps and blocks) against theirs, twice bitwise, the SpMM's columns
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

The second-to-last lines are the kernels' JSON summary (25 kernels, the
six traffic variants last, each with its launches on the main path, max
error, ms against
plain ms, bound and library ms; K7's rows also its launches by path;
the CSR SpMV's its whole-matrix times; the CSR kernels' and the ELL
SpMV's their times at the hybrid's shape, beside torch.sparse of that
part's own entries; and summaries of each path,
`formats`, `amg`, `traffic_split` and `simulate` the last) and nvidia-smi's
``name, power.limit``; the last line is the run's result.  Imports no JAX and nothing of the JAX
package: the machine with the card need not have it.  Bounds take the
data sheet's 3.35 TB/s, 67 TFLOP/s float32 and 989 TFLOP/s bfloat16
(H100 SXM, 700 W).
"""

from __future__ import annotations

import contextlib
import io
import json
import os
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
CG_ITERS = (50, 250)          # fixed-length solves for the slope
CG_ROUNDS = 11                # rounds of those solves, for the spread
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
        X_true = np.ones((n, CG_K)) * np.arange(1, CG_K + 1)
        rhs = torch.from_numpy(np.stack(
            [host.spmv(X_true[:, j]) for j in range(CG_K)], axis=1))
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
    del host
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
    (the path of -s csr), alone: against its plain version, twice
    bitwise, device ms and eager, bound, plain ms and ``S`` (torch.sparse
    of the same entries) timed the same way and eagerly."""
    import torch

    from spmv_tpu_torch.ops import csr_spmv_core, csr_spmv_reference

    y1, y2 = csr_spmv_core(R, x), csr_spmv_core(R, x)
    want = csr_spmv_reference(R, x)
    _sync(x.device)
    rel = _rel(y1, want)
    if not torch.equal(y1, y2) or not rel <= TOL_F32:
        _fail(f"csr_spmv on {label}: two launches differ or rel err "
              f"{rel} > {TOL_F32}")
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
    for what, got, ref in (
            ("spmv", hybrid_spmv_core(H, x), hybrid_spmv_reference(H, x)),
            (f"spmm k={k}", hybrid_spmm_core(H, X),
             hybrid_spmv_reference(H, X))):
        rel = _rel(got, ref)
        errs[what] = float((got.double() - ref.double()).abs().max())
        _say(f"[{tag}] hybrid {what}: rel err {rel:.3e} against the plain "
             f"version (tol {TOL_F32})")
        if not rel <= TOL_F32:
            _fail(f"hybrid {what}: rel err {rel} > {TOL_F32}")
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
    for what, got, ref in (("spmv", yc[0], csr_spmv_reference(R, x)),
                           (f"spmm k={k}", Yc[0],
                            csr_spmv_reference(R, X))):
        rel = _rel(got, ref)
        errs[f"coo {what}"] = float((got.double() - ref.double()).abs()
                                    .max())
        _say(f"[{tag}] the COO part's csr {what} ({shape['coo_split']}): "
             f"rel err {rel:.3e} against the plain version (tol {TOL_F32}),"
             " twice bitwise equal"
             + (", columns bitwise the SpMV kernel's" if what != "spmv"
                else ""))
        if not rel <= TOL_F32:
            _fail(f"the COO part's csr {what}: rel err {rel} > {TOL_F32}")
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
            "keep": keep}


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
    del cw, cw_mm
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
    del well_mats, dia_of, full, cg_well
    _sync(device)

    bsr_run = phase_bsr_path(device, smi_line, triad_gbps)
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
    del ell_mm, ell_host, ell_A, well_hosts, hybrid_mm, hybrid_host
    _sync(device)
    simulate = phase_simulate(device)

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
    ] + _traffic_rows(traffic), "wellcw_spmv": {**cw_times, "shape": cw_shape},
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
        "simulate": simulate}
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
          "--well-kernels-beside": (_PHASE_WELL, 13)}


if __name__ == "__main__":
    if len(sys.argv) == 3 and sys.argv[1] in BESIDE:
        script, phase = BESIDE[sys.argv[1]]
        if callable(script):
            script = script()
        sys.exit(_beside(sys.argv[2], script, phase))
    sys.exit(main())
