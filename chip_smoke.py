#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (stencil_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero before the last line:

1. card: ``torch.cuda.is_available()`` must hold; print the card's name
   and power limit (nvidia-smi) and the device count.
2. build: compile every kernel source of the package with nvcc, one
   process per source, all at once; the registers and spills of every
   instantiation of the two ring kernels (``csrc/mhd_ring.cuh``: B9 and
   B11, launched twice each as B10 and B12, and the margin kernel of
   ``csrc/mhd_margin.cuh`` in the ``mhd`` library, B13's interior, B14's
   shell and the margin kernel again (the pair forms) in
   ``mhd_overlap``; ``csrc/jacobi_ring.cuh``: K2 in ``jacobi7``, B6 in
   ``jacobi_halo``) and of B8's ring kernel (``csrc/laplace6.cu``: each
   copy width and store width, float32 and bfloat16), the MHD ones for
   float32 and bfloat16
   storage (and the bf16 pair's mixed instances), are read from the
   ``-Xptxas=-v`` lines (a NOTE where one uses more than 128 registers
   or spills), their opcode counts from ``cuobjdump -sass``.
3. kernels vs plain twins, on the card:
   - K1 (jacobi7_wrap), K2 (jacobi7_wrapn, N=1,2,3, and 4 at 512^3)
     and K3 (jacobi7_padded) at small odd shapes and at 512^3; K2 also at N=1,
     2, 3, 8 where x is a multiple of 4 (16-byte copies), y not a
     multiple of its 32-row tile, and at (131, 64, 128), where
     ``jacobi_ring_plan`` walks z in runs whose last one is shorter.
     Tolerance: 0 (bitwise) — each kernel adds and multiplies in its
     twin's order, built -fmad=false.
   - B8 (laplace6) at (8,8,8), (16,8,24), (8,16,40), 256^3, 136 x 128
     x 96 and (131, 64, 128) (``laplace6_plan`` walks z in runs whose
     last one is shorter), (1, 8, 1) (smaller than one tile) and (5, 7,
     33) (x not a multiple of 4) (Z,Y,X), and at 29 x 37 x 70 with low
     pads above 3 and padded rows that start on 4 or 8 bytes (its 4- and
     8-byte copies, 4-byte stores). Tolerance: 0, as for K3. B8's
     bfloat16 instance at the same shapes and layouts, on float32 draws
     rounded once to bfloat16 (its 2-byte and 4-byte loads, 8-byte and
     2-byte stores). Tolerance: 0 (bfloat16x2 instructions round each
     operation once, as the twin's bfloat16 ops do).
   - B5 (jacobi7_halo) and B6 (jacobi7_halon) on slabs from
     ``exchange_interior_slabs``: B5 at 512^3 with its own wrapped
     slabs, and on the four shards of 512 x 511 x 509 (x, y, z) over
     mesh (1,2,2) (capacity 512 x 256 x 255, remainders (0,1,1),
     compared on each shard's live cells), both with the halo path's
     one-row slabs, and at small odd shapes with JAX-style slabs (rz >
     1, or y slabs 8 columns wide); B6 at 512^3 N=2, and on the four
     shards of 512^3 over (1,2,2) at N=2 and 3, with the path's N-row
     slabs (N=4 too, and N=3 and 4 on one 512^3 shard), at small odd
     shapes with JAX-style rz = block_z, ry = 8
     slabs, on (1,2,4), and on the four (131, 64, 128) shards of 128 x
     128 x 262 over (1,2,2) (z runs, the last one shorter). Tolerance:
     0, as K1/K2.
   - B9 (mhd_substep_wrap: s=0 with w=None, s=1, s=2 with
     write_w=False), B10 (mhd_substep01_wrap) against its twin, at the
     same shapes, dt 1e-8 and 1e-4. Tolerance per field, for f and w:
     max |kernel - twin| <= 64 * eps(f32) * max |twin| (the kernels'
     expf and PyTorch's exp differ by an ulp; every other operation is
     in the twin's order); whether B9 came out bitwise is reported. B10
     also against B9 s=0 then B9 s=1, which it launches: bitwise. B9 (every variant) also
     against B11 on the same field as a (1,1,1) mesh, at those shapes,
     at 256^3 and at 136 x 128 x 96, where ``ring_zrun`` splits z into
     runs, the last one shorter. Tolerance: 0 (one kernel body).
   - B11 (mhd_substep_halo: every variant of s, w=None and write_w) and
     B12 (mhd_substep01_halo) against their twins on the slabs of
     ``exchange_interior_slabs``: JAX's layout (rz = ry = 8, zero filler)
     and the halo path's exact rows (rz = ry = 3, or 6 for B12), on
     (1,1,1), (1,2,2) and (1,2,4) meshes of small shards (x not a
     multiple of B11's 32-wide tile), on two 256^3 shards of a (1,1,2)
     mesh and on four 136 x 128 x 96 shards of a (1,2,2) mesh, where
     ``ring_zrun`` splits z into runs, the last one shorter; B12 also
     against B11 s=0, a radius-R slab round and B11 s=1 (what it
     launches, with substep 0 over the R rows around the shard in place
     of the round) on every one of those meshes and layouts; on one shard
     B11 (every variant) against B9 and B12 against B10. Tolerance: B11
     bitwise (it reads the shard and the slabs themselves and computes
     B9's arithmetic, as its twin does), B12 against its twin as for B9,
     B12 against the B11 chain and B10 bitwise.
   - B4 (exchange_axis: every shard stores its boundary slabs into its
     neighbours' halos; one launch per card and sweep for every quantity
     and shard) sweep by sweep against its twin, each sweep one launch,
     and whole ``Method.PallasDMA`` exchanges against the slab copy:
     512^3 radius 1 on (1,2,2), on (2,2,2) with eight shards on the card
     (the x sweep remote too), float64 and bfloat16 at odd shapes with
     asymmetric radii, 1 and 8 quantities of radius 3 on (1,2,2) and
     (1,2,4) in float32 and float64, and the 8-quantity radius-3 domain
     of 256 x 512 x 512 over (1,2,2) through ``DistributedDomain.
     exchange``; B7 (jacobi7_overlap:
     face slabs sent into the neighbours' receive slabs, interior, then
     faces), field and landed slabs, on the 512 x 256 x 256 quarter
     shards of (1,2,2), on one 512^3 shard and at small shapes.
     Tolerance: 0 (B4 copies; B7 adds in its twin's orders).
   - B13 (mhd_substep_overlap: every shard stores its boundary rows of
     the 8 fields into its face and diagonal neighbours' receive
     buffers, then computes its interior) and B14 (mhd_substep_fixup:
     the exterior shell from the landed rows) for every variant (s=0
     with w=None, s=1, s=2 with write_w=False, the pair) on (1,1,1),
     (1,1,2), (1,2,2) and (1,2,4) meshes of small shards (among them 24 x
     8 x 24 shards, thin in y and narrower than a tile) and on the four
     256^3 shards of 256 x 512 x 512 over (1,2,2), and on four 104 x 128
     x 96 shards of (1,2,2), whose interior the ring kernel walks in z
     runs, the last one shorter (B14: the ring kernel's z instance over
     its z strips, its y instance over its y strips, one launch a shard;
     with the pair, B13 is the sends and two ring launches and B14 two
     shell launches around the margin kernel, through the shard's
     scratch): B13's interior against its twin per
     field within 64 eps(f32) x max and bitwise against B11 (B12 with the
     pair) on the same shards and rows, its landed rows bitwise; B14
     after B13 bitwise against B11 (B12) on the same shards and rows, and
     within the same tolerance of their twins; a chain of substeps on the
     256^3 shards with shard 3's
     stream delayed before each of its launches bitwise equal to the
     undelayed chain.
   - bfloat16 storage (``compare_mhd_bf16_kernels``): B9 (s=0 with
     w=None, s=1, s=2 with write_w=False) and B10 at 16 x 16 x 24 (a
     16-row sub-tile), 32 x 16 x 33 (odd x) and 256^3; B11 (each s) and
     B12 on every shard of two small (1,2,2) meshes and on shard 0 of
     the four 256^3 shards of 256 x 512 x 512; B13 then B14 (each s and
     the pair) on those meshes. Each against its plain twin on the same
     bf16 inputs within one bf16 ulp of the largest twin value a field
     (2^-7 x max; the share of elements that differ is logged), and
     against the float32 instance on the widened inputs, rounded once
     to bf16: bitwise (the ring and the arithmetic are float32 in
     both).
   - bfloat16 on the Jacobi kernels (``compare_jacobi_bf16_kernels``):
     K1 and K3 (r = 1 and asymmetric) at 512^3 and 131 x 97 x 133 (Z,
     Y, X), K2 at N = 2, 3 and 16 (two launches) at 512^3 and 129 x 96
     x 130, B5 at 512^3 and on the four shards of 512 x 511 x 509 over
     (1,2,2), B6 at N = 2, 3 and 16 at 512^3 and 129 x 96 x 130, B7 on
     the four shards of 512^3 and of 132 x 80 x 130 over (1,2,2).
     Tolerance: 0 (bitwise) — each kernel rounds to bf16 after every
     operation in its twin's order.
4. main paths, each driven with the launch counts set to 0 just before
   it and read just after:
   - ``Jacobi3D(512, 512, 512, float32)``: kernel="auto" must take
     ``wrap``; ``run(21)`` must launch K2 exactly 10 times and K1 once,
     and agree with the plain ``xla`` path; then the ``pallas`` path runs
     4 steps (4 K3 launches) against ``xla``. The paths add in different
     orders, so they agree to ``steps * 8 * eps(float32)`` (values lie in
     [0, 1]; each step may round each of its 7 operations differently,
     and a Jacobi step never amplifies an earlier difference). A 16^3
     run is also held against the dense numpy oracle.
   - ``Jacobi3D(512, 512, 512, kernel="halo")`` on a (1,1,1) mesh:
     ``run(21)`` must launch B6 10 times and B5 once and equal the
     ``wrap`` path bitwise (on one shard the slabs are the shard's own
     wrapped edges, so B5 is K1's arithmetic and B6 K2's); the same
     grid on mesh (1,2,2) with all four shards on the one card
     (``devices=["cuda:0"] * 4``, kernel="auto" must take ``halo``):
     40 B6 + 4 B5 launches, bitwise equal to ``wrap``; and
     512 x 511 x 509 ``halo`` on (1,2,2) (uneven: B5 every step, 84
     launches) against the ``xla`` path on the same mesh within
     ``steps * 8 * eps(float32)``.
   - ``Astaroth(256, 256, 256, float32)``: kernel="auto" must take
     ``wrap``; ``run(2)`` must launch B9 exactly 6 times and B10 never;
     with ``STENCIL_MHD_PAIR=1``, ``run(2)`` must launch B10 twice and
     B9 twice; neither launches B8, which no model path runs. The models
     run at dt 1e-4, where the rates move the float32 fields by many
     ulps. ``wrap``+pair equals ``wrap`` bitwise, fields and carried w.
     Each run's fields, and the w it carries (substep 1's), agree
     with the plain ``xla`` path per field to ``substeps * 64 * eps(f32)
     * max |xla|`` (6 substeps), and a 16^3 run agrees with a float64
     ``xla`` run of the port to the same bound. Fields stay finite.
   - ``Astaroth(256, 512, 512, float32)`` on mesh (1,2,2), four 256^3
     shards on the one card (``devices=["cuda:0"] * 4``): kernel="auto"
     must take ``halo``; ``run(2)`` must launch B11 24 times and nothing
     else, with ``STENCIL_MHD_PAIR=1`` B12 8 times and B11 8 times; each
     equals the ``wrap`` path on the same grid (fields and carried w)
     within ``substeps * 64 * eps(f32) * max`` (bitwise is expected, and
     reported); ``halo`` on a 256^3 (1,1,1) mesh (6 B11 launches) the
     same against ``wrap``, and on (1,2,2) quarter shards against the
     ``xla`` run above. ``halo``+pair equals ``halo`` bitwise, fields
     and carried w, on the four 256^3 shards and on 256^3 (1,1,1) (2
     B12 and 2 B11 launches). Every run moves every field by more than
     10x that bound.
   - ``Jacobi3D(512, 512, 512, overlap=True)`` on (1,2,2) with four
     shards on the card (kernel="auto" must take ``overlap``): ``run(21)``
     launches B7 84 times (once per shard and step, launch A and B) and
     nothing else, agrees with ``xla`` on the same mesh within ``steps *
     8 * eps(float32)``, and equals itself bitwise when one shard's
     stream sleeps before each of its launches (a missing ordering rule
     between the shards' streams would show there); the same on
     (1,1,1) (21 launches). ``pallas`` with ``Method.PallasDMA`` (4
     steps: 12 B4 — one per step, sweep and card — and 16 K3 launches)
     and ``xla-overlap`` with ``PallasDMA`` bitwise equal to the slab
     method, and the latter also with every B4 launch delayed on its
     card's side stream.
   - ``Astaroth(256, 512, 512, overlap=True)`` on (1,2,2) with four
     shards on the card: kernel="auto" must take ``halo-overlap``;
     ``run(2)`` launches B13 and B14 24 times each and nothing else (16
     and 16 with ``STENCIL_MHD_PAIR=1``) and equals the ``halo`` runs
     above bitwise (fields and carried w), also with shard 3's stream
     delayed before each of its launches; 256^3 ``halo-overlap`` on
     (1,1,1) (6 + 6 launches, 4 + 4 with the pair) bitwise equal to
     ``wrap`` (which equals ``halo`` and ``halo``+pair there); the MHD
     ``xla-overlap`` path with ``Method.PallasDMA`` (18 B4 launches: one
     per substep, sweep and card) on 32 x 32 x 48 over (1,2,2) against
     ``xla`` within substeps x 64 eps x max, and bitwise against itself
     with every B4 launch delayed.
   - Temporal blocking, ``Jacobi3D(exchange_every=s)`` for s = 1, 3, 4,
     ``run(12)`` each: ``wrap`` at 512^3 launches K2 12/s times (K1 12
     times at s = 1); ``halo`` on four 512 x 256 x 256 shards of the
     card launches B6 4 x 12/s times where ``pair_halo_refusal`` allows
     N = s (the log says which), else B5 every step. ``halo`` equals
     ``wrap`` bitwise where both group steps alike, else within ``steps
     * 8 * eps(float32)``; each is within that of ``xla`` at 512^3.
     ``xla-temporal[s=4]``, ``[s=1.1.4]`` and ``[s=4]-overlap`` on four
     128^3 shards of the card equal stepwise ``xla`` bitwise after
     ``run(9)``.
   - bfloat16 storage (``run_astaroth_bf16``), each ``run(2)`` at dt
     1e-4: ``Astaroth(256, 256, 256, bfloat16)`` auto takes ``wrap`` (6
     B9 launches; 2 B10 + 2 B9 with the pair), ``halo`` on it as a
     (1,1,1) mesh (6 B11) bitwise equal to ``wrap``;
     ``Astaroth(256, 512, 512, bfloat16)`` on four 256^3 shards auto
     takes ``halo`` (24 B11; 8 B12 + 8 B11 with the pair) and with
     overlap ``halo-overlap`` (24 B13 + 24 B14; 16 + 16), bitwise equal
     to ``halo`` (+pair); each within 6 x 2^-7 x max of the bf16 ``xla``
     path on the same grid. A bf16 pair is not bitwise its
     single-substep path (f_1, w_1 stay float32 in it): logged.
   - The MHD temporal path and Boundary.NONE (``run_astaroth_temporal``),
     float32, ``Astaroth(256, 512, 512, kernel="xla")`` on four 256^3
     shards: ``exchange_every`` 2, 3 (also with overlap) and 4, two
     runs back to back (2 + 3 iterations; 4 + 1 at s = 4, whose period
     is four iterations), after each against stepwise ``xla`` within
     ``substeps x 64 eps(f32) x max`` ("bitwise: yes/no" logged), with
     iterations/s over the second run and ``exchange_stats()``;
     ``xla-overlap`` and ``xla-temporal[s=3]`` with Boundary.NONE
     against stepwise ``xla`` with it, ``run(2)``.
   - The exchange apps through their ``main()``, CSV lines printed:
     ``bench_exchange`` on four 256^3 shards of the card at
     ``--exchange-every 1,2,4`` and once with ``--pallas-dma`` (B4
     launches, counted), ``pingpong`` on two shards of the card,
     ``bench_pack`` at its default sizes; every time finite and
     positive.
   - ``Jacobi3D(512, 512, 512, bfloat16)`` (``run_jacobi_bf16``):
     ``auto`` takes ``wrap`` (K2 x 10 + K1 x 1 per ``run(21)``),
     ``halo`` on (1,1,1) and, by ``auto``, on four shards of (1,2,2)
     (B6 + B5), ``overlap`` on (1,2,2) (B7), ``pallas`` (K3 x 4 per
     ``run(4)``) and ``exchange_every=16`` on ``wrap`` and ``halo``
     (256 x 512 x 512, where JAX's planner takes 16-step groups);
     ``halo`` bitwise equal to ``wrap``, the others within ``steps x
     2^-7`` of bf16 ``xla``; finite and 512^3.
   - Particle-in-cell (``run_pic``): a 9^3 NGP float64 model on (2,2,2)
     shards of the card bitwise equal to the same on the CPU over 4
     steps, its first rho to the dense oracle; then 256^3 on (2,2,2)
     shards of 128^3: CIC float32 at 4 particles a cell (67,108,864,
     seeded on the card), 3 timed steps (particle steps/s), 18 messages
     a shard a step, the total charge within 1e-5 of the count; and NGP
     float64 at 1 particle a cell, the total charge equal to the count
     exactly after every step.
   - Two ranks on the one card (``run_two_ranks``): two processes
     (``multihost.spawn_ranks``, ``gloo`` for the group), two shards
     each of (1,2,2) (PIC: four of (2,2,2)), every case of
     ``TWO_RANK_CASES``: ``Jacobi3D(512, 512, 512)`` ``halo`` (B6 x 10
     + B5 x 1 a shard per ``run(21)``) and ``xla``, and
     ``Astaroth(256, 512, 512)`` ``halo`` ``run(2)`` (B11 x 6 a shard),
     whose slabs go as gloo messages staged through host memory; the
     remote-write kernels across processes (``IPC_CASES``): Jacobi
     ``overlap`` (B7, ``run(21)``), ``pallas`` with ``PallasDMA`` (K3 +
     B4, ``run(4)``) and Astaroth ``halo-overlap`` with and without the
     pair (B13/B14, ``run(2)``), whose only cross-process path is the
     other rank's buffers mapped through CUDA IPC and device-side flags
     (``parallel/ipc.py``: no message through the group, checked); and
     ``xla-overlap`` and ``xla`` with ``AllGather`` (``run(21)``) and
     PIC 256^3 NGP float64 (2 steps, the total charge equal to the count
     exactly). Each from a state seeded on the card, gathered on rank 0
     (collectives) and held bitwise against the same path in this one
     process, by SHA-256 of the arrays; each rank's launch deltas and
     their sum against the one process's (equal, except B4's, which
     launches once a card and sweep in every process: twice the one
     process's); steps/s (iterations/s) beside the one process's and,
     for the IPC cases, beside the world's Jacobi ``halo``; three
     timed runs pooled (each run's rate beside it; PIC one); each case
     ends with ``ipc.release``. With two or more cards the Jacobi
     ``halo`` case and the IPC cases run again with ``nccl``, one rank a
     card (IPC over NVLink); with one card a line says why they did
     not.
   - Segments (``run_segments``, ``parallel/megastep.py``): at 512^3
     ``Jacobi3D`` ``wrap`` in float32 and bfloat16 (K2, K2, K1 a
     5-step segment), ``halo`` and ``overlap`` on four 512 x 256 x 256
     shards of the card (B6 + B5, B7), ``pallas`` with ``PallasDMA`` on
     the four shards (K3 + B4) and ``xla``; ``Astaroth`` 256^3
     ``xla-temporal[s=2]`` (a 3-iteration segment: one period and a
     tail); PIC 256^3 NGP float64 on (2,2,2) (a 2-step segment). Each
     against a twin model run stepwise in the segment's chunks with a
     sentinel probe after each: fields (and ``w``, and every particle
     lane) and the trace bitwise, the launch counts of the two runs
     equal and the path's kernels launched; every segment run, and its
     trace's copy to the host, under
     ``torch.cuda.set_sync_debug_mode("error")``; a NaN planted before a
     segment trips its first row; Astaroth's ``wrap``, ``halo`` and
     ``halo-overlap`` decline (``interior-resident-state``). Then
     ``apps._common.megastep_race`` on ``wrap`` and on ``halo`` (1,2,2)
     at 512^3 (three races pooled, each beside) and the probe's ms a row
     (CUDA events) beside its bound, the padded field's bytes over
     3.35 TB/s.
   - Resilience and placement (``run_resilience``): ``run_resilient``
     on ``Jacobi3D`` 512^3 ``wrap`` (40 steps, check 10, checkpoints
     every 20, a NaN at 25: restored from 20, bitwise a clean
     ``run(40)``), on ``halo`` (1,2,2) at ``exchange_every=2`` (a NaN at
     5 twice with ``max_retries=1``: the ladder degrades to s = 1;
     bitwise s = 2 up to the anchor and s = 1 after it), a preemption at
     20 and the resume (bitwise one ``run(40)``), ``Astaroth`` 256^3
     ``wrap`` (B9; a NaN at iteration 3, bitwise a clean ``run(4)``) and
     PIC 128^3 CIC float32 with a ``ParticleLoss`` (its total charge,
     C1's float32 sum of rho, beside the count); each with JAX's events
     for its plan (``RES_EVENTS``, as a multiset: an async checkpoint may
     land later on the card) and each kernel's launches equal to the
     clean run's plus the replayed window's, every segment under the
     driver's ``set_sync_debug_mode("error")`` guard. Then checkpoint
     save and restore seconds at 512^3, the campaign's steps/s beside
     plain ``run()``, the rollback's replay cost; ``make_placement(
     NodeAware, mode="qap")`` on (1,2,2), the Jacobi ``halo`` run under
     it bitwise the trivial order's; ``bench_qap``'s lines and whether
     ``qap.cpp`` built natively; the plan file of the 512^3 (1,2,2)
     domain, its message bytes equal to the irredundant layout's
     ``exchange_bytes_total()``.
   - Autotune and observatory (``run_autotune_observatory``,
     ``tuning/``, ``observatory/``): ``Jacobi3D`` 512^3 float32
     ``pallas`` on (1,2,2) shards of the card with ``Method.Auto`` (the
     real ``MeshTimer``, depths (1, 2) — the ``pallas`` path keeps depth
     1 — and ``max_measurements=4``): the winner, each timed
     candidate's measured ms a step beside the model's, the fitted
     alpha and beta and the measurements; ``run(4)`` on it bitwise the
     same run with the winner named, with equal launches (K3 16, B4 12
     when ``PallasDMA`` wins); a second ``realize()`` on the same cache
     a hit with 0 measurements. A ``halo`` (1,2,2) campaign with one
     NaN, ``attribute_perf`` and a flight-recorder directory: the
     error-ratio gauge finite and positive, the dump valid
     (``validate_dump``). ``MetricsServer`` on port 0 read once at
     ``/metrics``; ``bench_exchange --autotune --tune-cache
     --metrics-json --ledger --json-out`` into a temporary directory,
     its ledger records valid.
   - Ensemble serving (``run_serving``, ``serving/``): ``EnsembleJacobi``
     width 8 at 256^3 float32 on (1,1,1) and on four shards of (1,2,2):
     members 0 and 5 bitwise ``Jacobi3D(kernel="xla")`` runs of the same
     initial fields, members 6 and 7 (other hot/cold) bitwise one-member
     ensembles; with a plan naming ``PallasDMA`` (a temporary plan
     cache) on (1,2,2), B4's launches per ``run(4)`` (counts set to 0
     just before) 12 at width 8 as at width 1, its launch tables' bytes
     exactly 8x, the slab engine's messages equal and its wire bytes
     exactly 8x, every member bitwise the width-8 ensemble of the plain
     slab exchange (``Default``) on the same initial fields and member 0
     bitwise the width-1 run; the three B4 sweeps of 8 members and of
     one (CUDA events); member-steps/s at width 1 and 8 on (1,1,1) and
     on the (1,2,2) ``PallasDMA`` ensembles (events, three runs pooled). ``EnsembleAstaroth`` width 4 at 128^3, member 2 on
     other ``nu_visc``/``eta``: members 0 and 2 bitwise the standalone
     ``Astaroth(kernel="xla")`` with their coefficients. A
     ``CampaignService`` on (1,2,2) with a ``MeshTimer``: three tenants
     at 256^3 and a warm second wave (the adopted plan; 0 recompiles and
     0 measurements from ``metrics_text()``), a NaN in one lane rolled
     back alone (every lane bitwise a clean service), a preemption and
     its resume (bitwise); with ``attribute_perf`` off, on, on, off,
     each service warmed by a short wave, the time a segment takes in a
     longer wave, from the service's own ``segment`` spans. A ``Fleet`` of three replicas on the card at 128^3
     (buckets 64^3 and 128^3, one grid padded up), four tenants, the
     replica owning t0 killed at step 2: every campaign bitwise the calm
     fleet's.
   - Analysis (``run_analysis``, ``stencil_tpu_torch.analysis``): every
     registered target, the ``cuda.`` group on the card (K3, B8 in
     float32 and bfloat16, B5, B6 and B11 under the footprint probe;
     every library's registers and spills; occupancy at the planned
     launches; donation and transfer on the wrap, pallas + PallasDMA
     and certified overlap paths); one line a checker, no error, no
     card target skipped, every kernel of ``ANALYSIS_KERNELS``
     launched. The segments step above holds the ``overlap`` segment,
     built on B7's replay-safe schedule certificate, bitwise its
     stepwise run with equal launches.
5. timing: steps/s of the Jacobi wrap, pallas and xla paths at 512^3,
   of the halo path at 512^3 on (1,1,1) and on (1,2,2) on the one card
   (every Jacobi rate three runs pooled), K2 and B6 at 512^3 and B6 on
   a quarter shard, with the ring kernel's launch plans there (tile, z
   run, blocks, and waves at the blocks an SM that the card reports;
   logged and in chip_smoke.json),
   and the halo path's slab exchange per group; steps/s of ``wrap`` and
   ``halo`` ((1,1,1) and four shards) at ``exchange_every`` 1-4, and K2
   and B6 (512^3 and a quarter shard) at N = 3 and 4 beside their twins
   and bounds (the kernels line's ``temporal`` entries of K2 and B6,
   with phase 4's launches at s = N); iterations/s of the
   Astaroth wrap, wrap+pair and xla paths at 256^3, and of the Astaroth
   halo and halo+pair paths at 256 x 512 x 512 on (1,2,2) and halo at
   256^3 on (1,1,1), with one slab round of that mesh at radius 3 and 6
   (host clock around run(k), ending in a synchronize; for the Jacobi
   halo and overlap paths and every Astaroth path three such runs, all
   iterations over all their time, every run beside it); B11
   and B12 on one 256^3 shard of the (1,2,2) mesh, B11 per variant
   beside B9 and B13 on the same shard in turns (B9, B11, B13, B13, B11,
   B9), B10 and B12 by device time alone (``device_ms``, below) beside
   B9 and B11 s=0 and s=1 on that shard, and per kernel they launch;
   ``overlap``
   steps/s at 512^3
   on (1,2,2) and (1,1,1), B4 per sweep of the (1,2,2) mesh beside the
   same sweep by ``copy_`` (its library call), an 8-field z sweep of
   four 256^3 shards beside 8 ``copy_`` sweeps, a whole ``PallasDMA``
   exchange of each beside the slab copy, B7 per step of the four quarter
   shards and of one 512^3 shard, and one ``measure_overlap`` line;
   iterations/s of Astaroth ``halo-overlap`` (and with the pair) at 256 x
   512 x 512 on (1,2,2) and at 256^3 on (1,1,1), ``halo-overlap``+pair
   over ``halo``+pair on the four shards, B13 and B14 per variant (the
   pair among them) on one 256^3 shard and per substep of the four
   shards of (1,2,2), those of B13 and B14 summed over an iteration's
   three substeps beside the ``halo-overlap`` iteration on the four
   shards, B13's and B14's device time alone (their launches queued
   behind a sleeping kernel, so that the CUDA events see no host time:
   ``device_ms``) and per kernel they launch
   (``utils.timers.kernel_profile``, torch.profiler), B14's blocks an SM as
   the card counts them (in the kernels line) against those of its
   launch plan on a 256^3 shard (``fixup_plan``, in the log and in
   chip_smoke.json as ``fixup_plan_256``), which must agree, and one
   ``measure_overlap --model mhd`` line at 256^3 per shard; each
   kernel's, twin's and library call's ms (CUDA events over repeated
   launches after a warm-up); and each kernel's bound: the larger of
   bytes / 3.35 TB/s and flops / 67 TFLOP/s (H100 SXM data sheet,
   float32 without tensor cores); B8's device time alone, its launch
   plan at 256^3 (logged, and in chip_smoke.json as
   ``laplace6_plan_256``) and its blocks an SM as the card counts them
   (in the kernels line), which must equal the plan's. The library calls
   are
   ``torch.nn.functional.conv3d`` for K3 (3x3x3 weight) and B8 (7x7x7),
   with cuDNN's TF32 turned off so that they compute in float32; the
   MHD kernels have no single PyTorch call. bfloat16: iterations/s of
   ``wrap`` (± pair) at 256^3 and ``halo``, ``halo-overlap`` (± pair) on
   four 256^3 shards, beside the float32 rates of this run
   (``time_astaroth_bf16_paths``); B9-B14 in bf16 on one 256^3 shard by
   CUDA events (B13, B14 also by device time alone) beside their bf16
   twins, bounds counting 2-byte cells, and B9 and B11 float32 s=0 in
   the same process (``time_mhd_bf16_kernels``; the kernels line's
   ``... bf16`` entries). The bfloat16 Jacobi kernels at 512^3 (K2 and
   B6 also at N = 16, K3 beside conv3d in bf16, B7 per step of the four
   quarter shards) beside their twins, bounds counting 2-byte cells,
   and the bf16 ``wrap``, ``halo`` and ``overlap`` rates beside float32's
   (``time_jacobi_bf16``; the kernels line's ``jacobi7_... bf16``
   entries). B8 in bfloat16 at 256^3 by events and device time beside
   float32's device time, its twin and conv3d in bfloat16 (the kernels
   line's ``laplace6 bf16`` entry, bound counting 2-byte cells,
   ``time_laplace6_bf16``). Results also go to
   chiprun_out/chip_smoke.json.

The last three lines are the card's name and power limit (nvidia-smi),
the ``kernels`` JSON object, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import faulthandler
import io
import json
import os
import shutil
import subprocess
import sys
import time

HBM_BYTES_PER_S = 3.35e12    # H100 SXM data sheet
F32_FLOPS_PER_S = 67e12      # H100 SXM data sheet, non-tensor float32
N512 = 512
N256 = 256
SMALL_SHAPES = [(5, 8, 7), (9, 16, 13), (3, 8, 33)]   # (Z, Y, X)
# K2's ring kernel: x a multiple of 4, y not a multiple of its 32-row
# tile; z runs, the last one shorter
RING_SHAPES = [(6, 16, 20), (23, 72, 132), (131, 64, 128)]
MHD_SHAPES = [(8, 8, 8), (16, 8, 24), (8, 16, 40)]    # (Z, Y, X)
MHD_DTS = (1e-8, 1e-4)
MHD_PATH_DT = 1e-4    # phase 4: large enough that the rates show in f32
# flops per output point, counted from the sources (each expf as one):
# csrc/mhd.cu B9: the 8 fields' derivatives 676, the rates 242, the
# update 24 without a w read (s=0) and 40 with one; B10: one of each;
# csrc/laplace6.cu: 34
B9_FLOPS = {0: 676 + 242 + 24, 1: 676 + 242 + 40, 2: 676 + 242 + 40}
B10_FLOPS = B9_FLOPS[0] + B9_FLOPS[1]
LAPLACE6_FLOPS = 34
#: the device every shard of the one-card meshes lies on
CARD = "cuda:0"


_T0 = time.perf_counter()


def log(msg: str) -> None:
    """One line of the run's log; a phase's first line also gives the
    seconds since the script started."""
    if msg.startswith("phase "):
        msg = f"[{time.perf_counter() - _T0:.1f} s] {msg}"
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def spheres(shape_zyx, widen: int = 0):
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.jacobi import sphere_geometry

    Z, Y, X = shape_zyx
    hot, cold, r = sphere_geometry(Dim3(X, Y, Z))
    return tuple(hot), tuple(cold), r + widen


def asym_radius():
    from stencil_tpu_torch.geometry import Radius

    r = Radius.constant(1)
    r.set_dir((1, 0, 0), 2)
    r.set_dir((0, 0, -1), 3)
    return r


def compare_kernels(torch, cs) -> dict:
    """Phase 3: every kernel against its twin; returns the largest
    absolute difference per kernel (must be 0)."""
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.local_domain import raw_size, zyx_shape

    gen = torch.Generator(device="cuda").manual_seed(1234)
    worst = {"jacobi7_wrap": 0.0, "jacobi7_wrapn": 0.0,
             "jacobi7_padded": 0.0}

    def check(name, got, want, what):
        assert got.shape == want.shape, (what, got.shape, want.shape)
        err = float((got - want).abs().max())
        same = bool(torch.equal(got, want))
        log(f"  {what}: max |kernel - twin| = {err!r} "
            f"({'bitwise equal' if same else 'DIFFERENT'})")
        if not same or not torch.isfinite(got).all():
            raise AssertionError(f"{what}: kernel disagrees with its twin")
        worst[name] = max(worst[name], err)

    for shape in SMALL_SHAPES + RING_SHAPES + [(N512,) * 3]:
        t = torch.rand(shape, generator=gen, device="cuda")
        hot, cold, r = spheres(shape, widen=0 if shape[0] == N512 else 2)
        check("jacobi7_wrap", cs.jacobi7_wrap_cuda(t, hot, cold, r),
              cs.jacobi7_wrap_plain(t, hot, cold, r), f"K1 {shape}")
        for n in (1, 2, 3) + ((8,) if shape in RING_SHAPES else
                              (4,) if shape[0] == N512 else ()):
            check("jacobi7_wrapn",
                  cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=n),
                  cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=n),
                  f"K2 N={n} {shape}")
        del t
    for shape in SMALL_SHAPES + [(N512,) * 3]:
        radii = [("r=1", Radius.constant(1))]
        if shape[0] != N512:
            radii.append(("asymmetric r", asym_radius()))
        for label, rad in radii:
            interior = Dim3(shape[2], shape[1], shape[0])
            p = torch.randn(zyx_shape(raw_size(interior, rad)),
                            generator=gen, device="cuda")
            check("jacobi7_padded", cs.jacobi7_padded_cuda(p, rad, interior),
                  cs.jacobi7_padded_plain(p, rad, interior),
                  f"K3 {label} {shape}")
            del p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def run_main_path(torch, cs) -> dict:
    """Phase 4: the solver at 512^3 through the user's entry points."""
    import numpy as np

    from stencil_tpu_torch.models.jacobi import (Jacobi3D,
                                                 dense_reference_step)

    eps = float(np.finfo(np.float32).eps)
    out = {}

    def solver(kernel, n=N512):
        j = Jacobi3D(n, n, n, dtype=torch.float32, kernel=kernel,
                     device="cuda")
        j.init()
        j.block()
        return j

    def diff(a, b):
        return float((a.dd.interior("temp") - b.dd.interior("temp"))
                     .abs().max())

    # small input against the dense numpy oracle
    small = solver("auto", 16)
    small.run(3)
    want = np.full((16, 16, 16), 0.5, dtype=np.float32)
    hot, cold, r = spheres((16, 16, 16))
    for _ in range(3):
        want = dense_reference_step(want, hot, cold, r)
    got = small.temperature()
    err = float(np.abs(got - want).max())
    log(f"  16^3 wrap run(3) vs dense numpy oracle: max diff {err!r} "
        f"(tolerance {3 * 4 * eps!r})")
    if not (np.isfinite(got).all() and err <= 3 * 4 * eps):
        raise AssertionError("16^3 wrap path disagrees with the oracle")
    del small

    j = solver("auto")
    if j.kernel_path != "wrap":
        raise AssertionError(f"auto picked {j.kernel_path!r}, not 'wrap'")
    cs.reset_launch_counts()
    j.run(21)
    j.block()
    wrap_counts = dict(cs.LAUNCHES)
    log(f"  wrap run(21) launches: {wrap_counts}")
    if wrap_counts != {"jacobi7_wrap": 1, "jacobi7_wrapn": 10,
                       "jacobi7_padded": 0, "laplace6": 0}:
        raise AssertionError("wrap path did not launch K2 x10 + K1 x1")
    ref = solver("xla")
    ref.run(21)
    ref.block()
    t = j.dd.interior("temp")
    if tuple(t.shape) != (N512,) * 3 or not bool(torch.isfinite(t).all()):
        raise AssertionError("wrap path produced a wrong shape or "
                             "non-finite values")
    err, tol = diff(j, ref), 21 * 8 * eps
    log(f"  wrap vs xla after 21 steps: max diff {err!r} (tolerance "
        f"{tol!r})")
    if err > tol:
        raise AssertionError("wrap path disagrees with the xla path")
    out["wrap_vs_xla_max_diff"] = err
    del j, ref
    torch.cuda.empty_cache()

    p = solver("pallas")
    cs.reset_launch_counts()
    p.run(4)
    p.block()
    pallas_counts = dict(cs.LAUNCHES)
    log(f"  pallas run(4) launches: {pallas_counts}")
    if pallas_counts != {"jacobi7_wrap": 0, "jacobi7_wrapn": 0,
                         "jacobi7_padded": 4, "laplace6": 0}:
        raise AssertionError("pallas path did not launch K3 x4")
    ref = solver("xla")
    ref.run(4)
    ref.block()
    err, tol = diff(p, ref), 4 * 8 * eps
    log(f"  pallas vs xla after 4 steps: max diff {err!r} (tolerance "
        f"{tol!r})")
    if err > tol or not bool(torch.isfinite(p.dd.interior("temp")).all()):
        raise AssertionError("pallas path disagrees with the xla path")
    out["pallas_vs_xla_max_diff"] = err
    del p, ref
    torch.cuda.empty_cache()
    out["launches"] = {"jacobi7_wrap": wrap_counts["jacobi7_wrap"],
                       "jacobi7_wrapn": wrap_counts["jacobi7_wrapn"],
                       "jacobi7_padded": pallas_counts["jacobi7_padded"],
                       "laplace6": wrap_counts["laplace6"]
                       + pallas_counts["laplace6"]}
    return out


def steps_per_s(torch, kernel: str, k: int):
    """Steps per second of the Jacobi path ``kernel`` at 512^3: three
    ``run(k)`` pooled, each run's rate beside it (``timed_runs``)."""
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    j = Jacobi3D(N512, N512, N512, kernel=kernel, device="cuda")
    j.init()
    j.run(2)
    j.block()
    got = timed_runs(j, k)
    del j
    torch.cuda.empty_cache()
    return got


def device_ms(torch, fn, reps: int, warmup: int = 2,
              cycles: int = 60_000_000, tries: int = 3) -> float:
    """ms of the device work of one ``fn()``, without the host's: the
    ``reps`` calls are queued behind a kernel that sleeps ``cycles``
    clocks, and the CUDA events around them are recorded after it, so
    the host has queued them all before the card starts them. Where the
    host took longer to queue them than the sleep lasted (a host stall),
    the measurement is taken again behind a sleep twice as long; raises
    if that happens ``tries`` times."""
    for _ in range(warmup):
        fn()
    for _ in range(tries):
        torch.cuda.synchronize()
        slept = torch.cuda.Event(enable_timing=True)
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        slept.record()
        torch.cuda._sleep(cycles)
        start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        host_ms = 1e3 * (time.perf_counter() - t0)
        stop.record()
        stop.synchronize()
        sleep_ms = slept.elapsed_time(start)
        if host_ms < sleep_ms:
            return start.elapsed_time(stop) / reps
        log(f"  device_ms: queuing took {host_ms!r} ms, longer than the "
            f"{sleep_ms!r} ms sleep; again behind a sleep twice as long")
        cycles *= 2
    raise AssertionError(f"device_ms: queuing outlasted the sleep {tries} "
                         f"times (last {host_ms!r} ms against {sleep_ms!r} "
                         f"ms)")


def event_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    stop.synchronize()
    return start.elapsed_time(stop) / reps


def bound_ms(nbytes: float, flops: float):
    b = nbytes / HBM_BYTES_PER_S * 1e3
    f = flops / F32_FLOPS_PER_S * 1e3
    return (b, "bytes") if b >= f else (f, "operations")


def b13_bytes(shape, read_w: bool, write_w: bool, pair: bool,
              item: int = 4) -> float:
    """Bytes B13 must move on one (Z, Y, X) shard: the shard read once,
    w read (where it is read) and f and w written at its interior
    (``interior_region``), and the slab rows it sends, hr =
    ``halo_rows`` of them (3, or 6 with the pair)."""
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo

    Z, Y, X = shape
    hr = mo.halo_rows(pair)
    inner = mo.interior_region(Z, Y, pair)
    p_in = inner[1] * inner[3] * X if inner else 0
    slab = 8 * (2 * hr * Y * X + 2 * (Z + 2 * hr) * hr * X)
    wr = (8 if read_w else 0) + (8 if write_w else 0)
    return float(item) * (8 * Z * Y * X + (8 + wr) * p_in + slab)


def b14_bytes(shape, read_w: bool, write_w: bool, pair: bool,
              item: int = 4) -> float:
    """Bytes B14 must move on one (Z, Y, X) shard: the shard rows within
    e + hr of a z or y face (the rows its shell's points read), every
    landed row, w at the shell where it is read, and f (and w) written
    at the shell (e = ``shell_width``, hr = ``halo_rows``: 3 and 3, or 8
    and 6 with the pair)."""
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo

    Z, Y, X = shape
    e, hr = mo.shell_width(pair), mo.halo_rows(pair)
    inner = mo.interior_region(Z, Y, pair)
    shell = Z * Y * X - (inner[1] * inner[3] * X if inner else 0)
    near = Z * Y * X - max(Z - 2 * (e + hr), 0) * max(Y - 2 * (e + hr), 0) * X
    slab = 8 * (2 * hr * Y * X + 2 * (Z + 2 * hr) * hr * X)
    wr = (8 if read_w else 0) + (8 if write_w else 0)
    return float(item) * (8 * near + (8 + wr) * shell + slab)


def halo_bytes(shape, r: int, z_extended: bool, itemsize: int = 4) -> float:
    """Bytes B5 (r = 1) or B6 (r = N) must move on a (Z, Y, X) shard of
    ``itemsize``-byte cells: the shard read once and written once, and of
    the slabs only the rows the kernel reads: r rows of each z slab, and
    r columns of each y slab over its Zs rows (Z + 2r when it is
    z-extended)."""
    Z, Y, X = shape
    zs = Z + 2 * r if z_extended else Z
    return itemsize * (2.0 * Z * Y * X + 2 * r * Y * X + 2 * zs * r * X)


def ring_plan(torch, cs, shape, steps: int) -> dict:
    """The launch plan of the Jacobi ring kernel (K2, B6) for a (Z, Y, X)
    shape on this card: the planner's tile, depth, z run and blocks an
    SM, the blocks of the launch, and its waves at the blocks an SM that
    the card reports (``ring_occupancy``). A NOTE where the two counts
    differ."""
    Z, Y, X = shape
    dev = torch.device("cuda")
    n_sms = cs.sm_count(dev)
    p = cs.jacobi_ring_plan(Z, Y, X, steps, n_sms)
    card_bps = cs.ring_occupancy(dev, steps, p.ty, p.depth)
    if card_bps != p.blocks_per_sm:
        log(f"  NOTE: the ring planner counts {p.blocks_per_sm} blocks an "
            f"SM at N = {steps}, the card {card_bps}")
    blocks = -(-X // cs.RING_TILE_X) * -(-Y // p.ty) * -(-Z // p.zrun)
    return dict(p._asdict(), card_blocks_per_sm=card_bps, blocks=blocks,
                sms=n_sms, waves=blocks / (n_sms * card_bps))


def time_kernels(torch, cs) -> dict:
    """Phase 5b: each kernel and twin at the main path's shapes."""
    from stencil_tpu_torch.geometry import Dim3, Radius

    n = N512
    pts = float(n ** 3)
    hot, cold, r = spheres((n, n, n))
    a = torch.rand((n, n, n), device="cuda")
    b = torch.empty_like(a)
    rad = Radius.constant(1)
    interior = Dim3(n, n, n)
    pad = torch.rand((n + 2,) * 3, device="cuda")
    res = {}
    cases = {
        "jacobi7_wrap": (
            lambda: cs.jacobi7_wrap_cuda(a, hot, cold, r, out=b),
            lambda: cs.jacobi7_wrap_plain(a, hot, cold, r),
            2 * pts * 4, 7 * pts),
        "jacobi7_wrapn": (
            lambda: cs.jacobi7_wrapn_cuda(a, hot, cold, r, steps=2, out=b),
            lambda: cs.jacobi7_wrapn_plain(a, hot, cold, r, steps=2),
            2 * pts * 4, 2 * 7 * pts),
        "jacobi7_padded": (
            lambda: cs.jacobi7_padded_cuda(pad, rad, interior, out=b),
            lambda: cs.jacobi7_padded_plain(pad, rad, interior),
            (float(n + 2) ** 3 + pts) * 4, 7 * pts),
    }
    for name, (kern, plain, nbytes, flops) in cases.items():
        ms = event_ms(torch, kern, reps=20)
        plain_ms = event_ms(torch, plain, reps=3, warmup=1)
        bms, by = bound_ms(nbytes, flops)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None}
        log(f"  {name}: {ms!r} ms/launch, bound {bms!r} ms ({by}), "
            f"{100 * bms / ms:.1f}% of bound; plain twin {plain_ms!r} ms")
    # K3's function as one library call: conv3d of the padded field with
    # 1/6 at the six face neighbours
    weight = torch.zeros((1, 1, 3, 3, 3), device="cuda")
    for k, j, i in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                    (1, 1, 2)):
        weight[0, 0, k, j, i] = 1.0 / 6.0
    res["jacobi7_padded"]["library_ms"] = library_ms(
        torch, pad, weight, cs.jacobi7_padded_cuda(pad, rad, interior, out=b),
        "jacobi7_padded")
    del a, b, pad
    torch.cuda.empty_cache()
    return res


def library_ms(torch, padded, weight, want, what: str) -> float:
    """ms of one ``F.conv3d`` of the padded field with ``weight`` (no
    padding, float32: cuDNN's TF32 is off), the kernel's function as one
    library call; first checks that it agrees with the kernel's output
    ``want`` (to 1e-4 of its largest value: conv3d adds its products in
    its own order)."""
    import torch.nn.functional as F

    x = padded[None, None]
    got = F.conv3d(x, weight)[0, 0]
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"  {what}: max |conv3d - kernel| = {err!r} ({err / scale:.2e} "
        f"of max |kernel|)")
    if not err <= 1e-4 * scale:
        raise AssertionError(f"{what}: conv3d does not compute the "
                             f"kernel's function")
    del got
    return event_ms(torch, lambda: F.conv3d(x, weight), reps=5)

# ---------------------------------------------------------------------------
# the halo path: B5, B6 and Jacobi3D(kernel="halo") on meshes of shards
# ---------------------------------------------------------------------------
def halo_case(torch, gen, size_xyz, mesh, slab_kw, widen: int = 0,
              dtype=None):
    """Random capacity-sized shards of a ``size_xyz`` grid over ``mesh``
    on the card (float32, or rounded once to ``dtype``), their slabs
    (``exchange_interior_slabs(**slab_kw)``), and per shard its global
    origin (z, y, x) and live extents (z, y). Returns (shards, slabs,
    origins, lens, spheres, global (z, y, x))."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.parallel.exchange import (exchange_interior_slabs,
                                                     shard_interior_len,
                                                     shard_origin)
    from stencil_tpu_torch.parallel.mesh import mesh_index

    size = Dim3(*size_xyz)
    counts = Dim3(*mesh)
    cap = Dim3(*(-(-size[a] // counts[a]) for a in range(3)))
    rem = Dim3(*(size[a] % counts[a] for a in range(3)))
    shards = [torch.rand((cap.z, cap.y, cap.x), generator=gen, device="cuda")
              for _ in range(counts.flatten())]
    if dtype is not None:
        shards = [t.to(dtype) for t in shards]
    kw = dict(slab_kw)
    if not kw.get("y_z_extended"):
        kw["rem"] = rem
    slabs = exchange_interior_slabs(shards, counts, **kw)
    origins, lens = [], []
    for i in range(len(shards)):
        idx = mesh_index(i, counts)
        ox, oy, oz = shard_origin(cap, rem, idx)
        origins.append((oz, oy, ox))
        lens.append((shard_interior_len(2, cap.z, rem, idx.z),
                     shard_interior_len(1, cap.y, rem, idx.y)))
    return (shards, slabs, origins, lens,
            spheres((size.z, size.y, size.x), widen), (size.z, size.y, size.x))


def compare_halo_kernels(torch, ch) -> dict:
    """Phase 3, the halo kernels against their twins; returns the largest
    absolute difference per kernel (must be 0)."""
    gen = torch.Generator(device="cuda").manual_seed(2468)
    worst = {"jacobi7_halo": 0.0, "jacobi7_halon": 0.0}

    def check(name, got, want, what, live=None):
        g, w = (got, want) if live is None else (
            got[:live[0], :live[1]], want[:live[0], :live[1]])
        err = float((g - w).abs().max())
        same = bool(torch.equal(g, w))
        every = "" if live is None else (
            f"; every cell incl. dead: "
            f"{'equal' if torch.equal(got, want) else 'different'}")
        log(f"  {what}: max |kernel - twin| = {err!r} "
            f"({'bitwise equal' if same else 'DIFFERENT'}{every})")
        if not same or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what}: kernel disagrees with its twin")
        worst[name] = max(worst[name], err)

    n = N512
    # the halo path's own slabs (rz = ry = 1) at 512^3, and JAX-shaped
    # ones (rz > 1, or y slabs a sublane tile wide) at small odd shapes
    b5 = [((n, n, n), (1, 1, 1), dict(rz=1, ry=1), 0),
          ((n, 511, 509), (1, 2, 2), dict(rz=1, ry=1), 0),
          ((33, 13, 9), (1, 1, 1), dict(rz=3, ry=8, radius_rows=1), 2),
          ((33, 16, 9), (1, 2, 2), dict(rz=1, ry=8), 2),
          ((33, 17, 9), (1, 2, 2), dict(rz=1, ry=1), 2)]
    for size, mesh, kw, widen in b5:
        shards, slabs, orgs, lens, (hot, cold, r), _ = halo_case(
            torch, gen, size, mesh, kw, widen)
        for i, t in enumerate(shards):
            check("jacobi7_halo",
                  ch.jacobi7_halo_cuda(t, slabs[i], orgs[i], hot, cold, r,
                                       interior_len_zy=lens[i]),
                  ch.jacobi7_halo_plain(t, slabs[i], orgs[i], hot, cold, r,
                                        lens[i]),
                  f"B5 {size} mesh {mesh} shard {i} slabs {kw}",
                  live=lens[i])
        del shards, slabs
    # (size, mesh, steps, rz, ry, widen): the path's own rz = ry = N
    # slabs at 512^3, JAX's rz = block_z, ry = 8 at small shapes
    b6 = [((n, n, n), (1, 1, 1), 2, 2, 2, 0),
          ((n, n, n), (1, 2, 2), 2, 2, 2, 0),
          ((n, n, n), (1, 2, 2), 3, 3, 3, 0),
          ((n, n, n), (1, 2, 2), 4, 4, 4, 0),
          ((n, n, n), (1, 1, 1), 3, 3, 3, 0),
          ((n, n, n), (1, 1, 1), 4, 4, 4, 0),
          ((33, 16, 10), (1, 2, 2), 2, 4, 8, 2),
          ((33, 16, 10), (1, 1, 2), 3, 5, 8, 2),
          ((20, 48, 64), (1, 2, 4), 2, 2, 2, 2),
          ((13, 40, 48), (1, 2, 4), 3, 8, 8, 2),
          ((128, 128, 262), (1, 2, 2), 2, 2, 2, 0)]
    for size, mesh, steps, rz, ry, widen in b6:
        kw = dict(rz=rz, ry=ry, radius_rows=steps, y_z_extended=True)
        shards, slabs, orgs, _, (hot, cold, r), gsize = halo_case(
            torch, gen, size, mesh, kw, widen)
        for i, t in enumerate(shards):
            check("jacobi7_halon",
                  ch.jacobi7_halon_cuda(t, slabs[i], orgs[i], gsize, hot,
                                        cold, r, steps=steps),
                  ch.jacobi7_halon_plain(t, slabs[i], orgs[i], gsize, hot,
                                         cold, r, steps=steps),
                  f"B6 N={steps} {size} mesh {mesh} shard {i} rz={rz} "
                  f"ry={ry}")
        del shards, slabs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def gather(torch, j):
    """A solver's global interior as one tensor on the card."""
    dd = j.dd
    out = torch.empty((dd.size.z, dd.size.y, dd.size.x), device=CARD)
    for i in range(dd.num_subdomains()):
        o, s = dd.shard_origin(i), dd.shard_size(i)
        out[o.z:o.z + s.z, o.y:o.y + s.y, o.x:o.x + s.x] = \
            dd.interior("temp", i)
    return out


def jacobi_mesh(kernel, mesh=(1, 1, 1), size=(N512, N512, N512), **kw):
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    j = Jacobi3D(*size, kernel=kernel, mesh_shape=mesh,
                 devices=[CARD] * (mesh[0] * mesh[1] * mesh[2]), **kw)
    j.init()
    j.block()
    return j


def run_halo_path(torch, cs, ch) -> dict:
    """Phase 4, the halo path: bitwise against ``wrap`` at 512^3 on
    (1,1,1) and on four shards of one card, and the uneven grid against
    ``xla`` on its mesh; launch counts from the counters."""
    import numpy as np

    eps = float(np.finfo(np.float32).eps)
    steps = 21
    out = {"launches_by_run": {}}
    ref = jacobi_mesh("wrap")
    ref.run(steps)
    want = gather(torch, ref)
    del ref
    runs = (("512^3 (1,1,1)", "halo", (1, 1, 1),
             {"jacobi7_halo": 1, "jacobi7_halon": 10}),
            ("512^3 (1,2,2) on one card", "auto", (1, 2, 2),
             {"jacobi7_halo": 4, "jacobi7_halon": 40}))
    for label, kernel, mesh, want_counts in runs:
        j = jacobi_mesh(kernel, mesh)
        if j.kernel_path != "halo":
            raise AssertionError(f"{label}: kernel={kernel!r} took "
                                 f"{j.kernel_path!r}, not 'halo'")
        ch.reset_launch_counts()
        cs.reset_launch_counts()
        j.run(steps)
        j.block()
        counts = dict(ch.LAUNCHES)
        log(f"  halo {label} run({steps}) launches: {counts}, K1-K3 "
            f"{dict(cs.LAUNCHES)}")
        if counts != want_counts or any(cs.LAUNCHES.values()):
            raise AssertionError(f"halo {label} launched {counts}, not "
                                 f"{want_counts}")
        got = gather(torch, j)
        err = float((got - want).abs().max())
        same = bool(torch.equal(got, want))
        log(f"  halo {label} vs wrap after {steps} steps: max diff {err!r} "
            f"({'bitwise equal' if same else 'DIFFERENT'})")
        if not same or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"halo {label} is not bitwise the wrap path")
        out["launches_by_run"][label] = counts
        out[f"halo_vs_wrap_max_diff {label}"] = err
        del j, got
        torch.cuda.empty_cache()
    del want
    size = (N512, 511, 509)
    h = jacobi_mesh("halo", (1, 2, 2), size)
    ch.reset_launch_counts()
    h.run(steps)
    h.block()
    counts = dict(ch.LAUNCHES)
    log(f"  halo {size} (1,2,2) run({steps}) launches: {counts}")
    if counts != {"jacobi7_halo": 4 * steps, "jacobi7_halon": 0}:
        raise AssertionError(f"uneven halo launched {counts}")
    x = jacobi_mesh("xla", (1, 2, 2), size)
    x.run(steps)
    got, ref = gather(torch, h), gather(torch, x)
    err, tol = float((got - ref).abs().max()), steps * 8 * eps
    log(f"  halo vs xla {size} (1,2,2) after {steps} steps: max diff "
        f"{err!r} (tolerance {tol!r})")
    if err > tol or not bool(torch.isfinite(got).all()):
        raise AssertionError("uneven halo path disagrees with the xla path")
    out["uneven_halo_vs_xla_max_diff"] = err
    out["launches_by_run"][f"{size} (1,2,2)"] = counts
    # the slice's main path: four shards on the card
    out["launches"] = dict(out["launches_by_run"]["512^3 (1,2,2) on one card"])
    del h, x, got, ref
    torch.cuda.empty_cache()
    return out


def time_halo(torch, cs, ch) -> dict:
    """Phase 5, the halo path: steps/s at 512^3 on (1,1,1) and (1,2,2),
    the slab exchange per group, and B5/B6 at 512^3 on one shard."""
    res = {"steps_per_s": {}, "slab_exchange_ms": {}}
    for label, mesh in (("(1,1,1)", (1, 1, 1)), ("(1,2,2)", (1, 2, 2))):
        j = jacobi_mesh("halo", mesh)
        j.run(2)
        j.block()
        res["steps_per_s"][label], runs = timed_runs(j, 40)
        res.setdefault("runs_steps_per_s", {})[label] = runs
        res["slab_exchange_ms"][label] = 1e3 * j.slab_exchange_seconds(10)
        log(f"  Jacobi halo {label}: {res['steps_per_s'][label]!r} steps/s "
            f"over three runs ({runs}); slab exchange "
            f"{res['slab_exchange_ms'][label]!r} ms per {j._halo_n}-step "
            f"group")
        del j
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(1357)
    n = N512
    pts = float(n ** 3)
    kernels = {}
    # the slabs of the halo path: one row (B5) or N = 2 rows (B6) wide
    for name, kw, steps in (("jacobi7_halo", dict(rz=1, ry=1), 1),
                            ("jacobi7_halon", dict(rz=2, ry=2, radius_rows=2,
                                                   y_z_extended=True), 2)):
        (a,), (sl,), (org,), (lens,), (hot, cold, r), gsize = halo_case(
            torch, gen, (n, n, n), (1, 1, 1), kw)
        b = torch.empty_like(a)
        if steps == 1:
            kern = lambda: ch.jacobi7_halo_cuda(a, sl, org, hot, cold, r,
                                                interior_len_zy=lens, out=b)
            plain = lambda: ch.jacobi7_halo_plain(a, sl, org, hot, cold, r,
                                                  lens)
        else:
            kern = lambda: ch.jacobi7_halon_cuda(a, sl, org, gsize, hot, cold,
                                                 r, steps=2, out=b)
            plain = lambda: ch.jacobi7_halon_plain(a, sl, org, gsize, hot,
                                                   cold, r, steps=2)
        ms = event_ms(torch, kern, reps=20)
        plain_ms = event_ms(torch, plain, reps=3, warmup=1)
        bms, by = bound_ms(halo_bytes(a.shape, steps,
                                      kw.get("y_z_extended", False)),
                           7 * steps * pts)
        kernels[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": None}
        log(f"  {name}: {ms!r} ms/launch, bound {bms!r} ms ({by}), "
            f"{100 * bms / ms:.1f}% of bound; plain twin {plain_ms!r} ms")
        del a, b, sl
        torch.cuda.empty_cache()
    # B6 on one shard of the (1,2,2) mesh, for the split of that path's
    # time
    (a,), (sl,), (org,), _, (hot, cold, r), gsize = halo_case(
        torch, gen, (n, n // 2, n // 2), (1, 1, 1),
        dict(rz=2, ry=2, radius_rows=2, y_z_extended=True))
    b = torch.empty_like(a)
    res["halon_quarter_shard_ms"] = event_ms(
        torch, lambda: ch.jacobi7_halon_cuda(a, sl, org, gsize, hot, cold, r,
                                             steps=2, out=b), reps=20)
    Z, Y, X = a.shape
    res["halon_quarter_shard_bound_ms"] = bound_ms(
        halo_bytes(a.shape, 2, True), 7 * 2 * float(Z * Y * X))[0]
    log(f"  jacobi7_halon on a 512 x 256 x 256 shard: "
        f"{res['halon_quarter_shard_ms']!r} ms/launch, bound "
        f"{res['halon_quarter_shard_bound_ms']!r} ms")
    # the ring kernel's launch plans of these cases (K2 at 512^3 has
    # B6's): kept in chip_smoke.json, not in the kernels line
    res["jacobi_ring_plans"] = {
        f"{label} N = 2": ring_plan(torch, cs, shape, 2)
        for label, shape in (("512^3", (n, n, n)),
                             ("512 x 256 x 256 shard", (Z, Y, X)))}
    for label, plan in res["jacobi_ring_plans"].items():
        log(f"  Jacobi ring kernel plan, {label}: {plan}")
    del a, b, sl
    torch.cuda.empty_cache()
    res["kernels"] = kernels
    return res


# ---------------------------------------------------------------------------
# temporal blocking: Jacobi3D(exchange_every=s) and the exchange apps
# ---------------------------------------------------------------------------
#: the depths phase 4 drives (1: single steps; 3 and 4: depths no earlier
#: path launched) and the steps of each run, a multiple of all of them
TEMPORAL_DEPTHS = (1, 3, 4)
TEMPORAL_STEPS = 12


def temporal_counts(s: int, grouped: bool, shards: int, n1: str, nn: str):
    """The launches ``run(TEMPORAL_STEPS)`` must make: ``steps / s``
    N-step launches a shard where the path groups steps, else one
    single-step launch a shard and step."""
    steps = TEMPORAL_STEPS
    if grouped:
        return {n1: 0, nn: shards * steps // s}
    return {n1: shards * steps, nn: 0}


def run_temporal_paths(torch, cs, ch) -> dict:
    """Phase 4, temporal blocking: ``Jacobi3D(exchange_every=s)`` on
    ``wrap`` at 512^3 (K2 at N = s) and ``halo`` on four 512 x 256 x 256
    shards of the card (B6 at N = s where ``pair_halo_refusal`` allows
    it), each against the other and against ``xla``; ``xla-temporal`` on
    four 128^3 shards against stepwise ``xla``, bitwise."""
    import numpy as np

    from stencil_tpu_torch.ops.halo_plan import pair_halo_refusal

    eps = float(np.finfo(np.float32).eps)
    steps = TEMPORAL_STEPS
    tol = steps * 8 * eps
    out = {"launches_by_run": {}, "max_diff": {}}
    x = jacobi_mesh("xla")
    x.run(steps)
    want = gather(torch, x)
    del x
    torch.cuda.empty_cache()

    def counted(j, label, expect):
        cs.reset_launch_counts()
        ch.reset_launch_counts()
        j.run(steps)
        j.block()
        counts = {k: v for k, v in list(cs.LAUNCHES.items())
                  + list(ch.LAUNCHES.items()) if v}
        log(f"  {label} run({steps}) launches: {counts}")
        if counts != {k: v for k, v in expect.items() if v}:
            raise AssertionError(f"{label} launched {counts}, not {expect}")
        out["launches_by_run"][label] = counts
        got = gather(torch, j)
        if tuple(got.shape) != (N512,) * 3 or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"{label}: wrong shape or non-finite")
        return got

    def held(label, got, ref, what, bitwise):
        err = float((got - ref).abs().max())
        same = bool(torch.equal(got, ref))
        log(f"  {label} vs {what}: max diff {err!r} ("
            f"{'bitwise equal' if same else 'different'}; required "
            f"{'bitwise' if bitwise else f'<= {tol!r}'})")
        if (bitwise and not same) or err > tol:
            raise AssertionError(f"{label} disagrees with {what}")
        out["max_diff"][f"{label} vs {what}"] = err

    for s in TEMPORAL_DEPTHS:
        w = jacobi_mesh("wrap", exchange_every=s)
        got_w = counted(w, f"wrap s={s}",
                        temporal_counts(s, w._pair_ok, 1, "jacobi7_wrap",
                                        "jacobi7_wrapn"))
        del w
        h = jacobi_mesh("halo", (1, 2, 2), exchange_every=s)
        why = (pair_halo_refusal(N512 // 2, N512 // 2, N512, 4, s)
               if s > 1 else "N = 1: single steps")
        log(f"  halo s={s} on four 512 x 256 x 256 shards: "
            f"{f'B6 at N = {s}' if h._halo_pair_ok else 'B5 every step'}"
            f" (pair_halo_refusal: {why})")
        got_h = counted(h, f"halo s={s} (1,2,2)",
                        temporal_counts(s, h._halo_pair_ok, 4,
                                        "jacobi7_halo", "jacobi7_halon"))
        del h
        held(f"halo s={s} (1,2,2)", got_h, got_w, f"wrap s={s}",
             bitwise=(s > 1) == bool(out["launches_by_run"]
                                     [f"halo s={s} (1,2,2)"]
                                     .get("jacobi7_halon")))
        held(f"wrap s={s}", got_w, want, "xla", bitwise=False)
        held(f"halo s={s} (1,2,2)", got_h, want, "xla", bitwise=False)
        del got_w, got_h
        torch.cuda.empty_cache()
    del want

    size, mesh, n = (128, 256, 256), (1, 2, 2), 9
    base = jacobi_mesh("xla", mesh, size)
    base.run(n)
    want = gather(torch, base)
    del base
    for s, overlap, path in ((4, False, "xla-temporal[s=4]"),
                             ({"z": 4}, False, "xla-temporal[s=1.1.4]"),
                             (4, True, "xla-temporal[s=4]-overlap")):
        t = jacobi_mesh("xla", mesh, size, exchange_every=s, overlap=overlap)
        if t.kernel_path != path:
            raise AssertionError(f"exchange_every={s} took "
                                 f"{t.kernel_path!r}, not {path!r}")
        t.run(n)
        got = gather(torch, t)
        same = bool(torch.equal(got, want))
        log(f"  {path} on four 128^3 shards, run({n}), vs stepwise xla: "
            f"{'bitwise equal' if same else 'DIFFERENT'}")
        if not same or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{path} is not bitwise stepwise xla")
        del t, got
    del want
    torch.cuda.empty_cache()
    out["launches"] = {
        "jacobi7_wrapn": out["launches_by_run"]["wrap s=3"]["jacobi7_wrapn"],
        "jacobi7_halon": out["launches_by_run"]["halo s=3 (1,2,2)"]
        .get("jacobi7_halon", 0)}
    return out


def run_exchange_apps(torch, cx) -> dict:
    """Phase 4, the exchange apps on the card, through their ``main()``:
    ``bench_exchange`` on four 256^3 shards at s = 1, 2, 4 and once with
    ``--pallas-dma`` (B4, counted), ``pingpong`` on two shards of the
    card and ``bench_pack`` at its default sizes. Their CSV lines are
    printed; each must carry finite, positive times."""
    from stencil_tpu_torch.apps import bench_exchange, bench_pack, pingpong

    os.makedirs("chiprun_out", exist_ok=True)
    cuda4 = ",".join(["cuda:0"] * 4)
    size = ["--x", "256", "--y", "256", "--z", "256"]
    runs = (("bench_exchange", bench_exchange.main,
             ["--devices", cuda4, *size, "--exchange-every", "1,2,4",
              "--ledger", "", "--json-out", os.path.join("chiprun_out",
                                         "bench_exchange_smoke.json")], 3),
            ("bench_exchange --pallas-dma", bench_exchange.main,
             ["--devices", cuda4, *size, "--pallas-dma"], 1),
            ("pingpong", pingpong.main, ["--devices", "cuda:0,cuda:0"], 16),
            ("bench_pack", bench_pack.main, ["--device", "cuda"], 4))
    out = {"lines": {}}
    for label, fn, argv, n_lines in runs:
        cx.reset_launch_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            fn(argv)
        lines = [ln for ln in buf.getvalue().splitlines() if "," in ln]
        for ln in lines:
            log(f"  {ln}")
        rows = [ln.split(",") for ln in lines
                if not ln.startswith("pingpong,bytes")]
        times = [float(r[-2]) for r in rows]
        if len(lines) != n_lines or not all(0 < t < 1e3 for t in times):
            raise AssertionError(f"{label}: {len(lines)} lines, times "
                                 f"{times}")
        if label.endswith("--pallas-dma"):
            b4 = cx.LAUNCHES["exchange_axis"]
            log(f"  {label}: {b4} B4 launches")
            if not b4:
                raise AssertionError(f"{label} launched no B4")
        out["lines"][label] = lines
    with open(os.path.join("chiprun_out", "bench_exchange_smoke.json")) as f:
        out["bench_exchange"] = json.load(f)
    return out


def time_temporal(torch, cs, ch) -> dict:
    """Phase 5, temporal blocking: steps/s of ``wrap`` and ``halo`` (one
    512^3 shard and four 512 x 256 x 256 shards of the card) at
    ``exchange_every`` 1-4 (three ``run(48)`` pooled), and K2 and B6 at N
    = 3 and 4 (512^3, and B6 on a quarter shard) beside their twins and
    bounds, with the ring kernel's launch plans."""
    res = {"steps_per_s": {}, "runs_steps_per_s": {}, "kernels": {},
           "jacobi_ring_plans": {}}
    for s in (1, 2, 3, 4):
        for label, kernel, mesh in (("wrap", "wrap", (1, 1, 1)),
                                    ("halo (1,1,1)", "halo", (1, 1, 1)),
                                    ("halo (1,2,2)", "halo", (1, 2, 2))):
            j = jacobi_mesh(kernel, mesh, exchange_every=s)
            j.run(12)
            j.block()
            key = f"{label} s={s}"
            res["steps_per_s"][key], res["runs_steps_per_s"][key] = \
                timed_runs(j, 48)
            log(f"  Jacobi {key}: {res['steps_per_s'][key]!r} steps/s over "
                f"three runs ({res['runs_steps_per_s'][key]})")
            del j
            torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(2024)
    n = N512
    a = torch.rand((n, n, n), generator=gen, device="cuda")
    b = torch.empty_like(a)
    hot, cold, r = spheres((n, n, n))
    pts = float(n ** 3)
    for N in (3, 4):
        ms = event_ms(torch, lambda: cs.jacobi7_wrapn_cuda(
            a, hot, cold, r, steps=N, out=b), reps=20)
        plain_ms = event_ms(torch, lambda: cs.jacobi7_wrapn_plain(
            a, hot, cold, r, steps=N), reps=2, warmup=1)
        bms, by = bound_ms(2 * pts * 4, 7 * N * pts)
        res["kernels"][f"jacobi7_wrapn N={N}"] = dict(
            ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
        log(f"  jacobi7_wrapn N={N}: {ms!r} ms/launch ({ms / N!r} a step), "
            f"bound {bms!r} ms ({by}), {100 * bms / ms:.1f}% of bound; "
            f"plain twin {plain_ms!r} ms")
        for label, size in (("512^3", (n, n, n)),
                            ("512 x 256 x 256 shard", (n, n // 2, n // 2))):
            (t,), (sl,), (org,), _, (h2, c2, r2), gsize = halo_case(
                torch, gen, size, (1, 1, 1),
                dict(rz=N, ry=N, radius_rows=N, y_z_extended=True))
            o = torch.empty_like(t)
            ms = event_ms(torch, lambda: ch.jacobi7_halon_cuda(
                t, sl, org, gsize, h2, c2, r2, steps=N, out=o), reps=20)
            plain_ms = event_ms(torch, lambda: ch.jacobi7_halon_plain(
                t, sl, org, gsize, h2, c2, r2, steps=N), reps=2, warmup=1)
            Z, Y, X = t.shape
            bms, by = bound_ms(halo_bytes(t.shape, N, True),
                               7 * N * float(Z * Y * X))
            res["kernels"][f"jacobi7_halon N={N} {label}"] = dict(
                ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by)
            log(f"  jacobi7_halon N={N} {label}: {ms!r} ms/launch, bound "
                f"{bms!r} ms ({by}), {100 * bms / ms:.1f}% of bound; plain "
                f"twin {plain_ms!r} ms")
            res["jacobi_ring_plans"][f"{label} N = {N}"] = ring_plan(
                torch, cs, (Z, Y, X), N)
            del t, sl, o
        torch.cuda.empty_cache()
    for label, plan in res["jacobi_ring_plans"].items():
        log(f"  Jacobi ring kernel plan, {label}: {plan}")
    del a, b
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# halo wire formats and layouts: Jacobi3D(wire_format=, wire_layout=), the
# packed and all-gather engines, make_exchange's gate, bench_exchange's race
# ---------------------------------------------------------------------------
WIRE_STEPS = 4
#: the grids of the exchange matrix over (2,2,2): 128^3 shards, even and
#: uneven
WIRE_MATRIX_N = (256, 255)
#: rel_error_bound of each narrowing format (half its dtype's epsilon)
WIRE_BOUNDS = {"bf16": 2.0 ** -8, "e4m3": 2.0 ** -4, "e5m2": 2.0 ** -3}
#: the wire settings phase 5 times on four shards
WIRE_TIMED = (("f32 slab", {}),
              ("f32 irredundant", {"wire_layout": "irredundant"}),
              ("bf16 irredundant", {"wire_format": "bf16",
                                    "wire_layout": "irredundant"}))


def equal_bits(torch, a, b) -> bool:
    """Bitwise equality of two float32 tensors, NaN bits included."""
    return bool(torch.equal(a.contiguous().view(torch.int32),
                            b.contiguous().view(torch.int32)))


def wire_matrix(torch) -> dict:
    """The exchange matrix of ``tests/test_torch_wire.py`` at 128^3
    shards on the card: grids 256^3 and 255^3 (uneven) over (2,2,2), the
    eight shards on one card, radius 1 and 3, periodic and zero
    exterior, wire f32 / bf16 / e4m3 / {y: bf16, z: e4m3}, slab and
    irredundant layouts, ``PpermuteSlab`` and ``PpermutePacked``
    (``AllGather`` on the periodic 256^3 f32 slab cases): every shard
    bitwise equal to the same exchange of the port on the CPU, and the
    irredundant layout equal to the slab layout on the live window."""
    import numpy as np

    from stencil_tpu_torch import Boundary, Method
    from stencil_tpu_torch.distributed import DistributedDomain

    wires = {"f32": None, "bf16": "bf16", "e4m3": "e4m3",
             "dict": {"y": "bf16", "z": "e4m3"}}
    cases = 0

    def domain(n, r, boundary, wire, layout, method, device):
        dd = DistributedDomain(n, n, n, devices=[device] * 8)
        dd.set_mesh_shape((2, 2, 2))
        dd.set_radius(r)
        dd.set_boundary(boundary)
        if wires[wire] is not None:
            dd.set_wire_format(wires[wire])
        dd.set_wire_layout(layout)
        dd.set_methods(method)
        dd.add_data("q", torch.float32)
        dd.realize()
        return dd

    for n in WIRE_MATRIX_N:
        for r in (1, 3):
            cap = -(-n // 2) + 2 * r
            rng = np.random.default_rng(71 + n + r)
            vals = [torch.from_numpy((rng.standard_normal((cap,) * 3)
                                      * 10.0 ** rng.uniform(
                                          -40, 3.2, (cap,) * 3))
                                     .astype(np.float32)) for _ in range(8)]
            for boundary in (Boundary.PERIODIC, Boundary.NONE):
                for wire in wires:
                    live = {}
                    for layout in ("slab", "irredundant"):
                        ref = domain(n, r, boundary, wire, layout,
                                     Method.PpermuteSlab, "cpu")
                        for t, v in zip(ref.curr["q"], vals):
                            t.copy_(v)
                        ref.exchange()
                        want = [t.to(CARD) for t in ref.curr["q"]]
                        methods = [Method.PpermuteSlab, Method.PpermutePacked]
                        if (n % 2 == 0 and boundary == Boundary.PERIODIC
                                and wire == "f32" and layout == "slab"):
                            methods.append(Method.AllGather)
                        for method in methods:
                            dd = domain(n, r, boundary, wire, layout,
                                        method, CARD)
                            for t, v in zip(dd.curr["q"], vals):
                                t.copy_(v)
                            dd.exchange()
                            for i, (t, w) in enumerate(zip(dd.curr["q"],
                                                           want)):
                                if not equal_bits(torch, t, w):
                                    raise AssertionError(
                                        f"exchange n={n} r={r} {boundary} "
                                        f"wire={wire} {layout} {method}: "
                                        f"shard {i} differs from the CPU")
                            cases += 1
                            del dd
                        lo, hi = ref.radius.pad_lo(), ref.radius.pad_hi()
                        live[layout] = []
                        for i, t in enumerate(want):
                            sz = ref.shard_size(i)
                            live[layout].append(
                                t[:lo.z + sz.z + hi.z, :lo.y + sz.y + hi.y,
                                  :lo.x + sz.x + hi.x])
                        del ref
                    for a, b in zip(live["slab"], live["irredundant"]):
                        if not equal_bits(torch, a, b):
                            raise AssertionError(
                                f"irredundant != slab on the live window, "
                                f"n={n} r={r} {boundary} wire={wire}")
                    del live, want
            torch.cuda.empty_cache()
    log(f"  exchange matrix at 128^3 shards: {cases} card exchanges "
        f"bitwise equal to the port's CPU exchange; irredundant = slab on "
        f"the live window in all 32 (n, r, boundary, wire) cells")
    return {"card_exchanges": cases}


def run_wire_paths(torch, cs) -> dict:
    """Phase 4, halo wire formats and layouts: the card's narrowing
    against the CPU's; ``Jacobi3D`` ``xla`` and ``pallas`` (K3) on four
    512 x 256 x 256 shards of (1,2,2) on the card, f32 wire = no wire
    argument, irredundant = slab, ``PpermutePacked`` = ``AllGather`` =
    ``PpermuteSlab`` bitwise, bf16 / e4m3 / e5m2 within ``steps *
    rel_error_bound * max`` of the f32 wire, above 0, and each below the
    next narrower format's error; the exchange
    matrix at 128^3 shards; Astaroth 256^3 ``xla`` (the packed engine)
    equal to ``PpermuteSlab`` bitwise, on (1,1,1) and on four shards;
    ``bench_exchange --wire-layout slab,irredundant`` on four 256^3
    shards (bytes ratio 0.97704)."""
    import numpy as np

    from stencil_tpu_torch import Method
    from stencil_tpu_torch.analysis.precision import wire_edge_values
    from stencil_tpu_torch.parallel.exchange import _from_wire, _to_wire

    out = {"launches_by_run": {}, "max_diff": {}}
    vals = torch.from_numpy(wire_edge_values())
    card = vals.to(CARD)
    for fmt in WIRE_BOUNDS:
        got = _from_wire(_to_wire(card, fmt), torch.float32).cpu()
        want = _from_wire(_to_wire(vals, fmt), torch.float32)
        if not equal_bits(torch, got, want):
            raise AssertionError(f"the card narrows to {fmt} unlike the CPU")
    log(f"  _to_wire/_from_wire on the card = on the CPU, bitwise, for "
        f"{sorted(WIRE_BOUNDS)} ({vals.numel()} edge values, e4m3's NaN "
        f"above 464 included)")

    steps = WIRE_STEPS
    for kernel in ("xla", "pallas"):
        def run(label, **kw):
            cs.reset_launch_counts()
            j = jacobi_mesh(kernel, (1, 2, 2), (N512,) * 3, **kw)
            if j.kernel_path != kernel:
                raise AssertionError(f"{kernel} {label} took "
                                     f"{j.kernel_path!r}")
            j.run(steps)
            j.block()
            k3 = cs.LAUNCHES["jacobi7_padded"]
            want = 4 * steps if kernel == "pallas" else 0
            out["launches_by_run"][f"{kernel} {label}"] = k3
            if k3 != want:
                raise AssertionError(f"{kernel} {label}: {k3} K3 launches, "
                                     f"not {want}")
            got = gather(torch, j)
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"{kernel} {label}: non-finite")
            del j
            return got

        ref = run("f32 slab")
        for label, kw in (("wire_format='f32'", {"wire_format": "f32"}),
                          ("f32 irredundant", {"wire_layout": "irredundant"}),
                          ("PpermutePacked", {"methods":
                                              Method.PpermutePacked}),
                          ("AllGather", {"methods": Method.AllGather})):
            got = run(label, **kw)
            if not equal_bits(torch, got, ref):
                raise AssertionError(f"{kernel} {label} != f32 slab")
            del got
        log(f"  {kernel} on four 512 x 256 x 256 shards, run({steps}): "
            f"wire_format='f32', f32 irredundant, PpermutePacked and "
            f"AllGather all bitwise equal to the f32 slab run")
        scale = float(ref.abs().max())
        errs = []
        for fmt, bound in WIRE_BOUNDS.items():
            got = run(f"{fmt} irredundant", wire_format=fmt,
                      wire_layout="irredundant")
            err = float((got - ref).abs().max())
            tol = steps * bound * scale
            log(f"  {kernel} {fmt} irredundant vs f32: max diff {err!r} "
                f"(required 0 < diff <= {tol!r})")
            if not 0.0 < err <= tol:
                raise AssertionError(f"{kernel} {fmt} wire outside its "
                                     f"bound")
            out["max_diff"][f"{kernel} {fmt} irredundant vs f32"] = err
            errs.append(err)
            if fmt == "bf16":
                packed = run("bf16 irredundant PpermutePacked",
                             wire_format=fmt, wire_layout="irredundant",
                             methods=Method.PpermutePacked)
                slab = run("bf16 slab", wire_format=fmt)
                if not (equal_bits(torch, packed, got)
                        and equal_bits(torch, slab, got)):
                    raise AssertionError(f"{kernel} bf16: packed or slab "
                                         f"layout != irredundant")
                log(f"  {kernel} bf16: PpermutePacked and the slab layout "
                    f"bitwise equal to the irredundant PpermuteSlab run")
                del packed, slab
            del got
        # each format's error below the next narrower one's: a format
        # that shipped at another width than its own would not be
        if not errs[0] < errs[1] < errs[2]:
            raise AssertionError(f"{kernel}: wire errors {errs} not "
                                 f"ordered bf16 < e4m3 < e5m2")
        log(f"  {kernel}: wire errors ordered bf16 < e4m3 < e5m2")
        del ref
        torch.cuda.empty_cache()
    out["launches"] = {"jacobi7_padded": out["launches_by_run"][
        "pallas bf16 irredundant"]}

    out["matrix"] = wire_matrix(torch)
    out["astaroth"] = astaroth_packed_vs_slab(torch)
    out["bench_exchange"] = bench_exchange_layout_race(torch)
    return out


def astaroth_packed_vs_slab(torch) -> dict:
    """Astaroth ``xla`` by its default method (``PpermutePacked``, the
    packed engine) against ``methods=Method.PpermuteSlab``, bitwise,
    fields and accumulators: 256^3 on (1,1,1), run(2), and 256 x 512 x
    512 on four shards of (1,2,2) on the card, run(1)."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    res = {}
    for label, size, mesh, iters in (("256^3 (1,1,1)", (N256,) * 3,
                                      (1, 1, 1), 2),
                                     ("256 x 512 x 512 (1,2,2)",
                                      (N256, 2 * N256, 2 * N256),
                                      (1, 2, 2), 1)):
        runs = []
        for methods in (None, Method.PpermuteSlab):
            kw = {} if methods is None else {"methods": methods}
            m = Astaroth(*size, params=MhdParams(dt=MHD_PATH_DT),
                         kernel="xla", mesh_shape=mesh,
                         devices=[CARD] * (mesh[1] * mesh[2]), **kw)
            m.init()
            t0 = time.perf_counter()
            m.run(iters)
            m.block()
            secs = time.perf_counter() - t0
            runs.append({q: (torch.from_numpy(m.field(q)),
                             torch.from_numpy(m.accumulator(q)))
                         for q in FIELDS})
            log(f"  Astaroth xla {label} methods="
                f"{'PpermutePacked (default)' if methods is None else methods}"
                f": run({iters}) {secs:.3f} s")
            del m
            torch.cuda.empty_cache()
        for q in FIELDS:
            for a, b in zip(runs[0][q], runs[1][q]):
                if not (bool(torch.isfinite(a).all())
                        and equal_bits(torch, a, b)):
                    raise AssertionError(f"Astaroth {label} packed != slab "
                                         f"({q})")
        res[label] = "bitwise"
        log(f"  Astaroth xla {label}: packed engine = PpermuteSlab, "
            f"bitwise, fields and accumulators")
    return res


def bench_exchange_layout_race(torch) -> dict:
    """``bench_exchange --wire-layout slab,irredundant`` on four 256^3
    shards of the card through its ``main()``: the layout line's bytes
    ratio must be the byte model's, 2,113,536 / 2,163,200 = 0.97704
    (radius 2, mesh (2,2,1))."""
    from stencil_tpu_torch import Dim3, Radius
    from stencil_tpu_torch.apps import bench_exchange
    from stencil_tpu_torch.parallel.exchange import exchanged_bytes_per_sweep
    from stencil_tpu_torch.parallel.packing import irredundant_bytes_per_sweep

    padded, r2, mesh = (N256 + 4,) * 3, Radius.constant(2), Dim3(2, 2, 1)
    expect = (sum(irredundant_bytes_per_sweep(padded, r2, mesh, 4).values())
              / sum(exchanged_bytes_per_sweep(padded, r2, mesh, 4).values()))
    if N256 == 256 and round(expect, 5) != 0.97704:
        raise AssertionError(f"byte model ratio {expect!r}")
    os.makedirs("chiprun_out", exist_ok=True)
    path = os.path.join("chiprun_out", "bench_exchange_layout.json")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_exchange.main(["--devices", ",".join([CARD] * 4),
                             "--x", str(N256), "--y", str(N256),
                             "--z", str(N256), "--iters", "10",
                             "--wire-layout",
                             "slab,irredundant", "--ledger", "",
                             "--json-out", path])
    lines = [ln for ln in buf.getvalue().splitlines() if "," in ln]
    for ln in lines:
        log(f"  {ln}")
    with open(path) as f:
        payload = json.load(f)
    race = payload["wire_layout_race"]["races"]["irredundant"]
    ratio = race["bytes_ratio"]
    if ratio != expect or not 0 < race["trimean_exchange_s"] < 1e3:
        raise AssertionError(f"bench_exchange layout race: bytes ratio "
                             f"{ratio!r}, {race}")
    log(f"  bench_exchange layout race: irredundant {race['bytes_per_exchange_model']} "
        f"B an exchange ({ratio!r} of slab), {race['trimean_exchange_s']!r} "
        f"s ({race['exchange_s_ratio']!r} of slab), {race['steps_per_s']!r} "
        f"steps/s ({race['steps_per_s_ratio']!r} of slab)")
    return {"lines": lines, "wire_layout_race": payload["wire_layout_race"],
            "slab": payload["configs"][0]}


def time_wire(torch) -> dict:
    """Phase 5, wire formats: steps/s of ``xla`` and ``pallas`` on four
    512 x 256 x 256 shards of (1,2,2) on the card, f32 slab, f32
    irredundant and bf16 irredundant (three ``run(k)`` pooled)."""
    res = {"steps_per_s": {}, "runs_steps_per_s": {}}
    for kernel, k in (("xla", 20), ("pallas", 40)):
        for label, kw in WIRE_TIMED:
            j = jacobi_mesh(kernel, (1, 2, 2), (N512,) * 3, **kw)
            j.run(2)
            j.block()
            key = f"{kernel} {label}"
            res["steps_per_s"][key], res["runs_steps_per_s"][key] = \
                timed_runs(j, k)
            log(f"  Jacobi {key} (1,2,2): {res['steps_per_s'][key]!r} "
                f"steps/s over three runs ({res['runs_steps_per_s'][key]})")
            del j
            torch.cuda.empty_cache()
    return res


EPS32 = 2.0 ** -23


def check_fields(torch, got: dict, want: dict, what: str,
                 factor: float = 64.0) -> float:
    """Per field: finite, same shape, max |got - want| <= factor *
    eps(f32) * max |want|. Returns the largest absolute difference."""
    worst = ratio = 0.0
    for q, t in want.items():
        g = got[q]
        if g.shape != t.shape or not bool(torch.isfinite(g).all()):
            raise AssertionError(f"{what} {q}: wrong shape or non-finite")
        err = float((g - t).abs().max())
        scale = float(t.abs().max())
        if err > factor * EPS32 * scale:
            raise AssertionError(f"{what} {q}: max |diff| {err!r} > "
                                 f"{factor:g} eps(f32) x {scale!r}")
        worst = max(worst, err)
        ratio = max(ratio, err / (EPS32 * scale) if scale else 0.0)
    log(f"  {what}: max |diff| {worst!r}, at most {ratio:.2f} eps(f32) x "
        f"max|ref| in a field (tolerance {factor:g})")
    return worst


def mhd_state(torch, shape, gen):
    """8 fields of sigma 0.1 and 8 w of sigma 1e-4 on the card."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    f = {q: 0.1 * torch.randn(shape, generator=gen, device="cuda")
         for q in FIELDS}
    w = {q: 1e-4 * torch.randn(shape, generator=gen, device="cuda")
         for q in FIELDS}
    return f, w


def mhd_inv_ds():
    from stencil_tpu_torch.models.astaroth import MhdParams

    prm = MhdParams()
    return (1.0 / prm.dsx, 1.0 / prm.dsy, 1.0 / prm.dsz)


# B8's shapes (Z, Y, X) beyond MHD_SHAPES: Astaroth's per-rank grid, z
# runs with a shorter last one, one smaller than a tile, x not a multiple
# of 4; and its layouts at 29 x 37 x 70: (low pads, high pads) (x, y, z)
# and the floats by which the field and the output start past 16 bytes
LAPLACE6_SHAPES = [(N256,) * 3, (136, 128, 96), (131, 64, 128), (1, 8, 1),
                   (5, 7, 33)]
LAPLACE6_LAYOUTS = [((5, 4, 6), (4, 4, 3), 0, 0),   # Xp odd: 4-byte copies
                    ((3, 3, 3), (3, 3, 3), 1, 0),   # rows on 4 bytes
                    ((3, 5, 4), (5, 3, 3), 2, 0),   # odd low x pad, 8 bytes
                    ((4, 4, 4), (4, 4, 4), 0, 1),   # even low x pad: 4
                    ((6, 3, 5), (4, 4, 4), 2, 3)]


def compare_laplace6(torch, cs, dtype=None) -> float:
    """Phase 3: B8 bitwise against its twin, one launch a call, at
    ``MHD_SHAPES`` and ``LAPLACE6_SHAPES`` padded by 3, and at 29 x 37 x
    70 in each of ``LAPLACE6_LAYOUTS``, in float32 or (``dtype``)
    bfloat16: cells drawn in float32 and rounded once. Returns the
    largest absolute difference."""
    from stencil_tpu_torch.geometry import Dim3, Radius

    dtype = dtype or torch.float32
    name = "B8" if dtype == torch.float32 else "B8 bf16"
    gen = torch.Generator(device="cuda").manual_seed(4322)
    inv = mhd_inv_ds()

    cases = [((Z, Y, X), (3, 3, 3), (3, 3, 3), 0, 0)
             for Z, Y, X in MHD_SHAPES + LAPLACE6_SHAPES]
    cases += [((29, 37, 70), lo, hi, off, ooff)
              for lo, hi, off, ooff in LAPLACE6_LAYOUTS]
    n_sms = cs.sm_count(torch.device("cuda"))
    worst = 0.0
    for (Z, Y, X), lo, hi, off, ooff in cases:
        r = Radius.constant(3)
        for axis, v in enumerate(lo):
            d = [0, 0, 0]
            d[axis] = -1
            r.set_dir(tuple(d), v)
        shape = (Z + lo[2] + hi[2], Y + lo[1] + hi[1], X + lo[0] + hi[0])
        n = shape[0] * shape[1] * shape[2]
        pad = torch.randn((n + off,), generator=gen, device="cuda").to(
            dtype)[off:].view(shape)
        out = torch.full((Z * Y * X + ooff,), float("nan"), dtype=dtype,
                         device="cuda")[ooff:].view(Z, Y, X)
        before = cs.LAUNCHES["laplace6"]
        got = cs.laplace6_cuda(pad, r, Dim3(X, Y, Z), inv, out=out)
        want = cs.laplace6_plain(pad, r, Dim3(X, Y, Z), inv)
        err = float((got.float() - want.float()).abs().max())
        same = bool(torch.equal(got, want))
        plan = cs.laplace6_plan(Z, Y, X, n_sms)
        tag = f"{(Z, Y, X)} pads {lo}/{hi} offsets {off}/{ooff}"
        log(f"  {name} {tag}, plan {tuple(plan)}: max |kernel - twin| = "
            f"{err!r} ({'bitwise equal' if same else 'DIFFERENT'})")
        if not same or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name} {tag}: kernel disagrees with "
                                 f"its twin")
        if cs.LAUNCHES["laplace6"] != before + 1:
            raise AssertionError(f"{name} {tag}: not one launch a call")
        worst = max(worst, err)
        del pad, out, got, want
    return worst


def compare_mhd_kernels(torch, cs, cm) -> dict:
    """Phase 3, Astaroth: B8 bitwise (``compare_laplace6``); B9 and B10
    per field within 64 eps(f32) of the largest twin value (whether B9
    came out bitwise is reported); B10 also against two B9 launches; B9
    (every variant)
    bitwise equal to B11 on the same field as a (1,1,1) mesh, whose slabs
    are its own wrapped rows, at these shapes, at 256^3 and at 136 x 128
    x 96, where ``ring_zrun`` splits z into runs, the last one shorter.
    Returns the largest absolute difference per kernel."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    gen = torch.Generator(device="cuda").manual_seed(4321)
    split = (136, 128, 96)
    worst = {"laplace6": compare_laplace6(torch, cs),
             "mhd_substep_wrap": 0.0, "mhd_substep01_wrap": 0.0}
    for shape in MHD_SHAPES + [(N256,) * 3, split]:
        Z, Y, X = shape
        zrun = cm.ring_zrun(Z, Y, X, cs.sm_count(torch.device("cuda")))
        log(f"  B9 on {shape}: {-(-Z // zrun)} z runs of {zrun} planes a "
            f"block")
        for dt in (MHD_DTS if shape != split else (MHD_PATH_DT,)):
            prm = MhdParams(dt=dt)
            f, w = mhd_state(torch, shape, gen)
            t = torch.stack(list(f.values()))
            own = mhd_slabs([t], (1, 1, 1), rz=3, ry=3)[0]
            tag = f"{shape} dt={dt:g}"
            for s, w_in, write_w in ((0, None, True), (1, w, True),
                                     (2, w, False)):
                kf, kw = cm.mhd_substep_wrap_cuda(f, w_in, s, prm, dt,
                                                  write_w=write_w)
                tf, tw = cm.mhd_substep_wrap_plain(f, w_in, s, prm, dt,
                                                   write_w=write_w)
                e = check_fields(torch, kf, tf, f"B9 s={s} f {tag}")
                if write_w:
                    e = max(e, check_fields(torch, kw, tw, f"B9 s={s} w {tag}"))
                elif kw is not None:
                    raise AssertionError("B9 write_w=False returned a w")
                bitwise = same_bits(torch, (kf, kw), (tf, tw))
                log(f"  B9 s={s} {tag} vs its twin: "
                    + ("bitwise equal" if bitwise
                       else "not bitwise, within the tolerance"))
                worst["mhd_substep_wrap"] = max(worst["mhd_substep_wrap"], e)
                same = same_bits(torch, (kf, kw), cm.mhd_substep_halo_cuda(
                    f, w_in, own, s, prm, dt, write_w=write_w))
                log(f"  B9 s={s} {tag} vs B11 on a (1,1,1) mesh: "
                    f"{'bitwise equal' if same else 'DIFFERENT'}")
                if not same:
                    raise AssertionError(f"B9 s={s} {tag} differs from B11 "
                                         f"on a (1,1,1) mesh")
                del kf, kw, tf, tw
            if shape == split:
                del f, w, t, own
                continue
            kf, kw = cm.mhd_substep01_wrap_cuda(f, prm, dt)
            tf, tw = cm.mhd_substep01_wrap_plain(f, prm, dt)
            e = max(check_fields(torch, kf, tf, f"B10 f {tag}"),
                    check_fields(torch, kw, tw, f"B10 w {tag}"))
            worst["mhd_substep01_wrap"] = max(worst["mhd_substep01_wrap"], e)
            del tf, tw
            f1, w1 = cm.mhd_substep_wrap_cuda(f, None, 0, prm, dt)
            f2, w2 = cm.mhd_substep_wrap_cuda(f1, w1, 1, prm, dt)
            same = same_bits(torch, (kf, kw), (f2, w2))
            log(f"  B10 {tag} vs B9 s=0 then B9 s=1: "
                f"{'bitwise equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"B10 {tag} differs from B9 s=0 then "
                                     f"B9 s=1")
            del f, w, t, own, kf, kw, f1, w1, f2, w2
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return worst


# ---------------------------------------------------------------------------
# the MHD halo path: B11, B12 and Astaroth(kernel="halo") on meshes of shards
# ---------------------------------------------------------------------------
def per_field(t):
    """The 8 fields of a (8, Z, Y, X) tensor, as views."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    return dict(zip(FIELDS, t.unbind(0)))


def per_field_slabs(sl):
    from stencil_tpu_torch.models.astaroth import FIELDS

    return {q: {k: v[j] for k, v in sl.items()} for j, q in enumerate(FIELDS)}


def mhd_mesh_case(torch, gen, size_zyx, mesh):
    """Random (8, Z, Y, X) shards (sigma 0.1) and w (sigma 1e-4) of a
    global grid over an x-unsharded mesh, on the card."""
    Z, Y, X = size_zyx
    lz, ly = Z // mesh[2], Y // mesh[1]
    n = mesh[1] * mesh[2]
    shards = [0.1 * torch.randn((8, lz, ly, X), generator=gen, device="cuda")
              for _ in range(n)]
    ws = [1e-4 * torch.randn((8, lz, ly, X), generator=gen, device="cuda")
          for _ in range(n)]
    return shards, ws


def mhd_slabs(shards, mesh, **kw):
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.parallel.exchange import exchange_interior_slabs

    return [per_field_slabs(s) for s in exchange_interior_slabs(
        shards, Dim3(*mesh), y_z_extended=True, **kw)]


def same_bits(torch, got, want) -> bool:
    """(fields, w) pairs equal bit for bit (w None in both, or equal)."""
    (gf, gw), (wf, ww) = got, want
    if (gw is None) != (ww is None):
        return False
    return (all(torch.equal(gf[q], wf[q]) for q in wf)
            and (ww is None or all(torch.equal(gw[q], ww[q]) for q in ww)))


def compare_mhd_halo_kernels(torch, cm) -> dict:
    """Phase 3, the MHD halo kernels: B11 (every variant) bitwise against
    its twin (and within 64 eps(f32) of the largest twin value per field,
    reported), B12 against its twin within that tolerance, on JAX-layout
    slabs (rz = ry = 8, zero filler) and the halo path's exact-row ones
    (rz = ry = R, or 2R for B12), at small shapes (x not a multiple of
    B11's 32-wide tile), on two 256^3 shards and on four 136 x 128 x 96
    shards, where B11's blocks walk z in runs; B12 also against B11 s=0, a slab
    round and B11 s=1; on one shard B11 (every variant) against B9 and
    B12 against B10, bitwise."""
    from stencil_tpu_torch.models.astaroth import MhdParams

    gen = torch.Generator(device="cuda").manual_seed(8642)
    worst = {"mhd_substep_halo": 0.0, "mhd_substep01_halo": 0.0}
    jax_layout = (dict(rz=8, ry=8, radius_rows=3),
                  dict(rz=8, ry=8, radius_rows=6))
    exact = (dict(rz=3, ry=3), dict(rz=6, ry=6))
    # (global (Z, Y, X), mesh, (B11 slabs, B12 slabs), dts, unelided)
    cases = [((16, 8, 16), (1, 1, 1), jax_layout, MHD_DTS, True),
             ((16, 8, 24), (1, 1, 1), exact, MHD_DTS, True),
             ((16, 16, 24), (1, 2, 2), exact, MHD_DTS, True),
             ((32, 16, 40), (1, 2, 4), jax_layout, MHD_DTS, True),
             ((2 * N256, N256, N256), (1, 1, 2), exact, (MHD_PATH_DT,),
              False),
             ((272, 256, 96), (1, 2, 2), exact, (MHD_PATH_DT,), False)]
    for size, mesh, (kw11, kw12), dts, unelided in cases:
        shards, ws = mhd_mesh_case(torch, gen, size, mesh)
        Z, Y, X = shards[0].shape[1:]
        zrun = cm.ring_zrun(Z, Y, X, cm.sm_count(shards[0].device))
        log(f"  B11 on {size} mesh {mesh}: {-(-Z // zrun)} z runs of "
            f"{zrun} planes a block")
        sl11 = mhd_slabs(shards, mesh, **kw11)
        sl12 = mhd_slabs(shards, mesh, **kw12)
        variants = [(0, False, True), (1, True, True), (2, True, False)]
        if unelided:
            variants += [(0, True, True), (2, True, True)]
        for dt in dts:
            prm = MhdParams(dt=dt)
            tag = f"{size} mesh {mesh} slabs {kw11['rz']}/{kw12['rz']} dt={dt:g}"
            for i, (t, w) in enumerate(zip(shards, ws)):
                f = per_field(t)
                for s, read_w, write_w in variants:
                    w_in = per_field(w) if read_w else None
                    kf, kw = cm.mhd_substep_halo_cuda(f, w_in, sl11[i], s, prm,
                                                      dt, write_w=write_w)
                    tf, tw = cm.mhd_substep_halo_plain(f, w_in, sl11[i], s,
                                                       prm, dt,
                                                       write_w=write_w)
                    what = (f"B11 s={s}{'' if read_w else ' w=None'}"
                            f"{'' if write_w else ' write_w=False'} {tag} "
                            f"shard {i}")
                    e = check_fields(torch, kf, tf, what + ", f")
                    if write_w:
                        e = max(e, check_fields(torch, kw, tw, what + ", w"))
                    elif kw is not None:
                        raise AssertionError("B11 write_w=False returned a w")
                    if not same_bits(torch, (kf, kw), (tf, tw)):
                        raise AssertionError(f"{what}: not bitwise equal to "
                                             f"its twin")
                    worst["mhd_substep_halo"] = max(
                        worst["mhd_substep_halo"], e)
                    if mesh == (1, 1, 1):
                        same = same_bits(torch, (kf, kw), cm.mhd_substep_wrap_cuda(
                            f, w_in, s, prm, dt, write_w=write_w))
                        log(f"  {what} vs B9: "
                            f"{'bitwise equal' if same else 'DIFFERENT'}")
                        if not same:
                            raise AssertionError("B11 differs from B9 on a "
                                                 "(1,1,1) mesh")
                    del kf, kw, tf, tw
                kf, kw = cm.mhd_substep01_halo_cuda(f, sl12[i], prm, dt)
                tf, tw = cm.mhd_substep01_halo_plain(f, sl12[i], prm, dt)
                e = max(check_fields(torch, kf, tf, f"B12 f {tag} shard {i}"),
                        check_fields(torch, kw, tw, f"B12 w {tag} shard {i}"))
                worst["mhd_substep01_halo"] = max(
                    worst["mhd_substep01_halo"], e)
                if mesh == (1, 1, 1):
                    bf, bw = cm.mhd_substep01_wrap_cuda(f, prm, dt)
                    same = all(torch.equal(kf[q], bf[q])
                               and torch.equal(kw[q], bw[q]) for q in bf)
                    log(f"  B12 vs B10 on one shard {tag}: "
                        f"{'bitwise equal' if same else 'DIFFERENT'}")
                    if not same:
                        raise AssertionError("B12 differs from B10 on a "
                                             "(1,1,1) mesh")
                del kf, kw, tf, tw
            # B12 against B11 s=0, a radius-R slab round, B11 s=1
            one = [cm.mhd_substep_halo_cuda(per_field(t), None, sl, 0, prm,
                                            dt)
                   for t, sl in zip(shards, mhd_slabs(shards, mesh, rz=3,
                                                      ry=3))]
            f1 = [torch.stack(list(f.values())) for f, _ in one]
            sl1 = mhd_slabs(f1, mesh, rz=3, ry=3)
            for i, t in enumerate(shards):
                f2, w2 = cm.mhd_substep_halo_cuda(per_field(f1[i]), one[i][1],
                                                  sl1[i], 1, prm, dt)
                kf, kw = cm.mhd_substep01_halo_cuda(per_field(t), sl12[i],
                                                    prm, dt)
                if not same_bits(torch, (kf, kw), (f2, w2)):
                    raise AssertionError(f"B12 {tag} shard {i} differs from "
                                         f"B11 s=0, a slab round, B11 s=1")
            log(f"  B12 {tag} vs B11 s=0, a radius-R slab round, B11 s=1: "
                f"bitwise equal on all {len(shards)} shards")
            del one, f1, sl1, f2, w2, kf, kw
        del shards, ws, sl11, sl12
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return worst


@contextlib.contextmanager
def mhd_pair(value: str):
    """STENCIL_MHD_PAIR set to ``value`` for the block (the models read
    it when they are built), then restored."""
    prev = os.environ.get("STENCIL_MHD_PAIR")
    os.environ["STENCIL_MHD_PAIR"] = value
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("STENCIL_MHD_PAIR", None)
        else:
            os.environ["STENCIL_MHD_PAIR"] = prev


def run_astaroth(torch, cs, cm) -> dict:
    """Phase 4, Astaroth at 256^3 through the model class, at dt 1e-4 so
    that the rates move the float32 fields by many ulps."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    factor = 6 * 64.0   # 6 substeps, each within 64 eps of its max
    prm = MhdParams(dt=MHD_PATH_DT)
    out = {}

    def model(kernel, n=N256, dtype=torch.float32):
        m = Astaroth(n, n, n, params=prm, dtype=dtype, kernel=kernel,
                     device="cuda")
        m.init()
        m.block()
        return m

    def state(m, dtype=torch.float32):
        return ({q: torch.from_numpy(m.field(q)).to(dtype) for q in FIELDS},
                {q: torch.from_numpy(m.accumulator(q)).to(dtype)
                 for q in FIELDS})

    def xla_reference(n=N256, dtype=torch.float32):
        """Fields after 2 iterations of the xla path, and the w of its
        last iteration's substep 1 — the w the wrap path carries (it
        never writes substep 2's, which nothing reads)."""
        m = model("xla", n, dtype)
        start = {q: torch.from_numpy(m.field(q)) for q in FIELDS}
        m.run(1)
        m._substep_xla(0)
        m._substep_xla(1)
        w1 = {q: torch.from_numpy(m.accumulator(q)).to(dtype)
              for q in FIELDS}
        m._substep_xla(2)
        fields, _ = state(m, dtype)
        # the comparison means something only if the rates moved every
        # field by far more than the tolerance
        moved = min(float((fields[q] - start[q].to(dtype)).abs().max())
                    / (EPS32 * float(fields[q].abs().max())) for q in FIELDS)
        log(f"  {n}^3 xla: 2 iterations moved every field by at least "
            f"{moved:.4g} eps(f32) x max|field|")
        if not moved > 10 * factor:
            raise AssertionError("the rates did not show in the fields")
        return fields, w1

    small = model("auto", 16)
    if small.kernel_path != "wrap":
        raise AssertionError(f"auto picked {small.kernel_path!r} at 16^3")
    small.run(2)
    f64, w64 = xla_reference(16, torch.float64)
    sf, sw = state(small, torch.float64)
    what = "16^3 wrap (float32) vs xla (float64) after 2 iterations"
    check_fields(torch, sf, f64, what + ", f", factor=factor)
    check_fields(torch, sw, w64, what + ", w", factor=factor)
    del small

    counts = {}
    got = {}
    for label, pair, want_counts in (
            ("wrap", "0", {"mhd_substep_wrap": 6, "mhd_substep01_wrap": 0,
                           "mhd_substep_halo": 0, "mhd_substep01_halo": 0,
                           "laplace6": 0}),
            ("wrap+pair", "1", {"mhd_substep_wrap": 2,
                                "mhd_substep01_wrap": 2,
                                "mhd_substep_halo": 0,
                                "mhd_substep01_halo": 0, "laplace6": 0})):
        with mhd_pair(pair):
            m = model("auto")
        if m.kernel_path != "wrap":
            raise AssertionError(f"auto picked {m.kernel_path!r}, not 'wrap'")
        cm.reset_launch_counts()
        cs.reset_launch_counts()
        m.run(2)
        m.block()
        counts[label] = dict(cm.LAUNCHES, laplace6=cs.LAUNCHES["laplace6"])
        log(f"  Astaroth 256^3 {label} run(2) launches: {counts[label]}")
        if counts[label] != want_counts:
            raise AssertionError(f"{label} path launched {counts[label]}, "
                                 f"not {want_counts}")
        got[label] = state(m)
        del m
        torch.cuda.empty_cache()
    same = same_bits(torch, got["wrap+pair"], got["wrap"])
    log(f"  256^3 wrap+pair vs wrap after 2 iterations (fields and carried "
        f"w): {'bitwise equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("wrap+pair differs from wrap")
    out["pair_vs_wrap_bitwise"] = same
    want_f, want_w = xla_reference()
    torch.cuda.empty_cache()
    for label, (gf, gw) in got.items():
        what = f"256^3 {label} vs xla after 2 iterations"
        out[f"{label}_vs_xla_max_diff"] = max(
            check_fields(torch, gf, want_f, what + ", f", factor=factor),
            check_fields(torch, gw, want_w, what + ", w", factor=factor))
    out["launches"] = {
        "mhd_substep_wrap": counts["wrap"]["mhd_substep_wrap"],
        "mhd_substep01_wrap": counts["wrap+pair"]["mhd_substep01_wrap"],
        "laplace6": sum(c["laplace6"] for c in counts.values())}
    out["launches_by_path"] = counts
    out["xla_fields_256"] = want_f     # for the halo path's check
    return out


def run_astaroth_halo(torch, cs, cm, xla_fields) -> dict:
    """Phase 4, the Astaroth halo path at dt 1e-4 through the model class:
    256 x 512 x 512 on mesh (1,2,2), four 256^3 shards on the one card,
    where kernel="auto" must take ``halo``: run(2) launches B11 24 times
    (with the pair: B12 8 times and B11 8 times) and nothing else, and
    equals the wrap path on the same grid (B11 keeps B9's per-point
    order, and the slabs hold the neighbours' rows: bitwise; the bound
    held is substeps x 64 eps x max). 256^3 ``halo`` on (1,1,1) (6 B11
    launches) equals ``wrap``; on (1,2,2) (quarter shards) it agrees with
    the xla path of run_astaroth within the same bound. With the pair
    the path equals itself without it bitwise, fields and carried w, on
    the four shards and on (1,1,1) (B12 is B11 s=0, the margin and B11
    s=1). Each run must move every field by more than 10x that bound."""
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    factor = 6 * 64.0
    prm = MhdParams(dt=MHD_PATH_DT)
    out = {"launches_by_run": {}}
    zero = {k: 0 for k in cm.LAUNCHES}
    zero["laplace6"] = 0

    def model(kernel, size, mesh=(1, 1, 1), pair="0"):
        with mhd_pair(pair):
            m = Astaroth(*size, params=prm, kernel=kernel, mesh_shape=mesh,
                         devices=["cuda:0"] * (mesh[1] * mesh[2]))
        m.init()
        m.block()
        return m

    def fields(m):
        return {q: torch.from_numpy(m.field(q)) for q in FIELDS}

    def drive(label, kernel, size, mesh, pair, want_counts):
        m = model(kernel, size, mesh, pair)
        if m.kernel_path != "halo":
            raise AssertionError(f"{label}: kernel={kernel!r} took "
                                 f"{m.kernel_path!r}, not 'halo'")
        start = fields(m)
        cm.reset_launch_counts()
        cs.reset_launch_counts()
        m.run(2)
        m.block()
        counts = dict(cm.LAUNCHES, laplace6=cs.LAUNCHES["laplace6"])
        want = dict(zero, **want_counts)
        log(f"  Astaroth halo {label} run(2) launches: {counts}")
        if counts != want:
            raise AssertionError(f"halo {label} launched {counts}, not {want}")
        out["launches_by_run"][label] = counts
        got = fields(m)
        w = {q: torch.from_numpy(m.accumulator(q)) for q in FIELDS}
        moved = min(float((got[q] - start[q]).abs().max())
                    / (EPS32 * float(got[q].abs().max())) for q in FIELDS)
        log(f"  halo {label}: 2 iterations moved every field by at least "
            f"{moved:.4g} eps(f32) x max|field|")
        if not moved > 10 * factor:
            raise AssertionError("the rates did not show in the fields")
        del m
        torch.cuda.empty_cache()
        return got, w

    def against_wrap(label, size, got, pair):
        m = model("wrap", size, pair=pair)
        m.run(2)
        want_f = fields(m)
        want_w = {q: torch.from_numpy(m.accumulator(q)) for q in FIELDS}
        del m
        torch.cuda.empty_cache()
        same = all(torch.equal(got[0][q], want_f[q])
                   and torch.equal(got[1][q], want_w[q]) for q in FIELDS)
        what = f"halo {label} vs wrap after 2 iterations"
        err = max(check_fields(torch, got[0], want_f, what + ", f",
                               factor=factor),
                  check_fields(torch, got[1], want_w, what + ", w",
                               factor=factor))
        log(f"  {what}: {'bitwise equal' if same else 'not bitwise equal'}")
        out[f"halo_vs_wrap_max_diff {label}"] = err
        out[f"halo_vs_wrap_bitwise {label}"] = same

    def pair_vs_single(label, got_pair, got):
        same = same_bits(torch, got_pair, got)
        log(f"  halo+pair vs halo {label} after 2 iterations (fields and "
            f"carried w): {'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"halo+pair differs from halo, {label}")
        out[f"pair_vs_halo_bitwise {label}"] = same

    big = (N256, 2 * N256, 2 * N256)           # (nx, ny, nz)
    for label, pair, want in (
            ("256x512x512 (1,2,2)", "0", {"mhd_substep_halo": 24}),
            ("256x512x512 (1,2,2) pair", "1", {"mhd_substep_halo": 8,
                                               "mhd_substep01_halo": 8})):
        got = drive(label, "auto", big, (1, 2, 2), pair, want)
        against_wrap(label, big, got, pair)
        # the halo-overlap path is held against these (phase 4, B13/B14)
        out.setdefault("halo_state", {})[pair] = got
        del got
    pair_vs_single("256x512x512 (1,2,2)", out["halo_state"]["1"],
                   out["halo_state"]["0"])
    cube = (N256,) * 3
    got = drive("256^3 (1,1,1)", "halo", cube, (1, 1, 1), "0",
                {"mhd_substep_halo": 6})
    against_wrap("256^3 (1,1,1)", cube, got, "0")
    pair_vs_single("256^3 (1,1,1)",
                   drive("256^3 (1,1,1) pair", "halo", cube, (1, 1, 1), "1",
                         {"mhd_substep_halo": 2, "mhd_substep01_halo": 2}),
                   got)
    got = drive("256^3 (1,2,2)", "halo", cube, (1, 2, 2), "0",
                {"mhd_substep_halo": 24})
    out["halo_quarter_vs_xla_max_diff"] = check_fields(
        torch, got[0], xla_fields, "halo 256^3 (1,2,2) vs xla after 2 "
        "iterations, f", factor=factor)
    del got
    main = out["launches_by_run"]
    out["launches"] = {
        "mhd_substep_halo": main["256x512x512 (1,2,2)"]["mhd_substep_halo"],
        "mhd_substep01_halo":
            main["256x512x512 (1,2,2) pair"]["mhd_substep01_halo"]}
    return out


def iters_per_s(torch, kernel: str, k: int, pair: str = "0"):
    """Iterations/s of Astaroth 256^3 on ``kernel``: three host-clocked
    ``run(k)`` pooled, each run's rate beside it (``timed_runs``)."""
    from stencil_tpu_torch.models.astaroth import Astaroth

    with mhd_pair(pair):
        m = Astaroth(N256, N256, N256, kernel=kernel, device="cuda")
    m.init()
    m.run(1)
    m.block()
    got = timed_runs(m, k)
    del m
    torch.cuda.empty_cache()
    return got


def time_mhd_kernels(torch, cs, cm) -> dict:
    """Phase 5b, Astaroth: B9 (each s), B10 and B8 at 256^3."""
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.models.astaroth import MhdParams
    from stencil_tpu_torch.ops.fd6 import _D2, _D2_C

    n = N256
    pts = float(n ** 3)
    field = 4 * pts
    gen = torch.Generator(device="cuda").manual_seed(999)
    f, w = mhd_state(torch, (n, n, n), gen)
    prm = MhdParams()
    dt = prm.dt
    r3 = Radius.constant(3)
    interior = Dim3(n, n, n)
    inv = mhd_inv_ds()
    pad = torch.randn((n + 6,) * 3, generator=gen, device="cuda")
    lap_out = torch.empty((n, n, n), device="cuda")
    cases = {
        "B9 s=0 (w=None)": (
            lambda: cm.mhd_substep_wrap_cuda(f, None, 0, prm, dt),
            lambda: cm.mhd_substep_wrap_plain(f, None, 0, prm, dt),
            24 * field, B9_FLOPS[0] * pts, 10),
        "B9 s=1": (
            lambda: cm.mhd_substep_wrap_cuda(f, w, 1, prm, dt),
            lambda: cm.mhd_substep_wrap_plain(f, w, 1, prm, dt),
            32 * field, B9_FLOPS[1] * pts, 10),
        "B9 s=2 (write_w=False)": (
            lambda: cm.mhd_substep_wrap_cuda(f, w, 2, prm, dt, write_w=False),
            lambda: cm.mhd_substep_wrap_plain(f, w, 2, prm, dt,
                                              write_w=False),
            24 * field, B9_FLOPS[2] * pts, 10),
        "mhd_substep01_wrap": (
            lambda: cm.mhd_substep01_wrap_cuda(f, prm, dt),
            lambda: cm.mhd_substep01_wrap_plain(f, prm, dt),
            24 * field, B10_FLOPS * pts, 5),
        "laplace6": (
            lambda: cs.laplace6_cuda(pad, r3, interior, inv, out=lap_out),
            lambda: cs.laplace6_plain(pad, r3, interior, inv),
            (float(n + 6) ** 3 + pts) * 4, LAPLACE6_FLOPS * pts, 20),
    }
    res = {}
    for name, (kern, plain, nbytes, flops, reps) in cases.items():
        ms = event_ms(torch, kern, reps=reps)
        plain_ms = event_ms(torch, plain, reps=2, warmup=1)
        bms, by = bound_ms(nbytes, flops)
        res[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None}
        log(f"  {name}: {ms!r} ms/launch, bound {bms!r} ms ({by}), "
            f"{100 * bms / ms:.1f}% of bound; plain twin {plain_ms!r} ms")
        torch.cuda.empty_cache()
    # B8's function as one library call: conv3d with the 6th-order cross
    ix2, iy2, iz2 = (v * v for v in inv)
    wt = torch.zeros((7, 7, 7), dtype=torch.float64)
    wt[3, 3, 3] = _D2_C * (ix2 + iy2 + iz2)
    for i, c in enumerate(_D2, start=1):
        for sgn in (-1, 1):
            wt[3, 3, 3 + sgn * i] = c * ix2
            wt[3, 3 + sgn * i, 3] = c * iy2
            wt[3 + sgn * i, 3, 3] = c * iz2
    weight = wt.to(torch.float32).cuda()[None, None]
    res["laplace6"]["library_ms"] = library_ms(
        torch, pad, weight, cs.laplace6_cuda(pad, r3, interior, inv),
        "laplace6")
    # B8's device time alone, its plan at 256^3 and the card's blocks an
    # SM there, which must equal the plan's
    dev = torch.device("cuda")
    plan = cs.laplace6_plan(n, n, n, cs.sm_count(dev))
    card_bps = cs.laplace6_occupancy(dev)
    blocks = -(-n // 64) * -(-n // cs.LAPLACE6_TY) * -(-n // plan.zrun)
    res["laplace6_plan_256"] = dict(
        plan._asdict(), blocks=blocks, card_blocks_per_sm=card_bps,
        waves=blocks / (cs.sm_count(dev) * card_bps))
    log(f"  laplace6 plan at 256^3: {res['laplace6_plan_256']}")
    if card_bps != plan.blocks_per_sm:
        raise AssertionError(f"laplace6: the card holds {card_bps} blocks "
                             f"an SM, the plan {plan.blocks_per_sm}")
    res["laplace6"].update(
        device_ms=device_ms(torch, cases["laplace6"][0], 20, warmup=3),
        blocks_per_sm=card_bps,
        design=("z-streaming shared-memory ring: 64 x 32 tiles walking z "
                "runs (laplace6_plan), cp.async of 8-byte cells (4 where "
                "rows start on 4 bytes or the low x pad is even) two "
                "planes ahead, four columns and two rows a thread, z "
                "pencil in registers"))
    log(f"  laplace6: device time alone "
        f"{res['laplace6']['device_ms']!r} ms")
    b9 = [res.pop(k) for k in ("B9 s=0 (w=None)", "B9 s=1",
                               "B9 s=2 (write_w=False)")]
    res["mhd_substep_wrap"] = {
        k: sum(v[k] for v in b9) / 3 for k in ("ms", "plain_ms", "bound_ms")}
    res["mhd_substep_wrap"].update(
        bound_by=b9[1]["bound_by"], library_ms=None,
        variants={"s=0 (w=None)": b9[0], "s=1": b9[1],
                  "s=2 (write_w=False)": b9[2]})
    del f, w, pad, lap_out
    torch.cuda.empty_cache()
    return res


def time_laplace6_bf16(torch, cs) -> dict:
    """Phase 5: B8's bfloat16 instance at 256^3 by CUDA events and by
    device time alone, its twin, and its function as one library call
    (conv3d in bfloat16 with the 7x7x7 cross, its own order: held to 2 %
    of max |kernel|); the bound counts 2-byte cells. B8 float32 at the
    same shape beside it, in the same process."""
    import torch.nn.functional as F

    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.ops.fd6 import _D2, _D2_C

    n = N256
    dev = torch.device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(4323)
    r3 = Radius.constant(3)
    interior = Dim3(n, n, n)
    inv = mhd_inv_ds()
    pad = torch.randn((n + 6,) * 3, generator=gen, device="cuda").to(
        torch.bfloat16)
    out = torch.empty((n,) * 3, device="cuda", dtype=torch.bfloat16)
    pts = float(n) ** 3

    def kern():
        return cs.laplace6_cuda(pad, r3, interior, inv, out=out)

    ms = event_ms(torch, kern, reps=20)
    dms = device_ms(torch, kern, 20, warmup=3)
    plain_ms = event_ms(torch, lambda: cs.laplace6_plain(pad, r3, interior,
                                                         inv),
                        reps=2, warmup=1)
    pad32 = pad.float()
    out32 = torch.empty((n,) * 3, device="cuda")
    f32_dms = device_ms(torch, lambda: cs.laplace6_cuda(
        pad32, r3, interior, inv, out=out32), 20, warmup=3)
    bms, by = bound_ms((float(n + 6) ** 3 + pts) * 2, LAPLACE6_FLOPS * pts)
    ix2, iy2, iz2 = (v * v for v in inv)
    wt = torch.zeros((7, 7, 7), dtype=torch.float64)
    wt[3, 3, 3] = _D2_C * (ix2 + iy2 + iz2)
    for i, c in enumerate(_D2, start=1):
        for sgn in (-1, 1):
            wt[3, 3, 3 + sgn * i] = c * ix2
            wt[3, 3 + sgn * i, 3] = c * iy2
            wt[3 + sgn * i, 3, 3] = c * iz2
    weight = wt.to(torch.bfloat16).cuda()[None, None]
    want = kern().float()
    got = F.conv3d(pad[None, None], weight)[0, 0].float()
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    log(f"  laplace6 bf16: max |conv3d - kernel| = {err!r} "
        f"({err / scale:.2e} of max |kernel|)")
    if not err <= 0.02 * scale:
        raise AssertionError("conv3d does not compute B8's function")
    lib_ms = event_ms(torch, lambda: F.conv3d(pad[None, None], weight),
                      reps=5)
    plan = cs.laplace6_plan(n, n, n, cs.sm_count(dev))
    card_bps = cs.laplace6_occupancy(dev, 2)
    if card_bps != plan.blocks_per_sm:
        raise AssertionError(f"laplace6 bf16: the card holds {card_bps} "
                             f"blocks an SM, the plan {plan.blocks_per_sm}")
    res = {"ms": ms, "device_ms": dms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "float32_device_ms": f32_dms, "blocks_per_sm": card_bps,
           "plan": plan._asdict(),
           "design": ("the float32 kernel's z-streaming ring of float32 "
                      "cells; bfloat16 window cells fetched in pairs into "
                      "registers after a pass's barrier and landed, "
                      "widened, at its end; four outputs of a row as two "
                      "bfloat16x2 lanes, each add and multiply one "
                      "packed instruction rounded once")}
    log(f"  laplace6 bf16: {ms!r} ms/launch by events, device {dms!r} ms "
        f"(float32 {f32_dms!r}), bound {bms!r} ms ({by}), "
        f"{100 * bms / dms:.1f}% of bound by device time; plain twin "
        f"{plain_ms!r} ms; conv3d bf16 {lib_ms!r} ms; plan {tuple(plan)}")
    del pad, out, pad32, out32, got, want
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# phase 4: the analysis checkers (stencil_tpu_torch.analysis)
# ---------------------------------------------------------------------------
#: the kernels the analysis phase must launch (the cuda. targets)
ANALYSIS_KERNELS = ("jacobi7_padded", "laplace6", "jacobi7_halo",
                    "jacobi7_halon", "mhd_substep_halo", "jacobi7_wrap",
                    "jacobi7_wrapn", "exchange_axis", "jacobi7_overlap")
ANALYSIS_B8_BF16 = "footprint:cuda.footprint.ops.cuda_stencil.laplace6_cuda[bf16]"


def run_analysis(torch) -> dict:
    """Phase 4, "analysis": every registered target of
    ``stencil_tpu_torch.analysis`` on this machine, the ``cuda.`` group
    on the card (the kernels' footprints, their builds' registers and
    spills, occupancy at the planned launches, donation and transfer on
    the wrap, pallas + PallasDMA and certified overlap paths). Fails on
    any error finding or any ``cuda.`` target skipped; one line a
    checker. The launch counts are set to 0 just before and read just
    after: every kernel of ``ANALYSIS_KERNELS`` must have launched."""
    from stencil_tpu_torch.analysis import CHECKERS, run_targets
    from stencil_tpu_torch.analysis.registry import (NO_COUNTERPART,
                                                     default_targets)

    for mod_counts in _launch_tables():
        for k in mod_counts:
            mod_counts[k] = 0
    t0 = time.perf_counter()
    targets = default_targets()
    report = run_targets(targets)
    seconds = time.perf_counter() - t0
    launches = all_launches()
    per = {}
    for c in CHECKERS:
        names = [t.name for t in targets if t.checker == c]
        errs = [f for f in report.errors if f.checker == c]
        warns = [f for f in report.warnings if f.checker == c]
        per[c] = {"targets": len(names), "errors": len(errs),
                  "warnings": len(warns),
                  "seconds": report.checker_seconds.get(c, 0.0),
                  "card_targets": sum(n.startswith("cuda.") for n in names)}
        log(f"  analysis {c}: {len(names)} targets "
            f"({per[c]['card_targets']} on the card), {len(errs)} errors, "
            f"{len(warns)} warnings, {per[c]['seconds']:.2f} s")
    for f in report.findings:
        log(f"  analysis {'ERROR' if f.severity == 'error' else 'warn '} "
            f"{f}")
    skipped = [k for k, m in report.metrics.items() if "skipped" in m]
    log(f"  analysis: {len(report.targets_checked)} targets "
        f"({len(NO_COUNTERPART)} JAX targets without a counterpart), "
        f"{len(report.errors)} errors, {len(report.warnings)} warnings, "
        f"{len(skipped)} skipped, in {seconds:.1f} s; launches {launches}")
    if report.errors or skipped:
        raise AssertionError(f"analysis: {len(report.errors)} errors, "
                             f"skipped {skipped}")
    idle = [k for k in ANALYSIS_KERNELS if not launches.get(k)]
    if idle:
        raise AssertionError(f"analysis: no launch of {idle}")
    occupancy = {k.split(":", 1)[1]: m for k, m in report.metrics.items()
                 if k.startswith("tiling:cuda.")}
    builds = {k.split(":", 1)[1]: m for k, m in report.metrics.items()
              if k.startswith("vmem:cuda.")}
    return {"seconds": seconds, "checkers": per, "launches": launches,
            "targets": len(report.targets_checked),
            "warnings": [str(f) for f in report.warnings],
            "b8_bf16_launches": report.metrics[ANALYSIS_B8_BF16][
                "probe_runs"],
            "occupancy": occupancy, "builds": builds}


def _launch_tables():
    from stencil_tpu_torch.ops import cuda_exchange as cx
    from stencil_tpu_torch.ops import cuda_halo as ch
    from stencil_tpu_torch.ops import cuda_mhd as cm
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
    from stencil_tpu_torch.ops import cuda_overlap as co
    from stencil_tpu_torch.ops import cuda_stencil as cs

    return [mod.LAUNCHES for mod in (cs, ch, co, cx, cm, mo)]


def timed_runs(m, k: int, reps: int = 3):
    """Iterations (steps) per second of ``reps`` host-clocked ``run(k)``
    of a warmed-up model, each ending in a synchronize: (all iterations
    over all their seconds, each run's rate). A stalled run counts in
    full: the host side of a path can stall, and that is the path's own
    cost."""
    secs = []
    for _ in range(reps):
        t0 = time.perf_counter()
        m.run(k)
        m.block()
        secs.append(time.perf_counter() - t0)
    return reps * k / sum(secs), [k / t for t in secs]


def time_mhd_halo(torch, cm, mo, ptxas) -> dict:
    """Phase 5, the Astaroth halo path: iterations/s of ``halo`` and
    ``halo`` + pair at 256 x 512 x 512 on (1,2,2) (four shards on the one
    card) and of ``halo`` at 256^3 on (1,1,1); one slab round (all 8
    fields of every shard) at radius R and 2R; B11 (each variant) and
    B12 on one 256^3 shard of that mesh, B11 also in turns with B9 and
    B13 on the same shard; B10 and B12 by device time alone beside the
    B9 and B11 launches they are made of, on that shard, and per kernel
    they launch."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams

    res = {"iters_per_s": {}, "slab_exchange_ms": {}}
    big = (N256, 2 * N256, 2 * N256)
    for label, size, mesh, pair, k in (
            ("halo 256x512x512 (1,2,2)", big, (1, 2, 2), "0", 10),
            ("halo+pair 256x512x512 (1,2,2)", big, (1, 2, 2), "1", 10),
            ("halo 256^3 (1,1,1)", (N256,) * 3, (1, 1, 1), "0", 20)):
        with mhd_pair(pair):
            m = Astaroth(*size, kernel="halo", mesh_shape=mesh,
                         devices=["cuda:0"] * (mesh[1] * mesh[2]))
        m.init()
        m.run(1)
        m.block()
        res["iters_per_s"][label], runs = timed_runs(m, k)
        res.setdefault("runs_iters_per_s", {})[label] = runs
        log(f"  Astaroth {label}: {res['iters_per_s'][label]!r} "
            f"iterations/s over three runs ({runs})")
        if pair == "0" and mesh != (1, 1, 1):
            for rr in (cm.R, 2 * cm.R):
                ms = 1e3 * m.slab_exchange_seconds(rr, reps=10)
                res["slab_exchange_ms"][f"{label} radius {rr}"] = ms
                log(f"  slab round, radius {rr}, {label}: {ms!r} ms "
                    f"(host clock)")
        del m
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(97531)
    shards, ws = mhd_mesh_case(torch, gen, (2 * N256, 2 * N256, N256),
                               (1, 2, 2))
    f, w = per_field(shards[0]), per_field(ws[0])
    sl3 = mhd_slabs(shards, (1, 2, 2), rz=3, ry=3)[0]
    sl6 = mhd_slabs(shards, (1, 2, 2), rz=6, ry=6)[0]
    del shards[1:], ws[1:]
    prm = MhdParams()
    dt = prm.dt
    Z = Y = X = N256
    pts = float(Z * Y * X)
    field = 4 * pts

    def slab_bytes(r):       # the slab rows a kernel reads, 8 fields
        return 8 * 4 * (2 * r * Y * X + 2 * (Z + 2 * r) * r * X)

    cases = {
        "B11 s=0 (w=None)": (
            lambda: cm.mhd_substep_halo_cuda(f, None, sl3, 0, prm, dt),
            lambda: cm.mhd_substep_halo_plain(f, None, sl3, 0, prm, dt),
            24 * field + slab_bytes(3), B9_FLOPS[0] * pts, 10),
        "B11 s=1": (
            lambda: cm.mhd_substep_halo_cuda(f, w, sl3, 1, prm, dt),
            lambda: cm.mhd_substep_halo_plain(f, w, sl3, 1, prm, dt),
            32 * field + slab_bytes(3), B9_FLOPS[1] * pts, 10),
        "B11 s=2 (write_w=False)": (
            lambda: cm.mhd_substep_halo_cuda(f, w, sl3, 2, prm, dt,
                                             write_w=False),
            lambda: cm.mhd_substep_halo_plain(f, w, sl3, 2, prm, dt,
                                              write_w=False),
            24 * field + slab_bytes(3), B9_FLOPS[2] * pts, 10),
        "mhd_substep01_halo": (
            lambda: cm.mhd_substep01_halo_cuda(f, sl6, prm, dt),
            lambda: cm.mhd_substep01_halo_plain(f, sl6, prm, dt),
            24 * field + slab_bytes(6), B10_FLOPS * pts, 5),
    }
    kernels = {}
    for name, (kern, plain, nbytes, flops, reps) in cases.items():
        ms = event_ms(torch, kern, reps=reps)
        plain_ms = event_ms(torch, plain, reps=2, warmup=1)
        bms, by = bound_ms(nbytes, flops)
        kernels[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                         "bound_by": by, "library_ms": None}
        log(f"  {name} (256^3 shard of the (1,2,2) mesh): {ms!r} ms/launch, "
            f"bound {bms!r} ms ({by}), {100 * bms / ms:.1f}% of bound; "
            f"plain twin {plain_ms!r} ms")
        torch.cuda.empty_cache()
    # B9, B11 and B13 (the shard as a (1,1,1) mesh: its rows go to
    # itself) on the same shard's fields, in turns (B9, B11, B13, B13,
    # B11, B9): all three are the ring kernel, over the whole shard (B9,
    # B11) or its interior (B13, after its sends)
    variants = {"s=0 (w=None)": (0, None, True),
                "s=1": (1, w, True), "s=2 (write_w=False)": (2, w, False)}
    res["b9_same_shard_ms"] = {}
    res["b13_same_shard_ms"] = {}
    b11 = []
    n_sms = cm.sm_count(shards[0].device)
    zrun = cm.ring_zrun(Z, Y, X, n_sms)
    zrun13 = cm.ring_zrun(Z - 2 * cm.R, Y - 2 * cm.R, X, n_sms)
    one = Dim3(1, 1, 1)
    recv = mo.MhdOverlapRecv([shards[0]], one)
    of = [per_field(torch.empty_like(shards[0]))]
    ow = [per_field(torch.empty_like(shards[0]))]
    for v, (s, w_in, write_w) in variants.items():
        def b9():
            return cm.mhd_substep_wrap_cuda(f, w_in, s, prm, dt,
                                            write_w=write_w)

        def b11_once():
            return cm.mhd_substep_halo_cuda(f, w_in, sl3, s, prm, dt,
                                            write_w=write_w)

        def b13():
            return mo.mhd_substep_overlap_cuda(
                [f], None if w_in is None else [w_in], s, prm, dt, one,
                write_w=write_w, out_f=of, out_w=ow if write_w else None,
                recv=recv)

        turns = [event_ms(torch, fn, reps=10)
                 for fn in (b9, b11_once, b13, b13, b11_once, b9)]
        res["b9_same_shard_ms"][v] = (turns[0] + turns[5]) / 2
        res["b13_same_shard_ms"][v] = (turns[2] + turns[3]) / 2
        entry = kernels.pop(f"B11 {v}")
        entry["b9_b11_b13_b13_b11_b9_ms"] = turns
        entry.update(ptxas.get(("mhd", s != 0, write_w), {}))
        entry["b13_ptxas"] = ptxas.get(("mhd_overlap", s != 0, write_w), {})
        log(f"  B11 {v} beside B9 and B13 on one 256^3 shard, in turns B9, "
            f"B11, B13, B13, B11, B9: {turns} ms (32 x {cm.RING_TILE_Y} "
            f"tiles, z runs of {zrun}; over B13's interior {zrun13}); ptxas "
            f"of the ring kernel in the B9/B11 library "
            f"{ {k: entry.get(k) for k in PTXAS_KEYS} }, in B13's "
            f"{entry['b13_ptxas']}")
        b11.append(entry)
    del recv, of, ow
    # B10 and B12 beside the launches they are made of, on the same
    # shard's fields, by device time alone (``device_ms``) and per kernel
    # they launch (``kernel_profile``): B10 is B9 s=0 then B9 s=1 (the
    # fields as a periodic field), B12 B11 s=0, the margin, B11 s=1
    from stencil_tpu_torch.utils.timers import kernel_profile

    res["pair_device_ms"] = dev = {}
    pair_fns = {
        "B9 s=0 (w=None)": lambda: cm.mhd_substep_wrap_cuda(f, None, 0, prm,
                                                            dt),
        "B9 s=1": lambda: cm.mhd_substep_wrap_cuda(f, w, 1, prm, dt),
        "B10": lambda: cm.mhd_substep01_wrap_cuda(f, prm, dt),
        "B11 s=0 (w=None)": lambda: cm.mhd_substep_halo_cuda(f, None, sl3, 0,
                                                             prm, dt),
        "B11 s=1": lambda: cm.mhd_substep_halo_cuda(f, w, sl3, 1, prm, dt),
        "B12": lambda: cm.mhd_substep01_halo_cuda(f, sl6, prm, dt)}
    for name, fn in pair_fns.items():
        dev[name] = device_ms(torch, fn, reps=10)
    for tag, name in (("B10", "mhd_substep01_wrap"),
                      ("B12", "mhd_substep01_halo")):
        split = kernel_profile(pair_fns[tag], 3)[0]
        res.setdefault("pair_kernels", {})[name] = split
        chain = (dev[f"{'B9' if tag == 'B10' else 'B11'} s=0 (w=None)"]
                 + dev[f"{'B9' if tag == 'B10' else 'B11'} s=1"])
        log(f"  {tag} on one 256^3 shard: device time alone {dev[tag]!r} ms "
            f"against its substeps launched alone {chain!r} ms; kernels a "
            f"call { {k: v['launches'] for k, v in split.items()} }, "
            f"{ {k: round(v['us'], 2) for k, v in split.items()} } us")
    kernels["mhd_substep01_halo"].update(
        device_ms=dev["B12"],
        design="B11 s=0 over the shard, substep 0 over the R rows around "
               "it (mhd_margin_kernel, from slabs of 2R rows), B11 s=1: "
               "three launches of the ring kernel, no window")
    kernels["mhd_substep_halo"] = {
        k: sum(v[k] for v in b11) / 3 for k in ("ms", "plain_ms", "bound_ms")}
    kernels["mhd_substep_halo"].update(
        bound_by=b11[1]["bound_by"], library_ms=None,
        zrun=zrun, variants=dict(zip(variants, b11)))
    del f, w, sl3, sl6, shards, ws
    torch.cuda.empty_cache()
    res["kernels"] = kernels
    return res


# ---------------------------------------------------------------------------
# the remote-write paths: B4 (Method.PallasDMA) and B7 (the overlap path)
# ---------------------------------------------------------------------------
#: cycles of ``torch.cuda._sleep`` queued on the delayed shard's stream
#: before each of its launches (about a millisecond at the H100's clock,
#: ten times a quarter shard's launch A)
DELAY_CYCLES = 2_000_000


B7_FNS = ("jacobi7_overlap_inner_launch", "jacobi7_overlap_faces_launch")
B13_B14_FNS = ("mhd_substep_overlap_launch", "mhd_substep_fixup_launch")


@contextlib.contextmanager
def delayed_shard(torch, shard: int, n_shards: int, cycles: int = DELAY_CYCLES,
                  fns=B7_FNS):
    """For the block, every launch ``fns`` (B7's launch A and launch B by
    default; a step launches the shards' A in mesh order, then their B)
    of mesh position ``shard`` waits ``cycles`` on its own stream before
    it starts, so that a missing ordering rule between the shards'
    streams shows as a wrong result."""
    from stencil_tpu_torch.ops import _build

    real = _build.launch
    calls = {fn: 0 for fn in fns}

    def launch(name, fn_name, *args):
        if fn_name in calls:
            if calls[fn_name] % n_shards == shard:
                torch.cuda._sleep(cycles)
            calls[fn_name] += 1
        return real(name, fn_name, *args)

    _build.launch = launch
    try:
        yield calls
    finally:
        _build.launch = real


@contextlib.contextmanager
def delayed_b4(torch, cycles: int = DELAY_CYCLES):
    """For the block, every B4 launch first waits ``cycles`` on its
    card's side stream, so that a missing join between that stream and
    the streams that read or write the halos shows as a wrong result.
    Yields the number of launches delayed so far (a one-item list)."""
    from stencil_tpu_torch.ops import cuda_exchange as cx

    real = cx._launch_card
    seen = [0]

    def launch(args, stream):
        with torch.cuda.stream(stream):
            torch.cuda._sleep(cycles)
        seen[0] += 1
        return real(args, stream)

    cx._launch_card = launch
    try:
        yield seen
    finally:
        cx._launch_card = real


def dma_shards(torch, gen, local_zyx, mesh, radius, dtype=None):
    """Random padded shards of an evenly divided grid over ``mesh`` on
    the card (halos random too)."""
    lo, hi = radius.pad_lo(), radius.pad_hi()
    Z, Y, X = local_zyx
    shape = (Z + lo.z + hi.z, Y + lo.y + hi.y, X + lo.x + hi.x)
    n = mesh[0] * mesh[1] * mesh[2]
    return [torch.rand(shape, generator=gen, device="cuda").to(
        dtype or torch.float32) for _ in range(n)]


def overlap_case(torch, gen, size_xyz, mesh):
    """Random (Z, Y, X) shards of an evenly divided grid over an
    x-unsharded mesh, their origins (z, y, x) and the grid's spheres."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.parallel.mesh import mesh_index

    X, Y, Z = size_xyz
    counts = Dim3(*mesh)
    lz, ly = Z // mesh[2], Y // mesh[1]
    shards = [torch.rand((lz, ly, X), generator=gen, device="cuda")
              for _ in range(counts.flatten())]
    origins = [(mesh_index(i, counts).z * lz, mesh_index(i, counts).y * ly, 0)
               for i in range(counts.flatten())]
    return shards, origins, spheres((Z, Y, X), widen=0 if X >= 64 else 2)


def compare_dma_overlap_kernels(torch, cx, co) -> dict:
    """Phase 3, B4 and B7 against their twins, bitwise: B4 sweep by sweep
    (kernel against ``exchange_axis_plain``, one launch per card and
    sweep, one-shard axes too; 1 and 8 quantities in one launch on
    (1,2,2) and (1,2,4), float32 and float64) and whole exchanges
    (``exchange_shard_cuda`` against the slab copy ``exchange_shard``) on
    (1,2,2) at 512^3 radius 1, on (2,2,2) with eight shards on the card
    (the x sweep remote too), on the 8-quantity radius-3 domain of 256 x
    512 x 512 over (1,2,2) through ``DistributedDomain.exchange``, and at
    small odd shapes in float64 and bfloat16 with an asymmetric radius;
    B7 (field and landed slabs) on the 512 x 256 x 256 quarter shards of
    (1,2,2), on one 512^3 shard, and at small shapes on (1,2,4) and (1,4,1)."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.parallel.cuda_exchange import exchange_shard_cuda
    from stencil_tpu_torch.parallel.exchange import exchange_shard

    gen = torch.Generator(device="cuda").manual_seed(7531)
    worst = {"exchange_axis": 0.0, "jacobi7_overlap": 0.0}

    def same(name, got, want, what):
        err = max(float((g.double() - w.double()).abs().max())
                  for g, w in zip(got, want))
        eq = all(torch.equal(g, w) for g, w in zip(got, want))
        log(f"  {what}: max |kernel - twin| = {err!r} "
            f"({'bitwise equal' if eq else 'DIFFERENT'})")
        if not eq:
            raise AssertionError(f"{what}: kernel disagrees with its twin")
        worst[name] = max(worst[name], err)

    n = N512
    r1 = Radius.constant(1)
    b4 = [("512^3 (1,2,2) r=1", (n, n // 2, n // 2), (1, 2, 2), r1, None),
          ("512^3 (2,2,2) r=1, eight shards", (n // 2,) * 3, (2, 2, 2), r1,
           None),
          ("(9, 6, 11) (2,2,2) asymmetric r, float64", (9, 6, 11),
           (2, 2, 2), asym_radius(), torch.float64),
          ("(9, 6, 11) (2,1,2) r=2, bfloat16", (9, 6, 11), (2, 1, 2),
           Radius.constant(2), torch.bfloat16)]
    def one_launch(before, what):
        got = cx.LAUNCHES["exchange_axis"] - before
        if got != 1:
            raise AssertionError(f"{what}: {got} B4 launches, not one per "
                                 f"card and sweep")

    for label, local, mesh, rad, dtype in b4:
        counts = Dim3(*mesh)
        shards = dma_shards(torch, gen, local, mesh, rad, dtype)
        for a in range(3):
            r_lo, r_hi = rad.face(a, -1), rad.face(a, 1)
            if r_lo == 0 and r_hi == 0:
                continue
            k = [t.clone() for t in shards]
            w = [t.clone() for t in shards]
            before = cx.LAUNCHES["exchange_axis"]
            cx.exchange_axis_cuda(k, a, r_lo, r_hi, counts)
            one_launch(before, f"B4 {label}, {'xyz'[a]} sweep")
            cx.exchange_axis_plain(w, a, r_lo, r_hi, counts)
            same("exchange_axis", k, w, f"B4 {label}, {'xyz'[a]} sweep")
        k = [t.clone() for t in shards]
        w = [t.clone() for t in shards]
        exchange_shard_cuda(k, rad, counts)
        exchange_shard(w, rad, counts)
        same("exchange_axis", k, w,
             f"B4 {label}, whole exchange vs the slab copy")
        del shards, k, w
    # 1 and 8 quantities in one launch per sweep, float32 and float64
    for mesh, local, n_q, dtype in (((1, 2, 2), (64, 40, 48), 8, None),
                                    ((1, 2, 4), (33, 20, 24), 8,
                                     torch.float64),
                                    ((1, 2, 4), (33, 20, 24), 1, None)):
        counts = Dim3(*mesh)
        rad = Radius.constant(3)
        fields = [dma_shards(torch, gen, local, mesh, rad, dtype)
                  for _ in range(n_q)]
        want = [[t.clone() for t in f] for f in fields]
        tag = f"B4 {n_q} quantities {local} {mesh} {dtype or torch.float32}"
        for a in range(3):
            before = cx.LAUNCHES["exchange_axis"]
            cx.start_sweeps(fields, [(a, 3, 3)], counts).exit()
            one_launch(before, f"{tag}, {'xyz'[a]} sweep")
            for f in want:
                cx.exchange_axis_plain(f, a, 3, 3, counts)
            for q in range(n_q):
                same("exchange_axis", fields[q], want[q],
                     f"{tag}, {'xyz'[a]} sweep, quantity {q}")
        del fields, want
    doms = []
    for method in (Method.PallasDMA, Method.PpermuteSlab):
        d = DistributedDomain(N256, 2 * N256, 2 * N256,
                              devices=["cuda:0"] * 4)
        d.set_radius(3)
        d.set_mesh_shape((1, 2, 2))
        d.set_methods(method)
        for q in range(8):
            d.add_data(f"q{q}")
        d.realize()
        doms.append(d)
    for q in doms[0].curr:
        for s0, s1 in zip(doms[0].curr[q], doms[1].curr[q]):
            s0.copy_(torch.rand(s0.shape, generator=gen, device="cuda"))
            s1.copy_(s0)
    for d in doms:
        d.exchange()
    for q in doms[0].curr:
        same("exchange_axis", doms[0].curr[q], doms[1].curr[q],
             f"B4 256x512x512 (1,2,2) r=3, quantity {q}: PallasDMA vs slab "
             f"exchange()")
    del doms
    torch.cuda.empty_cache()
    b7 = [((n, n, n), (1, 2, 2)), ((n, n, n), (1, 1, 1)),
          ((33, 32, 32), (1, 2, 4)), ((24, 8, 4), (1, 4, 1)),
          ((17, 6, 9), (1, 1, 1))]
    for size, mesh in b7:
        shards, origins, (hot, cold, r) = overlap_case(torch, gen, size, mesh)
        counts = Dim3(*mesh)
        out, recv = co.jacobi7_overlap_cuda(shards, origins, hot, cold, r,
                                            counts)
        new, slabs = co.jacobi7_overlap_plain(shards, origins, hot, cold, r,
                                              counts)
        same("jacobi7_overlap", out, new, f"B7 {size} mesh {mesh}, field")
        for k in co.SLAB_NAMES:
            same("jacobi7_overlap", [s[k] for s in recv.slabs],
                 [s[k] for s in slabs],
                 f"B7 {size} mesh {mesh}, landed {k} slabs")
        del shards, out, recv, new, slabs
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def run_overlap_paths(torch, cs, ch, cx, co) -> dict:
    """Phase 4, the remote-write paths through ``Jacobi3D`` at 512^3:
    ``overlap=True`` (kernel="auto" must take ``overlap``) on (1,2,2)
    with four shards on the card — 21 steps, 84 B7 launches and no other
    kernel — and on (1,1,1); each against the ``xla`` path on its mesh
    within ``steps * 8 * eps(f32)``, the (1,2,2) run also against the
    same run with one shard's stream delayed before each of its launches
    (bitwise); ``pallas`` with ``Method.PallasDMA`` (4 steps: 12 B4 — one
    per step, sweep and card — and 16 K3 launches) bitwise against
    ``pallas`` with the slab copy, and ``xla-overlap`` with ``PallasDMA``
    bitwise against the ``xla`` path and against itself with every B4
    launch delayed on its card's side stream."""
    import numpy as np

    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.jacobi import Jacobi3D

    eps = float(np.finfo(np.float32).eps)
    out = {"launches_by_run": {}}
    mods = (cs, ch, cx, co)

    def reset():
        for m in mods:
            m.reset_launch_counts()

    def counted():
        c = {}
        for m in mods:
            c.update(m.LAUNCHES)
        return c

    def model(kernel, mesh, **kw):
        j = Jacobi3D(N512, N512, N512, kernel=kernel, mesh_shape=mesh,
                     devices=["cuda:0"] * (mesh[1] * mesh[2] * mesh[0]),
                     **kw)
        j.init()
        j.block()
        return j

    def drive(label, j, steps, want):
        reset()
        j.run(steps)
        j.block()
        got = counted()
        log(f"  {label} run({steps}) launches: {got}")
        expect = {k: 0 for k in got}
        expect.update(want)
        if got != expect:
            raise AssertionError(f"{label} launched {got}, not {want}")
        out["launches_by_run"][label] = got
        t = gather(torch, j)
        if not bool(torch.isfinite(t).all()):
            raise AssertionError(f"{label}: non-finite values")
        return t

    def close(label, got, want, tol):
        err = float((got - want).abs().max())
        eq = bool(torch.equal(got, want))
        log(f"  {label}: max diff {err!r} "
            f"({'bitwise equal' if eq else 'not bitwise'}"
            f"{'' if tol == 0 else f'; tolerance {tol!r}'})")
        if (tol == 0 and not eq) or err > tol:
            raise AssertionError(f"{label}: disagrees")
        out[f"{label} max diff"] = err

    steps = 21
    for label, mesh in (("(1,2,2) on one card", (1, 2, 2)),
                        ("(1,1,1)", (1, 1, 1))):
        j = model("auto", mesh, overlap=True)
        if j.kernel_path != "overlap":
            raise AssertionError(f"overlap {label}: auto took "
                                 f"{j.kernel_path!r}")
        n_sh = mesh[1] * mesh[2]
        got = drive(f"overlap 512^3 {label}", j, steps,
                    {"jacobi7_overlap": n_sh * steps})
        del j
        x = model("xla", mesh)
        x.run(steps)
        ref = gather(torch, x)
        del x
        close(f"overlap 512^3 {label} vs xla after {steps} steps", got, ref,
              steps * 8 * eps)
        if mesh == (1, 2, 2):
            j = model("auto", mesh, overlap=True)
            with delayed_shard(torch, 3, n_sh) as calls:
                slow = drive(f"overlap 512^3 {label}, shard 3 delayed", j,
                             steps, {"jacobi7_overlap": n_sh * steps})
            log(f"  B7 launches seen while shard 3 was delayed before "
                f"each of its own: {dict(calls)}")
            if set(calls.values()) != {n_sh * steps}:
                raise AssertionError("the delay did not see every launch")
            del j
            close(f"overlap 512^3 {label}: delayed vs undelayed", slow, got,
                  0)
            del slow
        del got, ref
        torch.cuda.empty_cache()
    mesh = (1, 2, 2)
    runs = {}
    # B4: one launch per step (exchange), sweep (x, y, z) and card: 4 x 3
    for label, kernel, kw, want in (
            ("pallas + PallasDMA", "pallas",
             dict(methods=Method.PallasDMA),
             {"exchange_axis": 12, "jacobi7_padded": 16}),
            ("pallas + slab", "pallas", {}, {"jacobi7_padded": 16}),
            ("xla-overlap + PallasDMA", "xla",
             dict(methods=Method.PallasDMA, overlap=True),
             {"exchange_axis": 12}),
            ("xla-overlap + PallasDMA, B4 delayed", "xla",
             dict(methods=Method.PallasDMA, overlap=True),
             {"exchange_axis": 12}),
            ("xla + slab", "xla", {}, {})):
        j = model(kernel, mesh, **kw)
        if "delayed" in label:
            with delayed_b4(torch) as seen:
                runs[label] = drive(f"{label} 512^3 (1,2,2)", j, 4, want)
            if seen[0] != want["exchange_axis"]:
                raise AssertionError("the delay did not see every B4 launch")
        else:
            runs[label] = drive(f"{label} 512^3 (1,2,2)", j, 4, want)
        del j
        torch.cuda.empty_cache()
    close("pallas + PallasDMA vs pallas + slab, 4 steps",
          runs["pallas + PallasDMA"], runs["pallas + slab"], 0)
    close("xla-overlap + PallasDMA vs xla + slab, 4 steps",
          runs["xla-overlap + PallasDMA"], runs["xla + slab"], 0)
    close("xla-overlap + PallasDMA, every B4 launch delayed on its card's "
          "side stream, vs undelayed",
          runs["xla-overlap + PallasDMA, B4 delayed"],
          runs["xla-overlap + PallasDMA"], 0)
    del runs
    torch.cuda.empty_cache()
    main = out["launches_by_run"]
    out["launches"] = {
        "exchange_axis":
            main["pallas + PallasDMA 512^3 (1,2,2)"]["exchange_axis"],
        "jacobi7_overlap":
            main["overlap 512^3 (1,2,2) on one card"]["jacobi7_overlap"]}
    return out


def time_dma_overlap(torch, cx, co) -> dict:
    """Phase 5, the remote-write paths: B4 per sweep on the (1,2,2) mesh
    of 512^3 (z and y sweeps, radius 1, four shards) beside its twin and
    the same sweep by ``Tensor.copy_`` (``exchange_shard`` on that axis
    alone: the library call), and a z sweep of 8 fields of four 256^3
    shards at radius 3 beside 8 such ``copy_`` sweeps; a whole
    ``PallasDMA`` exchange on both beside the slab copy; B7 per step of
    the four 512 x 256 x 256
    quarter shards and of one 512^3 shard, beside its twin; ``overlap``
    steps/s at 512^3 on (1,2,2) and (1,1,1); one ``measure_overlap``
    line."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.apps import measure_overlap
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.parallel.cuda_exchange import exchange_shard_cuda
    from stencil_tpu_torch.parallel.exchange import (_single_axis_radius,
                                                     dispatch_exchange,
                                                     exchange_shard)

    res = {"steps_per_s": {}, "kernels": {}}
    n = N512
    for label, mesh in (("(1,2,2)", (1, 2, 2)), ("(1,1,1)", (1, 1, 1))):
        j = Jacobi3D(n, n, n, overlap=True, mesh_shape=mesh,
                     devices=["cuda:0"] * (mesh[1] * mesh[2]))
        j.init()
        j.run(2)
        j.block()
        res["steps_per_s"][label], runs = timed_runs(j, 40)
        res.setdefault("runs_steps_per_s", {})[label] = runs
        log(f"  Jacobi overlap 512^3 {label}: {res['steps_per_s'][label]!r} "
            f"steps/s over three runs ({runs})")
        del j
        torch.cuda.empty_cache()
    gen = torch.Generator(device="cuda").manual_seed(8642)
    r1 = Radius.constant(1)
    counts = Dim3(1, 2, 2)
    shards = dma_shards(torch, gen, (n, n // 2, n // 2), (1, 2, 2), r1)
    variants = {}
    for a in (2, 1):
        single = _single_axis_radius(r1, a)
        # each shard's two slabs of its padded cross section, read once
        # and written once
        dim = {1: 1, 2: 0}[a]
        cross = shards[0].numel() // shards[0].shape[dim]
        nbytes = 4 * len(shards) * 2 * 2 * cross
        ms = event_ms(torch, lambda: cx.exchange_axis_cuda(
            shards, a, 1, 1, counts), reps=20)
        plain_ms = event_ms(torch, lambda: cx.exchange_axis_plain(
            shards, a, 1, 1, counts), reps=20)
        lib_ms = event_ms(torch, lambda: exchange_shard(
            shards, single, counts, axis_order=(a,)), reps=20)
        bms, by = bound_ms(nbytes, 0)
        variants[f"{'xyz'[a]} sweep"] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": lib_ms, "bytes": nbytes}
        log(f"  exchange_axis {'xyz'[a]} sweep of four 512 x 256 x 256 "
            f"shards: {ms!r} ms, bound {bms!r} ms ({by}, {nbytes} B); "
            f"twin {plain_ms!r} ms; copy_ sweep {lib_ms!r} ms")
    # the whole PallasDMA exchange (three sweeps) beside the slab copy
    whole = {"Jacobi 512^3 (1,2,2) r=1": event_ms(
        torch, lambda: exchange_shard_cuda(shards, r1, counts), reps=20),
        "Jacobi slab copy": event_ms(
        torch, lambda: exchange_shard(shards, r1, counts), reps=20)}
    del shards
    torch.cuda.empty_cache()
    # 8 MHD fields of four 256^3 shards at radius 3: one z sweep (one
    # launch for all 32 shards of the 8 fields) beside 8 copy_ sweeps,
    # and the whole exchange beside the slab copy
    r3 = Radius.constant(3)
    fields = [dma_shards(torch, gen, (N256,) * 3, (1, 2, 2), r3)
              for _ in range(8)]
    single = _single_axis_radius(r3, 2)
    cross = fields[0][0].numel() // fields[0][0].shape[0]
    nbytes = 4 * 8 * len(fields[0]) * 2 * 2 * 3 * cross
    ms = event_ms(torch, lambda: cx.start_sweeps(fields, [(2, 3, 3)],
                                                 counts).exit(), reps=20)
    plain_ms = event_ms(torch, lambda: [cx.exchange_axis_plain(
        f, 2, 3, 3, counts) for f in fields], reps=5)
    lib_ms = event_ms(torch, lambda: [exchange_shard(
        f, single, counts, axis_order=(2,)) for f in fields], reps=5)
    bms, by = bound_ms(nbytes, 0)
    variants["z sweep, 8 MHD fields of four 256^3 shards, r=3"] = {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
        "library_ms": lib_ms, "bytes": nbytes}
    log(f"  exchange_axis z sweep of 8 fields x four 256^3 shards, r=3: "
        f"{ms!r} ms, bound {bms!r} ms ({by}, {nbytes} B); twin "
        f"{plain_ms!r} ms; 8 copy_ sweeps {lib_ms!r} ms")
    dmap = {f"q{q}": f for q, f in enumerate(fields)}
    whole["MHD 8 fields 256x512x512 (1,2,2) r=3"] = event_ms(
        torch, lambda: dispatch_exchange(dmap, r3, counts, Method.PallasDMA),
        reps=10)
    whole["MHD slab copy"] = event_ms(
        torch, lambda: dispatch_exchange(dmap, r3, counts,
                                         Method.PpermuteSlab), reps=3)
    log(f"  whole exchange, PallasDMA (B4) vs the slab copy: {whole} ms")
    res["whole_exchange_ms"] = whole
    res["kernels"]["exchange_axis"] = dict(variants["z sweep"],
                                           variants=variants)
    del fields, dmap
    torch.cuda.empty_cache()
    b7 = {}
    for label, mesh in (("four 512 x 256 x 256 shards of (1,2,2)",
                         (1, 2, 2)), ("one 512^3 shard", (1, 1, 1))):
        sh, orgs, (hot, cold, r) = overlap_case(torch, gen, (n, n, n), mesh)
        c = Dim3(*mesh)
        outs = [torch.empty_like(t) for t in sh]
        recv = co.OverlapRecv(sh, c)
        ms = event_ms(torch, lambda: co.jacobi7_overlap_cuda(
            sh, orgs, hot, cold, r, c, out=outs, recv=recv), reps=20)
        plain_ms = event_ms(torch, lambda: co.jacobi7_overlap_plain(
            sh, orgs, hot, cold, r, c), reps=3, warmup=1)
        pts = float(sum(t.numel() for t in sh))
        slab_pts = sum(2 * t.shape[1] * t.shape[2] + 2 * t.shape[0]
                       * t.shape[2] for t in sh)
        # each shard read once and written once, each slab written once
        # by its sender and read once by its receiver; 7 flops a point
        bms, by = bound_ms(4 * (2 * pts + 2 * slab_pts), 7 * pts)
        b7[label] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
                     "bound_by": by, "library_ms": None}
        log(f"  jacobi7_overlap, one step of {label}: {ms!r} ms, bound "
            f"{bms!r} ms ({by}), {100 * bms / ms:.1f}% of bound; plain twin "
            f"{plain_ms!r} ms")
        del sh, outs, recv
        torch.cuda.empty_cache()
    res["kernels"]["jacobi7_overlap"] = dict(
        b7["four 512 x 256 x 256 shards of (1,2,2)"], variants=b7)
    mo = measure_overlap.measure(n, n // 2, n // 2, iters=10,
                                 mesh_shape=(1, 2, 2), devices=["cuda:0"])
    res["measure_overlap"] = measure_overlap.csv_line(mo)
    log(f"  measure_overlap (1,2,2) on one card, {mo['fused_path']} vs "
        f"{mo['overlap_path']}: {res['measure_overlap']}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# the MHD overlap path: B13 (mhd_substep_overlap) and B14 (mhd_substep_fixup)
# ---------------------------------------------------------------------------
OVERLAP_VARIANTS = ((0, False, True, False), (1, True, True, False),
                    (2, True, False, False), (0, False, True, True))


def overlap_variant_tag(s, read_w, write_w, pair):
    if pair:
        return "pair"
    return (f"s={s}{'' if read_w else ' (w=None)'}"
            f"{'' if write_w else ' (write_w=False)'}")


def compare_mhd_overlap_kernels(torch, cm, mo) -> dict:
    """Phase 3, B13 and B14 against their twins per field within 64
    eps(f32) of the largest twin value (B13 at its interior points, its
    landed rows bitwise); B13's interior, and B14 after B13 everywhere,
    against B11 (B12 with the pair) on the same shards and rows bitwise,
    for every variant (s = 0 with w=None, s = 1, s = 2 with
    write_w=False, the pair), on (1,1,1), (1,1,2), (1,2,2) and (1,2,4)
    meshes of small shards (among them 24 x 8 x 24 shards: B14's y
    strips span 18 rows of z, Y = 8 and X below a 32-column tile), on
    four 104 x 128 x 96 shards of (1,2,2),
    whose interior's z the ring kernel splits into runs, the last one
    shorter, and on the four 256^3 shards of 256 x 512 x 512 over
    (1,2,2); there also a chain of
    substeps in one session with shard 3's stream delayed before each of
    its launches, bitwise equal to the undelayed chain. Returns the
    largest absolute difference per kernel."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams

    gen = torch.Generator(device="cuda").manual_seed(2468)
    worst = {"mhd_substep_overlap": 0.0, "mhd_substep_fixup": 0.0}
    dt = MHD_PATH_DT
    prm = MhdParams(dt=dt)
    cases = [((16, 8, 24), (1, 1, 1)), ((32, 8, 16), (1, 1, 2)),
             ((48, 48, 16), (1, 2, 2)), ((32, 32, 40), (1, 2, 4)),
             ((32, 16, 5), (1, 2, 4)), ((48, 16, 24), (1, 2, 2)),
             ((208, 256, 96), (1, 2, 2)),
             ((2 * N256, 2 * N256, N256), (1, 2, 2))]
    for size, mesh in cases:
        counts = Dim3(*mesh)
        shards, ws = mhd_mesh_case(torch, gen, size, mesh)
        f = [per_field(t) for t in shards]
        w = [per_field(t) for t in ws]
        Z, Y = shards[0].shape[1:3]
        for s, read_w, write_w, pair in OVERLAP_VARIANTS:
            tag = (f"{size} mesh {mesh} "
                   f"{overlap_variant_tag(s, read_w, write_w, pair)}")
            hr = mo.halo_rows(pair)
            w_in = w if read_w else None
            kf, kw, recv = mo.mhd_substep_overlap_cuda(
                f, w_in, s, prm, dt, counts, pair=pair, write_w=write_w)
            tf, tw, tsl = mo.mhd_substep_overlap_plain(
                f, w_in, s, prm, dt, counts, pair=pair, write_w=write_w)
            landed = recv.landed(hr)
            if not all(torch.equal(landed[i][q][k], tsl[i][q][k])
                       for i in range(len(f)) for q in FIELDS
                       for k in cm.SLAB_NAMES):
                raise AssertionError(f"B13 {tag}: landed rows differ from "
                                     f"the twin's")
            if pair:
                halo = [cm.mhd_substep01_halo_cuda(f[i], tsl[i], prm, dt)
                        for i in range(len(f))]
            else:
                halo = [cm.mhd_substep_halo_cuda(
                    f[i], None if w_in is None else w_in[i], tsl[i], s, prm,
                    dt, write_w=write_w) for i in range(len(f))]
            inner = mo.interior_region(Z, Y, pair)
            if inner is not None:
                z0, nz, y0, ny = inner
                cut = (slice(z0, z0 + nz), slice(y0, y0 + ny))

                def at(g):
                    return {f"{q} shard {i}": g[i][q][cut]
                            for i in range(len(f)) for q in FIELDS}

                e = check_fields(torch, at(kf), at(tf),
                                 f"B13 {tag}, f (interior)")
                if write_w:
                    e = max(e, check_fields(torch, at(kw), at(tw),
                                            f"B13 {tag}, w (interior)"))
                worst["mhd_substep_overlap"] = max(
                    worst["mhd_substep_overlap"], e)
                same = all(torch.equal(a, b) for a, b in zip(
                    at(kf).values(), at([h[0] for h in halo]).values()))
                if write_w:
                    same &= all(torch.equal(a, b) for a, b in zip(
                        at(kw).values(), at([h[1] for h in halo]).values()))
                log(f"  B13's interior vs {'B12' if pair else 'B11'}, {tag}: "
                    f"{'bitwise equal' if same else 'DIFFERENT'}")
                if not same:
                    raise AssertionError(f"B13's interior differs from "
                                         f"B11/B12 ({tag})")
            del tf, tw
            kf, kw = mo.mhd_substep_fixup_cuda(f, w_in, kf, kw, s, prm, dt,
                                               counts, recv, pair=pair)
            same = True
            tf, tw = {}, {}
            for i, (hf, hw) in enumerate(halo):
                if pair:
                    pf, pw = cm.mhd_substep01_halo_plain(f[i], tsl[i], prm, dt)
                else:
                    wi = None if w_in is None else w_in[i]
                    pf, pw = cm.mhd_substep_halo_plain(f[i], wi, tsl[i], s,
                                                       prm, dt,
                                                       write_w=write_w)
                same &= all(torch.equal(kf[i][q], hf[q]) for q in FIELDS)
                if write_w:
                    same &= all(torch.equal(kw[i][q], hw[q]) for q in FIELDS)
                tf.update({f"{q} shard {i}": v for q, v in pf.items()})
                if write_w:
                    tw.update({f"{q} shard {i}": v for q, v in pw.items()})
                del hf, hw, pf, pw
            every = {f"{q} shard {i}": kf[i][q]
                     for i in range(len(f)) for q in FIELDS}
            e = check_fields(torch, every, tf, f"B14 after B13 {tag} vs the "
                             f"B11/B12 twin, f")
            if write_w:
                every = {f"{q} shard {i}": kw[i][q]
                         for i in range(len(f)) for q in FIELDS}
                e = max(e, check_fields(torch, every, tw, f"B14 after B13 "
                                        f"{tag} vs the B11/B12 twin, w"))
            worst["mhd_substep_fixup"] = max(worst["mhd_substep_fixup"], e)
            del tf, tw, every
            log(f"  B14 after B13 vs {'B12' if pair else 'B11'}, {tag}: "
                f"{'bitwise equal' if same else 'DIFFERENT'}")
            if not same:
                raise AssertionError(f"B14 after B13 differs from B11/B12 "
                                     f"({tag})")
            del kf, kw, tsl, landed, recv, halo
        if mesh == (1, 2, 2) and size[0] == 2 * N256:
            chains = [overlap_chain(torch, mo, shards, counts, prm)]
            with delayed_shard(torch, 3, 4, fns=B13_B14_FNS) as calls:
                chains.append(overlap_chain(torch, mo, shards, counts, prm))
            same = all(torch.equal(a, b) for a, b in zip(*chains))
            log(f"  B13/B14 chain (s=0, 1, 2, pair) on the four 256^3 shards, "
                f"shard 3 delayed before each of its launches {dict(calls)}: "
                f"{'bitwise equal' if same else 'DIFFERENT'} to undelayed")
            if not same or set(calls.values()) != {16}:
                raise AssertionError("the delayed B13/B14 chain differs")
            del chains
        del shards, ws, f, w
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return worst


def overlap_chain(torch, mo, shards, counts, prm):
    """Substeps 0, 1, 2 and a pair pass of ``mhd_substep_overlap`` on
    copies of ``shards`` in one session; the final shards."""
    dt = prm.dt
    a = [t.clone() for t in shards]
    b = [torch.empty_like(t) for t in a]
    w1 = [torch.empty_like(t) for t in a]
    w2 = [torch.empty_like(t) for t in a]
    recv = mo.MhdOverlapRecv(a, counts)

    def v(ts):
        return None if ts is None else [per_field(t) for t in ts]

    with recv.session():
        for s, w_in, w_out in ((0, None, w1), (1, w1, w2), (2, w2, w1)):
            mo.mhd_substep_overlap(v(a), v(w_in), s, prm, dt, counts,
                                   out_f=v(b), out_w=v(w_out), recv=recv)
            a, b = b, a
        mo.mhd_substep_overlap(v(a), None, 0, prm, dt, counts, pair=True,
                               out_f=v(b), out_w=v(w2), recv=recv)
        a, b = b, a
    torch.cuda.synchronize()
    return a


def run_astaroth_overlap(torch, cs, cm, mo, cx, halo_state) -> dict:
    """Phase 4, the Astaroth ``halo-overlap`` path (B13/B14) at dt 1e-4
    through the model class: ``Astaroth(256, 512, 512, overlap=True)`` on
    (1,2,2), four 256^3 shards on the one card, where kernel="auto" must
    take ``halo-overlap``; run(2) launches B13 and B14 24 times each and
    nothing else (16 and 16 with the pair) and equals the ``halo`` runs
    of run_astaroth_halo bitwise (fields and carried w); the same with
    shard 3's stream delayed before each of its launches; 256^3 on
    (1,1,1) with overlap=True (6 + 6 launches; 4 + 4 with the pair)
    bitwise equal to ``wrap`` (which equals ``halo`` and ``halo``+pair
    there); and the ``xla-overlap`` path with ``Method.PallasDMA`` (B4: one launch
    per substep, sweep and card, 18) on a small (1,2,2) mesh against
    ``xla`` within substeps x 64 eps x max, and bitwise against itself
    with every B4 launch delayed on its card's side stream."""
    from stencil_tpu_torch import Method
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams

    prm = MhdParams(dt=MHD_PATH_DT)
    out = {"launches_by_run": {}}
    mods = (cs, cm, mo, cx)

    def counted():
        c = {}
        for m in mods:
            c.update(m.LAUNCHES)
        return c

    def drive(label, size, mesh, pair, want, kernel="auto", overlap=True,
              methods=Method.PpermutePacked, delay=False):
        with mhd_pair(pair):
            m = Astaroth(*size, params=prm, kernel=kernel, overlap=overlap,
                         mesh_shape=mesh, methods=methods,
                         devices=["cuda:0"] * (mesh[1] * mesh[2]))
        m.init()
        m.block()
        for mod in mods:
            mod.reset_launch_counts()
        if delay:
            with delayed_shard(torch, 3, 4, fns=B13_B14_FNS) as calls:
                m.run(2)
                m.block()
            log(f"  launches seen while shard 3 was delayed: {dict(calls)}")
        else:
            m.run(2)
            m.block()
        got = counted()
        expect = dict({k: 0 for k in got}, **want)
        log(f"  Astaroth {label} ({m.kernel_path}) run(2) launches: "
            f"{ {k: v for k, v in got.items() if v} }")
        if got != expect:
            raise AssertionError(f"{label} launched {got}, not {want}")
        out["launches_by_run"][label] = got
        state = ({q: torch.from_numpy(m.field(q)) for q in FIELDS},
                 {q: torch.from_numpy(m.accumulator(q)) for q in FIELDS})
        path = m.kernel_path
        del m
        torch.cuda.empty_cache()
        return path, state

    def bitwise(label, got, want):
        same = all(torch.equal(got[0][q], want[0][q])
                   and torch.equal(got[1][q], want[1][q]) for q in FIELDS)
        err = max(float((got[j][q] - want[j][q]).abs().max())
                  for j in (0, 1) for q in FIELDS)
        log(f"  {label}: max diff {err!r} "
            f"({'bitwise equal' if same else 'DIFFERENT'})")
        if not same:
            raise AssertionError(f"{label}: not bitwise equal")
        out[f"{label} bitwise"] = same

    big = (N256, 2 * N256, 2 * N256)
    for pair, n13 in (("0", 24), ("1", 16)):
        label = f"halo-overlap 256x512x512 (1,2,2){' pair' if pair == '1' else ''}"
        want = {"mhd_substep_overlap": n13, "mhd_substep_fixup": n13}
        path, got = drive(label, big, (1, 2, 2), pair, want)
        if path != "halo-overlap":
            raise AssertionError(f"{label}: auto took {path!r}")
        bitwise(f"{label} vs halo after 2 iterations", got, halo_state[pair])
        if pair == "0":
            _, slow = drive(label + ", shard 3 delayed", big, (1, 2, 2), pair,
                            want, delay=True)
            bitwise(f"{label}: delayed vs undelayed", slow, got)
            del slow
        del got
    cube = (N256,) * 3
    _, got = drive("halo-overlap 256^3 (1,1,1)", cube, (1, 1, 1), "0",
                   {"mhd_substep_overlap": 6, "mhd_substep_fixup": 6})
    _, ref = drive("wrap 256^3 (1,1,1)", cube, (1, 1, 1), "0",
                   {"mhd_substep_wrap": 6}, kernel="wrap", overlap=False)
    bitwise("halo-overlap 256^3 (1,1,1) vs wrap after 2 iterations", got, ref)
    del got
    # with the pair: wrap (= halo = halo+pair on one shard, phase 4 above)
    _, got = drive("halo-overlap+pair 256^3 (1,1,1)", cube, (1, 1, 1), "1",
                   {"mhd_substep_overlap": 4, "mhd_substep_fixup": 4})
    bitwise("halo-overlap+pair 256^3 (1,1,1) vs wrap (= halo+pair) after 2 "
            "iterations", got, ref)
    del got, ref
    small = (32, 32, 48)
    # B4: one launch per exchange, sweep and card: 3 substeps x 2
    # iterations x 3 sweeps (x, y, z) x 1 card, all 8 fields and 4 shards
    # in each launch
    b4 = {"exchange_axis": 3 * 2 * 3}
    _, xo = drive("xla-overlap + PallasDMA 32x32x48 (1,2,2)", small, (1, 2, 2),
                  "0", b4, kernel="xla", methods=Method.PallasDMA)
    with delayed_b4(torch) as seen:
        _, slow = drive("xla-overlap + PallasDMA 32x32x48 (1,2,2), B4 "
                        "delayed", small, (1, 2, 2), "0", b4, kernel="xla",
                        methods=Method.PallasDMA)
    log(f"  B4 launches delayed on the card's side stream: {seen[0]}")
    if seen[0] != b4["exchange_axis"]:
        raise AssertionError("the delay did not see every B4 launch")
    bitwise("xla-overlap + PallasDMA: B4 delayed vs undelayed", slow, xo)
    del slow
    _, xl = drive("xla 32x32x48 (1,2,2)", small, (1, 2, 2), "0", {},
                  kernel="xla", overlap=False)
    out["xla_overlap_dma_vs_xla_max_diff"] = check_fields(
        torch, xo[0], xl[0], "xla-overlap + PallasDMA vs xla after 2 "
        "iterations, f", factor=6 * 64.0)
    main = out["launches_by_run"]
    out["launches"] = {
        k: main["halo-overlap 256x512x512 (1,2,2)"][k]
        for k in ("mhd_substep_overlap", "mhd_substep_fixup")}
    return out


def time_mhd_overlap(torch, cm, mo) -> dict:
    """Phase 5, the Astaroth halo-overlap path: iterations/s at 256 x 512
    x 512 on (1,2,2) (four shards on the one card) and at 256^3 on
    (1,1,1), with and without the pair; B13 and B14 (each variant) on one
    256^3 shard (a (1,1,1) mesh: its rows go to itself) and per substep of
    the four shards of (1,2,2), beside their twins; one
    ``measure_overlap --model mhd`` line at 256^3 per shard on (1,2,2)."""
    from stencil_tpu_torch.apps import measure_overlap
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams
    from stencil_tpu_torch.utils.timers import kernel_profile

    res = {"iters_per_s": {}, "kernels": {}}
    big = (N256, 2 * N256, 2 * N256)
    for label, size, mesh, pair, k in (
            ("halo-overlap 256x512x512 (1,2,2)", big, (1, 2, 2), "0", 10),
            ("halo-overlap+pair 256x512x512 (1,2,2)", big, (1, 2, 2), "1",
             10),
            ("halo-overlap 256^3 (1,1,1)", (N256,) * 3, (1, 1, 1), "0", 20),
            ("halo-overlap+pair 256^3 (1,1,1)", (N256,) * 3, (1, 1, 1), "1",
             20)):
        with mhd_pair(pair):
            m = Astaroth(*size, kernel="halo", overlap=True, mesh_shape=mesh,
                         devices=["cuda:0"] * (mesh[1] * mesh[2]))
        m.init()
        m.run(1)
        m.block()
        res["iters_per_s"][label], runs = timed_runs(m, k)
        res.setdefault("runs_iters_per_s", {})[label] = runs
        log(f"  Astaroth {label}: {res['iters_per_s'][label]!r} iterations/s "
            f"over three runs ({runs})")
        del m
        torch.cuda.empty_cache()

    gen = torch.Generator(device="cuda").manual_seed(13579)
    prm = MhdParams()
    dt = prm.dt
    n = N256
    field = 4.0 * n ** 3
    variants = {}
    for mesh, size in (((1, 1, 1), (n, n, n)), ((1, 2, 2), (2 * n, 2 * n, n))):
        counts = Dim3(*mesh)
        shards, ws = mhd_mesh_case(torch, gen, size, mesh)
        f = [per_field(t) for t in shards]
        w = [per_field(t) for t in ws]
        of = [per_field(torch.empty_like(t)) for t in shards]
        ow = [per_field(torch.empty_like(t)) for t in shards]
        recv = mo.MhdOverlapRecv(shards, counts)
        Z = Y = X = n
        for s, read_w, write_w, pair in OVERLAP_VARIANTS:
            tag = overlap_variant_tag(s, read_w, write_w, pair)
            hr = mo.halo_rows(pair)
            w_in = w if read_w else None
            w_out = ow if write_w else None

            def b13():
                mo.mhd_substep_overlap_cuda(f, w_in, s, prm, dt, counts,
                                            pair=pair, write_w=write_w,
                                            out_f=of, out_w=w_out, recv=recv)

            def b14():
                mo.mhd_substep_fixup_cuda(f, w_in, of, w_out, s, prm, dt,
                                          counts, recv, pair=pair)

            b13()
            reps = 3 if pair else 10
            ms13 = event_ms(torch, b13, reps=reps)
            ms14 = event_ms(torch, b14, reps=reps)
            # the host work shows by events: B14's device time, apart,
            # and the device time of each kernel it launches (B13's too)
            dev14 = device_ms(torch, b14, reps=reps)
            split14 = kernel_profile(b14, reps)[0]
            dev13 = device_ms(torch, b13, reps=reps)
            split13 = kernel_profile(b13, reps)[0]
            # the work of one shard, as b13_bytes and b14_bytes count it
            pts = float(Z * Y * X)
            inner = mo.interior_region(Z, Y, pair)
            p_in = float(inner[1] * inner[3] * X) if inner else 0.0
            p_sh = pts - p_in
            flops = B10_FLOPS if pair else B9_FLOPS[s]
            per = len(shards)
            nb13 = per * b13_bytes((Z, Y, X), read_w, write_w, pair)
            nb14 = per * b14_bytes((Z, Y, X), read_w, write_w, pair)
            bm13, by13 = bound_ms(nb13, per * flops * p_in)
            bm14, by14 = bound_ms(nb14, per * flops * p_sh)
            if mesh == (1, 1, 1):
                plain13 = event_ms(torch, lambda: mo.mhd_substep_overlap_plain(
                    f, w_in, s, prm, dt, counts, pair=pair,
                    write_w=write_w), reps=1, warmup=1)
                plain14 = event_ms(torch, lambda: mo.mhd_substep_fixup_plain(
                    f, w_in, of, w_out, recv.landed(hr), s, prm, dt,
                    pair=pair), reps=1, warmup=1)
            else:
                plain13 = plain14 = None
            where = ("one 256^3 shard" if mesh == (1, 1, 1)
                     else "four 256^3 shards of (1,2,2)")
            for name, ms, plain, bms, by, nb, dev, split in (
                    ("mhd_substep_overlap", ms13, plain13, bm13, by13, nb13,
                     dev13, split13),
                    ("mhd_substep_fixup", ms14, plain14, bm14, by14, nb14,
                     dev14, split14)):
                variants.setdefault(name, {})[f"{tag}, {where}"] = {
                    "ms": ms, "plain_ms": plain, "bound_ms": bms,
                    "bound_by": by, "library_ms": None, "bytes": nb,
                    "device_ms": dev, "kernel_us": split}
                log(f"  {name} {tag}, {where}: {ms!r} ms, bound {bms!r} ms "
                    f"({by}), {100 * bms / ms:.1f}% of bound; plain twin "
                    f"{plain!r} ms; device time alone {dev!r} ms "
                    f"({100 * bms / dev:.1f}% of bound); kernels {split}")
        del shards, ws, f, w, of, ow, recv
        torch.cuda.empty_cache()
    for name, v in variants.items():
        one = [v[f"{overlap_variant_tag(*var)}, one 256^3 shard"]
               for var in OVERLAP_VARIANTS[:3]]
        res["kernels"][name] = {k: sum(x[k] for x in one) / 3
                                for k in ("ms", "plain_ms", "bound_ms")}
        res["kernels"][name].update(bound_by=one[1]["bound_by"],
                                    library_ms=None, variants=v)
        res["kernels"][name]["device_ms"] = sum(
            x["device_ms"] for x in one) / 3
    # B14's design and its blocks an SM as the card counts them (kernels
    # line); its launch plan on a 256^3 shard, computed, goes to the log
    # and chip_smoke.json, and must count as many blocks an SM
    card_bps = mo.fixup_occupancy(torch.device("cuda"))
    res["kernels"]["mhd_substep_overlap"]["design"] = (
        "the sends (send_rows_kernel), then the ring kernel over the "
        "interior from the shard alone; pair: substep 0 over [R, n - R) "
        "into the shard's scratch f1, w1, then substep 1 over [kT, n - kT) "
        "from them (two ring launches)")
    res["kernels"]["mhd_substep_fixup"].update(
        design="one substep: one launch a shard of the ring kernel "
               "(mhd_shell_kernel), z strips walked in z and y strips in "
               "y, margin rows from the shard and the landed rows, no "
               "scratch; pair: the shell kernel's substep 0 at depth R "
               "into f1, w1, the margin kernel (substep 0 around the "
               "shard), the shell kernel's substep 1 at depth kT",
        blocks_per_sm=card_bps)
    shell = mo.fixup_plan(n, n, n, False).shell
    n_sms = cm.sm_count(torch.device("cuda"))
    blocks = shell.grid[0] * shell.grid[1]
    res["fixup_plan_256"] = dict(
        shell._asdict(), grid=list(shell.grid), blocks=blocks,
        planned_blocks_per_sm=mo.FIXUP_BLOCKS_PER_SM,
        card_blocks_per_sm=card_bps, sms=n_sms,
        waves=blocks / (n_sms * card_bps))
    log(f"  B14's plan on a 256^3 shard: {res['fixup_plan_256']}")
    if card_bps != mo.FIXUP_BLOCKS_PER_SM:
        raise AssertionError(f"B14: the card holds {card_bps} blocks an SM, "
                             f"the plan counts {mo.FIXUP_BLOCKS_PER_SM}")
    # one halo-overlap iteration on the four shards beside the kernels'
    # CUDA-event times per substep of the four (s = 0, 1, 2), summed: what
    # is left of the iteration is the host's
    label = "halo-overlap 256x512x512 (1,2,2)"
    it_ms = 1e3 / res["iters_per_s"][label]
    split = {"iteration_ms": it_ms,
             "fastest_run_iteration_ms": 1e3 / max(
                 res["runs_iters_per_s"][label])}
    for name in ("mhd_substep_overlap", "mhd_substep_fixup"):
        split[name] = sum(
            variants[name][f"{overlap_variant_tag(*var)}, four 256^3 "
                           f"shards of (1,2,2)"]["ms"]
            for var in OVERLAP_VARIANTS[:3])
    split["mhd_substep_fixup_device"] = sum(
        variants["mhd_substep_fixup"][f"{overlap_variant_tag(*var)}, four "
                                      f"256^3 shards of (1,2,2)"]["device_ms"]
        for var in OVERLAP_VARIANTS[:3])
    res["iteration_ms"] = split
    log(f"  {label}: {it_ms!r} ms an iteration (pooled; fastest run "
        f"{split['fastest_run_iteration_ms']!r}), against B13's "
        f"{split['mhd_substep_overlap']!r} ms and B14's "
        f"{split['mhd_substep_fixup']!r} ms (three substeps of the four "
        f"shards, each timed alone; B14's device time alone "
        f"{split['mhd_substep_fixup_device']!r} ms)")
    mo_res = measure_overlap.measure_mhd(n, n, n, iters=5,
                                         mesh_shape=(1, 2, 2),
                                         devices=["cuda:0"])
    res["measure_overlap_mhd"] = measure_overlap.csv_line(
        mo_res, "measure_overlap_mhd")
    log(f"  measure_overlap --model mhd (1,2,2) on one card, "
        f"{mo_res['fused_path']} vs {mo_res['overlap_path']}: "
        f"{res['measure_overlap_mhd']}")
    torch.cuda.empty_cache()
    return res


# ---------------------------------------------------------------------------
# bfloat16 storage on the MHD ring kernels (B9-B14), the MHD temporal path
# (exchange_every >= 2 on xla) and Boundary.NONE
# ---------------------------------------------------------------------------
#: one bfloat16 ulp of a value's magnitude, relative: 8 significant bits
BF16_ULP = 2.0 ** -7
#: the bf16 launch families and the float32 wrapper name each extends
BF16_NAMES = ("mhd_substep_wrap", "mhd_substep01_wrap", "mhd_substep_halo",
              "mhd_substep01_halo", "mhd_substep_overlap",
              "mhd_substep_fixup")
# (Z, Y, X) of the bf16 kernel checks: a 16-row sub-tile (x below one
# 32-column tile), an odd x, the full 256^3
BF16_SHAPES = [(16, 16, 24), (32, 16, 33), (N256,) * 3]
# global (Z, Y, X) over (1,2,2): 16 x 16 x 40 and 16 x 32 x 33 shards,
# and the four 256^3 shards of Astaroth(256, 512, 512)
BF16_MESHES = [(32, 32, 40), (32, 64, 33), (2 * N256, 2 * N256, N256)]


def bf16_of(torch, d):
    return {q: t.to(torch.bfloat16) for q, t in d.items()}


def f32_of(d):
    return None if d is None else {q: t.float() for q, t in d.items()}


def check_bf16(torch, got: dict, want: dict, what: str,
               ulps: float = 1.0) -> float:
    """Per field: bfloat16, finite, max |got - want| <= ulps * 2^-7 *
    max |want| (one bf16 ulp of the largest value a substep), with the
    share of elements that differ logged. Returns the largest absolute
    difference."""
    worst = 0.0
    differ = total = 0
    for q, t in want.items():
        g = got[q]
        if (g.dtype != torch.bfloat16 or g.shape != t.shape
                or not bool(torch.isfinite(g).all())):
            raise AssertionError(f"{what} {q}: not finite bfloat16 of the "
                                 f"twin's shape")
        d = (g.float() - t.float()).abs()
        err = float(d.max())
        scale = float(t.float().abs().max())
        if err > ulps * BF16_ULP * scale:
            raise AssertionError(f"{what} {q}: max |diff| {err!r} > {ulps:g}"
                                 f" x 2^-7 x {scale!r}")
        worst = max(worst, err)
        differ += int((d > 0).sum())
        total += d.numel()
    log(f"  {what}: max |diff| {worst!r} (tolerance {ulps:g} bf16 ulp of "
        f"max a field), {differ / total:.3%} of the elements differ")
    return worst


def same_as_widened(torch, got, want32, what: str) -> None:
    """A bf16 launch's (fields, w) against the float32 instance's on the
    widened inputs, rounded once to bfloat16: bit for bit."""
    gf, gw = got
    wf, ww = want32
    rounded = (bf16_of(torch, wf), None if ww is None else bf16_of(torch, ww))
    same = same_bits(torch, (gf, gw), rounded)
    if not same:
        n = sum(int((gf[q] != rounded[0][q]).sum()) for q in gf)
        log(f"  {what} vs the float32 instance rounded once: {n} elements "
            f"DIFFER")
        raise AssertionError(f"{what}: not the float32 instance rounded "
                             f"once")
    log(f"  {what} vs the float32 instance on the widened inputs, rounded "
        f"once: bitwise equal")


def compare_mhd_bf16_kernels(torch, cm, mo) -> dict:
    """Phase 3, bfloat16 storage: B9 (s = 0 w=None, 1, 2 write_w=False)
    and B10 at ``BF16_SHAPES``, B11 (each s), B12 and B13 + B14 (each s
    and the pair, through ``mhd_substep_overlap``) on the (1,2,2) meshes
    of ``BF16_MESHES``, each against its plain twin on the same bf16
    inputs within one bf16 ulp of the largest twin value a field
    (``check_bf16``), and against the float32 instance on the widened
    inputs rounded once, bitwise. Returns the largest absolute
    difference from the twin per family."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import FIELDS, MhdParams

    gen = torch.Generator(device="cuda").manual_seed(1616)
    prm = MhdParams(dt=MHD_PATH_DT)
    dt = prm.dt
    worst = {name: 0.0 for name in BF16_NAMES}
    subs = ((0, False, True), (1, True, True), (2, True, False))
    for shape in BF16_SHAPES:
        f32, w32 = mhd_state(torch, shape, gen)
        f, w = bf16_of(torch, f32), bf16_of(torch, w32)
        fw, ww = f32_of(f), f32_of(w)
        for s, read_w, write_w in subs:
            tag = f"B9 bf16 s={s} {shape}"
            got = cm.mhd_substep_wrap_cuda(f, w if read_w else None, s, prm,
                                           dt, write_w=write_w)
            tw = cm.mhd_substep_wrap_plain(f, w if read_w else None, s, prm,
                                           dt, write_w=write_w)
            e = check_bf16(torch, got[0], tw[0], tag + " f vs twin")
            if write_w:
                e = max(e, check_bf16(torch, got[1], tw[1],
                                      tag + " w vs twin"))
            worst["mhd_substep_wrap"] = max(worst["mhd_substep_wrap"], e)
            same_as_widened(torch, got, cm.mhd_substep_wrap_cuda(
                fw, ww if read_w else None, s, prm, dt, write_w=write_w), tag)
            del got, tw
        tag = f"B10 bf16 {shape}"
        got = cm.mhd_substep01_wrap_cuda(f, prm, dt)
        tw = cm.mhd_substep01_wrap_plain(f, prm, dt)
        e = max(check_bf16(torch, got[0], tw[0], tag + " f vs twin"),
                check_bf16(torch, got[1], tw[1], tag + " w vs twin"))
        worst["mhd_substep01_wrap"] = max(worst["mhd_substep01_wrap"], e)
        same_as_widened(torch, got, cm.mhd_substep01_wrap_cuda(fw, prm, dt),
                        tag)
        del f32, w32, f, w, fw, ww, got, tw
        torch.cuda.empty_cache()
    mesh = (1, 2, 2)
    counts = Dim3(*mesh)
    for size in BF16_MESHES:
        s32, w32s = mhd_mesh_case(torch, gen, size, mesh)
        shards = [t.to(torch.bfloat16) for t in s32]
        wsh = [t.to(torch.bfloat16) for t in w32s]
        del s32, w32s
        f = [per_field(t) for t in shards]
        w = [per_field(t) for t in wsh]
        fw = [f32_of(x) for x in f]
        ww = [f32_of(x) for x in w]
        sl3 = mhd_slabs(shards, mesh, rz=3, ry=3)
        sl6 = mhd_slabs(shards, mesh, rz=6, ry=6)
        sl3w = mhd_slabs([t.float() for t in shards], mesh, rz=3, ry=3)
        sl6w = mhd_slabs([t.float() for t in shards], mesh, rz=6, ry=6)
        big = size[0] == 2 * N256
        # B11 and B12: shard 0 on the 256^3 mesh, every shard else
        for i in (range(1) if big else range(len(f))):
            for s, read_w, write_w in subs:
                tag = f"B11 bf16 s={s} {size} {mesh} shard {i}"
                wi = w[i] if read_w else None
                got = cm.mhd_substep_halo_cuda(f[i], wi, sl3[i], s, prm, dt,
                                               write_w=write_w)
                tw = cm.mhd_substep_halo_plain(f[i], wi, sl3[i], s, prm, dt,
                                               write_w=write_w)
                e = check_bf16(torch, got[0], tw[0], tag + " f vs twin")
                if write_w:
                    e = max(e, check_bf16(torch, got[1], tw[1],
                                          tag + " w vs twin"))
                worst["mhd_substep_halo"] = max(worst["mhd_substep_halo"], e)
                same_as_widened(torch, got, cm.mhd_substep_halo_cuda(
                    fw[i], ww[i] if read_w else None, sl3w[i], s, prm, dt,
                    write_w=write_w), tag)
                del got, tw
            tag = f"B12 bf16 {size} {mesh} shard {i}"
            got = cm.mhd_substep01_halo_cuda(f[i], sl6[i], prm, dt)
            tw = cm.mhd_substep01_halo_plain(f[i], sl6[i], prm, dt)
            e = max(check_bf16(torch, got[0], tw[0], tag + " f vs twin"),
                    check_bf16(torch, got[1], tw[1], tag + " w vs twin"))
            worst["mhd_substep01_halo"] = max(worst["mhd_substep01_halo"], e)
            same_as_widened(torch, got, cm.mhd_substep01_halo_cuda(
                fw[i], sl6w[i], prm, dt), tag)
            del got, tw
        # B13 + B14 over the mesh, each substep and the pair
        for s, read_w, write_w, pair in OVERLAP_VARIANTS:
            var = overlap_variant_tag(s, read_w, write_w, pair)
            tag = f"B13+B14 bf16 {var} {size} {mesh}"
            wi = w if read_w else None
            gf, gw, _ = mo.mhd_substep_overlap(f, wi, s, prm, dt, counts,
                                               pair=pair, write_w=write_w)
            kf, kw, _ = mo.mhd_substep_overlap(fw, ww if read_w else None,
                                               s, prm, dt, counts, pair=pair,
                                               write_w=write_w)
            sl = sl6 if pair else sl3
            for i in range(len(f)):
                if pair:
                    tw = cm.mhd_substep01_halo_plain(f[i], sl[i], prm, dt)
                else:
                    tw = cm.mhd_substep_halo_plain(
                        f[i], None if wi is None else wi[i], sl[i], s, prm,
                        dt, write_w=write_w)
                got = (gf[i], None if gw is None else gw[i])
                e = check_bf16(torch, got[0], tw[0],
                               f"{tag} shard {i} f vs the B11/B12 twin")
                if write_w:
                    e = max(e, check_bf16(torch, got[1], tw[1],
                                          f"{tag} shard {i} w vs the "
                                          f"B11/B12 twin"))
                for name in ("mhd_substep_overlap", "mhd_substep_fixup"):
                    worst[name] = max(worst[name], e)
                same_as_widened(torch, got,
                                (kf[i], None if kw is None else kw[i]),
                                f"{tag} shard {i}")
                del tw, got
            del gf, gw, kf, kw
        del shards, wsh, f, w, fw, ww, sl3, sl6, sl3w, sl6w
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return worst


def seed_state(torch, m, ref) -> None:
    """Start model ``m`` from model ``ref``'s fields, copied on the card
    interior to interior (both on the same mesh and dtype, allocation
    pads may differ): the host's ``init()`` of a 256 x 512 x 512 grid
    takes seconds a model. Accumulators start at zero, as after
    ``init()``."""
    ref.sync_domain()
    m.sync_domain()
    src, dst = ref._capacity(), m._capacity()
    for q, shards in ref.dd.curr.items():
        for a, b in zip(m.dd.curr[q], shards):
            a.zero_()
            a[dst].copy_(b[src])
    m._w = None
    m._inner = None


def state_of(torch, m) -> tuple:
    """(fields, w) of a model on the card: every shard's interior per
    field, keyed "q shard i" (the temporal path's w ring stripped), as
    float32 copies (a bf16 model's values exactly)."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    m.sync_domain()
    cap = m._capacity()
    wcap = cap if m._w_padded else (slice(None),) * 3
    f = {f"{q} shard {i}": t[cap].float().clone()
         for q in FIELDS for i, t in enumerate(m.dd.curr[q])}
    w = ({f"{q} shard {i}": wi[q][wcap].float().clone()
          for q in FIELDS for i, wi in enumerate(m._w)}
         if m._w is not None else None)
    return f, w


def run_astaroth_bf16(torch, cs, cm, mo) -> dict:
    """Phase 4, bfloat16 storage through the model class at dt 1e-4, each
    run ``run(2)`` with the launch counts set to 0 just before it and
    read just after: ``Astaroth(256, 256, 256, bfloat16)`` (auto must
    take ``wrap``: 6 B9 launches; with the pair 2 B10 and 2 B9), ``halo``
    on it as a (1,1,1) mesh (6 B11) bitwise equal to ``wrap``;
    ``Astaroth(256, 512, 512, bfloat16)`` on four 256^3 shards of the
    card (auto must take ``halo``: 24 B11; the pair 8 B12 and 8 B11) and
    ``halo-overlap`` (24 B13 and 24 B14; the pair 16 and 16), bitwise
    equal to ``halo`` (with the pair, to ``halo``+pair). Each path
    within ``substeps x 2^-7 x max`` (one bf16 ulp of the largest value
    a substep) of the bf16 ``xla`` path on the same grid and mesh; a
    pair path is not bitwise its single-substep twin in bf16 (f_1 and
    w_1 stay float32 inside the pair), which is logged."""
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams

    prm = MhdParams(dt=MHD_PATH_DT)
    bf = torch.bfloat16
    out = {"launches_by_run": {}, "checks": {}}
    zero = {k: 0 for k in list(cm.LAUNCHES) + list(mo.LAUNCHES)}

    def model(kernel, size, mesh, pair="0", overlap=False):
        with mhd_pair(pair):
            return Astaroth(*size, params=prm, dtype=bf, kernel=kernel,
                            overlap=overlap, mesh_shape=mesh,
                            devices=[CARD] * (mesh[1] * mesh[2]))

    def drive(label, m, ref, want_path, want):
        if m.kernel_path != want_path:
            raise AssertionError(f"bf16 {label}: took {m.kernel_path!r}, "
                                 f"not {want_path!r}")
        seed_state(torch, m, ref)
        cm.reset_launch_counts()
        mo.reset_launch_counts()
        cs.reset_launch_counts()
        m.run(2)
        m.block()
        counts = dict(cm.LAUNCHES, **mo.LAUNCHES)
        log(f"  Astaroth bf16 {label} run(2) launches: {counts}")
        if counts != dict(zero, **want):
            raise AssertionError(f"bf16 {label} launched {counts}, not "
                                 f"{dict(zero, **want)}")
        if cs.LAUNCHES["laplace6"]:
            raise AssertionError("an MHD path launched B8")
        out["launches_by_run"][label] = counts
        got = state_of(torch, m)
        del m
        torch.cuda.empty_cache()
        return got

    def near(label, got, want):
        out["checks"][f"{label} vs bf16 xla"] = check_bf16(
            torch, {k: v.to(bf) for k, v in got[0].items()},
            want[0], f"bf16 {label} vs bf16 xla after 2 iterations, f",
            ulps=6)

    def bitwise(label, got, want, must=True):
        same = all(torch.equal(got[0][k], want[0][k]) for k in want[0])
        if want[1] is not None and got[1] is not None:
            same &= all(torch.equal(got[1][k], want[1][k]) for k in want[1])
        log(f"  bf16 {label}: {'bitwise equal' if same else 'not bitwise equal'}")
        out["checks"][label] = same
        if must and not same:
            raise AssertionError(f"bf16 {label}: not bitwise equal")

    cube, big = (N256,) * 3, (N256, 2 * N256, 2 * N256)
    for size, mesh in ((cube, (1, 1, 1)), (big, (1, 2, 2))):
        tag = "256^3" if size == cube else "256x512x512 (1,2,2)"
        ref = model("xla", size, mesh)
        ref.init()
        xla = model("xla", size, mesh)
        seed_state(torch, xla, ref)
        xla.run(2)
        want = state_of(torch, xla)
        want = ({k: v.to(bf) for k, v in want[0].items()}, None)
        del xla
        torch.cuda.empty_cache()
        if size == cube:
            wrap = drive("wrap 256^3", model("auto", size, mesh), ref,
                         "wrap", {"mhd_substep_wrap": 6})
            near("wrap 256^3", wrap, want)
            pair = drive("wrap+pair 256^3", model("auto", size, mesh, "1"),
                         ref, "wrap", {"mhd_substep_wrap": 2,
                                       "mhd_substep01_wrap": 2})
            near("wrap+pair 256^3", pair, want)
            bitwise("wrap+pair vs wrap 256^3 (float32 f1, w1 in the pair)",
                    pair, wrap, must=False)
            halo = drive("halo 256^3 (1,1,1)", model("halo", size, mesh), ref,
                         "halo", {"mhd_substep_halo": 6})
            bitwise("halo vs wrap 256^3 (1,1,1)", halo, wrap)
            del wrap, pair, halo
        else:
            halo = drive(f"halo {tag}", model("auto", size, mesh), ref,
                         "halo", {"mhd_substep_halo": 24})
            near(f"halo {tag}", halo, want)
            hpair = drive(f"halo+pair {tag}", model("auto", size, mesh, "1"),
                          ref, "halo", {"mhd_substep_halo": 8,
                                        "mhd_substep01_halo": 8})
            near(f"halo+pair {tag}", hpair, want)
            ov = drive(f"halo-overlap {tag}",
                       model("auto", size, mesh, overlap=True), ref,
                       "halo-overlap", {"mhd_substep_overlap": 24,
                                        "mhd_substep_fixup": 24})
            bitwise(f"halo-overlap vs halo {tag}", ov, halo)
            ovp = drive(f"halo-overlap+pair {tag}",
                        model("auto", size, mesh, "1", overlap=True), ref,
                        "halo-overlap", {"mhd_substep_overlap": 16,
                                         "mhd_substep_fixup": 16})
            bitwise(f"halo-overlap+pair vs halo+pair {tag}", ovp, hpair)
            del halo, hpair, ov, ovp
        del ref, want
        torch.cuda.empty_cache()
    r = out["launches_by_run"]
    out["launches"] = {
        "mhd_substep_wrap": r["wrap 256^3"]["mhd_substep_wrap"],
        "mhd_substep01_wrap": r["wrap+pair 256^3"]["mhd_substep01_wrap"],
        "mhd_substep_halo": r["halo 256x512x512 (1,2,2)"]["mhd_substep_halo"],
        "mhd_substep01_halo":
            r["halo+pair 256x512x512 (1,2,2)"]["mhd_substep01_halo"],
        "mhd_substep_overlap":
            r["halo-overlap 256x512x512 (1,2,2)"]["mhd_substep_overlap"],
        "mhd_substep_fixup":
            r["halo-overlap 256x512x512 (1,2,2)"]["mhd_substep_fixup"]}
    return out


#: (label, exchange_every, overlap, the two runs) of phase 4's temporal
#: check; s = 4's period is four iterations, so it runs 4 then 1
TEMPORAL_MHD = (("s=2", 2, False, (2, 3)), ("s=3", 3, False, (2, 3)),
                ("s=3 overlap", 3, True, (2, 3)), ("s=4", 4, False, (4, 1)))


def run_astaroth_temporal(torch) -> dict:
    """Phase 4, the MHD temporal path and Boundary.NONE, float32 at dt
    1e-4 on ``Astaroth(256, 512, 512, kernel="xla")`` over four 256^3
    shards of the card: ``exchange_every`` 2, 3 (also with overlap) and
    4 (``xla-temporal[s=N]``), each two runs back to back (2 then 3
    iterations; 4 then 1 at s = 4), after each held against stepwise
    ``xla`` on the same state within ``substeps x 64 eps(f32) x max``
    (bitwise is reported), with its host-clocked iterations/s over the
    second run and ``exchange_stats()``; and ``xla``, ``xla-overlap``
    and ``xla-temporal[s=3]`` with ``Boundary.NONE``, ``run(2)``, against
    stepwise ``xla`` with ``Boundary.NONE``. No kernel runs on these
    paths."""
    from stencil_tpu_torch import Boundary
    from stencil_tpu_torch.models.astaroth import Astaroth, MhdParams

    prm = MhdParams(dt=MHD_PATH_DT)
    size, mesh = (N256, 2 * N256, 2 * N256), (1, 2, 2)
    out = {"iters_per_s": {}, "exchange_stats": {}, "bitwise": {},
           "max_diff": {}}

    def model(s=None, overlap=False, boundary=None):
        return Astaroth(*size, params=prm, kernel="xla", mesh_shape=mesh,
                        devices=[CARD] * 4, exchange_every=s,
                        overlap=overlap, boundary=boundary)

    def held(label, got, want, substeps):
        e = check_fields(torch, got[0], want[0], f"{label}, f",
                         factor=substeps * 64.0)
        e = max(e, check_fields(torch, got[1], want[1], f"{label}, w",
                                factor=substeps * 64.0))
        same = (all(torch.equal(got[0][k], want[0][k]) for k in want[0])
                and all(torch.equal(got[1][k], want[1][k]) for k in want[1]))
        log(f"  {label}: bitwise: {'yes' if same else 'no'}")
        out["bitwise"][label] = same
        out["max_diff"][label] = e

    ref = model()
    ref.init()
    # stepwise xla after 2, 4 and 5 iterations, timed over its last 3
    step = model()
    seed_state(torch, step, ref)
    want = {}
    step.run(2)
    want[2] = state_of(torch, step)
    step.block()
    t0 = time.perf_counter()
    step.run(2)
    want[4] = state_of(torch, step)
    step.run(1)
    step.block()
    out["iters_per_s"]["xla stepwise"] = 3 / (time.perf_counter() - t0)
    want[5] = state_of(torch, step)
    out["exchange_stats"]["xla stepwise"] = step.exchange_stats()
    del step
    torch.cuda.empty_cache()
    for label, s, overlap, (n1, n2) in TEMPORAL_MHD:
        m = model(s, overlap)
        path = f"xla-temporal[s={s}]" + ("-overlap" if overlap else "")
        if m.kernel_path != path:
            raise AssertionError(f"temporal {label}: took {m.kernel_path!r}")
        seed_state(torch, m, ref)
        m.run(n1)
        held(f"{path} after {n1} vs stepwise xla", state_of(torch, m),
             want[n1], 3 * n1)
        m.block()
        t0 = time.perf_counter()
        m.run(n2)
        m.block()
        out["iters_per_s"][path] = n2 / (time.perf_counter() - t0)
        held(f"{path} after {n1} + {n2} vs stepwise xla", state_of(torch, m),
             want[n1 + n2], 3 * (n1 + n2))
        out["exchange_stats"][path] = m.exchange_stats()
        log(f"  {path}: {out['iters_per_s'][path]!r} iterations/s over "
            f"run({n2}) (stepwise xla {out['iters_per_s']['xla stepwise']!r})"
            f"; exchange_stats {out['exchange_stats'][path]}")
        del m
        torch.cuda.empty_cache()
    del want
    none = Boundary.NONE
    step = model(boundary=none)
    seed_state(torch, step, ref)
    step.run(2)
    want = state_of(torch, step)
    del step
    for label, s, overlap in (("xla-overlap", None, True),
                              ("xla-temporal[s=3]", 3, False)):
        m = model(s, overlap, none)
        if m.kernel_path != label:
            raise AssertionError(f"Boundary.NONE {label}: took "
                                 f"{m.kernel_path!r}")
        seed_state(torch, m, ref)
        m.run(2)
        held(f"Boundary.NONE {label} after 2 vs stepwise xla",
             state_of(torch, m), want, 6)
        del m
        torch.cuda.empty_cache()
    del ref, want
    torch.cuda.empty_cache()
    return out


def time_astaroth_bf16_paths(torch) -> dict:
    """Phase 5, iterations/s of the bf16 paths at dt 1e-8: ``wrap`` and
    ``wrap``+pair on 256^3, ``halo``, ``halo``+pair, ``halo-overlap`` and
    ``halo-overlap``+pair on four 256^3 shards of the card; three
    host-clocked runs pooled (``timed_runs``), each model seeded from
    one ``init()`` on the card (``seed_state``). The float32 rates of
    the same paths are phase 5's own, in the same process."""
    from stencil_tpu_torch.models.astaroth import Astaroth

    res, runs = {}, {}
    cube, big = (N256,) * 3, (N256, 2 * N256, 2 * N256)
    for size, mesh, k, cases in (
            (cube, (1, 1, 1), 20, (("wrap 256^3", "0", False),
                                   ("wrap+pair 256^3", "1", False))),
            (big, (1, 2, 2), 10,
             (("halo 256x512x512 (1,2,2)", "0", False),
              ("halo+pair 256x512x512 (1,2,2)", "1", False),
              ("halo-overlap 256x512x512 (1,2,2)", "0", True),
              ("halo-overlap+pair 256x512x512 (1,2,2)", "1", True)))):
        devs = [CARD] * (mesh[1] * mesh[2])
        ref = Astaroth(*size, dtype=torch.bfloat16, kernel="xla",
                       mesh_shape=mesh, devices=devs)
        ref.init()
        for label, pair, overlap in cases:
            with mhd_pair(pair):
                m = Astaroth(*size, dtype=torch.bfloat16, mesh_shape=mesh,
                             devices=devs, overlap=overlap)
            seed_state(torch, m, ref)
            m.run(1)
            m.block()
            res[label], runs[label] = timed_runs(m, k)
            log(f"  Astaroth bf16 {label} ({m.kernel_path}): {res[label]!r} "
                f"iterations/s over three runs ({runs[label]})")
            del m
            torch.cuda.empty_cache()
        del ref
        torch.cuda.empty_cache()
    return {"iters_per_s": res, "runs_iters_per_s": runs}


def time_mhd_bf16_kernels(torch, cm, mo) -> dict:
    """Phase 5, bfloat16 storage: B9 (each s) and B10 on a 256^3 field,
    B11 (each s), B12, B13 and B14 (each s and the pair) on one 256^3
    shard (a (1,1,1) mesh), by CUDA events after two warm-ups, beside
    their bf16 twins and bounds with 2-byte storage (the pair's f1, w1
    and margin are scratch, not counted, as for float32); B9 and B11
    float32 at s=0 in the same process, beside them."""
    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.models.astaroth import MhdParams

    gen = torch.Generator(device="cuda").manual_seed(1617)
    n = N256
    pts = float(n ** 3)
    field = 2.0 * pts
    prm = MhdParams()
    dt = prm.dt
    counts = Dim3(1, 1, 1)
    f32, w32 = mhd_state(torch, (n, n, n), gen)
    f, w = bf16_of(torch, f32), bf16_of(torch, w32)
    t = torch.stack(list(f.values()))
    sl3 = mhd_slabs([t], (1, 1, 1), rz=3, ry=3)[0]
    sl6 = mhd_slabs([t], (1, 1, 1), rz=6, ry=6)[0]
    sl3f = mhd_slabs([t.float()], (1, 1, 1), rz=3, ry=3)[0]
    of = per_field(torch.empty_like(t))
    ow = per_field(torch.empty_like(t))
    recv = mo.MhdOverlapRecv([t], counts)

    def slab_bytes(r):
        return 2.0 * 8 * (2 * r * n * n + 2 * (n + 2 * r) * r * n)

    res = {name: {"variants": {}} for name in BF16_NAMES}
    f32_ms = {
        "B9 float32 s=0": event_ms(torch, lambda: cm.mhd_substep_wrap_cuda(
            f32, None, 0, prm, dt), reps=10),
        "B11 float32 s=0": event_ms(torch, lambda: cm.mhd_substep_halo_cuda(
            f32, None, sl3f, 0, prm, dt), reps=10)}
    for k, v in f32_ms.items():
        log(f"  {k} (same process): {v!r} ms/launch")
    cases = []
    for s, read_w, write_w in ((0, False, True), (1, True, True),
                               (2, True, False)):
        wi = w if read_w else None
        wo = ow if write_w else None
        passes = 8 + (8 if read_w else 0) + 8 + (8 if write_w else 0)
        tag = overlap_variant_tag(s, read_w, write_w, False)
        cases += [
            ("mhd_substep_wrap", tag,
             lambda s=s, wi=wi, write_w=write_w: cm.mhd_substep_wrap_cuda(
                 f, wi, s, prm, dt, write_w=write_w),
             lambda s=s, wi=wi, write_w=write_w: cm.mhd_substep_wrap_plain(
                 f, wi, s, prm, dt, write_w=write_w),
             passes * field, B9_FLOPS[s] * pts, 10),
            ("mhd_substep_halo", tag,
             lambda s=s, wi=wi, write_w=write_w: cm.mhd_substep_halo_cuda(
                 f, wi, sl3, s, prm, dt, write_w=write_w),
             lambda s=s, wi=wi, write_w=write_w: cm.mhd_substep_halo_plain(
                 f, wi, sl3, s, prm, dt, write_w=write_w),
             passes * field + slab_bytes(3), B9_FLOPS[s] * pts, 10),
        ]
    cases += [
        ("mhd_substep01_wrap", "pair",
         lambda: cm.mhd_substep01_wrap_cuda(f, prm, dt),
         lambda: cm.mhd_substep01_wrap_plain(f, prm, dt),
         24 * field, B10_FLOPS * pts, 5),
        ("mhd_substep01_halo", "pair",
         lambda: cm.mhd_substep01_halo_cuda(f, sl6, prm, dt),
         lambda: cm.mhd_substep01_halo_plain(f, sl6, prm, dt),
         24 * field + slab_bytes(6), B10_FLOPS * pts, 5)]
    for name, tag, kern, plain, nbytes, flops, reps in cases:
        ms = event_ms(torch, kern, reps=reps)
        plain_ms = event_ms(torch, plain, reps=1, warmup=1)
        bms, by = bound_ms(nbytes, flops)
        res[name]["variants"][tag] = {
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "library_ms": None}
        log(f"  {name} bf16 {tag}: {ms!r} ms/launch, bound {bms!r} ms "
            f"({by}), {100 * bms / ms:.1f}% of bound; plain twin "
            f"{plain_ms!r} ms")
        torch.cuda.empty_cache()
    fl, wl = [f], [w]
    for s, read_w, write_w, pair in OVERLAP_VARIANTS:
        tag = overlap_variant_tag(s, read_w, write_w, pair)
        wi = wl if read_w else None
        wo = [ow] if write_w else None

        def b13():
            mo.mhd_substep_overlap_cuda(fl, wi, s, prm, dt, counts,
                                        pair=pair, write_w=write_w,
                                        out_f=[of], out_w=wo, recv=recv)

        def b14():
            mo.mhd_substep_fixup_cuda(fl, wi, [of], wo, s, prm, dt, counts,
                                      recv, pair=pair)

        b13()
        reps = 3 if pair else 10
        pts_in = mo.interior_region(n, n, pair)
        p_in = float(pts_in[1] * pts_in[3] * n) if pts_in else 0.0
        flops = B10_FLOPS if pair else B9_FLOPS[s]
        for name, fn, nbytes, p in (
                ("mhd_substep_overlap", b13,
                 b13_bytes((n, n, n), read_w, write_w, pair, item=2), p_in),
                ("mhd_substep_fixup", b14,
                 b14_bytes((n, n, n), read_w, write_w, pair, item=2),
                 pts - p_in)):
            ms = event_ms(torch, fn, reps=reps)
            dev = device_ms(torch, fn, reps=reps)
            bms, by = bound_ms(nbytes, flops * p)
            res[name]["variants"][tag] = {
                "ms": ms, "device_ms": dev, "plain_ms": None,
                "bound_ms": bms, "bound_by": by, "library_ms": None}
            log(f"  {name} bf16 {tag}, one 256^3 shard: {ms!r} ms, device "
                f"time alone {dev!r} ms, bound {bms!r} ms ({by}), "
                f"{100 * bms / dev:.1f}% of bound (device)")
    # B13's and B14's twin: the overlap twin over the shard, once a
    # substep (both launches' function)
    for s, read_w, write_w, pair in OVERLAP_VARIANTS:
        tag = overlap_variant_tag(s, read_w, write_w, pair)
        wi = wl if read_w else None
        plain = event_ms(torch, lambda: mo.mhd_substep_overlap_plain(
            fl, wi, s, prm, dt, counts, pair=pair, write_w=write_w),
            reps=1, warmup=1)
        for name in ("mhd_substep_overlap", "mhd_substep_fixup"):
            res[name]["variants"][tag]["plain_ms"] = plain
    out = {}
    for name, r in res.items():
        v = r["variants"]
        main = [x for k, x in v.items() if k != "pair"] or list(v.values())
        if name in ("mhd_substep_overlap", "mhd_substep_fixup"):
            main = [v[overlap_variant_tag(*var)]
                    for var in OVERLAP_VARIANTS[:3]]
        out[name] = {k: sum(x[k] for x in main) / len(main)
                     for k in ("ms", "plain_ms", "bound_ms")}
        out[name].update(bound_by=main[-1]["bound_by"], library_ms=None,
                         variants=v)
    out["float32_same_process"] = f32_ms
    del f32, w32, f, w, t, sl3, sl6, sl3f, of, ow, recv
    torch.cuda.empty_cache()
    return out


# name: (tag, source, TPU kernel it replaces)
# ---------------------------------------------------------------------------
# bfloat16 on the Jacobi kernels (K1-K3, B5-B7) and the PIC model
# ---------------------------------------------------------------------------
JACOBI_BF16_NAMES = ("jacobi7_wrap", "jacobi7_wrapn", "jacobi7_padded",
                     "jacobi7_halo", "jacobi7_halon", "jacobi7_overlap")
#: shapes (Z, Y, X) off every tile: y a multiple of bfloat16's sublane
#: tile (16) where K2 and B6 need it, odd x elsewhere
JACOBI_BF16_UNEVEN = (131, 97, 133)
JACOBI_BF16_RING_UNEVEN = (129, 96, 130)
#: bfloat16 paths against the float32-computed-in-bfloat16 ``xla`` path:
#: each path adds in its own order, so each step may differ by an ulp
#: of bfloat16 at 1 (the field is in [0, 1])
BF16_STEP_TOL = 2.0 ** -7
PIC_GRID = 256          # global grid a side: (2,2,2) shards of 128^3
PIC_MESH = (2, 2, 2)
PIC_PER_CELL = 4        # CIC float32 particles a cell (67,108,864)
PIC_STEPS = 3


def compare_jacobi_bf16_kernels(torch, cs, ch, co) -> dict:
    """Phase 3: every bfloat16 Jacobi kernel bitwise its twin at 512^3
    and at one uneven size, K2 and B6 at N = 2, 3 and 16 (two launches);
    returns the largest |kernel - twin| per kernel (must be 0)."""
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch.local_domain import raw_size, zyx_shape

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(4321)
    worst = {k: 0.0 for k in JACOBI_BF16_NAMES}

    def check(name, got, want, what):
        assert got.shape == want.shape and got.dtype == bf, (what,)
        err = float((got.float() - want.float()).abs().max())
        same = bool(torch.equal(got, want))
        log(f"  {what} bf16: max |kernel - twin| = {err!r} "
            f"({'bitwise equal' if same else 'DIFFERENT'})")
        if not same or not torch.isfinite(got).all():
            raise AssertionError(f"{what} bf16: kernel disagrees with its "
                                 f"twin")
        worst[name] = max(worst[name], err)

    def field(shape):
        return torch.rand(shape, generator=gen, device="cuda").to(bf)

    n = N512
    for shape in ((n, n, n), JACOBI_BF16_UNEVEN):
        t = field(shape)
        hot, cold, r = spheres(shape, widen=0 if shape[0] == n else 2)
        check("jacobi7_wrap", cs.jacobi7_wrap_cuda(t, hot, cold, r),
              cs.jacobi7_wrap_plain(t, hot, cold, r), f"K1 {shape}")
        del t
    for shape in ((n, n, n), JACOBI_BF16_RING_UNEVEN):
        t = field(shape)
        hot, cold, r = spheres(shape, widen=0 if shape[0] == n else 2)
        for steps in (2, 3, 16):
            check("jacobi7_wrapn",
                  cs.jacobi7_wrapn_cuda(t, hot, cold, r, steps=steps),
                  cs.jacobi7_wrapn_plain(t, hot, cold, r, steps=steps),
                  f"K2 N={steps} {shape}")
        del t
    for shape, rad in (((n, n, n), Radius.constant(1)),
                       (JACOBI_BF16_UNEVEN, Radius.constant(1)),
                       (JACOBI_BF16_UNEVEN, asym_radius())):
        interior = Dim3(shape[2], shape[1], shape[0])
        p = field(zyx_shape(raw_size(interior, rad)))
        check("jacobi7_padded", cs.jacobi7_padded_cuda(p, rad, interior),
              cs.jacobi7_padded_plain(p, rad, interior), f"K3 {shape}")
        del p
    # B5 on 512^3 as one shard and on the uneven 512 x 511 x 509 grid
    # over (1,2,2); B6 on 512^3 as one shard and on an uneven single shard
    for size, mesh in (((n, n, n), (1, 1, 1)), ((n, 511, 509), (1, 2, 2))):
        shards, slabs, orgs, lens, (hot, cold, r), _ = halo_case(
            torch, gen, size, mesh, dict(rz=1, ry=1), dtype=bf)
        for t, sl, org, ln in zip(shards, slabs, orgs, lens):
            check("jacobi7_halo",
                  ch.jacobi7_halo_cuda(t, sl, org, hot, cold, r,
                                       interior_len_zy=ln),
                  ch.jacobi7_halo_plain(t, sl, org, hot, cold, r, ln),
                  f"B5 {size} {mesh}")
        del shards, slabs
    for size in ((n, n, n), tuple(reversed(JACOBI_BF16_RING_UNEVEN))):
        for steps in (2, 3, 16):
            kw = dict(rz=steps, ry=steps, radius_rows=steps,
                      y_z_extended=True)
            (t,), (sl,), (org,), _, (hot, cold, r), gsize = halo_case(
                torch, gen, size, (1, 1, 1), kw, widen=2, dtype=bf)
            check("jacobi7_halon",
                  ch.jacobi7_halon_cuda(t, sl, org, gsize, hot, cold, r,
                                        steps=steps),
                  ch.jacobi7_halon_plain(t, sl, org, gsize, hot, cold, r,
                                         steps=steps),
                  f"B6 N={steps} {size}")
            del t, sl
    for size in ((n, n, n), (130, 80, 132)):
        sh, orgs, (hot, cold, r) = overlap_case(torch, gen, size, (1, 2, 2))
        sh = [t.to(bf) for t in sh]
        c = Dim3(1, 2, 2)
        out, recv = co.jacobi7_overlap_cuda(sh, orgs, hot, cold, r, c)
        new, _ = co.jacobi7_overlap_plain(sh, orgs, hot, cold, r, c)
        for i, (g, w) in enumerate(zip(out, new)):
            check("jacobi7_overlap", g, w, f"B7 {size} (1,2,2) shard {i}")
        del sh, out, recv, new
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return worst


def run_jacobi_bf16(torch, cs, ch, co) -> dict:
    """Phase 4: ``Jacobi3D(512, 512, 512, dtype=bfloat16)`` through the
    user's entry points: ``auto`` takes ``wrap`` on one shard (K1, K2),
    ``halo`` on (1,2,2) (B5, B6) and, with ``overlap=True``, ``overlap``
    (B7); ``pallas`` runs K3; ``exchange_every=16`` runs K2 and B6 at 16
    steps (on 256 x 512 x 512). Each run's counts are set to 0 just before it and read just
    after. ``halo`` equals ``wrap`` bitwise; every path is within
    ``steps x BF16_STEP_TOL`` of bfloat16 ``xla``, finite and 512^3."""
    bf = torch.bfloat16
    steps = 21
    mods = (cs, ch, co)
    out = {"launches_by_run": {}}

    def run(label, k, kernel, mesh=(1, 1, 1), want_path=None,
            size=(N512, N512, N512), **kw):
        j = jacobi_mesh(kernel, mesh, size, dtype=bf, **kw)
        if want_path and j.kernel_path != want_path:
            raise AssertionError(f"bf16 {label}: kernel={kernel!r} took "
                                 f"{j.kernel_path!r}, not {want_path!r}")
        for m in mods:
            m.reset_launch_counts()
        j.run(k)
        j.block()
        counts = {name: n for m in mods for name, n in m.LAUNCHES.items()
                  if n}
        log(f"  bf16 {label} run({k}) launches: {counts}")
        out["launches_by_run"][label] = counts
        got = gather(torch, j).float()
        if tuple(got.shape) != tuple(reversed(size)) or not bool(
                torch.isfinite(got).all()):
            raise AssertionError(f"bf16 {label}: wrong shape or non-finite")
        del j
        torch.cuda.empty_cache()
        return got, counts

    def expect(label, counts, want):
        if counts != want:
            raise AssertionError(f"bf16 {label} launched {counts}, not "
                                 f"{want}")

    ref = {}
    for k in (steps, 4):
        x = jacobi_mesh("xla", dtype=bf)
        x.run(k)
        ref[k] = gather(torch, x).float()
        del x
    wrap, c = run("wrap (auto)", steps, "auto", want_path="wrap")
    expect("wrap", c, {"jacobi7_wrapn": 10, "jacobi7_wrap": 1})
    for label, k, kernel, mesh, want, kw in (
            ("halo (1,1,1)", steps, "halo", (1, 1, 1),
             {"jacobi7_halon": 10, "jacobi7_halo": 1}, {}),
            ("halo (1,2,2) (auto)", steps, "auto", (1, 2, 2),
             {"jacobi7_halon": 40, "jacobi7_halo": 4}, {})):
        got, c = run(label, k, kernel, mesh, "halo", **kw)
        expect(label, c, want)
        same = bool(torch.equal(got, wrap))
        log(f"  bf16 {label} vs bf16 wrap after {k} steps: "
            f"{'bitwise equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"bf16 {label} is not bitwise bf16 wrap")
        del got
    for label, k, kernel, mesh, path, want, kw in (
            ("overlap (1,2,2)", steps, "auto", (1, 2, 2), "overlap",
             {"jacobi7_overlap": 4 * steps}, dict(overlap=True)),
            ("pallas", 4, "pallas", (1, 1, 1), "pallas",
             {"jacobi7_padded": 4}, {})):
        got, c = run(label, k, kernel, mesh, path, **kw)
        expect(label, c, want)
        err, tol = float((got - ref[k]).abs().max()), k * BF16_STEP_TOL
        log(f"  bf16 {label} vs bf16 xla after {k} steps: max diff {err!r} "
            f"(tolerance {tol!r})")
        if err > tol:
            raise AssertionError(f"bf16 {label} disagrees with bf16 xla")
        out[f"{label} vs xla max diff"] = err
        del got
    err, tol = float((wrap - ref[steps]).abs().max()), steps * BF16_STEP_TOL
    log(f"  bf16 wrap vs bf16 xla after {steps} steps: max diff {err!r} "
        f"(tolerance {tol!r})")
    if err > tol:
        raise AssertionError("bf16 wrap disagrees with bf16 xla")
    out["wrap vs xla max diff"] = err
    del wrap, ref
    # 16-step groups on 256 x 512 x 512: at 512^3 JAX's planner, which
    # the halo path copies (ops/halo_plan.py), declines them (x = 512
    # stages 16 MB against its 14 MB budget), and the path steps by B5
    s16 = (N512 // 2, N512, N512)
    w16, c = run("wrap exchange_every=16", 32, "wrap", size=s16,
                 exchange_every=16)
    expect("wrap s=16", c, {"jacobi7_wrapn": 2})
    h16, c = run("halo (1,2,2) exchange_every=16", 32, "halo", (1, 2, 2),
                 "halo", size=s16, exchange_every=16)
    expect("halo s=16", c, {"jacobi7_halon": 8})
    same = bool(torch.equal(h16, w16))
    log(f"  bf16 halo (1,2,2) vs wrap at exchange_every=16: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("bf16 halo s=16 is not bitwise bf16 wrap s=16")
    del w16, h16
    torch.cuda.empty_cache()
    runs = out["launches_by_run"]
    out["launches"] = {
        "jacobi7_wrap": runs["wrap (auto)"]["jacobi7_wrap"],
        "jacobi7_wrapn": runs["wrap (auto)"]["jacobi7_wrapn"],
        "jacobi7_padded": runs["pallas"]["jacobi7_padded"],
        "jacobi7_halo": runs["halo (1,2,2) (auto)"]["jacobi7_halo"],
        "jacobi7_halon": runs["halo (1,2,2) (auto)"]["jacobi7_halon"],
        "jacobi7_overlap": runs["overlap (1,2,2)"]["jacobi7_overlap"]}
    return out


def time_jacobi_bf16(torch, cs, ch, co, f32_rates: dict) -> dict:
    """Phase 5: the bfloat16 Jacobi kernels at 512^3 (B7 per step of the
    four 512 x 256 x 256 shards of (1,2,2)) beside their twins, with
    their 2-byte bounds; K2 and B6 also at N = 16; K3 beside conv3d in
    bfloat16; and the bfloat16 path rates beside ``f32_rates``."""
    import functools

    import torch.nn.functional as F

    from stencil_tpu_torch.geometry import Dim3, Radius

    bf = torch.bfloat16
    gen = torch.Generator(device="cuda").manual_seed(2468)
    n = N512
    pts = float(n ** 3)
    hot, cold, r = spheres((n, n, n))
    a = torch.rand((n, n, n), generator=gen, device="cuda").to(bf)
    b = torch.empty_like(a)
    pad = torch.rand((n + 2,) * 3, generator=gen, device="cuda").to(bf)
    rad, inner = Radius.constant(1), Dim3(n, n, n)
    cases = {
        "jacobi7_wrap": (
            lambda: cs.jacobi7_wrap_cuda(a, hot, cold, r, out=b),
            lambda: cs.jacobi7_wrap_plain(a, hot, cold, r),
            2 * 2 * pts, 7 * pts),
        "jacobi7_wrapn": (
            lambda: cs.jacobi7_wrapn_cuda(a, hot, cold, r, steps=2, out=b),
            lambda: cs.jacobi7_wrapn_plain(a, hot, cold, r, steps=2),
            2 * 2 * pts, 2 * 7 * pts),
        "jacobi7_wrapn N=16": (
            lambda: cs.jacobi7_wrapn_cuda(a, hot, cold, r, steps=16, out=b),
            lambda: cs.jacobi7_wrapn_plain(a, hot, cold, r, steps=16),
            2 * 2 * pts, 16 * 7 * pts),
        "jacobi7_padded": (
            lambda: cs.jacobi7_padded_cuda(pad, rad, inner, out=b),
            lambda: cs.jacobi7_padded_plain(pad, rad, inner),
            2 * (float(n + 2) ** 3 + pts), 7 * pts),
    }
    for name, kw, k in (("jacobi7_halo", dict(rz=1, ry=1), 1),
                        ("jacobi7_halon", dict(rz=2, ry=2, radius_rows=2,
                                               y_z_extended=True), 2),
                        ("jacobi7_halon N=16", dict(rz=16, ry=16,
                                                    radius_rows=16,
                                                    y_z_extended=True), 16)):
        (t,), (sl,), (org,), (ln,), (h, c, rr), gsize = halo_case(
            torch, gen, (n, n, n), (1, 1, 1), kw, dtype=bf)
        o = torch.empty_like(t)
        if k == 1:
            kern = functools.partial(
                ch.jacobi7_halo_cuda, t, sl, org, h, c, rr,
                interior_len_zy=ln, out=o)
            plain = functools.partial(ch.jacobi7_halo_plain, t, sl, org, h,
                                      c, rr, ln)
        else:
            kern = functools.partial(ch.jacobi7_halon_cuda, t, sl, org,
                                     gsize, h, c, rr, steps=k, out=o)
            plain = functools.partial(ch.jacobi7_halon_plain, t, sl, org,
                                      gsize, h, c, rr, steps=k)
        cases[name] = (kern, plain, halo_bytes(t.shape, k, k > 1, 2),
                       7 * k * pts)
    sh, orgs, (h7, c7, r7) = overlap_case(torch, gen, (n, n, n), (1, 2, 2))
    sh = [t.to(bf) for t in sh]
    c122 = Dim3(1, 2, 2)
    outs = [torch.empty_like(t) for t in sh]
    recv = co.OverlapRecv(sh, c122)
    slab_pts = sum(2 * t.shape[1] * t.shape[2] + 2 * t.shape[0] * t.shape[2]
                   for t in sh)
    cases["jacobi7_overlap"] = (
        lambda: co.jacobi7_overlap_cuda(sh, orgs, h7, c7, r7, c122, out=outs,
                                        recv=recv),
        lambda: co.jacobi7_overlap_plain(sh, orgs, h7, c7, r7, c122),
        2 * (2 * pts + 2 * slab_pts), 7 * pts)
    res = {"kernels": {}, "steps_per_s": {}, "runs_steps_per_s": {}}
    for name, (kern, plain, nbytes, flops) in cases.items():
        ms = event_ms(torch, kern, reps=20)
        plain_ms = event_ms(torch, plain, reps=2, warmup=1)
        bms, by = bound_ms(nbytes, flops)
        res["kernels"][name] = {"ms": ms, "plain_ms": plain_ms,
                                "bound_ms": bms, "bound_by": by,
                                "library_ms": None}
        log(f"  {name} bf16: {ms!r} ms/launch, bound {bms!r} ms ({by}), "
            f"{100 * bms / ms:.1f}% of bound; plain twin {plain_ms!r} ms")
    # K3's function as one library call in bfloat16 (conv3d's own order:
    # held to 2 ulps of bfloat16 at 1 of the kernel)
    weight = torch.zeros((1, 1, 3, 3, 3), device="cuda", dtype=bf)
    for k, j, i in ((0, 1, 1), (2, 1, 1), (1, 0, 1), (1, 2, 1), (1, 1, 0),
                    (1, 1, 2)):
        weight[0, 0, k, j, i] = 1.0 / 6.0
    want = cs.jacobi7_padded_cuda(pad, rad, inner, out=b).float()
    got = F.conv3d(pad[None, None], weight)[0, 0].float()
    err = float((got - want).abs().max())
    log(f"  jacobi7_padded bf16: max |conv3d - kernel| = {err!r}")
    if not err <= 2 * BF16_STEP_TOL:
        raise AssertionError("conv3d does not compute K3's function")
    del got, want
    res["kernels"]["jacobi7_padded"]["library_ms"] = event_ms(
        torch, lambda: F.conv3d(pad[None, None], weight), reps=5)
    log(f"  conv3d bf16 (K3's library call): "
        f"{res['kernels']['jacobi7_padded']['library_ms']!r} ms")
    del a, b, pad, sh, outs, recv, cases
    torch.cuda.empty_cache()
    for label, kernel, mesh, kw in (
            ("wrap", "wrap", (1, 1, 1), {}),
            ("halo (1,2,2)", "halo", (1, 2, 2), {}),
            ("overlap (1,2,2)", "halo", (1, 2, 2), dict(overlap=True))):
        j = jacobi_mesh(kernel, mesh, dtype=bf, **kw)
        j.run(2)
        j.block()
        rate, runs = timed_runs(j, 40)
        res["steps_per_s"][label] = rate
        res["runs_steps_per_s"][label] = runs
        log(f"  Jacobi bf16 {label}: {rate!r} steps/s over three runs "
            f"({runs}) against float32 {f32_rates.get(label)!r}")
        del j
        torch.cuda.empty_cache()
    return res


def pic_shard_particles(torch, pic, per_shard: int, seed: int):
    """``per_shard`` particles on every shard of ``pic``, made on the card
    from ``seed``: positions uniform over the shard's box, thermal
    velocities (sigma 0.05), unit charges (``Pic.init``'s plasma, each
    shard holding the same count; the host ``init()`` of tens of millions
    of particles takes seconds)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dt = pic._dtype
    out = []
    for i in range(pic.dd.num_subdomains()):
        o, s = pic.dd.shard_origin(i), pic.dd.shard_size(i)
        parts = {}
        for k, lo, ln in (("x", o.x, s.x), ("y", o.y, s.y), ("z", o.z, s.z)):
            u = torch.rand(per_shard, generator=gen, device="cuda",
                           dtype=torch.float64)
            # in [lo, lo + ln) in the particle dtype too
            top = torch.tensor(float(lo + ln), dtype=dt).nextafter(
                torch.tensor(0.0, dtype=dt)).item()
            parts[k] = torch.clamp((lo + ln * u).to(dt), max=top)
        for k in ("vx", "vy", "vz"):
            parts[k] = 0.05 * torch.randn(per_shard, generator=gen,
                                          device="cuda", dtype=dt)
        parts["q"] = torch.ones(per_shard, device="cuda", dtype=dt)
        out.append(parts)
    return out


def run_pic(torch) -> dict:
    """Phase 4: the particle-in-cell model (``models/pic.py``; no Pallas
    kernel in either package, so no kernel of the kernels line runs
    here). A small NGP float64 case on the card equals the same on the
    CPU bitwise and its first rho JAX's dense oracle (the port's copy);
    then 256^3 on (2,2,2) shards of 128^3 on the card: CIC float32 at
    ``PIC_PER_CELL`` particles a cell for ``PIC_STEPS`` timed steps
    (particle steps/s), 18 messages a shard a step, the total charge
    within 1e-5 of the count; and NGP float64 at 1 particle a cell, the
    total charge equal to the count exactly after each step."""
    import numpy as np

    from stencil_tpu_torch.models.pic import Pic, dense_reference_rho
    from stencil_tpu_torch.parallel.exchange import WireProbe

    out = {}
    card = card_line()
    devs = [CARD] * 8
    rng = np.random.default_rng(11)
    n = 48
    ics = {"x": rng.uniform(0, 9, n), "y": rng.uniform(0, 9, n),
           "z": rng.uniform(0, 9, n), "vx": rng.normal(0, 0.3, n),
           "vy": rng.normal(0, 0.3, n), "vz": rng.normal(0, 0.3, n)}
    small = {}
    for label, d in (("card", devs), ("cpu", ["cpu"] * 8)):
        p = Pic(9, 9, 9, n, mesh_shape=PIC_MESH, devices=d,
                dtype=torch.float64, deposition="ngp", capacity=n,
                init=False)
        p.set_particles(ics)
        p.step()
        rho1 = p.rho()
        p.run(3)
        small[label] = (rho1, p.rho(), p.particles_to_host())
    oracle = dense_reference_rho(ics["x"], ics["y"], ics["z"], np.ones(n),
                                 (9, 9, 9), deposition="ngp")
    same = (np.array_equal(small["card"][0], oracle)
            and np.array_equal(small["card"][1], small["cpu"][1])
            and all(np.array_equal(small["card"][2][k], small["cpu"][2][k])
                    for k in small["cpu"][2]))
    log(f"  PIC NGP float64 9^3 (2,2,2), 4 steps: card vs CPU and the "
        f"first rho vs the dense oracle: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not same:
        raise AssertionError("PIC on the card disagrees with the CPU")
    g = PIC_GRID
    shards = 8
    for label, dtype, dep, per_cell in (
            ("CIC float32", torch.float32, "cic", PIC_PER_CELL),
            ("NGP float64", torch.float64, "ngp", 1)):
        total = per_cell * g ** 3
        p = Pic(g, g, g, total, mesh_shape=PIC_MESH, devices=devs,
                dtype=dtype, deposition=dep, init=False)
        p.set_shard_particles(pic_shard_particles(torch, p, total // shards,
                                                  seed=5))
        p.probe = WireProbe()
        p.step()
        p.block()
        msgs = len(p.probe.records) / shards
        p.probe = None
        charges = [p.total_charge()]
        secs = []
        for _ in range(PIC_STEPS):
            t0 = time.perf_counter()
            p.step()
            p.block()
            secs.append(time.perf_counter() - t0)
            charges.append(p.total_charge())
        rate = total * PIC_STEPS / sum(secs)
        ovf = p.overflow_total()
        log(f"  PIC {label} {g}^3 on {PIC_MESH} shards of {g // 2}^3, "
            f"{total} particles ({per_cell} a cell): {rate!r} particle "
            f"steps/s (step seconds {secs}; card: {card}); {msgs!r} "
            f"messages a shard a step; total charge {charges}; overflow "
            f"{ovf}")
        if msgs != 18:
            raise AssertionError(f"PIC sent {msgs} messages a shard a step")
        if dep == "ngp":
            if charges != [float(total)] * len(charges):
                raise AssertionError("NGP float64 charge is not exact")
        elif not all(abs(c - total) <= 1e-5 * total for c in charges):
            raise AssertionError("CIC float32 charge drifted")
        if not np.isfinite(p.rho()).all():
            raise AssertionError(f"PIC {label}: non-finite rho")
        out[label] = {"particles": total, "particle_steps_per_s": rate,
                      "step_seconds": secs, "total_charge": charges,
                      "messages_per_shard_step": msgs, "overflow": ovf,
                      "migration": p.migration_stats()}
        del p
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# phase 4: segments (parallel/megastep.py)
# ---------------------------------------------------------------------------
SEG_K = 5               # steps a Jacobi segment: chunks 2, 2, 1 on wrap/halo
SEG_RUNS = 2            # segment runs held against the stepwise twin
#: (label, kernel, mesh, model kwargs, kernels the path must launch)
SEG_JACOBI = (
    ("wrap float32", "wrap", (1, 1, 1), {},
     ("jacobi7_wrapn", "jacobi7_wrap")),
    ("wrap bfloat16", "wrap", (1, 1, 1), {"dtype": "bfloat16"},
     ("jacobi7_wrapn", "jacobi7_wrap")),
    ("halo (1,2,2)", "halo", (1, 2, 2), {},
     ("jacobi7_halon", "jacobi7_halo")),
    ("overlap (1,2,2)", "halo", (1, 2, 2), {"overlap": True},
     ("jacobi7_overlap",)),
    ("pallas PallasDMA (1,2,2)", "pallas", (1, 2, 2),
     {"methods": "PallasDMA"}, ("jacobi7_padded", "exchange_axis")),
    ("xla", "xla", (1, 1, 1), {}, ()),
)
SEG_RACE_K = 8
SEG_RACE_STEPS = 48
SEG_RACE_REPS = 3


def all_launches():
    """Every kernel wrapper's launch count, by kernel name."""
    from stencil_tpu_torch.ops import cuda_exchange as cx
    from stencil_tpu_torch.ops import cuda_halo as ch
    from stencil_tpu_torch.ops import cuda_mhd as cm
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
    from stencil_tpu_torch.ops import cuda_overlap as co
    from stencil_tpu_torch.ops import cuda_stencil as cs

    out = {}
    for mod in (cs, ch, co, cx, cm, mo):
        out.update(mod.LAUNCHES)
    return out


def launch_delta(before: dict) -> dict:
    now = all_launches()
    return {k: v - before[k] for k, v in now.items() if v != before[k]}


def checked_segment(torch, seg, base: int, sentinel=None):
    """``seg.run(base)`` and the queued copy of its trace to the host
    (``sentinel.observe_segment``), with every host synchronization an
    error (``torch.cuda.set_sync_debug_mode``)."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        tr = seg.run(base)
        if sentinel is not None:
            sentinel.observe_segment(tr, tr.abs_steps)
        return tr
    finally:
        torch.cuda.set_sync_debug_mode("default")


def segment_against_stepwise(torch, a, b, sentinel_of, fields_of, k: int,
                             runs: int):
    """``runs`` segments of ``k`` on model ``b`` (``checked_segment``)
    and, on its twin ``a``, the same chunks stepwise with a sentinel
    probe after each: (the segments' probe records, the stepwise
    probes' records, the launches of ``a``, the launches of ``b``). The
    records hold every element of a trace row (counts, max |finite| and
    extra columns, float32 values as Python floats: exact)."""
    seg = b.make_segment(k)
    chunks = [q - p for p, q in zip((0,) + seg.probe_steps,
                                    seg.probe_steps)]
    sa = sentinel_of(a)
    before = all_launches()
    for r in range(runs):
        for c, step in zip(chunks, seg.probe_steps):
            a.run(c)
            sa.probe(fields_of(a), r * k + step)
    a.block()
    la = launch_delta(before)
    sb = sentinel_of(b)
    before = all_launches()
    for r in range(runs):
        checked_segment(torch, seg, r * k, sb)
    b.block()
    lb = launch_delta(before)
    want = [x.to_record() for x in sa.poll(block=True)]
    got = [x.to_record() for x in sb.poll(block=True)]
    if any(x["tripped"] for x in got + want):
        raise AssertionError("a clean run tripped its sentinel")
    return got, want, la, lb


def run_segments(torch) -> dict:
    """Phase 4: segments (``make_segment``) on the card, each against a
    stepwise twin: fields and trace bitwise, launches equal, no host
    sync inside a segment, a planted NaN trips the first row; Astaroth's
    kernel paths decline; the race and the probe's cost."""
    from stencil_tpu_torch.apps._common import megastep_race
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.pic import PARTICLE_STATE_KEYS, Pic
    from stencil_tpu_torch.parallel.megastep import (
        DECLINE_INTERIOR_RESIDENT_STATE)
    from stencil_tpu_torch.parallel.methods import Method
    from stencil_tpu_torch.resilience.health import (HealthSentinel,
                                                     probe_mesh)

    card = card_line()
    out = {"jacobi": {}, "launches": {}}
    for label, kernel, mesh, kw, kernels in SEG_JACOBI:
        kw = dict(kw)
        if "dtype" in kw:
            kw["dtype"] = getattr(torch, kw["dtype"])
        if "methods" in kw:
            kw["methods"] = getattr(Method, kw["methods"])
        a = jacobi_mesh(kernel, mesh, **kw)
        b = jacobi_mesh(kernel, mesh, **kw)
        t0 = time.perf_counter()
        got, want, la, lb = segment_against_stepwise(
            torch, a, b, lambda m: HealthSentinel(m.dd),
            lambda m: m.dd.curr, SEG_K, SEG_RUNS)
        same = torch.equal(gather(torch, a), gather(torch, b)) and \
            got == want
        if kw.get("overlap"):
            # the overlap segment is built on B7's schedule certificate
            cert = b._schedule_certificate
            log(f"  segment {label}: schedule certificate {cert.to_dict()}")
            if not cert.replay_safe:
                raise AssertionError(f"segment {label}: uncertified")
        log(f"  segment {label} 512^3, {SEG_RUNS} x make_segment({SEG_K}) "
            f"({b.kernel_path}, probe steps {list(b.make_segment(SEG_K).probe_steps)}) "
            f"vs stepwise: fields and trace "
            f"{'bitwise equal' if same else 'DIFFERENT'}; launches "
            f"segments {lb} stepwise {la}; no host sync inside "
            f"({time.perf_counter() - t0:.1f} s)")
        if not same:
            raise AssertionError(f"segment {label} disagrees with stepwise")
        if la != lb or any(lb.get(n, 0) < 1 for n in kernels):
            raise AssertionError(f"segment {label}: launches {lb} against "
                                 f"stepwise {la}, kernels {kernels}")
        # a NaN planted before a segment trips its first row
        t = b.dd.interior("temp", 0)
        t[t.shape[0] // 2, t.shape[1] // 2, t.shape[2] // 2] = float("nan")
        seg = b.make_segment(SEG_K)
        sent = HealthSentinel(b.dd)
        tr = checked_segment(torch, seg, 100, sent)
        rows = sent.poll(block=True)
        first = sent.tripped.step if sent.tripped else None
        log(f"  segment {label}: NaN planted before make_segment({SEG_K})"
            f".run(100): tripped at step {first} (want "
            f"{tr.abs_steps[0]}), non-finite cells a row "
            f"{[r.nonfinite['temp'] for r in rows]}")
        if first != tr.abs_steps[0]:
            raise AssertionError(f"segment {label}: the planted NaN "
                                 f"tripped {first}")
        for n, v in lb.items():
            out["launches"][n] = out["launches"].get(n, 0) + v
        out["jacobi"][label] = {"path": b.kernel_path, "launches": lb,
                                "tripped_step": first}
        del a, b, seg, t
        torch.cuda.empty_cache()

    # Astaroth 256^3 xla-temporal[s=2]: one period and a tail
    def mhd():
        return Astaroth(N256, N256, N256, kernel="xla", exchange_every=2,
                        dtype=torch.float32, devices=[CARD])

    a = mhd()
    a.init()
    b = mhd()
    seed_state(torch, b, a)
    t0 = time.perf_counter()
    got, want, la, lb = segment_against_stepwise(
        torch, a, b, lambda m: HealthSentinel(m.dd), lambda m: m.dd.curr,
        3, 1)
    fa, wa = state_of(torch, a)
    fb, wb = state_of(torch, b)
    same = (got == want
            and all(torch.equal(fa[q], fb[q]) for q in fa)
            and all(torch.equal(wa[q], wb[q]) for q in wa))
    log(f"  segment Astaroth 256^3 {b.kernel_path}, make_segment(3) "
        f"(probe steps {list(b.make_segment(3).probe_steps)}) vs stepwise: "
        f"fields, w and trace {'bitwise equal' if same else 'DIFFERENT'}; "
        f"launches {lb} / {la}; no host sync inside "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same or la != lb:
        raise AssertionError("the Astaroth segment disagrees with stepwise")
    out["astaroth"] = {"path": b.kernel_path, "launches": lb}
    del a, b, fa, wa, fb, wb
    torch.cuda.empty_cache()
    declines = {}
    for kernel, overlap, mesh in (("wrap", False, (1, 1, 1)),
                                  ("halo", False, (1, 2, 2)),
                                  ("halo", True, (1, 2, 2))):
        m = Astaroth(32, 32, 32, kernel=kernel, overlap=overlap,
                     mesh_shape=mesh,
                     devices=[CARD] * (mesh[1] * mesh[2]))
        d = m.make_segment(2)
        declines[m.kernel_path] = getattr(d, "code", None)
        if d or d.code != DECLINE_INTERIOR_RESIDENT_STATE:
            raise AssertionError(f"Astaroth {m.kernel_path} did not "
                                 f"decline: {d!r}")
    log(f"  Astaroth kernel paths decline: {declines}")
    out["astaroth_declines"] = declines

    # PIC 256^3 NGP float64 on (2,2,2), one particle a cell
    g = PIC_GRID
    total = g ** 3

    def pic():
        p = Pic(g, g, g, total, mesh_shape=PIC_MESH, devices=[CARD] * 8,
                dtype=torch.float64, deposition="ngp", init=False)
        p.set_shard_particles(pic_shard_particles(torch, p, total // 8,
                                                  seed=5))
        return p

    a, b = pic(), pic()
    t0 = time.perf_counter()
    got, want, la, lb = segment_against_stepwise(
        torch, a, b, lambda m: m.make_sentinel(), lambda m: m.state, 2, 1)
    same = got == want and all(
        torch.equal(u, v) for k in ("rho",) + PARTICLE_STATE_KEYS
        for u, v in zip(a.state[k], b.state[k]))
    log(f"  segment PIC {g}^3 NGP float64 {PIC_MESH}, make_segment(2) vs "
        f"stepwise: every state tensor and the trace "
        f"{'bitwise equal' if same else 'DIFFERENT'}; overflow column "
        f"{[x['metrics'] for x in got]}; no host sync inside "
        f"({time.perf_counter() - t0:.1f} s)")
    if not same:
        raise AssertionError("the PIC segment disagrees with stepwise")
    del a, b
    torch.cuda.empty_cache()

    # the race (three pooled, each beside) and the probe's cost a row
    races = {}
    for label, kernel, mesh in (("wrap 512^3", "wrap", (1, 1, 1)),
                                ("halo 512^3 (1,2,2)", "halo", (1, 2, 2))):
        runs = [megastep_race(lambda: jacobi_mesh(kernel, mesh),
                              lambda m: HealthSentinel(m.dd),
                              lambda m: m.dd.curr, SEG_RACE_K,
                              SEG_RACE_STEPS)
                for _ in range(SEG_RACE_REPS)]
        n = SEG_RACE_REPS * SEG_RACE_STEPS
        step = n / sum(SEG_RACE_STEPS / r[0] for r in runs)
        fused = n / sum(SEG_RACE_STEPS / r[1] for r in runs)
        races[label] = {"stepwise_steps_per_s": step,
                        "fused_steps_per_s": fused,
                        "runs": [list(r) for r in runs]}
        log(f"  megastep_race {label}, k={SEG_RACE_K}, "
            f"{SEG_RACE_STEPS} steps: stepwise {step!r} steps/s, segments "
            f"{fused!r} steps/s, pooled over {SEG_RACE_REPS} "
            f"(stepwise, segments, ratio each: {runs}) (card: {card})")
        torch.cuda.empty_cache()
    probe_ms = {}
    for label, kernel, mesh in (("512^3 one shard", "wrap", (1, 1, 1)),
                                ("512^3 four shards (1,2,2)", "halo",
                                 (1, 2, 2))):
        j = jacobi_mesh(kernel, mesh)
        fields = {"temp": j.dd.curr["temp"]}
        ms = event_ms(torch, lambda: probe_mesh(fields, j.dd.mesh), 10)
        nbytes = sum(t.numel() * t.element_size() for t in fields["temp"])
        bound, by = bound_ms(nbytes, 0.0)
        probe_ms[label] = {"ms": ms, "bound_ms": bound, "bound_by": by,
                           "bytes": nbytes}
        log(f"  probe row, {label} float32: {ms!r} ms (bound {bound!r} "
            f"ms: {nbytes} padded bytes over 3.35 TB/s) (card: {card})")
        del j, fields
        torch.cuda.empty_cache()
    out["race"] = races
    out["probe_ms"] = probe_ms
    out["card"] = card
    return out


# ---------------------------------------------------------------------------
# phase 4: resilience and placement (resilience/driver.py, placement.py)
# ---------------------------------------------------------------------------
#: the events of JAX's driver for the phase's fault plans (as ``(kind,
#: step)``; ``tests/test_torch_resilience.py`` holds the port's CPU runs
#: of the same plans and these lists against JAX's driver). On the card
#: an async checkpoint's event may come later than on the CPU (it is
#: written once its device copies are done), so the phase compares them
#: as multisets and records whether the order matched
RES_EVENTS = {
    "wrap nan": [("checkpoint", 0), ("checkpoint", 20), ("fault_nan", 25),
                 ("sentinel_tripped", 25), ("restored", 20),
                 ("checkpoint", 40)],
    "halo degrade": [("checkpoint", 0), ("checkpoint", 4), ("fault_nan", 5),
                     ("sentinel_tripped", 5), ("restored", 4),
                     ("fault_nan", 5), ("sentinel_tripped", 5),
                     ("degraded", None), ("restored", 4),
                     ("checkpoint", 8), ("checkpoint", 10)],
    "wrap preempt": [("checkpoint", 0), ("checkpoint", 10),
                     ("fault_preemption", 20), ("checkpoint", 20),
                     ("preempted", 20)],
    "astaroth nan": [("checkpoint", 0), ("checkpoint", 2), ("fault_nan", 3),
                     ("sentinel_tripped", 3), ("restored", 2),
                     ("checkpoint", 4)],
    "pic loss": [("checkpoint", 0), ("checkpoint", 2),
                 ("fault_particle_loss", 3), ("sentinel_tripped", 3),
                 ("restored", 2), ("checkpoint", 4), ("checkpoint", 6)],
}
#: the fault plans (constructor arguments) and policies of the cases
RES_PLANS = {
    "wrap nan": ({"nans": [{"step": 25}]},
                 {"check_every": 10, "ckpt_every": 20}, 40),
    "halo degrade": ({"nans": [{"step": 5, "repeat": 2}]},
                     {"check_every": 2, "ckpt_every": 4, "max_retries": 1},
                     10),
    "wrap preempt": ({"preemptions": [{"step": 20}]},
                     {"check_every": 10, "ckpt_every": 10}, 40),
    "astaroth nan": ({"nans": [{"step": 3, "quantity": "uux"}]},
                     {"check_every": 1, "ckpt_every": 2}, 4),
    "pic loss": ({"particle_losses": [{"step": 3, "count": 2,
                                       "shard": (1, 0, 0)}]},
                 {"check_every": 2, "ckpt_every": 2}, 6),
}
RES_PIC_GRID = 128      # (2,2,2) shards of 64^3, 4 particles a cell
RES_IO_REPS = 2


def fault_plan(spec: dict):
    """A ``FaultPlan`` from a ``RES_PLANS`` description."""
    from stencil_tpu_torch import resilience as rs

    cls = {"nans": rs.NaNInjection, "preemptions": rs.Preemption,
           "particle_losses": rs.ParticleLoss}
    return rs.FaultPlan(**{k: [cls[k](**a) for a in v]
                           for k, v in spec.items()})


def res_policy(**kw):
    from stencil_tpu_torch.resilience import ResiliencePolicy

    return ResiliencePolicy(base_delay=0.0, sleep=lambda s: None,
                            max_to_keep=2, **kw)


def res_events(rep) -> list:
    """A report's ``(kind, step)`` events but the fused-decline notes and
    the observatory's ``perf_*`` events, which follow the card's clock
    (as the CPU tests compare them)."""
    return [(e["event"], e.get("step")) for e in rep.events
            if e["event"] != "fused_decline"
            and not e["event"].startswith("perf_")]


def sum_launches(*deltas) -> dict:
    out = {}
    for d in deltas:
        for k, v in d.items():
            out[k] = out.get(k, 0) + v
    return {k: v for k, v in out.items() if v}


def timed_launches(torch, fn):
    """(launch delta, seconds) of ``fn()`` with the card idle on both
    sides."""
    torch.cuda.synchronize()
    before = all_launches()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return launch_delta(before), time.perf_counter() - t0, out


def rep_events(rep) -> list:
    return [(e["event"], e.get("step")) for e in rep.events]


def split_segments(segs):
    """(kept, replayed) of a campaign's dispatched segments (base, k):
    a segment based at or after a later one's base was rolled back."""
    kept, replayed = [], []
    for b, k in segs:
        while kept and kept[-1][0] >= b:
            replayed.insert(0, kept.pop())
        kept.append((b, k))
    return kept, replayed


def res_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"resilience and placement: {what}")


def run_resilience(torch) -> dict:
    """Phase 4: the resilient campaigns (``run_resilient``), checkpoint
    I/O and QAP placement on the card. Each campaign: JAX's events for
    its plan, the final state bitwise its clean run's (by SHA-256), and
    each kernel's launches equal to the clean run's plus the replayed
    window's; every segment dispatch under the driver's transfer guard
    (``torch.cuda.set_sync_debug_mode("error")``)."""
    import tempfile

    import numpy as np

    from stencil_tpu_torch.apps import bench_qap
    from stencil_tpu_torch.distributed import DistributedDomain
    from stencil_tpu_torch.geometry import Dim3, Radius
    from stencil_tpu_torch import qap
    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams
    from stencil_tpu_torch.models.pic import Pic
    from stencil_tpu_torch.partition import RankPartition
    from stencil_tpu_torch.placement import PlacementStrategy, make_placement
    from stencil_tpu_torch.telemetry import get_registry, get_tracer
    from stencil_tpu_torch.utils import checkpoint as ck

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    out = {"card": card, "launches": {}, "events": {}}

    def sha(j) -> str:
        return digest(gather(torch, j).cpu().numpy())

    def campaign(label, model, ckpt, **kw):
        """Run the campaign of ``label``: (report, launch delta,
        seconds, the segments it dispatched as (base, k) — from the
        driver's ``megastep`` spans —, the steps it ran, replays
        included — its ``stencil_run_steps_total`` delta)."""
        spec, pol, n = RES_PLANS[label]
        tracer = get_tracer()
        steps_total = get_registry().counter("stencil_run_steps_total")
        n0, s0 = len(tracer.finished()), steps_total.value()
        delta, secs, rep = timed_launches(
            torch, lambda: model.run_resilient(
                n, policy=res_policy(**pol), ckpt_dir=ckpt,
                faults=fault_plan(spec), **kw))
        segs = [(sp.attrs["step"], sp.attrs["steps"])
                for sp in tracer.finished()[n0:] if sp.name == "megastep"]
        done = int(steps_total.value() - s0)
        got = res_events(rep)
        # the same events; their order may differ from JAX's CPU run by
        # an async checkpoint, written once its copies are done on the
        # card, so possibly after a later fault's event
        res_check(sorted(got, key=repr) == sorted(RES_EVENTS[label],
                                                  key=repr),
                  f"{label}: events {got} != JAX's {RES_EVENTS[label]}")
        out["events"][label] = {"events": got,
                                "in_jax_order": got == RES_EVENTS[label],
                                "segments": segs, "steps_run": done}
        out["launches"][label] = delta
        return rep, delta, secs, segs, done

    try:
        # A. Jacobi 512^3 wrap, a NaN at 25, restore of step 20. The
        # segments run past the anchor before the trip is harvested
        # (20..25, cut at the fault's step: K2, K2, K1; on the card also
        # 25..30, dispatched before the probe's copy had landed) are the
        # replayed window; after the rollback the fired fault no longer
        # cuts, so the kept segments are those of one run(40)
        j = jacobi_mesh("wrap")
        rep, l_camp, secs_nan, segs, done = campaign(
            "wrap nan", j, os.path.join(root, "a"))
        kept, replayed = split_segments(segs)
        clean = jacobi_mesh("wrap")
        l_clean, _, _ = timed_launches(
            torch, lambda: [clean.run(k) for _, k in kept])
        scratch = jacobi_mesh("wrap")
        l_replay, _, _ = timed_launches(
            torch, lambda: [scratch.run(k) for _, k in replayed])
        del scratch
        plain = jacobi_mesh("wrap")
        plain.run(40)
        want = sum_launches(l_clean, l_replay)
        same = sha(j) == sha(clean) == sha(plain)
        log(f"  resilient Jacobi 512^3 wrap, run_resilient(40) check 10, "
            f"checkpoint 20, NaN at 25: {rep.rollbacks} rollback, "
            f"fused={rep.fused}, segments {segs} ({done} steps run); final "
            f"field {'bitwise equal (SHA-256)' if same else 'DIFFERENT'} "
            f"to a clean run(40); launches {l_camp} = the clean run's "
            f"{l_clean} + the replayed window's {replayed} {l_replay}: "
            f"{l_camp == want}")
        res_check(same and rep.rollbacks == 1 and rep.fused
                  and sum(k for _, k in kept) == 40
                  and done == 40 + sum(k for _, k in replayed),
                  "wrap campaign differs from its clean run")
        res_check(l_camp == want, f"wrap launches {l_camp} != {want}")
        del clean, plain
        # the same campaign without the fault, the plain run, the replay
        j2 = jacobi_mesh("wrap")
        l_free, secs_free, _ = timed_launches(
            torch, lambda: j2.run_resilient(
                40, policy=res_policy(check_every=10, ckpt_every=20),
                ckpt_dir=os.path.join(root, "a_free")))
        p = jacobi_mesh("wrap")
        _, secs_plain, _ = timed_launches(torch, lambda: p.run(40))
        del j2, p
        rates = {"campaign_steps_per_s": 40 / secs_free,
                 "campaign_with_rollback_steps_per_s": 40 / secs_nan,
                 "plain_run_steps_per_s": 40 / secs_plain,
                 "rollback_replay_s": secs_nan - secs_free}
        out["wrap_rates"] = rates
        log(f"  Jacobi 512^3 wrap, 40 steps: campaign (check 10, "
            f"checkpoints 0, 20, 40) {rates['campaign_steps_per_s']!r} "
            f"steps/s, with the NaN rollback "
            f"{rates['campaign_with_rollback_steps_per_s']!r}, plain run() "
            f"{rates['plain_run_steps_per_s']!r}; the rollback's replay "
            f"costs {rates['rollback_replay_s']!r} s (card: {card})")

        # checkpoint I/O at 512^3
        io_s = {"save_s": [], "restore_s": []}
        for r in range(RES_IO_REPS):
            d = os.path.join(root, f"io{r}")
            t0 = time.perf_counter()
            ck.save_domain(j.dd, d, 1)
            io_s["save_s"].append(time.perf_counter() - t0)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ck.restore_domain(j.dd, d)
            torch.cuda.synchronize()
            io_s["restore_s"].append(time.perf_counter() - t0)
        nbytes = 4 * N512 ** 3
        io_s["bytes"] = nbytes
        io_s["save_gb_per_s"] = [nbytes / s / 1e9 for s in io_s["save_s"]]
        io_s["restore_gb_per_s"] = [nbytes / s / 1e9
                                    for s in io_s["restore_s"]]
        out["checkpoint_io_512"] = io_s
        log(f"  checkpoint of Jacobi 512^3 float32 ({nbytes} bytes, "
            f"sha256 per file, write to a temporary directory then rename): "
            f"save {io_s['save_s']} s ({io_s['save_gb_per_s']} GB/s), "
            f"restore {io_s['restore_s']} s ({io_s['restore_gb_per_s']} "
            f"GB/s), the file cache warm (card: {card})")
        del j

        # B. Jacobi 512^3 halo (1,2,2) at exchange_every=2: the ladder
        # degrades to s = 1 after max_retries; the kept segments run at
        # s = 2 up to the restore anchor and at s = 1 after it, the
        # replayed ones at s = 2
        j = jacobi_mesh("halo", (1, 2, 2), exchange_every=2)
        rep, l_camp, _, segs, done = campaign(
            "halo degrade", j, os.path.join(root, "b"))
        kept, replayed = split_segments(segs)
        anchor = [st for ev, st in rep_events(rep) if ev == "restored"][-1]
        ref = jacobi_mesh("halo", (1, 2, 2), exchange_every=2)
        l_ref_a, _, _ = timed_launches(
            torch, lambda: [ref.run(k) for b, k in kept if b < anchor])
        ref1 = jacobi_mesh("halo", (1, 2, 2), exchange_every=1)
        for i in range(4):
            ref1.dd.interior("temp", i).copy_(ref.dd.interior("temp", i))
        l_ref_b, _, _ = timed_launches(
            torch, lambda: [ref1.run(k) for b, k in kept if b >= anchor])
        scratch = jacobi_mesh("halo", (1, 2, 2), exchange_every=2)
        l_replay, _, _ = timed_launches(
            torch, lambda: [scratch.run(k) for _, k in replayed])
        del scratch, ref
        want = sum_launches(l_ref_a, l_ref_b, l_replay)
        same = sha(j) == sha(ref1)
        log(f"  resilient Jacobi 512^3 halo (1,2,2) exchange_every=2, NaN "
            f"at 5 twice, max_retries 1: degradations {rep.degradations}, "
            f"final {rep.final_config}, path {j.kernel_path}, segments "
            f"{segs}; final field {'bitwise equal' if same else 'DIFFERENT'}"
            f" to s = 2 up to the anchor {anchor} and s = 1 after it; "
            f"launches {l_camp} = {l_ref_a} + {l_ref_b} + the replayed "
            f"{replayed} {l_replay}: {l_camp == want}")
        res_check(same and rep.degradations == ["PpermuteSlab[s=1]"]
                  and sum(k for _, k in kept) == 10,
                  "the halo ladder campaign")
        res_check(l_camp == want, f"halo launches {l_camp} != {want}")
        del j, ref1

        # C. preemption at 20 of 40 on wrap, then the resume
        d = os.path.join(root, "c")
        j = jacobi_mesh("wrap")
        rep, l_first, _, _, _ = campaign("wrap preempt", j, d)
        meta = ck.checkpoint_meta(d)
        k = jacobi_mesh("wrap")
        l_second, _, rep2 = timed_launches(
            torch, lambda: k.run_resilient(
                40, policy=res_policy(check_every=10, ckpt_every=10),
                ckpt_dir=d))
        plain = jacobi_mesh("wrap")
        l_plain, _, _ = timed_launches(torch, lambda: plain.run(40))
        same = sha(k) == sha(plain)
        log(f"  preemption at step 20 of 40 (wrap 512^3): preempted="
            f"{rep.preempted}, checkpoint meta preempted={meta['preempted']}"
            f" completed_steps={meta['completed_steps']}; the resume from "
            f"{rep2.resumed_from} to {rep2.steps}: final field "
            f"{'bitwise equal' if same else 'DIFFERENT'} to an "
            f"uninterrupted run(40); launches {sum_launches(l_first, l_second)}"
            f" vs {l_plain}")
        res_check(rep.preempted and meta["preempted"] is True
                  and rep2.resumed_from == 20 and rep2.steps == 40 and same,
                  "preemption and resume")
        res_check(sum_launches(l_first, l_second) == l_plain,
                  "preempted + resumed launches differ from one run(40)")
        del j, k, plain

        # D. Astaroth 256^3 wrap (B9) float32, a NaN at iteration 3
        prm = MhdParams(dt=MHD_PATH_DT)

        def astaroth():
            m = Astaroth(N256, N256, N256, params=prm, kernel="wrap",
                         device=CARD)
            seed_mhd(torch, m, CARD)
            m.block()
            return m

        m = astaroth()
        rep, l_camp, _, _, done = campaign("astaroth nan", m,
                                           os.path.join(root, "d"))
        clean = astaroth()
        l_clean, _, _ = timed_launches(torch, lambda: clean.run(4))
        # stepwise (the wrap path declines segments): every iteration
        # past the anchor that ran before the trip was harvested replays
        scratch = astaroth()
        l_replay, _, _ = timed_launches(torch,
                                        lambda: scratch.run(done - 4))
        del scratch
        same = all(digest(m.field(q)) == digest(clean.field(q))
                   for q in FIELDS)
        want = sum_launches(l_clean, l_replay)
        log(f"  resilient Astaroth 256^3 wrap float32, run_resilient(4) "
            f"checkpoint 2, NaN in uux at 3: {rep.rollbacks} rollback, "
            f"stepwise ({rep.fused_decline_code}), {done} iterations run; "
            f"the 8 fields {'bitwise equal' if same else 'DIFFERENT'} to a "
            f"clean run(4); launches {l_camp} = {l_clean} + the replayed "
            f"{done - 4} iteration(s) {l_replay}: {l_camp == want}")
        res_check(same and rep.rollbacks == 1, "the Astaroth campaign")
        res_check(l_camp == want, f"Astaroth launches {l_camp} != {want}")
        del m, clean
        torch.cuda.empty_cache()

        # E. PIC 128^3 CIC float32 on (2,2,2) with a ParticleLoss
        g = RES_PIC_GRID
        total = PIC_PER_CELL * g ** 3
        p = Pic(g, g, g, total, mesh_shape=PIC_MESH, devices=[CARD] * 8,
                dtype=torch.float32, deposition="cic", init=False)
        p.set_shard_particles(pic_shard_particles(torch, p, total // 8,
                                                  seed=6))
        rep, _, secs, _, _ = campaign("pic loss", p,
                                      os.path.join(root, "e"))
        charge = p.total_charge()
        finite = bool(np.isfinite(p.rho()).all())
        log(f"  resilient PIC {g}^3 CIC float32 on {PIC_MESH}, {total} "
            f"particles, ParticleLoss of 2 at step 3: {rep.rollbacks} "
            f"rollback, fused={rep.fused}, {secs!r} s; total_charge (C1: "
            f"the float32 sum of rho) {charge!r} against {total} "
            f"particles, overflow {p.overflow_total()}")
        res_check(rep.rollbacks == 1 and finite
                  and abs(charge - total) <= 1e-5 * total
                  and p.overflow_total() == 0, "the PIC campaign")
        out["pic"] = {"particles": total, "total_charge": charge,
                      "seconds": secs}
        del p
        torch.cuda.empty_cache()

        # G. placement: the QAP order on (1,2,2) of the card
        part = RankPartition.from_dim(Dim3(N512, N512, N512), Dim3(1, 2, 2))
        pl = make_placement(PlacementStrategy.NodeAware, part, [CARD] * 4,
                            Radius.constant(1), [4], mode="qap")
        q = jacobi_mesh("halo", (1, 2, 2), placement="qap")
        t = jacobi_mesh("halo", (1, 2, 2),
                        placement=PlacementStrategy.Trivial)
        q.run(4)
        t.run(4)
        same = sha(q) == sha(t)
        log(f"  placement: make_placement(NodeAware, mode='qap') on (1,2,2) "
            f"of the card: assignment {pl.assignment} (the domain's "
            f"{q.dd.placement.assignment}); Jacobi halo 512^3 4 steps "
            f"under it {'bitwise equal' if same else 'DIFFERENT'} to the "
            f"trivial order")
        res_check(same and q.dd.placement.assignment == pl.assignment,
                  "QAP order against the trivial order")
        del q, t
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bench_qap.main(["--sizes", "4", "6", "8", "10", "16", "32"])
        for line in buf.getvalue().splitlines():
            log(f"  {line}")
        out["bench_qap"] = buf.getvalue().splitlines()
        out["qap_native"] = qap.native_available()
        log(f"  qap.cpp built natively (g++): {qap.native_available()}")
        res_check(qap.native_available(), "qap.cpp did not build")
        plans = {}
        for layout in ("slab", "irredundant"):
            dd = DistributedDomain(N512, N512, N512, devices=[CARD] * 4)
            dd.set_radius(1)
            dd.set_mesh_shape((1, 2, 2))
            dd.set_wire_layout(layout)
            dd.set_output_prefix(os.path.join(root, f"{layout}_"))
            dd.add_data("temp")
            dd.realize()
            plans[layout] = dd.exchange_bytes_total()
            del dd
            torch.cuda.empty_cache()
        text = open(os.path.join(root, "slab_plan.txt")).read()
        msgs = [int(ln.rsplit(": ", 1)[1].split()[0])
                for ln in text.splitlines() if ln.startswith("message ")]
        out["plan_file"] = {"messages": len(msgs), "bytes": sum(msgs),
                            "exchange_bytes_total_slab": plans["slab"],
                            "exchange_bytes_total_irredundant":
                                plans["irredundant"]}
        log(f"  plan file of the 512^3 (1,2,2) domain: {len(msgs)} "
            f"messages, {sum(msgs)} bytes = exchange_bytes_total() of the "
            f"irredundant layout {plans['irredundant']} (each halo cell "
            f"once), <= the slab layout's {plans['slab']}")
        res_check(len(msgs) == 96 and sum(msgs) == plans["irredundant"]
                  <= plans["slab"], "the plan file's messages")
    finally:
        import shutil

        shutil.rmtree(root, ignore_errors=True)
    return out


PTXAS_KEYS = ("registers", "spill_stores", "spill_loads", "sass")


# the libraries that build a ring kernel: B9/B11, B13's interior and
# B14's shell (csrc/mhd_ring.cuh), K2 and B6 (csrc/jacobi_ring.cuh)
RING_LIBS = ("mhd", "mhd_overlap", "jacobi7", "jacobi_halo", "laplace6")


# ---------------------------------------------------------------------------
# phase 4: autotune and observatory (tuning/, observatory/, telemetry/http)
# ---------------------------------------------------------------------------
def auto_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"autotune and observatory: {what}")


def run_autotune_observatory(torch) -> dict:
    """Phase 4: ``Method.Auto`` on ``Jacobi3D`` 512^3 ``pallas`` (1,2,2),
    the observatory around a resilient campaign, the ``/metrics`` server
    and ``bench_exchange``'s autotune, metrics and ledger options."""
    import tempfile

    card = card_line()
    root = tempfile.mkdtemp(prefix="chip_smoke_tune_")
    out = {"card": card}
    mesh = (1, 2, 2)
    devs = [CARD] * 4
    # Method.Auto reads its plan cache from the environment
    prior_cache = os.environ.get("STENCIL_TUNE_CACHE")
    os.environ["STENCIL_TUNE_CACHE"] = os.path.join(root, "plans.json")
    try:
        return _autotune_observatory(torch, root, out, mesh, devs)
    finally:
        if prior_cache is None:
            os.environ.pop("STENCIL_TUNE_CACHE", None)
        else:
            os.environ["STENCIL_TUNE_CACHE"] = prior_cache
        shutil.rmtree(root, ignore_errors=True)


def _autotune_observatory(torch, root, out, mesh, devs) -> dict:
    import math
    import urllib.request

    from stencil_tpu_torch.apps import bench_exchange
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.observatory import (METRIC_MODEL_ERROR_RATIO,
                                               validate_dump)
    from stencil_tpu_torch.observatory.ledger import (read_ledger,
                                                      validate_ledger)
    from stencil_tpu_torch.parallel.methods import Method
    from stencil_tpu_torch.telemetry import MetricsServer, get_registry
    from stencil_tpu_torch.utils.profiling import autotune_report

    card = out["card"]

    def auto_jacobi():
        # the pallas path sweeps depth 1 only; the tuner times at most
        # four candidates (its default)
        return Jacobi3D(N512, N512, N512, kernel="pallas", mesh_shape=mesh,
                        devices=devs, methods=Method.Auto)

    # 1. Method.Auto: the tuner times its candidates on the four shards
    torch.cuda.synchronize()
    before = all_launches()
    t0 = time.perf_counter()
    j = auto_jacobi()
    torch.cuda.synchronize()
    tune_s = time.perf_counter() - t0
    tune_launches = launch_delta(before)
    plan = j.dd.plan
    win = plan.config
    timed = {k: {"measured_ms": 1e3 * c["measured_s"],
                 "min_ms": 1e3 * c["measured_min_s"],
                 "max_ms": 1e3 * c["measured_max_s"],
                 "model_ms": 1e3 * c["predicted_s"]}
             for k, c in plan.costs.items() if "measured_s" in c}
    fit = plan.coefficients["ici"]
    out.update(winner=win.key(), provenance=plan.provenance,
               measurements=plan.measurements, autotune_wall_s=tune_s,
               candidates_ms_per_step=timed,
               alpha_s=fit["alpha_s"], beta_bytes_per_s=fit["beta_bytes_per_s"],
               tune_launches=tune_launches, tiling=plan.tiling)
    log(autotune_report(plan))
    log(f"  Method.Auto on Jacobi3D 512^3 float32 pallas (1,2,2): winner "
        f"{win.key()} ({plan.provenance}, {plan.measurements} "
        f"measurements, {tune_s!r} s with the realize); fitted alpha "
        f"{fit['alpha_s']!r} s, beta {fit['beta_bytes_per_s']!r} B/s; "
        f"timed candidates (ms a step: the median of the windows, their "
        f"least and most, the model's): {timed}; "
        f"launches while tuning {tune_launches} (card: {card})")
    auto_check(plan.provenance == "tuned" and len(timed) >= 1
               and win.exchange_every == 1 and j.kernel_path == "pallas",
               f"tuned plan {win.key()} {plan.provenance} on path "
               f"{j.kernel_path}")
    j.init()
    j.block()
    before = all_launches()
    j.run(4)
    j.block()
    l_auto = launch_delta(before)
    named = jacobi_mesh("pallas", mesh, methods=Method[win.method])
    before = all_launches()
    named.run(4)
    named.block()
    l_named = launch_delta(before)
    same = equal_bits(torch, gather(torch, j), gather(torch, named))
    want_b4 = 12 if win.method == "PallasDMA" else 0
    out.update(run4_launches=l_auto, named_run4_launches=l_named,
               run4_bitwise=same)
    log(f"  run(4) on the winner: {'bitwise equal' if same else 'DIFFERENT'}"
        f" to the same run with {win.method} named; launches {l_auto} "
        f"against {l_named}")
    auto_check(same and l_auto == l_named
               and l_auto.get("jacobi7_padded") == 16
               and l_auto.get("exchange_axis", 0) == want_b4,
               f"run(4) {same}, launches {l_auto} vs {l_named}")
    del j, named
    # a second realize on the same cache: a hit, nothing measured
    before = all_launches()
    j2 = auto_jacobi()
    hit = j2.dd.plan
    out.update(second_provenance=hit.provenance,
               second_measurements=hit.measurements,
               second_tune_launches=launch_delta(before))
    log(f"  second realize: {hit.config.key()} provenance "
        f"{hit.provenance}, {hit.measurements} measurements")
    auto_check(hit.provenance == "cached" and hit.measurements == 0
               and hit.config == win, f"second realize {hit.provenance} "
               f"{hit.measurements} {hit.config.key()}")
    del j2

    # 2. the observatory around a resilient halo campaign with one NaN
    flight = os.path.join(root, "flight")
    h = jacobi_mesh("halo", mesh)
    rep = h.run_resilient(10, policy=res_policy(
        check_every=2, ckpt_every=4, flight_recorder_dir=flight),
        ckpt_dir=os.path.join(root, "ckpt"),
        faults=fault_plan({"nans": [{"step": 5}]}))
    gauge = get_registry().gauge(METRIC_MODEL_ERROR_RATIO)
    ratio = gauge.value(entry="jacobi", method="PpermuteSlab", s="1")
    dumps = sorted(os.listdir(flight)) if os.path.isdir(flight) else []
    problems = [p for d in dumps
                for p in validate_dump(os.path.join(flight, d))]
    drift = [e for e in rep.events if e["event"] == "perf_drift"]
    out.update(campaign_rollbacks=rep.rollbacks, error_ratio=ratio,
               flight_dumps=dumps, perf_drift_events=len(drift))
    log(f"  resilient halo (1,2,2) 512^3, NaN at 5: {rep.rollbacks} "
        f"rollback, stencil_perf_model_error_ratio {ratio!r}, "
        f"{len(drift)} perf_drift events, flight dumps {dumps} "
        f"{'valid' if not problems else problems}")
    auto_check(rep.rollbacks == 1 and math.isfinite(ratio) and ratio > 0
               and dumps and not problems,
               f"campaign ratio {ratio} dumps {dumps} {problems}")
    del h
    out["attribution_cost"] = attribution_cost(root, mesh)

    # 3. the /metrics server, read once from this process
    with MetricsServer(get_registry(), port=0) as srv:
        body = urllib.request.urlopen(
            f"http://127.0.0.1:{srv.port}/metrics", timeout=10).read()
    text = body.decode()
    out["metrics_bytes"] = len(body)
    log(f"  /metrics on port {srv.port}: {len(body)} bytes, the error "
        f"ratio {'present' if METRIC_MODEL_ERROR_RATIO in text else 'MISSING'}")
    auto_check(METRIC_MODEL_ERROR_RATIO in text
               and "stencil_run_steps_total" in text, "/metrics body")

    # 4. bench_exchange --autotune --tune-cache --metrics-json --ledger
    paths = {k: os.path.join(root, f) for k, f in (
        ("cache", "be_plans.json"), ("metrics", "be_metrics.json"),
        ("ledger", "be_ledger.jsonl"), ("json", "be.json"))}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        bench_exchange.main([
            "--x", "128", "--y", "128", "--z", "128", "--iters", "5",
            "--devices", ",".join(devs), "--mesh-shape", "1,2,2",
            "--autotune", "--tune-cache", paths["cache"],
            "--metrics-json", paths["metrics"], "--ledger", paths["ledger"],
            "--json-out", paths["json"]])
    lines = [ln for ln in buf.getvalue().splitlines()
             if ln.startswith("bench_exchange")]
    records = read_ledger(paths["ledger"])
    bad = validate_ledger(records)
    with open(paths["metrics"]) as f:
        snap = json.load(f)
    out.update(bench_exchange_lines=lines, ledger_records=len(records),
               ledger_benches=[r["bench"] for r in records])
    log(f"  bench_exchange --autotune: {lines}; {len(records)} ledger "
        f"records {'valid' if not bad else bad}, metrics snapshot "
        f"{len(snap.get('metrics', {}))} metrics")
    auto_check(records and not bad and any(
        ln.startswith("bench_exchange_autotune,") for ln in lines)
        and "stencil_bench_tuned_steps_per_s" in snap.get("metrics", {}),
        f"bench_exchange records {bad} lines {lines}")
    return out


def attribution_cost(root, mesh) -> dict:
    """Campaign steps/s of the ``halo`` (1,2,2) runs with ``attribute_perf``
    off and on (the attributor fences the cards after every segment), in
    the order off, on, on, off: the phase's campaign (10 steps, a NaN at
    5, checkpoints every 4, a flight recorder), and 40 clean steps with
    no checkpoints, where the fence is all that differs."""
    cases = {
        "nan_ckpt_10": dict(steps=10, ckpt=True,
                            faults={"nans": [{"step": 5}]}),
        "clean_40": dict(steps=40, ckpt=False, faults=None)}
    res = {}
    for name, c in cases.items():
        rates = {"off": [], "on": []}
        for k, on in enumerate((False, True, True, False)):
            h = jacobi_mesh("halo", mesh)
            tag = f"{name}_{k}"
            pol = res_policy(check_every=2, ckpt_every=4, attribute_perf=on,
                             flight_recorder_dir=os.path.join(
                                 root, "flight_" + tag))
            t0 = time.perf_counter()
            h.run_resilient(
                c["steps"], policy=pol,
                ckpt_dir=(os.path.join(root, "ckpt_" + tag) if c["ckpt"]
                          else None),
                faults=fault_plan(c["faults"]) if c["faults"] else None)
            h.block()
            rates["on" if on else "off"].append(
                c["steps"] / (time.perf_counter() - t0))
            del h
            shutil.rmtree(os.path.join(root, "ckpt_" + tag),
                          ignore_errors=True)
        res[name] = rates
        log(f"  attribution cost, halo (1,2,2) 512^3 {name}: steps/s off "
            f"{rates['off']!r}, on {rates['on']!r}")
    return res


# ---------------------------------------------------------------------------
# phase 4: ensemble serving (serving/)
# ---------------------------------------------------------------------------
SERVE_N = 256           # the Jacobi ensemble's and the service's grid a side
SERVE_WIDTH = 8         # Jacobi ensemble members
SERVE_STEPS = 4         # run(4)
SERVE_RATE_RUNS = 3     # member-steps/s: runs pooled
SERVE_AST_N = 128       # the Astaroth ensemble's grid a side
SERVE_AST_WIDTH = 4
SERVE_FLEET_N = 128     # the fleet's grid a side (its bucket)
SERVE_ATT_STEPS = 32    # the attribution cost's timed wave, member steps
SERVE_TEMPS = {6: (1.5, -0.5), 7: (0.75, 0.25)}   # other hot/cold members


def serve_check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"ensemble serving: {what}")


def b4_table_bytes(fields, radius, counts) -> int:
    """Bytes B4's launch tables of one exchange store: every row's two
    slabs, over every sweep (``ops/cuda_exchange.exchange_plan``; rows
    of a one-shard axis store into the shard itself)."""
    from stencil_tpu_torch.ops import cuda_exchange as cx

    sweeps = [(a, radius.face(a, -1), radius.face(a, 1)) for a in range(3)]
    plan = cx.exchange_plan(cx.member_views(fields), sweeps, counts)
    f = cx.ENTRY_FIELDS
    lo, hi, runs = f.index("lo_run"), f.index("hi_run"), f.index("runs")
    return sum((row[lo] + row[hi]) * row[runs] * cs.unit
               for per_card in plan.launches for cs in per_card
               for row in cs.rows)


def seeded_member(torch, k: int, n: int):
    """Member ``k``'s initial temperature, made on the card from a seed:
    0.5 + 0.01 x uniform noise, (n, n, n)."""
    g = torch.Generator(device=CARD).manual_seed(1000 + k)
    return 0.5 + 0.01 * torch.rand((n, n, n), generator=g, device=CARD)


def serving_plan_cache(root: str, fp: str, method: str) -> str:
    """A plan cache holding one plan that names ``method`` (depth 1) for
    the fingerprint ``fp``."""
    from stencil_tpu_torch.tuning import Candidate, Plan, store_plan

    path = os.path.join(root, f"plans_{method}.json")
    store_plan(Plan(config=Candidate(method=method), fingerprint=fp,
                    coefficients={}, costs={}), path)
    return path


def member_steps_per_s(torch, eng, k: int) -> tuple:
    """Member-steps/s of ``eng.run(k)``: CUDA events around each of
    ``SERVE_RATE_RUNS`` runs after one untimed run, pooled (all member
    steps over all their seconds), and each run's rate."""
    eng.run(1)
    torch.cuda.synchronize()
    ms = []
    for _ in range(SERVE_RATE_RUNS):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        eng.run(k)
        stop.record()
        stop.synchronize()
        ms.append(start.elapsed_time(stop))
    work = eng.n_members * k
    return (1e3 * work * len(ms) / sum(ms), [1e3 * work / m for m in ms])


def run_serving(torch) -> dict:
    """Phase 4: ensemble serving — the Jacobi and Astaroth ensembles
    against their standalone models bitwise, B4 on the member views of
    a PallasDMA plan, the campaign service (tuned plan, warm path,
    member rollback, preemption) and the fleet's replica-kill recovery,
    all on the one card."""
    import tempfile

    root = tempfile.mkdtemp(prefix="chip_smoke_serve_")
    try:
        return _serving(torch, root)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _serving(torch, root) -> dict:
    import numpy as np

    from stencil_tpu_torch.models.astaroth import FIELDS, Astaroth, MhdParams
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.ops import cuda_exchange as cx
    from stencil_tpu_torch.parallel.exchange import WireProbe, dispatch_exchange
    from stencil_tpu_torch.parallel.methods import Method
    from stencil_tpu_torch.serving import EnsembleAstaroth, EnsembleJacobi
    from stencil_tpu_torch.tuning import load_plan

    card = card_line()
    out = {"card": card}
    n = SERVE_N
    grid = (n, n, n)

    # 1. the Jacobi ensemble, width 8 at 256^3 float32, periodic
    def jacobi_ensemble(mesh, width=SERVE_WIDTH, plan=None, temps=True):
        devs = [CARD] * (mesh[0] * mesh[1] * mesh[2])
        eng = EnsembleJacobi(width, *grid, mesh_shape=mesh, devices=devs,
                             plan=plan)
        for k, (hot, cold) in SERVE_TEMPS.items():
            if temps and k < width:
                eng.set_member_params(k, {"hot_temp": hot,
                                          "cold_temp": cold})
        eng.init()
        for k in range(width):
            eng.set_member_interior("temp", k, seeded_member(torch, k, n))
        return eng

    checks = {}
    for mesh in ((1, 1, 1), (1, 2, 2)):
        devs = [CARD] * (mesh[0] * mesh[1] * mesh[2])
        eng = jacobi_ensemble(mesh)
        eng.run(SERVE_STEPS)
        ref = Jacobi3D(*grid, kernel="xla", mesh_shape=mesh, devices=devs)
        same = []
        for k in (0, SERVE_WIDTH - 3):
            ref.init()
            ref.dd.set_interior("temp", seeded_member(torch, k, n))
            ref.run(SERVE_STEPS)
            same.append(np.array_equal(ref.temperature(),
                                       eng.member_interior("temp", k)))
        for k, (hot, cold) in SERVE_TEMPS.items():
            solo = EnsembleJacobi(1, *grid, mesh_shape=mesh, devices=devs)
            solo.set_member_params(0, {"hot_temp": hot, "cold_temp": cold})
            solo.init()
            solo.set_member_interior("temp", 0, seeded_member(torch, k, n))
            solo.run(SERVE_STEPS)
            same.append(np.array_equal(solo.member_interior("temp", 0),
                                       eng.member_interior("temp", k)))
            del solo
        checks[str(mesh)] = same
        log(f"  Jacobi ensemble width {SERVE_WIDTH} {n}^3 {mesh}: members "
            f"0 and {SERVE_WIDTH - 3} against Jacobi3D(kernel='xla'), "
            f"members {sorted(SERVE_TEMPS)} (other hot/cold) against "
            f"one-member ensembles: {'bitwise equal' if all(same) else same}")
        serve_check(all(same), f"Jacobi ensemble {mesh}: {same}")
        del eng, ref
    out["jacobi_bitwise"] = checks

    # 2. B4 on the member views: a plan naming PallasDMA, (1,2,2)
    mesh = (1, 2, 2)
    devs = [CARD] * 4
    fp = EnsembleJacobi(1, *grid, mesh_shape=mesh, devices=devs).fingerprint
    cache = serving_plan_cache(root, fp, "PallasDMA")
    plan = load_plan(fp, cache)
    runs = {}
    # the same initial fields through the plain slab exchange
    plain = jacobi_ensemble(mesh, temps=False)
    plain.run(SERVE_STEPS)
    for width in (1, SERVE_WIDTH):
        eng = jacobi_ensemble(mesh, width=width, plan=plan, temps=False)
        serve_check(eng._method == Method.PallasDMA,
                    f"plan adopted {eng._method}")
        torch.cuda.synchronize()
        cx.reset_launch_counts()
        eng.run(SERVE_STEPS)
        torch.cuda.synchronize()
        launches = cx.LAUNCHES["exchange_axis"]
        dd = eng.dd
        table = b4_table_bytes(list(eng.state.values()), dd.radius,
                               dd.mesh_counts)
        probe = WireProbe()
        copies = {"temp": [t.clone() for t in eng.state["temp"]]}
        dispatch_exchange(copies, dd.radius, dd.mesh_counts,
                          Method.PpermuteSlab, probe=probe)
        def sweeps(eng=eng, dd=dd):
            join = cx.start_sweeps([eng.state["temp"]],
                                   [(a, 1, 1) for a in range(3)],
                                   dd.mesh_counts)
            if join is not None:
                join.exit()

        sweep_ms = event_ms(torch, sweeps, reps=20)
        runs[width] = {"launches_run4": launches, "b4_table_bytes": table,
                       "slab_messages": len(probe.records),
                       "slab_wire_bytes": probe.bytes,
                       "b4_sweeps_ms": sweep_ms, "eng": eng}
    one, many = runs[1], runs[SERVE_WIDTH]
    b4 = {"launches_run4": many["launches_run4"],
          "single_launches_run4": one["launches_run4"],
          # each stored slab read once and written once
          "b4_sweeps_bound_ms": bound_ms(2 * many["b4_table_bytes"], 0)[0]}
    for key in ("b4_table_bytes", "slab_messages", "slab_wire_bytes",
                "b4_sweeps_ms"):
        b4[key] = many[key]
        b4["single_" + key] = one[key]
    # every member of the B4 run against the plain exchange's, and
    # member 0 against the width-1 B4 run
    same = [np.array_equal(many["eng"].member_interior("temp", k),
                           plain.member_interior("temp", k))
            for k in range(SERVE_WIDTH)]
    same.append(np.array_equal(many["eng"].member_interior("temp", 0),
                               one["eng"].member_interior("temp", 0)))
    del plain
    out["b4"] = b4
    log(f"  B4 batched, PallasDMA plan (seeded cache), {n}^3 (1,2,2): "
        f"run({SERVE_STEPS}) launches width {SERVE_WIDTH} "
        f"{many['launches_run4']} against width 1 {one['launches_run4']}; "
        f"B4 table bytes an exchange {many['b4_table_bytes']} against "
        f"{one['b4_table_bytes']} "
        f"(x{many['b4_table_bytes'] / one['b4_table_bytes']!r}); slab "
        f"engine {many['slab_messages']} messages, {many['slab_wire_bytes']}"
        f" wire bytes against {one['slab_messages']}, "
        f"{one['slab_wire_bytes']}; the three sweeps "
        f"{many['b4_sweeps_ms']!r} ms batched against "
        f"{one['b4_sweeps_ms']!r} ms one member (events); members "
        f"0..{SERVE_WIDTH - 1} against the plain slab exchange, member 0 "
        f"against width 1: {'bitwise' if all(same) else same} "
        f"(card: {card})")
    serve_check(
        many["launches_run4"] == one["launches_run4"] == 3 * SERVE_STEPS
        and many["b4_table_bytes"] == SERVE_WIDTH * one["b4_table_bytes"]
        and many["slab_messages"] == one["slab_messages"] > 0
        and many["slab_wire_bytes"] == SERVE_WIDTH * one["slab_wire_bytes"]
        and all(same), f"B4 batched {b4} bitwise {same}")

    # 3. member-steps/s at width 1 and 8: the (1,2,2) PallasDMA
    # ensembles above, and (1,1,1) with the default method
    rates = {"(1,2,2) PallasDMA": {w: member_steps_per_s(
        torch, r["eng"], SERVE_STEPS) for w, r in runs.items()}}
    del runs, one, many
    rates["(1,1,1) Default"] = {}
    for width in (1, SERVE_WIDTH):
        eng = jacobi_ensemble((1, 1, 1), width=width, temps=False)
        rates["(1,1,1) Default"][width] = member_steps_per_s(
            torch, eng, SERVE_STEPS)
        del eng
    out["member_steps_per_s"] = {
        m: {w: r[0] for w, r in per.items()} for m, per in rates.items()}
    out["runs_member_steps_per_s"] = {
        m: {w: r[1] for w, r in per.items()} for m, per in rates.items()}
    for m, per in rates.items():
        log(f"  member-steps/s {n}^3 {m}, pooled over {SERVE_RATE_RUNS} "
            f"runs: width 1 {per[1][0]!r} (each {per[1][1]!r}), width "
            f"{SERVE_WIDTH} {per[SERVE_WIDTH][0]!r} (each "
            f"{per[SERVE_WIDTH][1]!r}) (card: {card})")

    # 4. the Astaroth ensemble, width 4 at 128^3 float32
    an = SERVE_AST_N
    over = {"nu_visc": 7e-3, "eta": 6e-3}
    eng = EnsembleAstaroth(SERVE_AST_WIDTH, an, an, an, mesh_shape=(1, 1, 1),
                           devices=[CARD])
    eng.init(seeds=[20 + k for k in range(SERVE_AST_WIDTH)])
    eng.set_member_params(2, over)
    ics = {k: {q: eng.member_interior(q, k) for q in FIELDS}
           for k in (0, 2)}
    eng.run(1)
    same = []
    for k in (0, 2):
        ref = Astaroth(an, an, an, kernel="xla", mesh_shape=(1, 1, 1),
                       devices=[CARD],
                       params=MhdParams(**(over if k == 2 else {})))
        for q in FIELDS:
            ref.dd.set_interior(q, torch.from_numpy(ics[k][q]))
        ref.run(1)
        same.append(all(np.array_equal(ref.field(q),
                                       eng.member_interior(q, k))
                        for q in FIELDS))
        del ref
    out["astaroth_bitwise"] = same
    log(f"  Astaroth ensemble width {SERVE_AST_WIDTH} {an}^3 float32, "
        f"member 2 on nu_visc/eta {over}: members 0 and 2 against "
        f"Astaroth(kernel='xla') with their coefficients: "
        f"{'bitwise equal' if all(same) else same}")
    serve_check(all(same), f"Astaroth ensemble members {same}")
    del eng

    out["service"] = serving_service(torch, root)
    out["fleet"] = serving_fleet(torch, root)
    return out


def serving_requests(tag: str, chaos: bool = False, n_steps: int = 6,
                     **kw):
    from stencil_tpu_torch.serving import CampaignRequest

    kw.setdefault("ckpt_every", 3)
    return [CampaignRequest(
        tenant=f"t{i}", campaign=tag, grid=(SERVE_N,) * 3, n_steps=n_steps,
        mesh_shape=(1, 2, 2), init_seed=100 + i,
        params={"hot_temp": 1.0 + 0.25 * i},
        chaos_nan_step=4 if chaos and i == 1 else None, **kw)
        for i in range(3)]


def segment_cycle(tracer, lanes: int) -> tuple:
    """From a service's ``segment`` spans of one wave: the seconds from
    one segment's start to the next's (dispatch, the attributor's fence
    when on, the blocking probe poll, the lane bookkeeping) averaged
    over the wave, and the member steps a second over those cycles."""
    segs = sorted((sp for sp in tracer.finished() if sp.name == "segment"),
                  key=lambda sp: sp.start_s)
    cycles = [b.start_s - a.start_s for a, b in zip(segs, segs[1:])]
    steps = sum(sp.attrs["steps"] for sp in segs[:-1]) * lanes
    return sum(cycles) / len(cycles), steps / sum(cycles)


def serving_service(torch, root) -> dict:
    """The campaign service on (1,2,2) of the card: a MeshTimer tunes the
    plan once, three tenants at 256^3 and a warm second wave; a NaN in
    one lane rolls back that lane alone; a preempted campaign resumes;
    the time a segment takes with ``attribute_perf`` off, on, on, off."""
    import numpy as np

    from stencil_tpu_torch.geometry import Dim3
    from stencil_tpu_torch.numerics import div_ceil
    from stencil_tpu_torch.parallel.mesh import Mesh
    from stencil_tpu_torch.serving import CampaignService
    from stencil_tpu_torch.serving.ensemble import request_domain
    from stencil_tpu_torch.telemetry import metric_value
    from stencil_tpu_torch.tuning import MeshTimer

    card = card_line()
    devs = [CARD] * 4
    cache = os.path.join(root, "service_plans.json")
    dd = request_domain(serving_requests("probe")[0], devs)
    dim = dd._choose_partition_dim()
    timer = MeshTimer(Mesh(dim, dd._choose_placement(
        dim, dd._discover_dcn_groups()).slot_order_for_mesh()),
        Dim3(*(div_ceil(dd.size[a], dim[a]) for a in range(3))),
        [dd._dtypes[q] for q in dd._names])

    def service(tag, **kw):
        return CampaignService(os.path.join(root, tag), devices=devs,
                               width=4, tuner_timer=timer,
                               plan_cache_path=cache, **kw)

    out = {}
    svc = service("svc")
    hs = [svc.submit(r) for r in serving_requests("wave1", chaos=True)]
    svc.drain()
    res = [h.result(timeout=0) for h in hs]
    eng = next(iter(svc._engines.values()))
    plan = eng.dd.plan
    text1 = metric_value(svc.metrics_text(),
                         "stencil_service_tuner_measurements_total")
    warm = svc.submit(serving_requests("wave2")[0])
    svc.drain()
    warm_res = warm.result(timeout=0)
    text = svc.metrics_text()
    recompiles = metric_value(text, "stencil_service_recompiles_total")
    meas = metric_value(text, "stencil_service_tuner_measurements_total")
    out.update(plan=plan.config.key(), plan_provenance=plan.provenance,
               tune_measurements=text1, recompiles=recompiles,
               warm_measurements=meas - text1,
               rollbacks=[r.rollbacks for r in res])
    log(f"  service (1,2,2) {SERVE_N}^3, MeshTimer: adopted plan "
        f"{plan.config.key()} ({plan.provenance}, {int(text1)} "
        f"measurements); rollbacks {[r.rollbacks for r in res]}; warm "
        f"wave: recompiles {recompiles}, measurements {meas - text1} "
        f"(metrics_text)")
    serve_check(recompiles == 0 and meas == text1 and text1 > 0
                and warm_res.steps == 6
                and [r.rollbacks for r in res] == [0, 1, 0],
                f"service {out}")
    calm = service("calm")
    hc = [calm.submit(r) for r in serving_requests("wave1")]
    calm.drain()
    same = [np.array_equal(h.result(timeout=0).final["temp"], r.final["temp"])
            for h, r in zip(hc, res)]
    out["chaos_vs_clean_bitwise"] = same
    log(f"  NaN in t1's lane at step 4: rolled back alone; t0, t1, t2 "
        f"against a clean service: {same}")
    serve_check(all(same), f"service lanes against a clean run {same}")
    # preempt at step 3, resume in a new service: bitwise the clean run
    pre = service("pre")
    pre.arm_preempt_at(3)
    hp = pre.submit(serving_requests("wave1")[0])
    pre.drain()
    r_pre = hp.result(timeout=0)
    pre2 = CampaignService(os.path.join(root, "pre"), devices=devs,
                           width=4, tuner_timer=timer, plan_cache_path=cache)
    hr = pre2.submit(serving_requests("wave1")[0])
    pre2.drain()
    r_res = hr.result(timeout=0)
    resumed = np.array_equal(r_res.final["temp"],
                             hc[0].result(timeout=0).final["temp"])
    out.update(preempted_at=r_pre.steps, resumed_from=r_res.resumed_from,
               resume_bitwise=resumed)
    log(f"  preempted at step {r_pre.steps}, resumed from "
        f"{r_res.resumed_from}: {'bitwise' if resumed else 'DIFFERENT'} "
        f"the clean run")
    serve_check(r_pre.preempted and r_pre.steps == 3
                and r_res.resumed_from == 3 and resumed,
                f"preempt/resume {r_pre.steps} {r_res.resumed_from}")
    del svc, calm, pre, pre2
    # the attributor's cost: attribute_perf off, on, on, off; each
    # service warmed by a two-step wave (engine, plan, attributor built),
    # then a wave of SERVE_ATT_STEPS one-step segments (check_every 1,
    # the default) timed by its own segment spans
    cycle = {"off": [], "on": []}
    rates = {"off": [], "on": []}
    for k, on in enumerate((False, True, True, False)):
        s = service(f"att{k}", attribute_perf=on)
        for r in serving_requests(f"att{k}warm", n_steps=2, ckpt_every=0):
            s.submit(r)
        s.drain()
        s.tracer.clear()
        hs = [s.submit(r) for r in serving_requests(
            f"att{k}", n_steps=SERVE_ATT_STEPS, ckpt_every=0)]
        s.drain()
        serve_check(all(h.result(timeout=0).steps == SERVE_ATT_STEPS
                        for h in hs), f"attribution wave att{k}")
        sec, rate = segment_cycle(s.tracer, len(hs))
        cycle["on" if on else "off"].append(sec)
        rates["on" if on else "off"].append(rate)
        del s
    out["segment_s"] = cycle
    out["segment_member_steps_per_s"] = rates
    log(f"  service segments (3 tenants x {SERVE_ATT_STEPS} one-step "
        f"segments after a warm wave, width 4, {SERVE_N}^3 (1,2,2); "
        f"segment span start to start): attribute_perf off "
        f"{cycle['off']!r} s ({rates['off']!r} member steps/s), on "
        f"{cycle['on']!r} s ({rates['on']!r}) (card: {card})")
    return out


def serving_fleet(torch, root) -> dict:
    """Three replicas sharing the card at 128^3 (buckets 64^3, 128^3),
    four tenants (one grid padded up to its bucket); the replica that
    owns t0 is killed at member step 2: every campaign equals its calm
    run bitwise."""
    import numpy as np

    from stencil_tpu_torch.resilience.faults import ReplicaCrash
    from stencil_tpu_torch.serving import (CampaignRequest, Fleet,
                                           rendezvous_replica)
    from stencil_tpu_torch.serving.queue import request_fingerprint

    n = SERVE_FLEET_N
    buckets = ((64, 64, 64), (n, n, n))
    plans = os.path.join(root, "fleet_plans.json")

    def reqs():
        return [CampaignRequest(
            tenant=f"t{i}", campaign="c0",
            grid=(n * 25 // 32, n, n) if i == 3 else (n, n, n), n_steps=6,
            ckpt_every=2, init_seed=200 + i,
            params={"hot_temp": 1.0 + 0.05 * i}) for i in range(4)]

    def fleet(tag, chaos=()):
        return Fleet(os.path.join(root, tag), n_replicas=3, devices=[CARD],
                     width=4, plan_cache_path=plans, buckets=buckets,
                     chaos=chaos)

    calm = fleet("calm")
    hc = [calm.submit(r) for r in reqs()]
    calm.serve()
    r0 = reqs()[0]
    fp = request_fingerprint(r0, devices=[CARD])
    victim = int(rendezvous_replica(
        f"{fp}|t0", [f"replica-{i}" for i in range(3)]).rsplit("-", 1)[1])
    chaos = fleet("chaos", [ReplicaCrash(step=0, replica=victim,
                                         at_member_step=2)])
    hs = [chaos.submit(r) for r in reqs()]
    chaos.serve()
    same = [np.array_equal(a.result(timeout=0).final["temp"],
                           b.result(timeout=0).final["temp"])
            for a, b in zip(hc, hs)]
    states = [r.state for r in chaos.replicas]
    resumed = [h.result(timeout=0).resumed_from for h in hs]
    log(f"  fleet 3 replicas {n}^3, buckets {buckets}, 4 tenants: "
        f"replica-{victim} killed at step 2; replicas {states}; resumed "
        f"from {resumed}; every campaign against the calm fleet: "
        f"{'bitwise equal' if all(same) else same}")
    serve_check(all(same) and states.count("dead") == 1
                and any(r == 2 for r in resumed),
                f"fleet recovery {same} {states} {resumed}")
    return {"victim": victim, "states": states, "resumed_from": resumed,
            "bitwise": same}


def _storage(name: str, m) -> tuple:
    """The storage types after a match of the bool template arguments: ()
    for the float32 instance, else ("bf16", ...) or the (TIn, TOut) pair
    of a mixed instance."""
    rest = name[m.end():]
    if rest.startswith("ffE") or rest.startswith("fE"):
        return ()
    if rest.startswith("13__nv_bfloat16S1_E") or rest.startswith(
            "13__nv_bfloat16E"):
        return ("bf16",)
    if rest.startswith("13__nv_bfloat16fE"):
        return ("bf16->f32",)
    if rest.startswith("f13__nv_bfloat16E"):
        return ("f32->bf16",)
    return ("?",)


def kernel_key(lib: str, name: str):
    """(library, read_w, write_w) of an MHD ring-kernel instantiation
    (``mhd_substep_ring_kernel<kReadW, kWriteW, TIn, TOut>``, which the
    ``mhd`` library launches as B9 and B11 and ``mhd_overlap`` as B13's
    interior, and twice each as B10 and B12), (library, "shell", read_w,
    write_w) of B14's (``mhd_shell_kernel``, the ring's z and y
    instances), (library, "margin") of B12's margin
    (``mhd_margin_kernel``, the same two instances), each followed by
    its storage types where they are not float32 ("bf16", or the pair's
    "bf16->f32" and "f32->bf16"), (library, "send_rows", ...) of B13's
    sends, (library, "jacobi_ring") of the Jacobi ring kernel (K2 in
    ``jacobi7``, B6 in ``jacobi_halo``; "padded" for the source of B6's
    second launch of 9 to 16 steps, and "bf16" for bfloat16), or
    (library, "laplace6_ring", cells a copy or load, vector stores[,
    "bf16"]) of B8's (``laplace6_ring_kernel<T, kChunk, kVecOut>``), from
    its mangled name,
    else None."""
    import re

    if lib not in RING_LIBS:
        return None
    m = re.search(r"mhd_substep_ring_kernelILb(\d)ELb(\d)E", name)
    if m:
        return (lib, m.group(1) == "1", m.group(2) == "1") + _storage(name, m)
    m = re.search(r"mhd_shell_kernelILb(\d)ELb(\d)E", name)
    if m:
        return ((lib, "shell", m.group(1) == "1", m.group(2) == "1")
                + _storage(name, m))
    m = re.search(r"mhd_margin_kernelI", name)
    if m:
        return (lib, "margin") + _storage(name, m)
    m = re.search(r"send_rows_kernelI", name)
    if m:
        return (lib, "send_rows") + _storage(name, m)
    m = re.search(r"jacobi_ring_kernelILi(\d)E", name)
    if m:
        src = ("padded",) if m.group(1) == "2" else ()
        return (lib, "jacobi_ring") + src + _storage(name, m)
    m = re.search(r"laplace6_ring_kernelI(f|13__nv_bfloat16)Li(\d)ELb(\d)E",
                  name)
    if m:
        return ((lib, "laplace6_ring", int(m.group(2)), m.group(3) == "1")
                + (("bf16",) if m.group(1) != "f" else ()))
    return None


# ----------------------------------------------------------------------
# phase 4: two ranks on the one card (multi-process meshes)
# ----------------------------------------------------------------------
TWO_RANK_STEPS = 21
TWO_RANK_MHD_ITERS = 2
#: timed runs a case, pooled (host-clocked rates can halve between runs)
TWO_RANK_REPS = 3
#: untimed steps (iterations) first, the same in every process
TWO_RANK_WARMUP = {"jacobi": 2, "astaroth": 1, "pic": 0}
TWO_RANK_MESH = (1, 2, 2)
TWO_RANK_SIZE = {"jacobi": "512^3", "astaroth": "256x512x512",
                 "pic": "256^3 NGP float64"}
TWO_RANK_OUT = os.path.join("chiprun_out", "two_ranks")


def digest(a) -> str:
    """SHA-256 of a numpy array's bytes: equal digests are equal bits."""
    import hashlib

    import numpy as np

    return hashlib.sha256(memoryview(np.ascontiguousarray(a))).hexdigest()


def seed_mhd(torch, m, card: str, seed: int = 18) -> None:
    """An Astaroth state drawn on the card from ``seed`` (the same bits
    in every process): lnrho 0.5, the velocities in [-0.1, 0.1), the
    other fields in [-1, 1). A host ``init()`` of 256 x 512 x 512 takes
    seconds a model."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    d = m.dd.size
    gen = torch.Generator(device=card).manual_seed(seed)
    for q in FIELDS:
        v = torch.rand((d.z, d.y, d.x), generator=gen, device=card) * 2 - 1
        if q == "lnrho":
            v.fill_(0.5)
        elif q.startswith("uu"):
            v *= 0.1
        m.dd.set_interior(q, v)


def timed(run, block, n: int, barrier=None, reps: int = TWO_RANK_REPS
          ) -> dict:
    """``reps`` runs of ``run(n)``, each started and ended by
    ``block()`` (and a barrier of every rank, where given): all
    iterations over all their seconds, and each run's rate."""
    secs = []
    for _ in range(reps):
        block()
        if barrier is not None:
            barrier()
        t0 = time.perf_counter()
        run(n)
        block()
        if barrier is not None:
            barrier()
        secs.append(time.perf_counter() - t0)
    return {"rate": reps * n / sum(secs), "seconds": sum(secs),
            "rates": [n / t for t in secs]}


#: the cases of the two-rank worlds: name -> (model, constructor
#: settings, steps a timed run). The first three move their slabs as
#: gloo messages; the rest of the Jacobi and Astaroth cases are the
#: remote-write kernels across processes (``IPC_CASES``: B7, K3 + B4,
#: B13/B14 with and without the pair) and the overlap exchange, the
#: all-gather engine and PIC, whose messages go through the group
TWO_RANK_CASES = {
    "jacobi halo": ("jacobi", {"kernel": "halo"}, TWO_RANK_STEPS),
    "jacobi xla": ("jacobi", {"kernel": "xla"}, TWO_RANK_STEPS),
    "astaroth halo": ("astaroth", {"kernel": "halo"}, TWO_RANK_MHD_ITERS),
    "jacobi overlap": ("jacobi", {"kernel": "halo", "overlap": True},
                       TWO_RANK_STEPS),
    "jacobi pallas-dma": ("jacobi", {"kernel": "pallas",
                                     "methods": "PallasDMA"}, 4),
    "jacobi xla-overlap": ("jacobi", {"kernel": "xla", "overlap": True},
                           TWO_RANK_STEPS),
    "jacobi xla-allgather": ("jacobi", {"kernel": "xla",
                                        "methods": "AllGather"},
                             TWO_RANK_STEPS),
    "astaroth halo-overlap": ("astaroth", {"kernel": "halo",
                                           "overlap": True},
                              TWO_RANK_MHD_ITERS),
    "astaroth halo-overlap+pair": ("astaroth", {"kernel": "halo",
                                                "overlap": True,
                                                "exchange_every": 2},
                                   TWO_RANK_MHD_ITERS),
    "pic ngp": ("pic", {}, 2),
}
#: seconds a case may take in a rank of the world before it is ended
TWO_RANK_CASE_S = 300
#: the cases whose cross-process path is CUDA IPC and device-side flags
IPC_CASES = ("jacobi overlap", "jacobi pallas-dma", "astaroth halo-overlap",
             "astaroth halo-overlap+pair")
#: timed runs a case (PIC: one run of 2 steps, its migration buffers
#: staged through the host)
TWO_RANK_RUNS = {"jacobi": TWO_RANK_REPS, "astaroth": TWO_RANK_REPS,
                 "pic": 1}


def two_rank_model(torch, case: str, devs, card: str):
    """The model of ``case`` over ``devs`` (four positions of (1,2,2),
    or eight of (2,2,2) for PIC), its state made on ``card`` from a
    seed, the same bits in every process."""
    from stencil_tpu_torch.models.astaroth import Astaroth
    from stencil_tpu_torch.models.jacobi import Jacobi3D
    from stencil_tpu_torch.models.pic import Pic
    from stencil_tpu_torch.parallel.methods import Method

    model, kw, _ = TWO_RANK_CASES[case]
    kw = dict(kw)
    if "methods" in kw:
        kw["methods"] = Method[kw["methods"]]
    if model == "jacobi":
        m = Jacobi3D(N512, N512, N512, mesh_shape=TWO_RANK_MESH,
                     devices=devs, **kw)
        m.init()
    elif model == "astaroth":
        m = Astaroth(N256, 2 * N256, 2 * N256, mesh_shape=TWO_RANK_MESH,
                     devices=devs, **kw)
        seed_mhd(torch, m, card)
    else:
        total = PIC_GRID ** 3
        m = Pic(PIC_GRID, PIC_GRID, PIC_GRID, total, mesh_shape=PIC_MESH,
                devices=devs, dtype=torch.float64, deposition="ngp",
                init=False)
        with torch.cuda.device(card):
            m.set_shard_particles(pic_shard_particles(torch, m, total // 8,
                                                      seed=5))
    return m


def two_rank_arrays(case: str, m) -> dict:
    """What a case is held to (collectives on a mesh over ranks)."""
    from stencil_tpu_torch.models.astaroth import FIELDS

    model = TWO_RANK_CASES[case][0]
    if model == "jacobi":
        return {"temp": m.temperature()}
    if model == "astaroth":
        return {q: m.field(q) for q in FIELDS}
    return {"rho": m.rho(), **m.particles_to_host()}


def two_rank_run(torch, case: str, m, barrier=None) -> dict:
    """Warm ``m`` up, then time ``TWO_RANK_RUNS`` runs of the case's
    steps, counting the kernels' launches, the messages through the
    process group and the flag operations of this process over them."""
    import numpy as np

    from stencil_tpu_torch.parallel import ipc, multihost

    model, _, n = TWO_RANK_CASES[case]
    m.run(TWO_RANK_WARMUP[model])
    m.block()
    before = all_launches()
    msgs, flags = dict(multihost.MESSAGES), dict(ipc.STATS)
    rate = timed(m.run, m.block, n, barrier, TWO_RANK_RUNS[model])
    got = {"path": getattr(m, "kernel_path", "pic"), **rate,
           "launches": launch_delta(before),
           "messages": {k: v - msgs[k]
                        for k, v in multihost.MESSAGES.items()},
           "flags": {k: v - flags[k] for k, v in ipc.STATS.items()}}
    arrays = two_rank_arrays(case, m)
    if case in ("jacobi halo", "jacobi xla", "astaroth halo"):
        got["exchange_s"] = m.measure_exchange_seconds()
    got["digests"] = {k: digest(v) for k, v in arrays.items()}
    got["finite"] = all(bool(np.isfinite(v).all()) for v in arrays.values())
    if model == "pic":
        got["charge"] = m.total_charge()
    return got


def two_rank_paths(rank: int, out: str, cards, cases) -> None:
    """One rank of ``run_two_ranks``: the ``cases`` (``TWO_RANK_CASES``)
    with two shards (PIC: four) on card ``cards[rank]``; writes
    ``rank<r>.json`` (per case: path, pooled rate, this rank's launches,
    messages and flag operations over the timed runs, the gathered
    arrays' digests and, for the IPC cases, the blocks this rank mapped
    from the other). After each case ``ipc.release`` (a collective)
    closes the mappings before the buffers go."""
    import torch
    import torch.distributed as dist

    from stencil_tpu_torch.parallel import ipc
    from stencil_tpu_torch.parallel.multihost import backend, global_devices

    card = cards[rank]
    torch.cuda.set_device(card)
    res = {"backend": backend(), "card": card}
    for case in cases:
        # a case that has not ended in TWO_RANK_CASE_S (a flag that is
        # never written) ends this process, and the world fails
        faulthandler.dump_traceback_later(TWO_RANK_CASE_S, exit=True)
        model = TWO_RANK_CASES[case][0]
        devs = global_devices([card] * (4 if model == "pic" else 2))
        mapped = ipc.STATS["mapped"]
        m = two_rank_model(torch, case, devs, card)
        got = two_rank_run(torch, case, m, dist.barrier)
        got["mapped"] = ipc.STATS["mapped"] - mapped
        got["shards"] = m.dd.mesh.local_positions
        res[case] = got
        del m
        ipc.release()
        torch.cuda.empty_cache()
        faulthandler.cancel_dump_traceback_later()
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)


def one_process(torch, case: str) -> dict:
    """``case`` of ``two_rank_paths`` in this process, its four (PIC:
    eight) shards on the card: path, pooled rate, launches and
    digests."""
    model = TWO_RANK_CASES[case][0]
    m = two_rank_model(torch, case, [CARD] * (8 if model == "pic" else 4),
                       CARD)
    got = two_rank_run(torch, case, m)
    del m
    torch.cuda.empty_cache()
    return got


def run_two_ranks(torch) -> dict:
    """Phase 4: a mesh over two processes on the one card (gloo for the
    group), each case bitwise the same path in one process after the
    same steps: the gloo-staged ``halo`` and ``xla`` paths, the
    remote-write kernels over CUDA IPC with device-side flags (B7, K3 +
    B4, B13/B14 with and without the pair: no message through the
    group), the overlap exchange, the all-gather engine and PIC; with
    two or more cards the Jacobi halo case and the IPC cases again over
    nccl, one rank a card (IPC over NVLink). The launch counts are each
    rank's, read around its timed runs; their sum over the ranks equals
    the one-process count, except B4's, which launches once a card and
    sweep in every process (twice the one process's on one card)."""
    from stencil_tpu_torch.parallel.multihost import spawn_ranks

    os.makedirs(TWO_RANK_OUT, exist_ok=True)
    cases = tuple(TWO_RANK_CASES)
    worlds = [("gloo", [CARD, CARD], cases)]
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        worlds.append(("nccl", ["cuda:0", "cuda:1"],
                       ("jacobi halo",) + IPC_CASES))
    else:
        log("  nccl two-rank cases (jacobi halo, and B7, B4 and B13/B14 "
            "over CUDA IPC between two cards, NVLink) not run: they need a "
            f"card per rank, and this machine has {n_cards} CUDA device")
    torch.cuda.empty_cache()
    ref = {case: one_process(torch, case) for case in cases}
    out = {"one_process": ref}
    for backend_name, cards, todo in worlds:
        t0 = time.perf_counter()
        spawn_ranks(two_rank_paths, 2,
                    args=(TWO_RANK_OUT, cards, todo),
                    backend_name=backend_name, timeout_s=600)
        ranks = []
        for r in range(2):
            with open(os.path.join(TWO_RANK_OUT, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        log(f"  two ranks ({backend_name}, cards {cards}): world of 2 "
            f"processes ran in {time.perf_counter() - t0:.1f} s")
        halo_rate = ranks[0]["jacobi halo"]["rate"]
        for case in todo:
            check_two_rank_case(case, backend_name,
                                [rk[case] for rk in ranks], ref[case],
                                halo_rate)
        out[backend_name] = {case: [rk[case] for rk in ranks]
                             for case in todo}
    return out


def check_two_rank_case(case: str, backend_name: str, got, ref,
                        halo_rate: float) -> None:
    """Print one case of a world beside the one process (and an IPC
    case beside the world's Jacobi halo rate, whose slabs go as
    messages through the group), and raise unless it
    is bitwise the one process's, finite, on the same path, with every
    kernel launched as often as the one process launches it (B4: once a
    process) and, for an IPC case, nothing sent through the group."""
    model = TWO_RANK_CASES[case][0]
    unit = ("steps/s" if model == "jacobi" else "iterations/s"
            if model == "astaroth" else "steps/s (PIC)")
    same = got[0]["digests"] == ref["digests"]
    total = {}
    for g in got:
        for k, v in g["launches"].items():
            total[k] = total.get(k, 0) + v
    want = {k: v * (2 if k == "exchange_axis" else 1)
            for k, v in ref["launches"].items()}
    ipc_case = case in IPC_CASES
    sent = sum(g["messages"]["sent"] for g in got)
    waits = sum(g["flags"]["waits"] for g in got)
    transport = (f"CUDA IPC + device flags ({waits} waits, "
                 f"{sum(g['flags']['signals'] for g in got)} signals, "
                 f"{[g['mapped'] for g in got]} blocks mapped), {sent} "
                 f"messages through the group" if ipc_case else
                 f"{sent} {backend_name} messages "
                 f"({sum(g['messages']['bytes'] for g in got)} bytes"
                 f"{' halo_rate through host memory' if backend_name == 'gloo' else ''})")
    log(f"  {case} {TWO_RANK_SIZE[model]}, two ranks ({backend_name}): "
        f"{got[0]['rate']!r} {unit} pooled over {len(got[0]['rates'])} "
        f"runs, each {got[0]['rates']!r} (path {got[0]['path']}, shards "
        f"{got[0]['shards']} and {got[1]['shards']}); one process: "
        f"{ref['rate']!r} {unit}, each {ref['rates']!r}"
        + (f"; jacobi halo over {backend_name} messages: {halo_rate!r} "
           f"steps/s" if ipc_case else "")
        + f"; {'bitwise equal' if same else 'DIFFERENT'}; launches "
        f"{got[0]['launches']} and {got[1]['launches']}, sum {total} "
        f"against one process {ref['launches']}; transport: {transport}"
        + (f"; total charge {got[0]['charge']!r}" if model == "pic" else "")
        + (f"; exchange {got[0]['exchange_s']!r} s a step (iteration) "
           f"against {ref['exchange_s']!r} in one process"
           if "exchange_s" in ref else "")
        + f" (card: {card_line()})")
    if not same or not all(g["finite"] for g in got):
        raise AssertionError(f"{case} over two ranks ({backend_name}) is "
                             f"not bitwise the one-process run")
    if got[0]["path"] != ref["path"] or total != want:
        raise AssertionError(
            f"{case} over two ranks took {got[0]['path']} with launches "
            f"{total}, not {ref['path']} with {want}")
    if ipc_case and (sent or not waits):
        raise AssertionError(f"{case} over two ranks sent {sent} messages "
                             f"and queued {waits} flag waits: its only "
                             f"cross-process path must be CUDA IPC")
    if model == "pic" and got[0]["charge"] != PIC_GRID ** 3:
        raise AssertionError(f"PIC over two ranks: total charge "
                             f"{got[0]['charge']!r}, not {PIC_GRID ** 3}")


def ptxas_usage() -> dict:
    """Registers, spill bytes and static shared memory of every
    ring-kernel instantiation, from each library's ``-Xptxas=-v`` lines
    (``_build.usage``): ``kernel_key`` -> {"registers", "spill_stores",
    "spill_loads", "static_smem"}."""
    from stencil_tpu_torch.ops import _build

    out = {}
    for lib in _build.sources():
        for (_, name), use in _build.usage(lib).items():
            key = kernel_key(lib, name)
            if key is not None:
                out[key] = use
    return out


#: opcodes every ``sass_counts`` entry names, frequent or not: the
#: float32 -> bfloat16 conversions (F2F, F2FP) and the packed half-width
#: arithmetic (HADD2, HMUL2, HFMA2)
SASS_WATCHED = ("F2F", "F2FP", "HADD2", "HMUL2", "HFMA2")


def sass_counts() -> dict:
    """Static opcode counts of every ring-kernel instantiation in the
    ``RING_LIBS`` libraries (``_build.sass_opcodes``): ``kernel_key`` ->
    {"total": n, the 8 most frequent opcodes and the ``SASS_WATCHED``
    ones}. Empty where the toolkit has no cuobjdump."""
    from stencil_tpu_torch.ops import _build

    out = {}
    for lib in RING_LIBS:
        ops = _build.sass_opcodes(lib)
        if ops is None:
            return {}
        for name, c in ops.items():
            key = kernel_key(lib, name)
            if key is None:
                continue
            out[key] = dict(total=sum(c.values()), **dict(c.most_common(8)))
            out[key].update((o, c[o]) for o in SASS_WATCHED)
    return out


KERNEL_META = {
    "jacobi7_wrap": ("K1", "stencil_tpu_torch/csrc/jacobi7.cu",
                     "stencil_tpu/ops/pallas_stencil.py:134"),
    "jacobi7_wrapn": ("K2", "stencil_tpu_torch/csrc/jacobi7.cu",
                      "stencil_tpu/ops/pallas_stencil.py:246"),
    "jacobi7_padded": ("K3", "stencil_tpu_torch/csrc/jacobi7.cu",
                       "stencil_tpu/ops/pallas_stencil.py:72"),
    "jacobi7_halo": ("B5", "stencil_tpu_torch/csrc/jacobi_halo.cu",
                     "stencil_tpu/ops/pallas_halo.py:115"),
    "jacobi7_halon": ("B6", "stencil_tpu_torch/csrc/jacobi_halo.cu",
                      "stencil_tpu/ops/pallas_halo.py:317"),
    "laplace6": ("B8", "stencil_tpu_torch/csrc/laplace6.cu",
                 "stencil_tpu/ops/pallas_stencil.py:432"),
    "mhd_substep_wrap": ("B9", "stencil_tpu_torch/csrc/mhd.cu",
                         "stencil_tpu/ops/pallas_mhd.py:186"),
    "mhd_substep01_wrap": ("B10", "stencil_tpu_torch/csrc/mhd.cu",
                           "stencil_tpu/ops/pallas_mhd.py:347"),
    "mhd_substep_halo": ("B11", "stencil_tpu_torch/csrc/mhd.cu",
                         "stencil_tpu/ops/pallas_halo.py:852"),
    "mhd_substep01_halo": ("B12", "stencil_tpu_torch/csrc/mhd.cu",
                           "stencil_tpu/ops/pallas_halo.py:969"),
    "exchange_axis": ("B4", "stencil_tpu_torch/csrc/exchange_dma.cu",
                      "stencil_tpu/parallel/pallas_exchange.py:57"),
    "jacobi7_overlap": ("B7", "stencil_tpu_torch/csrc/jacobi_overlap.cu",
                        "stencil_tpu/ops/pallas_overlap.py:55"),
    "mhd_substep_overlap": ("B13", "stencil_tpu_torch/csrc/mhd_overlap.cu",
                            "stencil_tpu/ops/pallas_mhd_overlap.py:67"),
    "mhd_substep_fixup": ("B14", "stencil_tpu_torch/csrc/mhd_overlap.cu",
                          "stencil_tpu/ops/pallas_mhd_overlap.py:360"),
}


def main() -> int:
    import torch

    # phase 1: the card
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this "
              "smoke run needs a CUDA GPU", file=sys.stderr)
        return 2
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"phase 1: card {card!r}, torch {torch.__version__}, cuda "
        f"{torch.version.cuda}, {count} device(s)")
    # the library yardsticks (conv3d) compute in float32, not TF32
    torch.backends.cudnn.allow_tf32 = False

    from stencil_tpu_torch.ops import _build
    from stencil_tpu_torch.ops import cuda_exchange as cx
    from stencil_tpu_torch.ops import cuda_halo as ch
    from stencil_tpu_torch.ops import cuda_mhd as cm
    from stencil_tpu_torch.ops import cuda_mhd_overlap as mo
    from stencil_tpu_torch.ops import cuda_overlap as co
    from stencil_tpu_torch.ops import cuda_stencil as cs

    # phase 2: build
    t0 = time.perf_counter()
    built = _build.build_all()
    ptxas = ptxas_usage()
    for key, counts in sass_counts().items():
        ptxas.setdefault(key, {})["sass"] = counts
    log(f"phase 2: built {sorted(built)} in "
        f"{time.perf_counter() - t0:.1f} s")
    for key, use in sorted(ptxas.items(), key=str):
        log(f"  ptxas {key}: {use}")
        if (use.get("registers", 0) > 128 or use.get("spill_stores")
                or use.get("spill_loads")):
            log(f"  NOTE: ring kernel {key} uses more than 128 registers "
                f"or spills")

    # phase 3: kernels vs twins
    log("phase 3: kernels vs plain twins")
    worst = compare_kernels(torch, cs)
    worst.update(compare_halo_kernels(torch, ch))
    worst.update(compare_mhd_kernels(torch, cs, cm))
    worst.update(compare_mhd_halo_kernels(torch, cm))
    worst.update(compare_dma_overlap_kernels(torch, cx, co))
    worst.update(compare_mhd_overlap_kernels(torch, cm, mo))
    log("phase 3: bfloat16 storage on the MHD ring kernels (B9-B14)")
    worst_bf16 = compare_mhd_bf16_kernels(torch, cm, mo)
    log("phase 3: bfloat16 on the Jacobi kernels (K1-K3, B5-B7)")
    worst_jbf16 = compare_jacobi_bf16_kernels(torch, cs, ch, co)
    log("phase 3: B8 in bfloat16 (laplace6_cuda) against its twin")
    worst_b8_bf16 = compare_laplace6(torch, cs, torch.bfloat16)

    # phase 4: the main paths
    log("phase 4: Jacobi3D 512^3 float32 main path")
    main_path = run_main_path(torch, cs)
    log("phase 4: Jacobi3D halo path on meshes of shards on one card")
    halo_path = run_halo_path(torch, cs, ch)
    log("phase 4: Astaroth 256^3 float32 main path")
    mhd_path = run_astaroth(torch, cs, cm)
    log("phase 4: Astaroth halo path on meshes of shards on one card")
    mhd_halo_path = run_astaroth_halo(torch, cs, cm,
                                      mhd_path.pop("xla_fields_256"))
    launches = dict(main_path["launches"])
    launches.update(halo_path["launches"])
    for name, n in mhd_path["launches"].items():
        launches[name] = launches.get(name, 0) + n
    launches.update(mhd_halo_path["launches"])
    log("phase 4: Jacobi3D remote-write paths (overlap, PallasDMA) on one "
        "card")
    overlap_path = run_overlap_paths(torch, cs, ch, cx, co)
    launches.update(overlap_path["launches"])
    log("phase 4: Astaroth halo-overlap path (B13/B14) on meshes of shards "
        "on one card")
    mhd_overlap_path = run_astaroth_overlap(
        torch, cs, cm, mo, cx, mhd_halo_path.pop("halo_state"))
    launches.update(mhd_overlap_path["launches"])
    log("phase 4: Jacobi3D temporal blocking (exchange_every) on one card")
    temporal_path = run_temporal_paths(torch, cs, ch)
    log("phase 4: the exchange apps (bench_exchange, pingpong, bench_pack) "
        "on one card")
    exchange_apps = run_exchange_apps(torch, cx)
    log("phase 4: halo wire formats (bf16, e4m3, e5m2), the irredundant "
        "layout and the packed and all-gather engines on one card")
    wire_path = run_wire_paths(torch, cs)
    log("phase 4: Astaroth bfloat16 storage (wrap, halo, halo-overlap, "
        "+ pair) on one card")
    bf16_path = run_astaroth_bf16(torch, cs, cm, mo)
    log("phase 4: Astaroth temporal path (exchange_every 2-4 on xla) and "
        "Boundary.NONE on four 256^3 shards of one card")
    mhd_temporal = run_astaroth_temporal(torch)
    log("phase 4: Jacobi3D 512^3 bfloat16 (wrap, halo, overlap, pallas, "
        "exchange_every 16) on one card")
    jbf16_path = run_jacobi_bf16(torch, cs, ch, co)
    log("phase 4: particle-in-cell, 256^3 on (2,2,2) shards of one card")
    pic = run_pic(torch)
    log("phase 4: segments (make_segment) on Jacobi3D 512^3, Astaroth "
        "256^3 xla-temporal[s=2] and PIC 256^3, against stepwise twins")
    segments = run_segments(torch)
    log("phase 4: resilience and placement: run_resilient on Jacobi3D "
        "512^3 (wrap, halo), Astaroth 256^3 wrap and PIC 128^3, checkpoint "
        "I/O, QAP placement and the plan file (card: " + card + ")")
    resilience = run_resilience(torch)
    log("phase 4: autotune and observatory: Method.Auto on Jacobi3D 512^3 "
        "pallas (1,2,2), the attributor and flight recorder on a halo "
        "campaign, /metrics and bench_exchange --autotune (card: " + card
        + ")")
    t0 = time.perf_counter()
    autotune = run_autotune_observatory(torch)
    autotune["phase_s"] = time.perf_counter() - t0
    log(f"  phase took {autotune['phase_s']!r} s")
    log("phase 4: ensemble serving: Jacobi ensembles width 8 at 256^3 "
        "(1,1,1) and (1,2,2) with B4 on the member views, Astaroth width 4 "
        "at 128^3, the campaign service and the fleet (card: " + card + ")")
    t0 = time.perf_counter()
    serving = run_serving(torch)
    serving["phase_s"] = time.perf_counter() - t0
    log(f"  phase took {serving['phase_s']!r} s")
    log("phase 4: two ranks on the one card: Jacobi3D 512^3 halo and xla "
        "and Astaroth 256x512x512 halo (gloo-staged), B7, K3 + B4 and "
        "B13/B14 over CUDA IPC with device-side flags, xla-overlap, "
        "AllGather and PIC 256^3, against one process (card: " + card + ")")
    two_ranks = run_two_ranks(torch)
    log("phase 4: analysis: the registry of stencil_tpu_torch.analysis, "
        "the cuda. targets on the card (card: " + card + ")")
    analysis = run_analysis(torch)

    # phase 5: timing
    log("phase 5: timing at 512^3 (Jacobi) and 256^3 (Astaroth) (card: "
        + card + ")")
    sps, sps_runs = {}, {}
    for path, k in (("wrap", 40), ("pallas", 20), ("xla", 6)):
        sps[path], sps_runs[path] = steps_per_s(torch, path, k)
        log(f"  Jacobi {path}: {sps[path]!r} steps/s over three runs "
            f"({sps_runs[path]})")
    halo_times = time_halo(torch, cs, ch)
    temporal_times = time_temporal(torch, cs, ch)
    wire_times = time_wire(torch)
    ips, ips_runs = {}, {}
    for path, kernel, k, pair in (("wrap", "wrap", 20, "0"),
                                  ("wrap+pair", "wrap", 20, "1"),
                                  ("xla", "xla", 3, "0")):
        ips[path], ips_runs[path] = iters_per_s(torch, kernel, k, pair)
        log(f"  Astaroth {path}: {ips[path]!r} iterations/s over three "
            f"runs ({ips_runs[path]})")
    mhd_halo_times = time_mhd_halo(torch, cm, mo, ptxas)
    dma_times = time_dma_overlap(torch, cx, co)
    mhd_overlap_times = time_mhd_overlap(torch, cm, mo)
    ratio = (mhd_overlap_times["iters_per_s"]
             ["halo-overlap+pair 256x512x512 (1,2,2)"]
             / mhd_halo_times["iters_per_s"]["halo+pair 256x512x512 (1,2,2)"])
    log(f"  Astaroth halo-overlap+pair / halo+pair on four 256^3 shards: "
        f"{ratio!r}")
    bf16_rates = time_astaroth_bf16_paths(torch)
    f32_rates = {"wrap 256^3": ips["wrap"],
                 "wrap+pair 256^3": ips["wrap+pair"]}
    f32_rates.update(mhd_halo_times["iters_per_s"])
    f32_rates.update(mhd_overlap_times["iters_per_s"])
    for label, rate in bf16_rates["iters_per_s"].items():
        log(f"  Astaroth {label}: bf16 {rate!r} against float32 "
            f"{f32_rates.get(label)!r} iterations/s")
    bf16_times = time_mhd_bf16_kernels(torch, cm, mo)
    jbf16_times = time_jacobi_bf16(torch, cs, ch, co, {
        "wrap": sps["wrap"], "halo (1,2,2)": halo_times["steps_per_s"][
            "(1,2,2)"], "overlap (1,2,2)": dma_times["steps_per_s"][
            "(1,2,2)"]})
    b8_bf16_times = time_laplace6_bf16(torch, cs)
    times = time_kernels(torch, cs)
    times.update(halo_times["kernels"])
    times.update(time_mhd_kernels(torch, cs, cm))
    times.update(mhd_halo_times["kernels"])
    times["mhd_substep01_wrap"].update(
        device_ms=mhd_halo_times["pair_device_ms"]["B10"],
        design="B9 s=0 then B9 s=1: two launches of the ring kernel")
    times.update(dma_times["kernels"])
    times.update(mhd_overlap_times["kernels"])

    kernels = []
    for name, (tag, source, replaces) in KERNEL_META.items():
        t = times[name]
        entry = {
            "name": f"{name} ({tag})", "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        entry["resilient_launches"] = {
            label: d[name] for label, d in resilience["launches"].items()
            if d.get(name)}
        if name == "laplace6":
            entry["path"] = "none: no model path runs it in either package"
            entry["ptxas"] = {
                f"laplace6_ring_kernel {4 * k[2]}-byte copies, "
                f"16-byte stores={k[3]}": use
                for k, use in ptxas.items() if k[:2] == ("laplace6",
                                                         "laplace6_ring")
                and k[-1] != "bf16"}
        for k in ("device_ms", "design", "blocks_per_sm"):
            if k in t:
                entry[k] = t[k]
        if name in ("jacobi7_wrapn", "jacobi7_halon"):
            # N = 3 and 4 (exchange_every): launches of the phase-4 run at
            # s = N, times at 512^3 (B6 also on a quarter shard)
            entry["temporal"] = {
                f"N={N}": {
                    "launches": temporal_path["launches_by_run"][
                        f"wrap s={N}" if name == "jacobi7_wrapn"
                        else f"halo s={N} (1,2,2)"].get(name, 0),
                    **{k: v for k, v in temporal_times["kernels"].items()
                       if k.startswith(f"{name} N={N}")}}
                for N in (3, 4)}
            entry["ptxas"] = ptxas.get(
                ("jacobi7" if name == "jacobi7_wrapn" else "jacobi_halo",
                 "jacobi_ring"), {})
        if name in ("jacobi7_padded", "exchange_axis"):
            # the Method.Auto run(4) on the tuned winner (phase 4)
            entry["auto_launches"] = autotune["run4_launches"].get(name, 0)
        if name == "exchange_axis":
            # the serving path: run(4) of the width-8 ensemble on (1,2,2)
            # with a PallasDMA plan, the member views rows of one table
            entry["serving"] = serving["b4"]
        if name == "jacobi7_padded":
            # K3 behind narrowed and irredundant wires: launches of the
            # phase-4 pallas run(4) on four shards behind a bf16
            # irredundant wire, and the phase-5 rates of that path
            entry["wire"] = {
                "launches": wire_path["launches"]["jacobi7_padded"],
                "steps_per_s_1x2x2": {
                    k[len("pallas "):]: v
                    for k, v in wire_times["steps_per_s"].items()
                    if k.startswith("pallas ")}}
        if name == "mhd_substep01_halo":
            entry["ptxas"] = {"mhd_margin_kernel": ptxas.get(("mhd",
                                                              "margin"), {})}
        if name == "mhd_substep_overlap":
            entry["ptxas"] = {
                f"mhd_substep_ring_kernel read_w={k[1]}, write_w={k[2]}": use
                for k, use in ptxas.items()
                if k[0] == "mhd_overlap" and len(k) == 3
                and isinstance(k[1], bool)}
        if name == "mhd_substep_fixup":
            entry["ptxas"] = {
                f"mhd_shell_kernel read_w={k[2]}, write_w={k[3]}": use
                for k, use in ptxas.items()
                if k[:2] == ("mhd_overlap", "shell") and len(k) == 4}
            entry["ptxas"]["mhd_margin_kernel"] = ptxas.get(
                ("mhd_overlap", "margin"), {})
        if "variants" in t:
            entry["variants"] = t["variants"]
        kernels.append(entry)
    # the bfloat16 instances of B9-B14: launches of the phase-4 bf16
    # runs, errors against the bf16 twins, times of phase 5
    for name in BF16_NAMES:
        tag, source, replaces = KERNEL_META[name]
        t = bf16_times[name]
        lib = "mhd_overlap" if name in ("mhd_substep_overlap",
                                        "mhd_substep_fixup") else "mhd"
        entry = {
            "name": f"{name} bf16 ({tag})", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": bf16_path["launches"][name],
            "max_abs_err": worst_bf16[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": None,
            "variants": t["variants"],
            "ptxas": {", ".join(str(x) for x in k[1:]): use
                      for k, use in ptxas.items()
                      if k[0] == lib and len(k) > 1
                      and k[-1] in ("bf16", "bf16->f32", "f32->bf16")}}
        kernels.append(entry)
    # the bfloat16 instances of K1-K3 and B5-B7: launches of the phase-4
    # bf16 runs, errors against the bf16 twins, times of phase 5
    for name in JACOBI_BF16_NAMES:
        tag, source, replaces = KERNEL_META[name]
        t = jbf16_times["kernels"][name]
        entry = {
            "name": f"{name} bf16 ({tag})", "route": "cuda",
            "source": source, "replaces": replaces,
            "launches": jbf16_path["launches"][name],
            "max_abs_err": worst_jbf16[name], "ms": t["ms"],
            "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": t["bound_by"], "library_ms": t["library_ms"]}
        if name in ("jacobi7_wrapn", "jacobi7_halon"):
            lib = "jacobi7" if name == "jacobi7_wrapn" else "jacobi_halo"
            entry["N=16"] = dict(
                jbf16_times["kernels"][f"{name} N=16"],
                launches=jbf16_path["launches_by_run"][
                    "wrap exchange_every=16" if name == "jacobi7_wrapn"
                    else "halo (1,2,2) exchange_every=16"][name])
            entry["ptxas"] = {", ".join(str(x) for x in k[2:]): use
                              for k, use in ptxas.items()
                              if k[:2] == (lib, "jacobi_ring")
                              and k[-1] == "bf16"}
        kernels.append(entry)
    # B8's bfloat16 instance: its path is this slice's analysis phase
    # (the cuda. footprint target), its error against the bf16 twin,
    # its times of phase 5
    tag, source, replaces = KERNEL_META["laplace6"]
    t = b8_bf16_times
    kernels.append({
        "name": f"laplace6 bf16 ({tag})", "route": "cuda", "source": source,
        "replaces": replaces, "launches": analysis["b8_bf16_launches"],
        "max_abs_err": worst_b8_bf16, "ms": t["ms"],
        "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
        "bound_by": t["bound_by"], "library_ms": t["library_ms"],
        "device_ms": t["device_ms"], "design": t["design"],
        "blocks_per_sm": t["blocks_per_sm"],
        "path": "the analysis phase (cuda.footprint target); no model path "
                "runs B8 in either package",
        "ptxas": {f"laplace6_ring_kernel bf16 {2 * k[2]}-byte loads, "
                  f"8-byte stores={k[3]}": use
                  for k, use in ptxas.items()
                  if k[:2] == ("laplace6", "laplace6_ring") and
                  k[-1] == "bf16"}})
    for entry in kernels:
        base = entry["name"].split(" (")[0]
        if " bf16" not in base:
            entry["analysis_launches"] = analysis["launches"].get(base, 0)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "torch": torch.__version__,
                   "steps_per_s_512": sps, "runs_steps_per_s_512": sps_runs,
                   "iters_per_s_256": ips,
                   "runs_iters_per_s_256": ips_runs,
                   "halo_steps_per_s_512": halo_times["steps_per_s"],
                   "halo_runs_steps_per_s_512":
                       halo_times["runs_steps_per_s"],
                   "halo_slab_exchange_ms": halo_times["slab_exchange_ms"],
                   "halon_quarter_shard_ms":
                       halo_times["halon_quarter_shard_ms"],
                   "halon_quarter_shard_bound_ms":
                       halo_times["halon_quarter_shard_bound_ms"],
                   "jacobi_ring_plans": halo_times["jacobi_ring_plans"],
                   "temporal_path": temporal_path,
                   "exchange_apps": exchange_apps,
                   "wire_path": wire_path,
                   "wire_steps_per_s_1x2x2": wire_times["steps_per_s"],
                   "wire_runs_steps_per_s_1x2x2":
                       wire_times["runs_steps_per_s"],
                   "temporal_steps_per_s_512": temporal_times["steps_per_s"],
                   "temporal_runs_steps_per_s_512":
                       temporal_times["runs_steps_per_s"],
                   "temporal_kernels": temporal_times["kernels"],
                   "temporal_ring_plans": temporal_times["jacobi_ring_plans"],
                   "fixup_plan_256": mhd_overlap_times["fixup_plan_256"],
                   "laplace6_plan_256": times.pop("laplace6_plan_256"),
                   "astaroth_halo_iters_per_s":
                       mhd_halo_times["iters_per_s"],
                   "astaroth_halo_runs_iters_per_s":
                       mhd_halo_times["runs_iters_per_s"],
                   "astaroth_halo_slab_exchange_ms":
                       mhd_halo_times["slab_exchange_ms"],
                   "b9_same_shard_ms": mhd_halo_times["b9_same_shard_ms"],
                   "b13_same_shard_ms": mhd_halo_times["b13_same_shard_ms"],
                   "pair_device_ms": mhd_halo_times["pair_device_ms"],
                   "pair_kernels": mhd_halo_times["pair_kernels"],
                   "astaroth_overlap_iteration_ms":
                       mhd_overlap_times["iteration_ms"],
                   "main_path": main_path, "halo_path": halo_path,
                   "astaroth_path": mhd_path,
                   "astaroth_halo_path": mhd_halo_path,
                   "overlap_path": overlap_path,
                   "astaroth_overlap_path": mhd_overlap_path,
                   "astaroth_overlap_iters_per_s":
                       mhd_overlap_times["iters_per_s"],
                   "astaroth_overlap_runs_iters_per_s":
                       mhd_overlap_times["runs_iters_per_s"],
                   "measure_overlap_mhd":
                       mhd_overlap_times["measure_overlap_mhd"],
                   "overlap_steps_per_s_512": dma_times["steps_per_s"],
                   "overlap_runs_steps_per_s_512":
                       dma_times["runs_steps_per_s"],
                   "whole_exchange_ms": dma_times["whole_exchange_ms"],
                   "measure_overlap": dma_times["measure_overlap"],
                   "astaroth_bf16_path": bf16_path,
                   "astaroth_bf16_iters_per_s": bf16_rates["iters_per_s"],
                   "astaroth_bf16_runs_iters_per_s":
                       bf16_rates["runs_iters_per_s"],
                   "astaroth_f32_iters_per_s_same_run": f32_rates,
                   "bf16_kernel_times": bf16_times,
                   "astaroth_temporal": mhd_temporal,
                   "jacobi_bf16_path": jbf16_path,
                   "jacobi_bf16_steps_per_s": jbf16_times["steps_per_s"],
                   "jacobi_bf16_runs_steps_per_s":
                       jbf16_times["runs_steps_per_s"],
                   "jacobi_bf16_kernel_times": jbf16_times["kernels"],
                   "pic": pic,
                   "segments": segments,
                   "resilience": resilience,
                   "autotune": autotune,
                   "serving": serving,
                   "two_ranks": two_ranks,
                   "analysis": analysis,
                   "laplace6_bf16": b8_bf16_times,
                   "kernels": kernels}, f, indent=1, default=str)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": kind,
                                             "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
