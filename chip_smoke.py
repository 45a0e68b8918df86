"""Chip smoke of the PyTorch/CUDA port: build, check and time its kernels,
and drive the erasure-code write and read path at full width.

    python3 chip_smoke.py

Needs one CUDA card (exits non-zero without one) and ``nvcc``.  Phases:

1. device: the ``nvidia-smi`` name/power-limit line and the arch probe;
2. build: every ``ceph_tpu_torch/csrc/*.cu`` with nvcc (in parallel),
   with ptxas' registers/spills and, per kernel, the POPC, LDS and
   instruction counts of its SASS (``cuobjdump -sass``);
3. kernel against its plain PyTorch version on the card, byte-exact, at
   the main path's shapes, at ragged/odd shapes, on random 0/1 matrices
   for k in {1, 9, 32, 256} x r in {1, 5, 8} x C in {1, 15, 4097}, and on
   a data pointer one byte off 16-byte alignment; the first (popcount)
   design of the kernel is held against the same plain outputs at the
   three main-path shapes;
4. main path, k=8 m=4, reed_sol_van and cauchy, stripe unit 4096:
   (a) ``ecutil.encode`` of 64 objects of 4 MiB one by one,
   (b) one ``encode_batch_device`` of all 64 (S=8192, C=4096), and one
   ``decode_batch_device`` of shard 1 from the card-resident survivors,
   (c) ``ecutil.decode_concat`` of every object with shards {1, 9} lost,
   (d) ``ecutil.decode`` of shard 9, (e) one object against the host
   ``MatrixRSCodec``; the kernel's launch count must move;
5. times with CUDA events (medians of >= 10 samples after a warm-up): the
   end-to-end paths, then at encode, decode r=1 and decode r=2 the kernel,
   its first design (``prior_ms``) and a device copy of the same bytes
   read and written (``copy_ms``), in turns, each sample 10 launches back
   to back; and the plain version.

The crc32c slice adds, after phase 4 (so that phases 1-4 run as they did
before it):

3b. the crc32c kernel against its plain version on the card, byte-exact:
   every length 0..4097 as one padded batch, 64 rows of 0..41 segments,
   a 1-D view one byte off 16-byte alignment and rows at odd strides;
4r. the device-resident write path, per technique, with the residency
   budget large enough to keep every body: (d) ``encode_resident_shards``
   of each object (S=128, 12 bodies of 512 KiB) and (e) one of all 64 as
   one (8192, 8, 4096) batch on the card, counted alone: the one-pass fused
   kernel (``csrc/fused_encode_crc.cu``) must launch exactly once per call
   and the bit-matmul and crc32c kernels never; then the device verify of
   every stored shard (``crc32c_of_device_array``), counted apart: the
   crc32c kernel must launch.  After the counted runs: every body equals
   the ``ecutil.encode`` shard, every crc equals the device verify and the
   plain crc32c, one object's 12 crcs equal a host ``HashInfo``, a
   ``corrupted()`` data shard fails its verify while its siblings pass and
   ``decode_concat`` of the other 11 returns the object; the crc32c kernel
   on the 12 x 32 MiB bodies and the fused encode at S=8192 against their
   plain versions, the fused call allocating nothing beside its bodies;
5r. times: the crc32c kernel on the 12 bodies of 32 MiB and the fused
   encode at S=8192, each in turns with its first form (``prior_ms``: the
   kernel's per-thread path; the two-launch form, bit-matmul then crc32c
   gather) and a device copy of its bytes, 10 launches per sample; their
   plain versions; (d) and (e) as GiB/s of object data (host clock around
   calls that end in the crc fetch).

The one-pass fused encode adds, after 3b:

3f. the one-pass kernel against ``fused_encode_crc_plain``, byte-exact,
   per technique, at S = 128, 1 and 3, C = 2048 and 6144, (k, m) = (3, 2),
   (10, 4) and (8, 5) (two parity groups); and C = 4099, which takes the
   two-launch form (the one-pass count must stay put there, the bit-matmul
   and crc32c counts move).

The codec-family slice adds, after 5r:

3w. the word-layout kernel K3 (``gfw_bit_matmul_launch``) against
   ``gfw_bit_matmul_plain``, byte-exact, at w = 16 and 32: the path shape
   (S, k, m, C) = (16384, 4, 2, 4096), (5, 3) and (1, 1), k' = k w/8 = 256,
   C = w/8 and 4096 + 3 w/8, random 0/1 matrices, a pointer one byte off
   16-byte alignment (the byte path); and its prior form (torch
   de-interleave, K1, re-interleave) at the path shape;
4j. seven k=4 profiles (jerasure reed_sol_van w=8/16/32, reed_sol_r6_op,
   cauchy_good at packetsize 2048, shec k4m3c2, lrc k4m2l3) on the same 64
   objects of 4 MiB, chunk ``get_chunk_size(4 * 4096)``: (a) ``ecutil.encode``
   per object, (b) one batched encode of all 64 (numpy in and out), (c)
   ``ecutil.decode_concat`` per object with one data and one coding chunk
   lost where the code tolerates it; the batch against the per-object
   shards, object 0 against the host codec, the decoded objects against the
   payloads, byte-exact; K3 must launch and K1 must not on w=16/32, K1 on
   the others; which profiles decode on the host codec is logged;
5w. K3 at the path shape per w in turns with its prior form and a device
   copy of its bytes, its plain version, the (a)/(b)/(c) rates per profile,
   and K1 at cauchy_good's virtual shape (1024, 32, 16, 8192).

The CRUSH slice adds, after 5w, on measure_crush_remap's map (1000 OSDs in
50 hosts of 20, straw2, jewel tunables; (u) weights 0x10000, (n) 0x8000 x
{1..4}) with rule ``data`` (chooseleaf firstn, size 3) and jerasure k=8
m=4's ``create_rule`` (chooseleaf indep, size 12):

3c. K7a (``crush_descend``) and K7b (``crush_resolve``) against their plain
   versions on the card, exact: the candidates, leaf attempts and packed
   rows of the four configurations at 100000 x under four weight vectors
   (all in, one out, ten out, a random mix), and of the small shapes
   (chained firstn/indep/chooseleaf rules, choose_args with 3 positions, a
   zero-weight host, a map with no quotient-table level, and (since K7a's
   redesign) (n)-style host weights with weights below 0x10000 among them)
   at 4096 x, whose ``map_batch`` also goes against ``crush_do_rule``;
4c. the main path, counts reset just before: per configuration
   ``compile_fast_rule(...).map_batch`` of 100000 x, then 10 epochs, epoch e
   with OSD (7e+3) % 1000 out (the K7a count must not move on them); an
   OSDMap of the (u) map with a replicated pool of 65536 PGs and an EC pool
   of 32768, ``OSDMapMapping().update`` and 10 epochs of ``mark_out`` (both
   pools must map on the card).  A 2048-x sample of every fifth epoch
   (0, 5, 10) goes against ``crush_do_rule`` and 1024 PGs per pool
   against ``pg_to_up_acting_osds``, in a pool of worker processes; epoch
   10 goes against the plain versions on all 100000 x;
5c. K7a over one candidate phase per configuration and K7b per epoch, in
   turns, 10 back to back per sample, and their plain versions (one
   sample each since the cephfs slice, for the time limit); (f) and (g)
   are the host-clock walls of 4c's epochs.

The whole-rule slice adds K6 (``crush_rule``, the whole rule for each x with
its full tries) and the redesigned K7b to 3c/4c/5c, and crushtool --test:

3c. K6 against ``crush_rule_plain`` (on the CPU), exact: on the small shapes
   at 4096 x under four weight vectors, and per configuration over 4096
   sampled x plus every x K7b flags under the 3c weights; the K6-finished
   rows of every 3c weight vector (``FastRule.exact_packed``) against the
   plain versions' on the card; 256 x per configuration against
   ``crush_do_rule`` on the host (with the other host checks);
4c. the K6 count must move in every epoch of both drives (it runs over the
   flagged x, none or many, with no host sync); every epoch asserts
   ``host_replayed == 0`` (FastRule and both OSDMap pools) and logs the
   residual fraction, the share of x K7b flagged and K6 finished;
5c. K6 over all 100000 x per configuration and over the flagged x alone,
   and K7b, replayed from a CUDA graph of 10 launches (the kernel's own
   time; K7b's wrapper takes longer on the host than its kernel on the
   card, so it is also timed as before, host launch included), against
   K6's instruction bound: the straw2 items its plain version draws for
   the same x, times OPS_PER_DRAW;
4t. ``CrushTester`` (crushtool --test --show-statistics) over the (u) map:
   every rule and numrep at x 0..1023 on the card equals the same sweep on
   the plain versions (CPU) byte for byte; then each rule at its pool size
   over 100000 x on the card, timed.

K6's warp redesign (one warp per x over an index list, the thread form
kept for a whole list of x) adds:

3c. every K6 check above on both forms: the thread form (``map_batch``)
   and the warp form over an index list of the same x (``k6_warp_all``),
   beside the flagged launch (``exact_packed``), which is the warp form;
5c. K6 over all x in both forms, in turns; the most straw2 items one
   flagged x draws (``crush_rule_plain``'s ``draws``);
   K7c over epoch 10 against epoch 9 by graph replay, against its byte
   bound; K6's ptxas registers, stack and spill in the ``kernels`` line.

K7c by hand (``crush_delta``, ``csrc/crush_fast.cu``: the changed rows of
an epoch, two launches) adds:

4c. the K7c count must move on every delta epoch of the drive, and is in
   the main path's counts;
3c. after the drive (``k7c_checks``), per configuration ((u) and (n),
   firstn and EC), K7c's flat buffer equals ``crush_delta_plain``'s
   exactly on epoch 10 against epoch 9, on an all-equal epoch and with a
   cap of half the changed rows (an overflow); then ``map_batch`` with a
   cap of 1 overflows on epoch 9, takes its refetch path (the cap
   doubles) and equals the plain versions on every x;
5c. K7c and its plain version by graph replay in turns, in the
   ``kernels`` line as ``crush_delta``.

The legacy slice (K8, ``csrc/crush_legacy.cu``: the legacy-tunables mapper
of ``ops/crush_legacy.py``) adds, after 5c, on (L): 1000
OSDs in 5 racks x 10 hosts x 20, every bucket straw (v1), compiled by
``crushtool -c`` from text without tunable lines (so choose_local_tries 2,
choose_local_fallback_tries 5, choose_total_tries 19), with rules L1
(chooseleaf firstn 0 type host, size 3) and L2 (choose firstn 2 type rack,
chooseleaf firstn 2 type host, size 4), and 12 weight epochs (all in; 1..10
each marking 2 more OSDs out; H: 3 hosts with 15 of their 20 OSDs out and 20
other OSDs at 0x8000):

3l. K8 against its plain version on the card, byte-exact: every rule and
   weight vector of the small legacy maps of
   ``tests/test_torch_crush_legacy*.py`` at 4096 x, and the first 4096 x of
   each rule and epoch of (L); the x that took a permutation draw and a
   local retry are counted (both must be > 0 on (L));
4l. the path, the K8 count reset just before: ``crushtool -c`` of (L)'s
   text, ``decode_crushmap``, ``LegacyFastRule(...).map_batch`` of 100000 x
   per rule and epoch (K8 must launch every time, residual_fraction 0.0);
   ``crushtool -i L.bin --test --show-mappings`` (x 0..1023, its own
   process) prints K8's rows; a 1000-x sample per rule and epoch equals the
   host ``crush_do_rule`` and K8's one-thread walk (``_Thread``,
   ``tests/test_torch_crush_legacy_kernel.py``) in a pool of workers;
5l. K8 per rule and epoch over 100000 x from a CUDA graph of 3 launches,
   against its instruction bound (the items the transcription hashes per x
   over the sample, scaled, at OPS_PER_DRAW each), the plain version's wall
   on its 4096 x, and the ``map_batch`` walls.

K8's group redesign (a group of 4 lanes per x; each straw draw shared by
the group and reduced by xor shuffles; slot state in registers; one flat
machine per group between draws) adds:

3l. a wide map (3 racks x 2 hosts x 40 OSDs: host draws of ten rounds of
   the group's lanes) to the maps K8 is held against its plain version on;
5l. the ptxas registers, stack and spill of both instances in the
   ``kernels`` line.

K7a's redesign (one launch per stage: a thread per (lane, r, position)
derives its lanes from its index and draws its candidate's leaf attempts;
the hash split across the integer and FMA pipes; per-item int64 quotient
tables, or a multiply-high, in place of the s64 divide) adds, before 3c:

3h. the hash alone (``csrc/crush_probe.cu``): ``hash32_3`` and K7a's
   ``hash32_3_split`` (part of each mix on the FMA pipe) over 2^22 x 256
   hashes, both forms' folded words equal, timed in turns, with their SASS
   ALU / FMA counts per hash and thread-instructions per SM per clock; K7a's SASS
   must call no subroutine.  In 5c K7a's launches are also timed, in the
   same turns, in the draw form K7a does not take (every level on the
   multiply-high on (u); the multiply-high in place of the per-item int64
   quotient tables on (n)), and the SASS class counts of every kernel are
   logged in phase 2.

``python3 chip_smoke.py --k6-parent DIR`` builds and checks nothing else:
after phases 1-2 it times K6 of this tree in turns with K6 of the checkout
of the port under DIR (``k6_parent_turns``, one log line per configuration)
and prints the same last line.  ``--k8-parent DIR`` does the same for K8
(``k8_parent_turns``): (L)'s 100000 x for L1 and L2 at epochs 0, 10 and H,
both trees' rows equal.  ``--k7a-parent DIR`` (``k7a_parent_turns``) times
the candidate phase and its K7a launches of both trees in turns on the four
configurations at 100000 x, both trees' cand and leaf tables equal.
``--k7a-forms`` (``k7a_form_turns``) times K7a's per-item int64 quotient
tables against its multiply-high in turns on (n) maps of 4 to 1000
distinct weights, both forms' tables equal: the measurement behind
``Q64_MAX_TABLES``.  ``--dispatch-scan`` (``dispatch_scan_turns``) looks for
where the bench CLI's coalesced flush loses its time: the first touch of
new host pages, 4n's ``encode_batch_scan``, the CLI's dispatch workloads in
this process, and the CLI in turns as it is and with glibc's malloc held
(``MALLOC_KEEP``); results in ``chiprun_out/dispatch_scan.json``.

The observability and bench-core slice adds, after 5l:

4b. the port's own fenced bench (``ceph_tpu_torch/bench``) on the card,
   with the kernel timer on: ``measure_encode`` and ``measure_decode``
   (e=2) on ``gf_gen_rs_matrix(12, 8)`` at the JAX bench's full-mode
   shapes (batch (64, 8, 131072), target 3 s, 3 repeats, 1 warmup), then
   ``parity_check``; ``measure_crush_remap`` (1000 OSDs, 100000 PGs, 10
   epochs) on the uniform and the nonuniform map.  Every kernel count is
   set to 0 just before each step and read just after: K1 must move for
   encode and decode, K7b and K6 (over the x K7b flags) for each remap.
   Each schema metric is printed with its roofline verdict; the run fails
   if a metric is not fenced or is suspect, if ``parity_check`` is false,
   if a count does not move or if the remap recomputed an x on the host.
   Then the device-flow profiler's dump (its compile count must equal the
   nvcc builds of the run), the kernel timer's dump and the oplat stage
   breakdown of the phase.  After 4c the ``crush_map_update`` histogram's
   percentiles (``OSDMapMapping.update``, the OSDMap drive) are printed.

The dispatch and native-library slice adds, after 4b:

4d. the dispatch scheduler (``ceph_tpu_torch/dispatch``) on the card, with
   the ``cuda`` plugin k=8 m=4 reed_sol_van, stripe unit 4096, on the 64
   objects of 4 MiB: ``submit_encode`` of all 64 with
   ``ec_dispatch_batch_max`` 64 (one coalesced flush, byte-equal to
   per-object ``ecutil.encode``); ``submit_decode_concat`` of all 64 with
   shards {1, 9} lost (byte-equal to the payloads); then 8 submitter
   threads x 8 objects on a new codec (its device backend must be built
   once), byte-equal: with a collection window and flushes of 16, every
   thread queued before any asks for a result, so the mean batch
   occupancy (the dispatcher's histogram) must exceed 8, a flush holding
   requests of two threads; and at window 0, where each thread runs its
   encodes inline, at least two threads must be in the codec's
   ``encode_batch`` at once.  The most ``_execute`` calls, ``encode_batch``
   calls and K1 wrapper calls running at once are logged per leg.  K1's
   count is set to 0 just before each leg and must equal the leg's
   flushes and inline calls just after; the dispatcher's
   ``batch_fallbacks``, ``dispatch_fallback`` and ``request_errors`` must
   not move in any leg.  Then the host-clock times
   of coalesced against serial (window 0) encode and decode of the 64
   objects, in turns, and one more run of each with its stage ledger,
   kernel timer and host copies and transfers per object;
4n. the native host library (``native.py``, g++ of ``csrc_host/``): its
   build seconds and a check of its crc32c and region coder against the
   plain versions; ``encode_batch_scan``: the ``cuda`` codec's
   ``encode_batch`` and K1 alone at (S, 8, 8192), S = 1, 8, 16, 32, 64,
   the shapes the CLI's dispatch workloads flush, byte for byte against
   K1's plain version, with the pieces of its time and of one coalesced
   flush of S objects; then ``python -m ceph_tpu_torch.bench --gate warn`` in
   its own process, whose one JSON line must be schema-valid with every
   metric fenced and not suspect, ``decode_parity`` and the pipeline's
   ``identical`` true and no error (the line goes to
   ``chiprun_out/bench_line.json``).  Since the cephfs slice 4n runs
   first after the build, on a host the host-bound checks have not yet
   loaded: its mesh workloads' wall-clock gates (4w (d)) read the host's
   jitter.

The placement and store slice (``osdmap/upmap.py``, ``osdmap/balancer.py``,
``tools/osdmaptool.py``, ``os_store/memstore.py`` and the modules under
them) adds, after 4n:

4o. ``osdmaptool`` on the card (``tools/osdmaptool.main``, in this
   process): ``--create-from-conf`` of a ceph.conf.withracks-style conf the
   script writes (1000 OSDs, 5 racks x 10 hosts x 20, jewel tunables) with
   ``--with-default-pool --pg_bits 7 --pgp_bits 7`` (128000 PGs, size 3,
   chooseleaf host); ``--mark-up-in --test-map-pgs`` with the K7a, K7b and
   K6 counts set to 0 just before and read just after (each must move;
   ``last_backend`` "device", ``host_replayed`` 0), 2048 sampled PGs
   against the scalar ``pg_to_up_acting_osds`` (``crush_do_rule``, the
   ``--host-mapper`` route); then ``--mark-up-in --mark-out 7 --upmap FILE
   --upmap-max 100 --upmap-deviation .01 --upmap-save`` (the native
   library's mapper under the optimizer) and ``--test-map-pgs`` of the
   saved map, counted the same way, every upmapped PG and the sample
   against the scalar pipeline.  The walls of each step, with
   ``--test-map-pgs`` split into the device update (``_raw_batch``, rows
   fetched) and the host post-pass (``_postprocess``);
4m. ``MemStore`` with resident bodies: the resident write (K5, one launch
   per object) of the 64 objects of 4 MiB, k=8 m=4 reed_sol_van, into 12
   stores through ``write_shard`` transactions, counted alone;
   ``read_shard`` of every body returns its resident handle with no
   device-to-host bytes in the device-flow profiler; the device verify
   (K4) of every body passes; ``store.shard_corrupt`` armed on one shard
   and the verify flags that shard and no other; ``read`` of every body
   equals the host encode (the corrupted one differs in its first byte).

The OSD data path slice (``common/work_queue.py``, ``osd/ec_backend.py``,
``osd/pg.py``, ``osd/osd.py``, ``recovery/``, ``mon/monitor.py``,
``client/``, ``ec/regenerating.py``) adds, after 4m:

4p. a client's writes and reads through the port's daemons: one monitor
   and 12 OSDs (one per host) over the in-process messenger, assembled by
   ``Daemons`` as the JAX ``MiniCluster`` assembles them without its
   manager, and a ``RadosClient``; k=8 m=4 ``plugin=cuda`` pools of 128
   PGs (32 in the whole smoke since the cephfs slice, as in 4q and 4x,
   for its time limit; ``crush-failure-domain=host``), the 64 objects of
   4 MiB made from
   the seed.  Legs (a) write, reads, ranged read, rmw; (b) two OSDs down,
   degraded reads; (c) one downed OSD's disk replaced, recovery; (d)
   residency on: K5 writes, K4-verified reads, a rotted body, deep scrub;
   (e) four op threads, pipeline depth 8 and a collection window: 64
   writes of 64 KiB in one burst, K1 once per flush; (f) a regenerating
   pool (k=8 m=4 d=10), a replaced disk rebuilt by sub-chunk repair
   rounds.  Every op answers within ``OSD_PATH_DEADLINE_S``, every write
   answers 0, every read and stored body is byte-exact against the native
   host coder (the regenerating pool's against the port's ``backend=host``
   codec), and each leg's K1, K4 and K5 counts, set to 0 just before it,
   must move as ``osd_path_slice`` states.  Wall and GiB/s per leg, and
   from a separate traced run (``LegTrace``: the kernel timer and
   ``torch.profiler``) the share of the wall in kernels, but for the two
   rebuilds.  ``python3 chip_smoke.py --osd-path`` runs 4p alone after
   phases 1-2, the rebuilds' traced runs included.

The process slice (``msg/tcp.py``, ``auth/``, ``compressor/``,
``vstart.py``) adds, after 4q:

4v. the port's process cluster: ``ProcessCluster(device="cuda")`` spawns
   one mon process and 12 OSD processes (``python -m
   ceph_tpu_torch.vstart``, here through ``osd_launcher``), cephx on, each
   OSD on a ``WALStore`` in a temporary directory; an isa k=8 m=4 pool of
   32 PGs, 32 objects of 4 MiB from the seed and a client in this
   process over TCP.  (a) writes and reads; (b) two OSDs holding data
   shards SIGKILLed, degraded reads, 8 more writes; (c) both restarted on
   their data directories, ``wait_healthy``, recovery's pushes, reads,
   then (``--vstart`` only since the rbd slice, for the time limit) 4
   other OSDs SIGKILLed and the 8 late objects read through the restarted
   disks' recovered shards.
   Each OSD process opens the card and loads K1 before READY and reports
   both and its own K1 launches (the sum must move in every leg); the
   device memory the 12 processes took is the contexts' size.  ``python3 chip_smoke.py --vstart`` runs 4v
   alone after phases 1-2.

The mon failover over TCP adds to 4v: three mon processes (``mon_grace``
8 s), the client bound to the peon ``mon.1``, and after (c) a leg (d): three
self-managed snapshot ids, a relayed ``selfmanaged_snap_create`` in flight
and the leader ``mon.0`` SIGKILLed; ``quorum_status`` until rank 1 leads a
quorum of two without rank 0; a snapshot id above every earlier one; 8
writes of 4 MiB (the OSD processes' K1 sum must move by at least 8); every
object of (a)-(d) read back byte-exact; a second client on ``mon.2`` at the
same epoch and snapshot sequence.  The election's seconds and the leg's
wall are logged.  (--vstart's proof kill now follows (d).)

The mesh slice adds, after 4v (the earlier phases run as they did):

4w. the mesh on 8 members of ``cuda:0`` (``set_members_per_device(8)``;
   the members share one card: parity and per-member launches, not
   scaling).  (a) K9x (``csrc/mesh_xor.cu``) against its plain version on
   the partial products of the survivor-sharded decode of survivors
   (8192, 8, 4096) with data shards 1 and 2 lost, for 2, 4 and 8
   partials, max_abs_err 0 and equal to K1's whole decode; its time, a
   device copy of the same bytes, its bound ((n+1) S r C bytes) and the
   plain version.  (b) ``ShardedRS`` on a (4, 2) mesh: encode, decode,
   survivor-sharded decode (K1 once per member, K9x once) and reshard,
   byte-equal to one-device K1 and the native host coder;
   ``ShardedFastRule`` on 4o's 1000-OSD map over 100000 x, rows equal to
   ``FastRule``'s, K7a/K7b/K6 counted.  (c) a coalesced flush of 4d's 64
   objects of 4 MiB with ``ec_mesh_chips=8`` against the mesh off:
   byte-equal, every member occupied, K1 members x flushes; then
   ``batch_mesh(-1)`` with one member per device: one member, the
   single-device path.  (d) the gates of the bench CLI's four mesh
   workloads from 4n's line (the skew ruler, the straggler and
   degraded-read A/Bs, the mesh encode's receipt), with each leg's K1 /
   K9x launches.  ``python3 chip_smoke.py --mesh`` runs 4w alone after
   phases 1-2, running (d)'s workloads in its own process.

The harnesses and rbd slice adds, to 4n and after 4w (the earlier phases
run as they did):

4n. the bench CLI's line also carries the SLO autotune and composed chaos
   (seeds 24, 103, 196 and 20260807), ``not_ported`` empty: regress.py's
   CONTROL and CHAOS gates pass, every storyline accepted, byte-exact and
   unwedged, the autotune byte-exact with no move from its disabled twin;
   each workload's wall and K1 / K9x launches are logged and counted.
4x. a block device on an erasure-coded data pool (``rbd_slice``): a
   ``MiniCluster`` of 12 OSDs, a replicated ``rbd`` pool (size 3) for the
   headers and the journal, an ``ecdata`` pool (``cuda`` k=8 m=4, 128
   PGs, 32 in the whole smoke), ``rbd create --size 256M --data-pool ecdata --journaling`` at
   order 22.  (a) fill, 64 writes of 4 MiB; (b) 128 writes of 4 KiB at
   seeded random offsets (64 in the whole smoke since the cephfs slice,
   for the time limit), p50 / p99 per op; (c) snapshot, protect, a
   clone on ``ecdata`` and 16 copyup writes into it, then a sample of
   stored shards against the native host coder; (d) two OSDs holding
   data shards killed and marked down, the image, its snapshot and the
   clone exported against a numpy model; (e) an ``ImageMirror`` replaying
   the source journal onto a second ``MiniCluster`` (6 OSDs, ``cuda``
   k=4 m=2, 32 PGs), its export equal to the source.  K1 is counted per
   leg (once per write in (a)-(c) and per replayed write in (e), at least
   once per object that lost a data shard in each export of (d)), with
   each leg's wall and the device's busy share where the profiler sees
   it.  ``python3 chip_smoke.py --rbd`` runs 4x alone after phases 1-2.

The cephfs slice (``cephfs/``, ``mds/``) adds, after 4x (the earlier
phases run as they did):

4y. a filesystem whose file data lives on an erasure-coded pool
   (``cephfs_slice``): a ``MiniCluster`` of 12 OSDs, a replicated
   ``fsmeta`` pool (size 3, 32 PGs), an ``fsdata`` pool (``cuda`` k=8 m=4,
   stripe unit 4096, 64 PGs), ``MDSDaemon(mkfs=True)`` and two
   ``RemoteCephFS`` clients.  (a) A buffers 32 files of 4 MiB under the
   BUFFER cap, B reads each (the revoke round makes A flush first),
   byte-exact; (b) 256 files of 4 KiB in 16 directories created, written
   and stat'ed, p50 / p99 per file; (c) a snapshot of one directory, a
   file in it overwritten, the snapshot's view equal to the old bytes;
   (d) two OSDs holding data shards killed and marked down, every file
   read back equal to a numpy model; (e) the MDS dropped and a fresh
   ``MDSDaemon(mkfs=False)`` replaying the journal, the namespace and the
   bytes equal.  K1 is counted per leg (it must move in (a), (b) and
   (d), and some object must have lost a data shard in (d)), with each
   leg's wall and, from a traced sample, the device's busy share where
   the profiler sees it.  ``python3 chip_smoke.py --cephfs`` runs 4y alone
   after phases 1-2.

The rgw slice (``rgw/``, ``radosgw-admin``) adds, after 4y (the earlier
phases run as they did):

4z. an S3 object store whose data lives on an erasure-coded pool
   (``rgw_slice``): a ``MiniCluster`` of 12 OSDs, a replicated
   ``rgwmeta`` pool (size 3, 32 PGs), an ``rgwdata`` pool (``cuda`` k=8
   m=4, stripe unit 4096, 32 PGs), ``RGWLite`` behind ``S3Frontend``
   under ``serve()`` on localhost, and a user made by ``radosgw-admin
   user create`` whose keys sign every request (AWS v4).  (a) 16 PUTs of
   16 MiB (4 chunks each) and their GETs, byte-exact, ETag = md5; (b) 128
   PUTs of 4 KiB, p50 / p99 per PUT; (c) a multipart upload of 3 parts of
   8 MiB, completed, its GET the concatenation; (d) versioning on (b)'s
   bucket, 8 keys overwritten, a noncurrent-after-3-days lifecycle pass
   four days on and ``gc``: the data pool holds exactly the model's live
   chunks; (e) two OSDs holding data shards killed and marked down, every
   live object's GET equal to a numpy model.  K1 is counted per leg (it
   must move in (a), (b), (c) and (e), and some chunk must have lost a
   data shard in (e)); any request that should succeed and gets a reply
   outside 2xx fails the phase.  Each leg's wall and, from a traced
   sample, the device's busy share where the profiler sees it.
   ``python3 chip_smoke.py --rgw`` runs 4z alone after phases 1-2.

The RADOS features that the case twins hold to the JAX package's own
cases (``tests/test_torch_rados_cases.py`` and its siblings) add, after
4z (the earlier phases run as they did):

4r (rados features; not 4r the resident write above). An erasure-coded
   pool through a monitor failover, an OSD flap, a PG split and a
   self-managed snapshot (``rados_features_slice``): a ``MiniCluster`` of
   3 monitors and 12 OSDs, a ``cuda`` k=8 m=4 pool of 32 PGs, objects of
   4 MiB.  (a) 32 ``write_full``; the leader monitor killed, ticks until
   ``mon.1`` leads; 16 writes and a pool created under the new leader;
   the monitor revived: K1 launches once per write (48).  (b) One OSD
   killed and marked down; 16 writes and 16 unaligned partial overwrites
   while it is away; revived and recovered: recovery pushes exactly one
   shard per object changed in its absence (the PG log's delta, not the
   PGs' contents), and K1 decodes the pushed data shards.  (c) ``pg_num``
   then ``pgp_num`` 32 -> 64; every object read back byte-exact; an OSD
   holding a data shard of a child PG's object killed: its degraded
   reads decode on K1.  (d) A self-managed snapshot, 8 overwrites under
   its write context (each clones the old bytes as an EC object of its
   own: K1 twice per write), every object read at the snap equal to its
   old bytes and at head to its new ones.
   Every read is byte-exact, and a missing reply or a non-zero answer
   fails the leg.  ``python3 chip_smoke.py --rados-features`` runs 4r
   alone after phases 1-2.

Each phase's seconds are printed.  Prints the ``{"kernels": [...]}`` line
before the last and, as the last line, ``{"ok": true, "device": {...}}``.
Full results also go to ``chiprun_out/chip_smoke.json``, and every line
logged, stamped with the seconds since the start, to
``chiprun_out/chip_smoke.log``.
"""
from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# the one definition of the card's two peaks, shared with the bench's
# roofline (NVIDIA H100 SXM, dense)
from ceph_tpu_torch.bench.roofline import (
    H100_HBM_BYTES_PER_S as HBM_BYTES_PER_S,
    H100_INT8_OPS_PER_S as INT8_OPS_PER_S)

K, M = 8, 4
CHUNK = 4096                      # osd_pool_erasure_code_stripe_unit
OBJ_BYTES = 4 << 20
N_OBJ = 64
ERASED = (1, 9)
# H100 SXM 32-bit integer throughput: 132 SMs x 64 lanes x 1.98 GHz
INT32_OPS_PER_S = 132 * 64 * 1.98e9
RESIDENT_BUDGET = 4 << 30         # os_memstore_device_bytes_max for 4r
RUNS = 10
REPS = 10                         # back-to-back launches per kernel sample
SEED = 20261016


LOG_FILE = []                     # main()'s log file, stamped, if any


def log(msg: str) -> None:
    print(msg, flush=True)
    for path, t0 in LOG_FILE:
        with open(path, "a") as f:
            f.write(f"{time.perf_counter() - t0:8.1f} {msg}\n")


def cuda_ms(fn, runs: int = RUNS, warmup: int = 2) -> float:
    """Median device time of one call of ``fn`` over ``runs`` calls, by
    CUDA events: the time a caller waits for it, host launch included."""
    return turns_ms([fn], runs, warmup)[0]


def turns_ms(fns, runs: int = RUNS, warmup: int = 2, reps: int = 1):
    """Median device time of each of ``fns``, launched in turns (one
    sample of each per round) so that they share the card's state.  A
    sample times ``reps`` calls back to back and divides: with reps > 1
    the host's launch overhead hides behind the queued launches, and the
    figure is the kernel's own time."""
    for fn in fns:
        for _ in range(warmup):
            fn()
    times = [[] for _ in fns]
    for _ in range(runs):
        for fn, t in zip(fns, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(reps):
                fn()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b) / reps)
    return [statistics.median(t) for t in times]


def kernel_name(mangled: str) -> str:
    """``crush_rule_thread_kernel<12>`` for a mangled kernel name."""
    m = re.search(r"\d+((?:crush|gfw?|crc32c|fused)\w*?_kernel)"
                  r"(I(?:L[ib]\d+E)+E)?", mangled)
    if not m:
        return mangled
    args = re.findall(r"L[ib](\d+)E", m.group(2) or "")
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def graph_ms(fn, launches: int = REPS, samples: int = RUNS) -> float:
    """Median device time of one call of ``fn``, replayed from a CUDA graph
    of ``launches`` calls back to back: the kernels' own time, with no
    host launch cost between them (a wrapper that takes longer on the host
    than its kernel on the card is otherwise what a timer measures)."""
    return graph_turns_ms([fn], launches, samples)[0]


def graph_turns_ms(fns, launches: int = REPS, samples: int = RUNS):
    """``graph_ms`` of each of ``fns``, one graph each, replayed in turns
    (one sample of each per round) so that they share the card's state."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            for _ in range(2):
                fn()
    torch.cuda.current_stream().wait_stream(side)
    graphs = []
    for fn in fns:
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(launches):
                fn()
        g.replay()
        graphs.append(g)
    torch.cuda.synchronize()
    times = [[] for _ in fns]
    for _ in range(samples):
        for g, t in zip(graphs, times):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            g.replay()
            b.record()
            b.synchronize()
            t.append(a.elapsed_time(b) / launches)
    del graphs
    return [statistics.median(t) for t in times]


def ptxas_usage(lines):
    """{kernel: {"registers", "stack", "spill_stores", "spill_loads"}} from
    the ptxas lines ``main`` keeps per source (a kernel's name, then its
    stack/spill and register lines)."""
    usage, name = {}, None
    for line in lines:
        if "bytes stack frame" in line or "registers" in line:
            if name is None:
                continue
            u = usage.setdefault(name, {})
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers")):
                m = re.search(pat, line)
                if m:
                    u[key] = int(m.group(1))
        else:
            name = line
    return usage


# SASS opcodes that issue on the integer (ALU) pipe: 16 lanes per SM
# sub-partition, one warp instruction every other clock; IMAD* runs on the
# FMA pipe
ALU_OPS = ("IADD3", "LOP3", "SHF", "ISETP", "SEL", "LEA")


def sass_counts(so_path, nvcc):
    """{kernel: {"POPC": n, "LDS": n, "instructions": n, "alu": n, "fma":
    n, "opcodes": {head: n}, "subroutines": {address: n}}} from the SASS of
    a built library (static counts: each instruction once, loops not
    multiplied; ``alu`` the ALU_OPS, ``fma`` the IMAD forms; a subroutine
    the compiler emits inside a kernel and reaches by ``CALL.REL``, such
    as the s64 divide, counted from its address to its ``RET``), or None
    when the toolkit has no ``cuobjdump``."""
    tool = os.path.join(os.path.dirname(nvcc or ""), "cuobjdump")
    if not os.access(tool, os.X_OK):
        return None
    text = subprocess.run([tool, "-sass", str(so_path)], capture_output=True,
                          text=True, check=True).stdout
    counts, code, name = {}, {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = kernel_name(m.group(1))
            counts[name] = {"POPC": 0, "LDS": 0, "instructions": 0,
                            "alu": 0, "fma": 0, "opcodes": {}}
            code[name] = []
            continue
        ins = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)(.*)", line)
        if not name or not ins:
            continue
        c = counts[name]
        c["instructions"] += 1
        head = ins.group(2).split(".")[0]
        if head in ("POPC", "LDS"):
            c[head] += 1
        if head in ALU_OPS:
            c["alu"] += 1
        elif head.startswith("IMAD"):
            c["fma"] += 1
        c["opcodes"][head] = c["opcodes"].get(head, 0) + 1
        code[name].append((int(ins.group(1), 16), ins.group(2), ins.group(3)))
    for name, listing in code.items():
        subs = {}
        for _, op, rest in listing:
            target = re.match(r"\s+(0x[0-9a-f]+)", rest)
            if op.startswith("CALL.REL") and target:
                start = int(target.group(1), 16)
                n = 0
                for addr, op2, _ in listing:
                    if addr >= start:
                        n += 1
                        if op2.startswith("RET"):
                            break
                subs[target.group(1)] = n
        counts[name]["subroutines"] = subs
    return counts


def wall_s(fn, runs: int = RUNS, warmup: int = 1) -> float:
    """Median host time of ``fn`` (ending in a device synchronise)."""
    for _ in range(warmup):
        fn()
        torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def bound_ms(s: int, k: int, r: int, c: int):
    """Least time for the product on this card: each input byte read
    once and each output byte written once over HBM, against the same
    product counted as an int8 matmul (2 * S*C * 8k * 8r) at peak."""
    t_bytes = (s * k * c + s * r * c) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * s * c * (8 * k) * (8 * r) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def crc_bound_ms(n_bytes: int, n_rows: int):
    """Least time for crc32c of n_bytes in n_rows: every byte read once
    and 4 B written per row over HBM, against one table lookup and one
    XOR per byte at the card's 32-bit integer instruction rate."""
    t_bytes = (n_bytes + 4 * n_rows) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * n_bytes / INT32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fused_bound_ms(s: int, k: int, m: int, c: int):
    """Least time for the fused encode: stripes read once, n bodies and n
    crcs written once, against the product as an int8 matmul plus the
    crc's lookups and XORs over the n bodies."""
    n = k + m
    t_bytes = (s * k * c + n * s * c + 4 * n) / HBM_BYTES_PER_S * 1e3
    t_ops = (2 * s * c * (8 * k) * (8 * m) / INT8_OPS_PER_S
             + 2 * n * s * c / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def int_err(got: torch.Tensor, want: torch.Tensor) -> int:
    """Largest absolute difference of two integer tensors (0 if empty)."""
    if got.shape != want.shape:
        raise AssertionError(f"shape {tuple(got.shape)} != "
                             f"{tuple(want.shape)}")
    if not got.numel():
        return 0
    return int((got.long() - want.long()).abs().max())


def crc_checks(gen, rng, dev) -> int:
    """3b: the crc32c kernel against its plain version, byte-exact, at
    the sweep, ragged, misaligned and odd-stride cases; returns the max
    error (0)."""
    from ceph_tpu_torch.ops import crc32c_device
    crc_cases = []
    sweep_len = np.arange(0, 4098)
    rows = torch.randint(0, 256, (4098, 4104), generator=gen, device=dev,
                         dtype=torch.uint8)
    crc_cases.append(("sweep_0_4097", rows, sweep_len))
    rag_len = rng.integers(0, 40 * 4096 + 100, 64)
    rag_len[:4] = (0, 40 * 4096 + 100, 32 * 4096, 4096)
    crc_cases.append(("ragged_0_41_segments", torch.randint(
        0, 256, (64, 40 * 4096 + 104), generator=gen, device=dev,
        dtype=torch.uint8), rag_len))
    buf = torch.randint(0, 256, (1 + (3 << 20) + 7,), generator=gen,
                        device=dev, dtype=torch.uint8)
    one = buf[1:]                       # one byte off 16-byte alignment
    if one.data_ptr() % 16 != 1:
        raise AssertionError("misaligned crc case is not one byte off")
    crc_cases.append(("misaligned_1d", one.view(1, -1), None))
    crc_cases.append(("odd_stride_rows",
                      buf[1:1 + 5 * 4099].view(5, 4099), None))
    crc_err = 0
    for name, rows, lens in crc_cases:
        got = crc32c_device.crc32c_kernel(rows, lens)
        want = crc32c_device.crc32c_plain(
            rows, None if lens is None else torch.from_numpy(lens).to(dev))
        torch.cuda.synchronize()
        err = int_err(got, want)
        log(f"check crc32c {name} rows={rows.shape[0]} "
            f"max_len={rows.shape[1] if lens is None else int(lens.max())} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c kernel disagrees with plain at "
                                 f"{name}")
        crc_err = max(crc_err, err)
    if crc32c_device.crc32c_of_device_array(one) != int(
            crc32c_device.to_u32(crc32c_device.crc32c_plain(
                one.view(1, -1)))[0]):
        raise AssertionError("crc32c_of_device_array disagrees at a "
                             "misaligned view")
    # the coalesced path (aligned rows, lengths a multiple of 16): runs
    # with zeros in front, empty rows, and a table of 200 rows (two
    # launches of at most 128)
    rows = torch.randint(0, 256, (300, 3 * 4096 + 48), generator=gen,
                         device=dev, dtype=torch.uint8)
    for name, got, want in (
            ("coalesced_rows", crc32c_device.crc32c_kernel(rows),
             crc32c_device.crc32c_plain(rows)),
            ("coalesced_table_200", crc32c_device.crc32c_rows_kernel(
                list(rows[:200])), crc32c_device.crc32c_plain(rows[:200])),
            ("coalesced_empty", crc32c_device.crc32c_kernel(rows[:3, :0]),
             crc32c_device.crc32c_plain(rows[:3, :0]))):
        err = int_err(got, want)
        log(f"check crc32c {name} max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c kernel disagrees at {name}")
    # the gather mode (copy while hashing): C = 4099 at a pitch of 3 C,
    # one byte off alignment, C = 24 (64 segments), both per-thread, and
    # C = 2048 and 6144 at a pitch of 3 C, coalesced
    for name, src in (("gather_odd", buf[1:1 + 5 * 3 * 4099].view(5, 3, 4099)),
                      ("gather_small", buf[:40 * 3 * 24].view(40, 3, 24)),
                      ("gather_coalesced",
                       buf[:67 * 3 * 2048].view(67, 3, 2048)),
                      ("gather_coalesced_6144",
                       buf[:33 * 3 * 6144].view(33, 3, 6144))):
        s, k, c = src.shape
        bodies = [torch.empty(s * c, dtype=torch.uint8, device=dev)
                  for _ in range(k)]
        got = crc32c_device.crc32c_gather_kernel(
            [src[:, i] for i in range(k)], bodies)
        want = torch.stack([src[:, i].reshape(-1) for i in range(k)])
        err = max(int_err(torch.stack(bodies), want),
                  int_err(got, crc32c_device.crc32c_plain(want)))
        log(f"check crc32c {name} (S,k,C)={(s, k, c)} max_abs_err={err}")
        if err:
            raise AssertionError(f"crc32c gather disagrees at {name}")
    return crc_err


def fused_checks(gen, dev) -> int:
    """3f: the one-pass fused encode against its plain version, byte-exact,
    per technique at the shapes it takes beside the main one, and the
    two-launch form at a tail shape; returns the max error (0)."""
    from ceph_tpu_torch.gf.matrices import (gf_gen_cauchy1_matrix,
                                            gf_gen_rs_matrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    gens = {"reed_sol_van": gf_gen_rs_matrix,
            "cauchy": gf_gen_cauchy1_matrix}
    shapes = [(128, K, M, CHUNK), (1, K, M, CHUNK), (3, K, M, CHUNK),
              (64, K, M, 2048), (64, K, M, 6144), (64, 3, 2, CHUNK),
              (64, 10, 4, CHUNK), (64, K, 5, CHUNK), (64, K, M, 4099)]
    worst = 0
    for tech, genm in gens.items():
        for s, k, m, c in shapes:
            bm = gf_pallas.BitMatrix(
                expand_to_bitmatrix(genm(k + m, k)[k:]), dev)
            data = torch.randint(0, 256, (s, k, c), generator=gen, device=dev,
                                 dtype=torch.uint8)
            one = c % 2048 == 0
            counts = [x.n for x in (fused_encode_crc.launches,
                                    gf_pallas.launches, crc32c_device.launches)]
            bodies, crcs = resident._fused_encode_crc(data, bm)
            moved = [x.n - y for x, y in zip(
                (fused_encode_crc.launches, gf_pallas.launches,
                 crc32c_device.launches), counts)]
            if moved != ([1, 0, 0] if one else [0, 1, 1]):
                raise AssertionError(f"fused {tech} {(s, k, m, c)}: launches "
                                     f"{moved} on the wrong route")
            pb, pcrc = fused_encode_crc.fused_encode_crc_plain(data, bm)
            err = max(int_err(torch.stack(bodies), pb), int_err(crcs, pcrc))
            torch.cuda.synchronize()
            log(f"check fused_encode_crc {tech} (S,k,m,C)={(s, k, m, c)} "
                f"{'one-pass' if one else 'two-launch'} max_abs_err={err}")
            if err:
                raise AssertionError(f"fused encode disagrees with plain at "
                                     f"{tech} {(s, k, m, c)}")
            worst = max(worst, err)
            del bodies, crcs, pb, pcrc, data
    return worst


def resident_phase(tech, codec, objs, objs_dev, shards, sinfo, spo, dev):
    """4r: the device-resident write path of one technique.  Returns its
    launch counts, the batched shards and the max error of its checks."""
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    from ceph_tpu_torch.os_store.device_shard import \
        memstore_device_perf_counters
    from ceph_tpu_torch.osd import ecutil
    n = K + M
    pc = memstore_device_perf_counters()
    demotions = pc.get("demotions")
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crc32c": crc32c_device.launches,
                "fused_encode_crc": fused_encode_crc.launches,
                "resident_calls": resident.launches}
    for c in counters.values():
        c.reset()
    # (d) per object from host memory, (e) the whole batch on the card:
    # one launch of the one-pass kernel per call, no other kernel
    per_obj = [resident.encode_resident_shards(
        codec, o.reshape(spo, K, CHUNK)) for o in objs]
    batch = resident.encode_resident_shards(codec, objs_dev)
    counts = {name: c.n for name, c in counters.items()}
    calls = len(per_obj) + 1
    log(f"resident {tech}: write launches " + json.dumps(counts))
    if counts != {"gf_bit_matmul": 0, "crc32c": 0,
                  "fused_encode_crc": calls, "resident_calls": calls}:
        raise AssertionError(f"{tech}: the resident write is not one "
                             "one-pass launch per call")
    # then the read-side device verify of every stored shard
    crc32c_device.launches.reset()
    verify = [[crc32c_device.crc32c_of_device_array(sh[i].device_array())
               for i in range(n)] for sh in per_obj + [batch]]
    counts["crc32c"] = crc32c_device.launches.n
    log(f"resident {tech}: verify launches crc32c {counts['crc32c']}")
    if counts["crc32c"] == 0:
        raise AssertionError(f"{tech}: the device verify skipped crc32c")
    if pc.get("demotions") != demotions or any(
            not sh[i].is_resident for sh in per_obj + [batch]
            for i in range(n)):
        raise AssertionError(f"{tech}: a body left the card")

    # -- checks, outside the counted run ----------------------------------
    for o, sh in enumerate(per_obj):
        want = torch.from_numpy(np.stack([shards[o][i] for i in range(n)]))
        got = torch.stack([sh[i].device_array() for i in range(n)])
        if not torch.equal(got, want.to(dev)):
            raise AssertionError(f"{tech}: resident body != ecutil.encode "
                                 f"(object {o})")
        if [sh[i].crc for i in range(n)] != verify[o]:
            raise AssertionError(f"{tech}: crc != device verify ({o})")
    stored = np.array([sh[i].crc for sh in per_obj for i in range(n)],
                      dtype=np.uint32)
    plain = crc32c_device.to_u32(crc32c_device.crc32c_plain(torch.stack(
        [sh[i].device_array() for sh in per_obj for i in range(n)])))
    if not np.array_equal(plain, stored):
        raise AssertionError(f"{tech}: crc != plain crc32c")
    hinfo = ecutil.HashInfo(n)
    hinfo.append(0, {i: shards[0][i] for i in range(n)})
    if [hinfo.get_chunk_hash(i) for i in range(n)] != \
            [per_obj[0][i].crc for i in range(n)]:
        raise AssertionError(f"{tech}: crc != host HashInfo")
    for i in range(n):
        want = torch.from_numpy(np.concatenate([sh[i] for sh in shards]))
        if not torch.equal(batch[i].device_array(), want.to(dev)):
            raise AssertionError(f"{tech}: batched body {i} != per-object")
    if [batch[i].crc for i in range(n)] != verify[-1]:
        raise AssertionError(f"{tech}: batched crc != device verify")
    log(f"resident {tech}: (d) {len(per_obj)} x {n} and (e) {n} bodies "
        "equal ecutil.encode; crcs equal the device verify, the plain "
        "crc32c and host HashInfo (object 0)")
    # bitrot on one resident data shard of object 0
    sh, victim = per_obj[0], 2
    sh[victim].corrupted()
    if crc32c_device.crc32c_of_device_array(
            sh[victim].device_array()) == sh[victim].crc:
        raise AssertionError(f"{tech}: corrupted shard passed its verify")
    if any(crc32c_device.crc32c_of_device_array(sh[i].device_array())
           != sh[i].crc for i in range(n) if i != victim):
        raise AssertionError(f"{tech}: a sibling's crc moved")
    surv = {i: np.frombuffer(sh[i].materialize(), dtype=np.uint8)
            for i in range(n) if i != victim}
    if not np.array_equal(ecutil.decode_concat(sinfo, codec, surv), objs[0]):
        raise AssertionError(f"{tech}: reconstruction after bitrot failed")
    log(f"resident {tech}: corrupted shard {victim} fails its verify, "
        "siblings pass, decode_concat of the other 11 is byte-exact")
    del per_obj, sh, surv

    # kernels at full width against their plain versions
    bodies = [batch[i].device_array() for i in range(n)]
    got = crc32c_device.crc32c_rows_kernel(bodies)
    err = int_err(got, crc32c_device.crc32c_plain(torch.stack(bodies)))
    # the one-pass call allocates the bodies and the crcs, nothing more
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fb, fc = resident._fused_encode_crc(objs_dev, codec.device().enc_bits)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base - sum(
        b.untyped_storage().nbytes() for b in fb)
    pb, pcrc = fused_encode_crc.fused_encode_crc_plain(
        objs_dev, codec.device().enc_bits)
    ferr = max(int_err(torch.stack(fb), pb), int_err(fc, pcrc))
    torch.cuda.synchronize()
    log(f"check crc32c {n} x {bodies[0].numel()} B bodies max_abs_err={err}; "
        f"fused_encode_crc S={objs_dev.shape[0]} max_abs_err={ferr}, "
        f"{extra} B allocated beside the bodies")
    if err or ferr:
        raise AssertionError(f"{tech}: kernel disagrees with plain at "
                             "full width")
    if extra > 1 << 20:
        raise AssertionError(f"{tech}: the fused call allocated {extra} B "
                             "beside its bodies")
    del fb, fc, pb, pcrc

    # -- (d), (e): end-to-end times ---------------------------------------
    total = N_OBJ * OBJ_BYTES
    td = wall_s(lambda: [resident.encode_resident_shards(
        codec, o.reshape(spo, K, CHUNK)) for o in objs], runs=RUNS)
    te = wall_s(lambda: resident.encode_resident_shards(codec, objs_dev),
                runs=RUNS)
    e2e = {"d_resident_per_object_GiBps": total / td / 2**30,
           "e_resident_batched_GiBps": total / te / 2**30}
    log(f"e2e {tech} " + json.dumps(e2e))
    return {"launches": counts, "e2e": e2e, "max_abs_err": max(err, ferr),
            "batch": batch}


def resident_times(batch, codec, objs_dev, dev) -> dict:
    """5r: the crc32c kernel on the batched bodies and the fused encode
    of the whole batch, in turns with their first forms (``prior_ms``:
    the kernel's per-thread path; the two-launch form) and with a device
    copy of their bytes; their plain versions."""
    from ceph_tpu_torch.ops import crc32c_device, fused_encode_crc, resident
    bodies = [batch[i].device_array() for i in range(K + M)]
    enc_bits = codec.device().enc_bits
    n_crc = sum(b.numel() for b in bodies)
    s_b = objs_dev.shape[0]
    n_fused = s_b * K * CHUNK + (K + M) * s_b * CHUNK
    copies = []
    for nbytes in (n_crc, n_fused):     # the kernel's bytes, half each way
        src = torch.empty(nbytes // 2, dtype=torch.uint8, device=dev)
        copies.append((src, torch.empty_like(src)))
    check = crc32c_device.crc32c_rows_per_thread(bodies)
    if not torch.equal(check, crc32c_device.crc32c_rows_kernel(bodies)):
        raise AssertionError("crc32c paths disagree")
    one = resident._fused_encode_crc(objs_dev, enc_bits)
    two = resident._fused_encode_crc_two_pass(objs_dev, enc_bits)
    if not (torch.equal(one[1], two[1])
            and torch.equal(torch.stack(one[0]), torch.stack(two[0]))):
        raise AssertionError("fused encode forms disagree")
    del one, two
    ms4, prior4, copy4, ms5, prior5, copy5 = turns_ms([
        lambda: crc32c_device.crc32c_rows_kernel(bodies),
        lambda: crc32c_device.crc32c_rows_per_thread(bodies),
        lambda: copies[0][1].copy_(copies[0][0]),
        lambda: resident._fused_encode_crc(objs_dev, enc_bits),
        lambda: resident._fused_encode_crc_two_pass(objs_dev, enc_bits),
        lambda: copies[1][1].copy_(copies[1][0])], reps=REPS)
    del copies
    stacked = torch.stack(bodies)
    plain4 = cuda_ms(lambda: crc32c_device.crc32c_plain(stacked), runs=3,
                     warmup=1)
    del stacked
    plain5 = cuda_ms(lambda: fused_encode_crc.fused_encode_crc_plain(
        objs_dev, enc_bits), runs=3, warmup=1)
    b4, b4_by = crc_bound_ms(n_crc, K + M)
    b5, b5_by = fused_bound_ms(s_b, K, M, CHUNK)
    times = {}
    times["crc32c"] = {"ms": ms4, "prior_ms": prior4, "copy_ms": copy4,
                       "plain_ms": plain4,
                       "bound_ms": b4, "bound_by": b4_by,
                       "share_of_bound": b4 / ms4,
                       "GBps": n_crc / ms4 / 1e6}
    times["fused_encode_crc"] = {"ms": ms5, "prior_ms": prior5,
                                 "copy_ms": copy5,
                                 "plain_ms": plain5, "bound_ms": b5,
                                 "bound_by": b5_by,
                                 "share_of_bound": b5 / ms5,
                                 "GBps": n_fused / ms5 / 1e6}
    for name in ("crc32c", "fused_encode_crc"):
        log(f"time {name} " + json.dumps(times[name]))
    return times


def word_bound_ms(s: int, k: int, r: int, c: int, w: int):
    """Least time for K3: each input byte read once and each output byte
    written once over HBM, against the product counted as an int8 matmul
    over the words' bits (2 * S*(C/ws) * k*w * r*w) at peak."""
    t_bytes = (s * k * c + s * r * c) / HBM_BYTES_PER_S * 1e3
    t_ops = 2 * s * (c // (w // 8)) * (k * w) * (r * w) / INT8_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def word_prior(data, bm, w):
    """K3's plain alternative on the card: torch de-interleave to the
    virtual byte layout, K1, re-interleave."""
    from ceph_tpu_torch.ops import gf_pallas
    s, k, c = data.shape
    ws = w // 8
    virt = data.view(s, k, c // ws, ws).permute(0, 1, 3, 2).reshape(
        s, k * ws, c // ws)
    out = gf_pallas.gf_bit_matmul_kernel(virt, bm)
    r = bm.r // ws
    return out.view(s, r, ws, c // ws).permute(0, 1, 3, 2).reshape(s, r, c)


def word_checks(gen, rng, dev):
    """3w: K3 against its plain version on the card, byte-exact, at the
    path shape (16384, 4, 2, 4096), at (5, 3) and (1, 1), at k' = 256, at
    C = w/8 and 4096 + 3 w/8, on random 0/1 matrices and on a pointer one
    byte off 16-byte alignment (the byte path); returns the max error and
    the path-shape inputs for the times."""
    from ceph_tpu_torch.gf.word_codec import reed_sol_van_matrix_w
    from ceph_tpu_torch.ops import gf_pallas
    from ceph_tpu_torch.ops.gf_matmul import expand_to_bitmatrix_w
    worst, inputs = 0, {}
    for w in (16, 32):
        ws = w // 8
        van = {(k, m): gf_pallas.BitMatrix(expand_to_bitmatrix_w(
            reed_sol_van_matrix_w(k, m, w), w), dev)
            for k, m in ((4, 2), (5, 3), (1, 1), (256 // ws, 2))}
        cases = [("path", (16384, 4, 2, 4096), van[4, 2]),
                 ("k5m3", (64, 5, 3, 4096), van[5, 3]),
                 ("k1m1", (64, 1, 1, 4096), van[1, 1]),
                 ("kv256", (8, 256 // ws, 2, 4096), van[256 // ws, 2]),
                 ("one_word", (33, 4, 2, ws), van[4, 2]),
                 ("ragged", (33, 4, 2, 4096 + 3 * ws), van[4, 2])]
        for k, m in ((3, 1), (6, 5), (9, 4)):
            bm = gf_pallas.BitMatrix(
                rng.integers(0, 2, (k * w, m * w), dtype=np.uint8), dev)
            for c in (ws, 200 - 200 % ws, 4096 + ws):
                cases.append((f"random_{k}x{m}x{c}", (5, k, m, c), bm))
        cases.append(("misaligned", (64, 4, 2, 4096), van[4, 2]))
        for name, (s, k, m, c), bm in cases:
            if name == "misaligned":
                buf = torch.randint(0, 256, (s * k * c + 1,), generator=gen,
                                    device=dev, dtype=torch.uint8)
                data = buf[1:].view(s, k, c)
                if data.data_ptr() % 16 != 1:
                    raise AssertionError("misaligned K3 case is not one "
                                         "byte off")
            else:
                data = torch.randint(0, 256, (s, k, c), generator=gen,
                                     device=dev, dtype=torch.uint8)
            got = gf_pallas.gfw_bit_matmul_kernel(data, bm, w)
            want = gf_pallas.gfw_bit_matmul_plain(data, bm.bits, w)
            torch.cuda.synchronize()
            err = int_err(got, want)
            if not name.startswith("random_") or err:
                log(f"check gfw w={w} {name} (S,k,m,C)={(s, k, m, c)} "
                    f"max_abs_err={err}")
            if err:
                raise AssertionError(f"K3 disagrees with plain at w={w} "
                                     f"{name}")
            worst = max(worst, err)
            if name == "path":
                if not torch.equal(word_prior(data, bm, w), got):
                    raise AssertionError(f"K3 prior form disagrees at w={w}")
                inputs[w] = (data, bm)
            del got, want
        log(f"check gfw w={w}: {len(cases)} shapes byte-exact (random 0/1 "
            "matrices included), prior form equal at the path shape")
    return worst, inputs


# 4j: the codec families at full width (k=4 profiles; SURVEY's reference
# profile at three word widths, RAID-6, cauchy_good at jerasure's default
# packet size, and the corpus's shec and lrc profiles)
FAMILY_PROFILES = [
    ("jerasure_van_w8", {"plugin": "jerasure", "technique": "reed_sol_van",
                         "k": "4", "m": "2", "w": "8"}),
    ("jerasure_van_w16", {"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "16"}),
    ("jerasure_van_w32", {"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "32"}),
    ("jerasure_r6_op", {"plugin": "jerasure", "technique": "reed_sol_r6_op",
                        "k": "4"}),
    ("jerasure_cauchy_good", {"plugin": "jerasure",
                              "technique": "cauchy_good", "k": "4", "m": "2",
                              "packetsize": "2048"}),
    ("shec_k4m3c2", {"plugin": "shec", "k": "4", "m": "3", "c": "2"}),
    ("lrc_k4m2l3", {"plugin": "lrc", "k": "4", "m": "2", "l": "3"}),
]
FAMILY_RUNS = 3


def host_encode(codec, flat: np.ndarray) -> np.ndarray:
    """All n chunks (physical order) of (k, L) logical data, on the port's
    host codecs: the split-table word codec at w = 16/32, the packet codec
    for bitmatrix codes, the GF(2^8) matvec for shec, layer by layer for
    lrc."""
    from ceph_tpu_torch.ec.rs_codec import gf_matvec_bytes
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    out = np.zeros((n, flat.shape[1]), dtype=np.uint8)
    for i in range(k):
        out[codec.chunk_index(i)] = flat[i]
    if hasattr(codec, "layers"):
        for layer in codec.layers:
            out[layer.coding] = layer.erasure_code.codec.encode(
                out[layer.data])
    elif hasattr(codec, "codec"):
        out[k:] = codec.codec.encode(flat)
    else:
        out[k:] = gf_matvec_bytes(codec.matrix, flat)
    return out


def batch_all(codec, stripes: np.ndarray) -> np.ndarray:
    """(S, k, C) -> (S, n, C) every chunk in physical order through the
    batched API: lrc's encode_batch_full, else data + encode_batch."""
    if hasattr(codec, "encode_batch_full"):
        return codec.encode_batch_full(stripes)
    return np.concatenate([stripes, codec.encode_batch(stripes)], axis=1)


def family_phase(name, prof, objs):
    """4j for one profile: (a) ecutil.encode per object, (b) one batched
    encode of all 64, (c) decode_concat per object with one data and one
    coding chunk lost where the code tolerates it; launches counted from
    just before (a) to just after (c); then the checks and the times."""
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.ops import gf_pallas
    from ceph_tpu_torch.osd import ecutil
    codec = create_erasure_code(dict(prof))
    k, n = codec.get_data_chunk_count(), codec.get_chunk_count()
    c = codec.get_chunk_size(k * CHUNK)
    sinfo = ecutil.stripe_info_t(k, k * c)
    spo = OBJ_BYTES // sinfo.get_stripe_width()
    if spo * sinfo.get_stripe_width() != OBJ_BYTES:
        raise AssertionError(f"{name}: 4 MiB is not whole stripes of {c}")
    data_phys = [codec.chunk_index(i) for i in range(k)]
    coding_phys = [p for p in range(n) if p not in data_phys]
    lost = (data_phys[1], coding_phys[0])
    try:
        codec.minimum_to_decode(set(data_phys), set(range(n)) - set(lost))
    except IOError:
        lost = (data_phys[1],)
    host_decoded = not getattr(codec, "_device_decode_supported", True)
    stripes = objs.reshape(-1, k, c)
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "gfw_bit_matmul": gf_pallas.word_launches}
    for ctr in counters.values():
        ctr.reset()
    shards = [ecutil.encode(sinfo, codec, o, set(range(n))) for o in objs]
    full = batch_all(codec, stripes)
    surv = [{i: b for i, b in sh.items() if i not in lost} for sh in shards]
    decoded = [ecutil.decode_concat(sinfo, codec, sv) for sv in surv]
    counts = {cname: ctr.n for cname, ctr in counters.items()}
    log(f"family {name}: chunk {c}, lost {list(lost)}, decode on "
        f"{'the host codec (by technique)' if host_decoded else 'the card'}"
        f", launches " + json.dumps(counts))
    word = prof.get("w") in ("16", "32")
    if word and (counts["gfw_bit_matmul"] == 0 or counts["gf_bit_matmul"]):
        raise AssertionError(f"{name}: the word path did not run on K3 "
                             "alone")
    if not word and (counts["gf_bit_matmul"] == 0
                     or counts["gfw_bit_matmul"]):
        raise AssertionError(f"{name}: the path did not run on K1 alone")
    # -- checks, outside the counted run ----------------------------------
    full = full.reshape(len(objs), spo, n, c)
    for o, sh in enumerate(shards):
        for i in range(n):
            if not np.array_equal(full[o, :, i].reshape(-1), sh[i]):
                raise AssertionError(f"{name}: batched chunk {i} != "
                                     f"per-object (object {o})")
        if not np.array_equal(decoded[o], objs[o]):
            raise AssertionError(f"{name}: decode_concat mismatch ({o})")
    flat = np.ascontiguousarray(
        objs[0].reshape(spo, k, c).transpose(1, 0, 2)).reshape(k, spo * c)
    host = host_encode(codec, flat)
    for i in range(n):
        if not np.array_equal(host[i], shards[0][i]):
            raise AssertionError(f"{name}: host codec disagrees (chunk {i})")
    log(f"family {name}: (a) {len(objs)} objects x {n} shards == (b) "
        f"batch of S={stripes.shape[0]} == host codec (object 0); (c) "
        "decoded objects == payloads")
    del full, decoded
    # -- end-to-end times, fewer runs than phase 5 (host-bound) -----------
    total = len(objs) * OBJ_BYTES
    ta = wall_s(lambda: [ecutil.encode(sinfo, codec, o, set(range(n)))
                         for o in objs], runs=FAMILY_RUNS)
    batch = (codec.encode_batch_full if hasattr(codec, "encode_batch_full")
             else codec.encode_batch)
    tb = wall_s(lambda: batch(stripes), runs=FAMILY_RUNS)
    tc = wall_s(lambda: [ecutil.decode_concat(sinfo, codec, sv)
                         for sv in surv], runs=FAMILY_RUNS)
    e2e = {"chunk": c, "lost": list(lost), "host_decoded": host_decoded,
           "launches": counts,
           "a_encode_per_object_GiBps": total / ta / 2**30,
           "b_encode_batch_GiBps": total / tb / 2**30,
           "c_decode_concat_GiBps": total / tc / 2**30}
    log(f"e2e {name} " + json.dumps(e2e))
    return e2e


def word_times(inputs, dev) -> dict:
    """5w: K3 at the path shape per w, in turns with its prior form and a
    device copy of its bytes, 10 launches per sample; its plain version;
    and K1 at cauchy_good's virtual shape (1024, 32, 16, 8192)."""
    from ceph_tpu_torch.gf.bitmatrix import (cauchy_good_matrix,
                                             matrix_to_bitmatrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.ops import gf_pallas
    times = {}
    for w, (data, bm) in sorted(inputs.items()):
        s, k, c = data.shape
        r = bm.r // (w // 8)
        src = torch.empty(s * (k + r) * c // 2, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        ms, prior, copy = turns_ms([
            lambda: gf_pallas.gfw_bit_matmul_kernel(data, bm, w),
            lambda: word_prior(data, bm, w),
            lambda: dst.copy_(src)], reps=REPS)
        del src, dst
        plain = cuda_ms(lambda: gf_pallas.gfw_bit_matmul_plain(
            data, bm.bits, w), runs=3, warmup=1)
        b_ms, b_by = word_bound_ms(s, k, r, c, w)
        times[f"w{w}"] = {"ms": ms, "prior_ms": prior, "copy_ms": copy,
                          "plain_ms": plain, "bound_ms": b_ms,
                          "bound_by": b_by, "share_of_bound": b_ms / ms,
                          "GBps": s * (k + r) * c / ms / 1e6}
        log(f"time gfw_bit_matmul w={w} (S,k,m,C)={(s, k, r, c)} "
            + json.dumps(times[f"w{w}"]))
    bits = expand_to_bitmatrix(matrix_to_bitmatrix(
        cauchy_good_matrix(4, 2, 8), 8))
    bm = gf_pallas.BitMatrix(bits, dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 3)
    virt = torch.randint(0, 256, (1024, 32, 8192), generator=gen, device=dev,
                         dtype=torch.uint8)
    ms = turns_ms([lambda: gf_pallas.gf_bit_matmul_kernel(virt, bm)],
                  reps=REPS)[0]
    b_ms, b_by = bound_ms(1024, 32, 16, 8192)
    times["k1_cauchy_good_virtual"] = {"ms": ms, "bound_ms": b_ms,
                                       "bound_by": b_by}
    log("time gf_bit_matmul cauchy_good virtual (S,k,r,C)=(1024,32,16,8192) "
        + json.dumps(times["k1_cauchy_good_virtual"]))
    return times


# ---- the CRUSH slice: 3c / 4c / 5c ---------------------------------------------

CRUSH_OSDS = 1000                 # measure_crush_remap's map: 50 hosts of 20
CRUSH_PER_HOST = 20
CRUSH_X = 100000                  # crushtool --test over 100k inputs
CRUSH_SAMPLE = 4096               # x of 3c's K6 check
# x (PGs per pool) of every drive epoch held against the host in worker
# processes: half of the 4096 (2048) they were, which keeps the whole
# smoke inside its time limit with the process cluster (4v) added
CRUSH_EPOCH_SAMPLE = 2048
CRUSH_EPOCHS = 10
# the drives' epochs whose sample goes to the host: every fifth one and the
# last (0, 5, 10), which keeps the whole smoke inside its time limit with
# the rbd and cephfs phases (4x, 4y) added; every epoch still runs on the
# card, with its kernel counts and host_replayed checked
CRUSH_CHECK_EVERY = 5
OSDMAP_PG_NUM = {"rep": 65536, "ec": 32768}
OSDMAP_SAMPLE = 1024              # PGs per pool held against the scalar path
CHECK_PROCS = 7                   # host checks beside the main process
# Instructions per straw2 draw, at the fewest the card can take: hash32_3
# (the seed XORs as two 3-input logic ops, then 5 mixes of 9 lines, each a
# 3-input add, a shift and an XOR), the 16-bit mask, the table gather, the
# compare and the select.  The bound of K7a, K6 and K8 counts them at
# INSTR_PER_S.  It stays so after the hash probe (3h): hash32_3 as ptxas
# compiles it runs at the integer pipe's 64 thread-instructions per SM per
# clock (120 of its 140 SASS instructions per hash issue there), but the
# split form K7a draws with runs its 173 at ~101, past the integer pipe's
# rate, so the same work is not bound by that pipe.  Neither form reaches
# the full issue rate (128): the hash alone measured 0.58 (hash32_3) and
# 0.65 (the split) of this bound on an H100 80GB HBM3 at 700 W (PERF.md
# section 6)
OPS_PER_DRAW = 2 + 5 * 9 * 3 + 4
# a draw on a level without an i32 quotient table (K7a's per-item int64
# table, or its multiply-high) adds the 64-bit compare and select and the
# item's table index; the multiply-high's product is not counted: the
# bound counts the work at its fewest instructions
WIDE_DRAW_OPS = 3
# the card's instruction rate: 132 SMs x 4 schedulers x one warp
# instruction (32 lanes) per clock at 1.98 GHz, whichever pipe runs it; the
# integer pipe (IADD3, LOP3, SHF, ...) takes half of it, IMAD the FMA pipe
INSTR_PER_S = 132 * 4 * 32 * 1.98e9
# the hash probe's forms, by its kernel's SPLIT argument
HASH_FORMS = ("hash32_3", "hash32_3_split")


HASH_PROBE_THREADS = 1 << 22     # threads of the hash probe, n_id ids each
HASH_PROBE_IDS = 256
HASH_PROBE_UNROLL = 16            # kProbeUnroll of csrc/crush_probe.cu


def sm_clock_hz() -> float:
    """The card's SM clock now, from nvidia-smi (MHz -> Hz)."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True).stdout
    return float(out.split()[0]) * 1e6


def hash_probe(dev, sass, sm_count) -> dict:
    """3h: the rjenkins hash alone (``csrc/crush_probe.cu``), ``hash32_3``
    and K7a's ``hash32_3_split``, each over 2^22 x 256 (x, id, r): both
    forms' XOR-folded words equal; each form's time (CUDA events, in turns,
    3 launches per sample), hashes/s, and its SASS per hash (the kernel's
    static ALU / FMA / all counts over the 16 hashes of its loop step, loop
    overhead included) times hashes/s as thread-instructions per SM per
    clock at the clock read right after."""
    import ctypes
    from ceph_tpu_torch.ops import _build
    I, VP = ctypes.c_int, ctypes.c_void_p
    lib = _build.load("crush_probe", {
        "crush_hash_probe_launch": ([I, VP, ctypes.c_longlong, I, I, VP], I)})
    outs = [torch.empty(HASH_PROBE_THREADS, dtype=torch.int32, device=dev)
            for _ in HASH_FORMS]

    def run(f):
        def go():
            rc = lib.crush_hash_probe_launch(
                f, outs[f].data_ptr(), HASH_PROBE_THREADS, HASH_PROBE_IDS, 7,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise RuntimeError(f"crush_hash_probe_launch failed: {rc}")
        return go
    fns = [run(f) for f in range(len(HASH_FORMS))]
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    if not torch.equal(outs[1], outs[0]):
        raise AssertionError("hash32_3_split != hash32_3")
    ms = turns_ms(fns, runs=5, warmup=1, reps=3)
    clock = sm_clock_hz()
    hashes = HASH_PROBE_THREADS * HASH_PROBE_IDS
    per_fn = (sass or {}).get("crush_probe") or {}
    forms = {}
    for f, form in enumerate(HASH_FORMS):
        c = per_fn.get(f"crush_hash_probe_kernel<{f}>", {})
        per_hash = {k: c[k] / HASH_PROBE_UNROLL
                    for k in ("alu", "fma", "instructions") if k in c}
        rate = hashes / (ms[f] / 1e3)
        entry = {"ms": ms[f], "hashes_per_s": rate, "sass_per_hash": per_hash}
        for k, v in per_hash.items():
            entry[f"{k}_per_sm_clk"] = rate * v / sm_count / clock
        forms[form] = entry
        log(f"hash probe {form} " + json.dumps(entry))
    log(f"hash probe: the split at {ms[1] / ms[0]:.3f} of hash32_3's time, "
        f"{clock / 1e6:.0f} MHz")
    return {"forms": forms, "clock_hz": clock, "hashes": hashes,
            "sm_count": sm_count}


def _do_rule_rows(args):
    """Check worker: crush_do_rule of a chunk of x on the host."""
    m, ruleno, xs, result_max, weight = args
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    return [crush_do_rule(m, ruleno, int(x), result_max, weight) for x in xs]


def _pg_rows(args):
    """Check worker: the scalar pg -> up/acting pipeline of a chunk of PGs
    of a pickled OSDMap."""
    import pickle
    from ceph_tpu_torch.osdmap import pg_t
    blob, pool_id, pss = args
    m = pickle.loads(blob)
    return [m.pg_to_up_acting_osds(pg_t(pool_id, int(ps))) for ps in pss]


def crush_remap_map(uniform: bool, distinct: int = 0):
    """measure_crush_remap's map, taken from ``bench.workloads``'s
    ``remap_crush_map`` so that the map checked here and the map the bench
    times have one source: 1000 OSDs in 50 hosts of 20, straw2, the
    default (jewel) tunables, (u) weights 0x10000 or (n) 0x8000 x {1..4}
    from default_rng(7), and its ``data`` rule (chooseleaf firstn over
    hosts, size 3).  Added here: the rule a jerasure k=8 m=4's
    create_rule adds (chooseleaf indep over hosts, size 12).  With
    ``distinct`` each host is rebuilt with OSD weights of that many
    distinct values from 0x8000 to 0x20000, spread over the OSDs by a
    permutation from default_rng(7); the root's weights stay."""
    from ceph_tpu_torch.bench.workloads import remap_crush_map
    from ceph_tpu_torch.ec import create_erasure_code
    cw, data = remap_crush_map(CRUSH_OSDS, uniform or bool(distinct))
    if distinct:
        vals = np.linspace(0x8000, 0x20000, distinct).astype(np.int64)
        spread = vals[np.random.default_rng(7).permutation(CRUSH_OSDS)
                      % distinct]
        for h in range(CRUSH_OSDS // CRUSH_PER_HOST):
            osds = list(range(h * CRUSH_PER_HOST, (h + 1) * CRUSH_PER_HOST))
            cw.rebuild_bucket(-(h + 2), osds, [int(spread[o]) for o in osds])
    codec = create_erasure_code({"plugin": "jerasure", "k": "8", "m": "4"})
    ec = codec.create_rule("ec", cw)
    if data < 0 or ec < 0:
        raise AssertionError(f"rules not added: {data}, {ec}")
    return cw, {"firstn": (data, 3), "ec": (ec, codec.get_chunk_count())}


def _small_map(n_hosts, per_host, weights, root_ws=None, racks=0):
    """A straw2 map of the port: hosts of ``per_host`` OSDs weighted by
    ``weights(h, i)``, optionally grouped in ``racks`` racks."""
    from ceph_tpu_torch.crush import CRUSH_BUCKET_STRAW2, CrushWrapper
    cw = CrushWrapper()
    cw.set_type_name(1, "host")
    cw.set_type_name(2, "rack")
    cw.set_type_name(10, "root")
    hosts, hws, osd = [], [], 0
    for h in range(n_hosts):
        ws = [weights(h, i) for i in range(per_host)]
        hosts.append(cw.add_bucket(CRUSH_BUCKET_STRAW2, 1, f"h{h}",
                                   list(range(osd, osd + per_host)), ws,
                                   id=-(h + 2)))
        hws.append(sum(ws))
        osd += per_host
    top = hosts
    if racks:
        per = n_hosts // racks
        top = [cw.add_bucket(CRUSH_BUCKET_STRAW2, 2, f"rack{r}",
                             hosts[r * per:(r + 1) * per],
                             hws[r * per:(r + 1) * per], id=-(100 + r))
               for r in range(racks)]
        hws = [sum(hws[r * per:(r + 1) * per]) for r in range(racks)]
    cw.set_max_devices(osd)
    cw.add_bucket(CRUSH_BUCKET_STRAW2, 10, "default", top,
                  root_ws or [min(w, 0x7fffffff) for w in hws], id=-1)
    return cw, osd


def small_crush_cases():
    """test_crush_fast.py's small shapes: chained two-step rules (firstn,
    indep, chooseleaf under racks), choose_args with 3 positions and
    replacement ids, a zero-weight host, and a map with no quotient-table
    level (near-tie weights)."""
    from ceph_tpu_torch.crush import (
        CRUSH_RULE_CHOOSELEAF_FIRSTN, CRUSH_RULE_CHOOSE_FIRSTN,
        CRUSH_RULE_CHOOSE_INDEP, CRUSH_RULE_EMIT, CRUSH_RULE_TAKE, Rule,
        RuleStep, WeightSet)
    rng = np.random.default_rng(SEED)
    uneven = [[int(v) * 0x10000 for v in rng.integers(1, 4, 4)]
              for _ in range(6)]

    def rule(cw, steps, name):
        return cw.add_rule(Rule(steps=[RuleStep(*s) for s in steps],
                                ruleset=1, type=1, min_size=1, max_size=10),
                           name)
    cases = []
    for op, mode in ((CRUSH_RULE_CHOOSE_FIRSTN, "firstn"),
                     (CRUSH_RULE_CHOOSE_INDEP, "indep")):
        cw, n = _small_map(6, 4, lambda h, i: uneven[h][i])
        rno = rule(cw, [(CRUSH_RULE_TAKE, -1, 0), (op, 2, 1), (op, 2, 0),
                        (CRUSH_RULE_EMIT, 0, 0)], f"chain-{mode}")
        cases.append((f"chained_{mode}", cw, n, rno, 4, None))
    cw, n = _small_map(9, 3, lambda h, i: uneven[h % 6][i], racks=3)
    rno = rule(cw, [(CRUSH_RULE_TAKE, -1, 0),
                    (CRUSH_RULE_CHOOSE_FIRSTN, 2, 2),
                    (CRUSH_RULE_CHOOSELEAF_FIRSTN, 2, 1),
                    (CRUSH_RULE_EMIT, 0, 0)], "chain-leaf")
    cases.append(("chained_chooseleaf_racks", cw, n, rno, 4, None))
    cw, n = _small_map(6, 3, lambda h, i: 0x10000)
    rno = cw.add_simple_rule("data", "default", "host", mode="firstn")
    args = cw.choose_args_create(0)
    for bi, b in enumerate(cw.crush.buckets):
        args[bi].weight_set = [WeightSet(weights=[
            int(v) for v in rng.integers(0x4000, 0x30000, b.size)])
            for _ in range(3)]
    args[3].ids = [1000 + i for i in range(cw.crush.buckets[3].size)]
    cases.append(("choose_args_3_positions", cw, n, rno, 3, args))
    cw, n = _small_map(5, 3, lambda h, i: 0 if h == 2 else 0x10000,
                       root_ws=[0x30000] * 5)
    cases.append(("zero_weight_host_firstn", cw, n,
                  cw.add_simple_rule("data", "default", "host",
                                     mode="firstn"), 3, None))
    cases.append(("zero_weight_host_indep", cw, n,
                  cw.add_simple_rule("ec", "default", "host",
                                     mode="indep"), 3, None))
    cw, n = _small_map(12, 2, lambda h, i: 0x7fffffff - h - i,
                       root_ws=[0x7fffffff - h for h in range(12)])
    cases.append(("no_quotient_levels", cw, n,
                  cw.add_simple_rule("data", "default", "host",
                                     mode="firstn"), 3, None))
    # (n)-style host weights with weights below 0x10000 among them, more
    # distinct weights (40 OSD weights and the hosts' sums) than K7a keeps
    # int64 tables for: the multiply-high at small and large shifts
    mixed = [0x8000, 0x10000, 0x18000, 0x20000, 0x1234, 0xFFFF, 0x7FFF,
             0x10001, 0x3, 0x8001, 0xFFFE, 0x20001] + [
                 0x9000 + 0x1111 * k for k in range(28)]
    cw, n = _small_map(12, 4, lambda h, i: mixed[(4 * h + i) % 40])
    for mode in ("firstn", "indep"):
        cases.append((f"mixed_low_weights_{mode}", cw, n,
                      cw.add_simple_rule(mode, "default", "host", mode=mode),
                      3, None))
    return cases


def _crush_weights(n, rng):
    """The weight vectors 3c holds the resolve at: all in, one OSD out,
    ten out, and a random mix of out and reweighted OSDs."""
    w = np.full(n, 0x10000, np.uint32)
    one = w.copy()
    one[(7 * CRUSH_EPOCHS + 3) % n] = 0
    ten = w.copy()
    ten[[(7 * e + 3) % n for e in range(1, 11)]] = 0
    mix = rng.choice([0, 0x3000, 0x8000, 0x10000], size=n,
                     p=[0.05, 0.05, 0.1, 0.8]).astype(np.uint32)
    return [w, one, ten, mix]


def _rule_pair_err(fr, frp, xs, weights):
    """Candidates (K7a), packed rows (K7b) and K6-finished rows of a kernel
    rule and its plain twin on the card: (K7a err, K7b err, finished-rows
    err, residual fractions, the x K7b flagged under any weight)."""
    fr.prepare_candidates(xs)
    frp.prepare_candidates(xs)
    a_err = 0
    for got, want in zip(fr._cand, frp._cand):
        if want is None:
            if got is not None:
                raise AssertionError("leaf attempts where plain has none")
            continue
        a_err = max(a_err, int_err(got, want))
    b_err, k6_err, resid, flagged = 0, 0, [], set()
    for w in weights:
        wd = torch.from_numpy(w.view(np.int32)).to(fr.device)
        got, want = fr.resolve_packed(wd), frp.resolve_packed(wd)
        b_err = max(b_err, int_err(got, want))
        flag = ((got[:, -1] >> 16) != 0).cpu().numpy()
        resid.append(float(flag.mean()))
        flagged.update(xs[np.nonzero(flag)[0]].tolist())
        got, want = fr.exact_packed(wd), frp.exact_packed(wd)
        k6_err = max(k6_err, int_err(got, want))
    torch.cuda.synchronize()
    return a_err, b_err, k6_err, resid, flagged


def k6_warp_all(prog, x, w):
    """A call of K6's warp form over an index list of every x of ``x``,
    returning (rows, counts) as the thread form does; its buffers are made
    here, so the call can be captured in a CUDA graph."""
    from ceph_tpu_torch.ops import crush_kernels
    n = x.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=x.device)
    n_live = torch.tensor([n], dtype=torch.int32, device=x.device)
    packed = torch.empty((n, prog.result_max + 1), dtype=torch.int32,
                         device=x.device)

    def run():
        crush_kernels.crush_rule(prog, x, w, idx=idx, n_live=n_live,
                                 packed=packed)
        return packed[:, :-1], packed[:, -1]
    return run


def _k6_pair_err(cw, rno, size, args, xs, weights, dev):
    """K6 against ``crush_rule_plain`` on the CPU over ``xs`` under each
    weight vector, in both of its forms: the thread form
    (``DeviceCrushMapper`` on the card, a whole list of x) and the warp
    form (an index list of every x into a packed table): (err, rows and
    counts of the last)."""
    from ceph_tpu_torch.ops.crush_kernels import DeviceCrushMapper, compile_map
    card = DeviceCrushMapper(compile_map(cw.crush, args, device=dev), rno,
                             size)
    cpu = DeviceCrushMapper(compile_map(cw.crush, args, device="cpu"), rno,
                            size)
    xd = torch.from_numpy(np.ascontiguousarray(xs, np.uint32).view(
        np.int32)).to(dev)
    err = 0
    for w in weights:
        pres, pcnt = cpu.map_batch(xs, w)
        res, cnt = card.map_batch(xs, w)
        wres, wcnt = k6_warp_all(card.program, xd, torch.from_numpy(
            np.ascontiguousarray(w, np.uint32).view(np.int32)).to(dev))()
        for got, want in ((res, pres), (cnt, pcnt), (wres, pres),
                          (wcnt, pcnt)):
            err = max(err, int_err(got.cpu(), want))
    return err, res.cpu().numpy(), cnt.cpu().numpy()


K6_HOST_SAMPLE = 256               # K6 rows per configuration checked on the host


def crush_checks(configs, dev):
    """3c: K7a, K7b and K6 against their plain versions, exact, on the four
    BASELINE configurations at 100000 x and the small shapes.  Returns the
    errors, the plain rules, and host jobs holding K6 rows against
    ``crush_do_rule`` (run with 4c's)."""
    from ceph_tpu_torch.crush.mapper import crush_do_rule
    from ceph_tpu_torch.ops.crush_fast import compile_fast_rule
    rng = np.random.default_rng(SEED)
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    errs = {"crush_descend": 0, "crush_resolve": 0, "crush_rule": 0}
    plain_rules, jobs = {}, []
    for name, cw, rno, size in configs:
        fr = compile_fast_rule(cw.crush, rno, size, device=dev)
        frp = compile_fast_rule(cw.crush, rno, size, device=dev, plain=True)
        weights = _crush_weights(CRUSH_OSDS, rng)
        a, b, f, resid, flagged = _rule_pair_err(fr, frp, xs, weights)
        # K6 alone: 4096 sampled x and every x K7b flagged above
        kx = np.union1d(rng.choice(CRUSH_X, CRUSH_SAMPLE, replace=False),
                        np.fromiter(flagged, np.int64, len(flagged))
                        ).astype(np.uint32)
        e6, rows, cnt = _k6_pair_err(cw, rno, size, None, kx,
                                     [weights[1], weights[3]], dev)
        host = np.sort(rng.choice(len(kx), K6_HOST_SAMPLE, replace=False))
        jobs.append((f"K6 {name}", [[int(v) for v in rows[i, :cnt[i]]]
                                    for i in host], _do_rule_rows,
                     [(cw.crush, rno, c, size, [int(v) for v in weights[3]])
                      for c in _chunks(kx[host], CHECK_PROCS)]))
        log(f"check crush {name} X={CRUSH_X} levels "
            f"{fr.integer_exact_levels} cand {tuple(fr._cand[0].shape)}: "
            f"K7a max_abs_err={a} K7b max_abs_err={b} residual "
            f"{[round(r, 5) for r in resid]}; K6-finished rows "
            f"max_abs_err={f}; K6 on {len(kx)} x ({len(flagged)} flagged) "
            f"max_abs_err={e6}")
        if a or b or f or e6:
            raise AssertionError(f"crush kernels disagree with plain: {name}")
        errs["crush_descend"] = max(errs["crush_descend"], a)
        errs["crush_resolve"] = max(errs["crush_resolve"], b)
        errs["crush_rule"] = max(errs["crush_rule"], f, e6)
        plain_rules[name] = frp
        del fr
    xs_small = (np.arange(4096, dtype=np.uint64) * 2654435761
                & 0xFFFFFFFF).astype(np.uint32)
    for name, cw, n, rno, rmax, args in small_crush_cases():
        fr = compile_fast_rule(cw.crush, rno, rmax, args, device=dev)
        frp = compile_fast_rule(cw.crush, rno, rmax, args, device=dev,
                                plain=True)
        weights = _crush_weights(n, rng)
        a, b, f, resid, _ = _rule_pair_err(fr, frp, xs_small, weights)
        e6, _, _ = _k6_pair_err(cw, rno, rmax, args, xs_small, weights, dev)
        w = _crush_weights(n, rng)[3]
        res, cnt = fr.map_batch(xs_small, w)
        wl = [int(v) for v in w]
        for i in range(0, len(xs_small), 16):
            want = crush_do_rule(cw.crush, rno, int(xs_small[i]), rmax, wl,
                                 args)
            if [int(v) for v in res[i, :cnt[i]]] != want:
                raise AssertionError(f"crush {name}: map_batch != "
                                     f"crush_do_rule at x={xs_small[i]}")
        log(f"check crush {name} (P={fr.posP}, parents={fr.parents}, "
            f"levels {fr.integer_exact_levels}): K7a max_abs_err={a} "
            f"K7b max_abs_err={b} K6-finished max_abs_err={f} K6 "
            f"max_abs_err={e6}; map_batch == crush_do_rule on 256 x")
        if a or b or f or e6:
            raise AssertionError(f"crush kernels disagree with plain: {name}")
        errs["crush_rule"] = max(errs["crush_rule"], e6)
    return errs, plain_rules, jobs


def _chunks(seq, n):
    return [c for c in np.array_split(np.asarray(seq), n) if len(c)]


def crush_drive(configs, dev):
    """4c (a), crushtool-style: per configuration, ``map_batch`` of 100000
    x at all-in weights, then 10 epochs, epoch e with OSD (7e+3) % 1000
    out (workloads.py:1915-1920).  Returns the host checks of the sample's
    rows as jobs, run once every timed epoch is done, so the walls are
    taken with nothing else on the host."""
    from ceph_tpu_torch.ops import crush_fast as cf, crush_kernels as ck
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    sample = np.sort(np.random.default_rng(SEED).choice(
        CRUSH_X, CRUSH_EPOCH_SAMPLE, replace=False))
    out, jobs, rules = {}, [], {}
    for name, cw, rno, size in configs:
        fr = cf.compile_fast_rule(cw.crush, rno, size, device=dev)
        walls, resid = [], []
        for e in range(CRUSH_EPOCHS + 1):
            w = np.full(CRUSH_OSDS, 0x10000, np.uint32)
            if e:
                w[(7 * e + 3) % CRUSH_OSDS] = 0
            a0 = cf.descend_launches.n
            b0 = cf.resolve_launches.n
            c0 = ck.rule_launches.n
            d0 = cf.delta_launches.n
            t0 = time.perf_counter()
            res, cnt = fr.map_batch(xs, w)
            walls.append(time.perf_counter() - t0)
            if e and cf.delta_launches.n == d0:
                raise AssertionError(f"{name}: K7c did not launch on delta "
                                     f"epoch {e}")
            if e and cf.descend_launches.n != a0:
                raise AssertionError(f"{name}: K7a launched on delta epoch "
                                     f"{e} (candidates not cached)")
            if cf.resolve_launches.n == b0 or ck.rule_launches.n == c0:
                raise AssertionError(f"{name}: K7b or K6 did not launch, "
                                     f"epoch {e}")
            if fr.host_replayed:
                raise AssertionError(f"{name}: {fr.host_replayed} x "
                                     f"recomputed on the host, epoch {e}")
            resid.append(fr.residual_fraction)
            if e % CRUSH_CHECK_EVERY:
                continue
            got = [[int(v) for v in res[x, :cnt[x]]] for x in sample]
            wl = [int(v) for v in w]
            jobs.append((f"{name} epoch {e}", got, _do_rule_rows,
                         [(cw.crush, rno, c, size, wl)
                          for c in _chunks(sample, 4 * CHECK_PROCS)]))
        rules[name] = (fr, res, cnt, w)
        out[name] = {"first_wall_s": walls[0],
                     "epoch_wall_s": statistics.median(walls[1:]),
                     "epoch_walls_s": walls[1:],
                     "residual_fraction": resid,
                     "host_replayed": 0,
                     "delta_cap": fr.delta_cap}
        log(f"drive crush {name}: epoch 0 {walls[0]:.3f} s, epochs 1-10 "
            f"median {out[name]['epoch_wall_s'] * 1e3:.2f} ms, residual "
            f"fraction (flagged by K7b, finished by K6) per epoch "
            f"{[round(r, 5) for r in resid]}, host_replayed 0 every epoch")
    return out, jobs, rules


def osdmap_drive(cw, rules, dev):
    """4c (b): an OSDMap holding the (u) map, all OSDs up and in, pool 1
    replicated size 3 (pg_num 65536) and pool 2 erasure k=8 m=4 (size 12,
    the create_rule rule, pg_num 32768); ``OSDMapMapping().update`` and
    then 10 epochs, each marking one more OSD out.  Returns the host checks
    of the sampled PGs as jobs (run after the timed epochs) and, per pool,
    the cached kernel rule with its lanes and last weights."""
    import pickle
    from ceph_tpu_torch.osdmap import (OSDMap, OSDMapMapping, TYPE_ERASURE,
                                       TYPE_REPLICATED, pg_pool_t, pg_t)
    from ceph_tpu_torch.osdmap.mapping import pool_pps
    from ceph_tpu_torch.osdmap.simple_build import mark_out, mark_up_in
    m = OSDMap()
    m.epoch = 1
    m.crush = cw
    m.set_max_osd(CRUSH_OSDS)
    mark_up_in(m)
    pools = {
        "rep": m.add_pool("rbd", pg_pool_t(
            type=TYPE_REPLICATED, size=3, min_size=2,
            crush_rule=rules["firstn"][0], pg_num=OSDMAP_PG_NUM["rep"],
            pgp_num=OSDMAP_PG_NUM["rep"])),
        "ec": m.add_pool("ec", pg_pool_t(
            type=TYPE_ERASURE, size=12, min_size=9,
            crush_rule=rules["ec"][0], pg_num=OSDMAP_PG_NUM["ec"],
            pgp_num=OSDMAP_PG_NUM["ec"])),
    }
    rng = np.random.default_rng(SEED + 1)
    samples = {k: np.sort(rng.choice(OSDMAP_PG_NUM[k], OSDMAP_SAMPLE,
                                     replace=False)) for k in pools}
    mm = OSDMapMapping(device=dev)
    walls, jobs, resid_epochs = [], [], []
    for e in range(CRUSH_EPOCHS + 1):
        if e:
            mark_out(m, (7 * e + 3) % CRUSH_OSDS)
            m.epoch += 1
        t0 = time.perf_counter()
        mm.update(m)
        walls.append(time.perf_counter() - t0)
        if mm.host_replayed != {pid: 0 for pid in pools.values()}:
            raise AssertionError(f"OSDMap epoch {e}: PGs mapped on the "
                                 f"host: {mm.host_replayed}")
        resid_epochs.append({k: fr.residual_fraction for (pid, _, _), (_, fr)
                             in mm._rule_cache.items()
                             for k, p in pools.items() if p == pid})
        if e % CRUSH_CHECK_EVERY:
            continue
        blob = pickle.dumps(m)
        for k, pid in pools.items():
            got = [mm.get(pg_t(pid, int(ps))) for ps in samples[k]]
            jobs.append((f"osdmap {k} epoch {e}", got, _pg_rows,
                         [(blob, pid, c) for c in
                          _chunks(samples[k], 2 * CHECK_PROCS)]))
    backends = {k: mm.last_backend[pid] for k, pid in pools.items()}
    if set(backends.values()) != {"device" if torch.device(dev).type == "cuda"
                                  else "cpu"}:
        raise AssertionError(f"OSDMapMapping did not map on the card: "
                             f"{backends}")
    resid, lanes = {}, {}
    weight = np.asarray(m.osd_weight, dtype=np.uint32)
    for (pid, ruleno, size), (_, fr) in mm._rule_cache.items():
        k = [k for k, p in pools.items() if p == pid][0]
        resid[k] = fr.residual_fraction
        pps = pool_pps(m.pools[pid], pid,
                       np.arange(m.pools[pid].pg_num, dtype=np.uint32))
        lanes[k] = (fr, ruleno, size, pps, weight)
    out = {"first_update_s": walls[0],
           "update_s": statistics.median(walls[1:]),
           "update_walls_s": walls[1:], "last_backend": backends,
           "residual_fraction_last_epoch": resid,
           "residual_fraction": resid_epochs, "host_replayed": 0}
    log(f"drive osdmap: update {walls[0]:.3f} s first, median "
        f"{out['update_s']:.3f} s over 10 mark_out epochs; last_backend "
        f"{backends}; host_replayed 0 for both pools every epoch; residual "
        f"fraction per epoch {resid_epochs}")
    return out, jobs, lanes


def check_pending(pending) -> int:
    """Wait for the host checks; every row must equal the host's."""
    n = 0
    for what, got, res in pending:
        want = [r for part in res.get() for r in part]
        if len(want) != len(got):
            raise AssertionError(f"{what}: {len(got)} rows, host {len(want)}")
        for g, h in zip(got, want):
            if list(g) != list(h):
                raise AssertionError(f"{what}: {g} != host {h}")
        n += len(got)
    return n


STRAW2_WIDTHS = (2, 3, 4, 6, 8, 10, 12, 14, 16, 20, 30, 50)


def straw2_host_times(calls: int = 200, repeats: int = 5) -> dict:
    """The host mapper's two forms of one straw2 draw (the scalar loop and
    the numpy pass), microseconds per draw by bucket width, best of
    ``repeats`` runs of ``calls`` draws, with nothing else running.  The
    first width at which the numpy pass is no slower is the crossover that
    mapper.STRAW2_NUMPY_MIN is set from."""
    from ceph_tpu_torch.crush import mapper
    rng = np.random.default_rng(SEED)
    us = {}
    for n in STRAW2_WIDTHS:
        ids = [int(v) for v in rng.integers(0, CRUSH_OSDS, n)]
        ws = [int(v) * 0x8000 for v in rng.integers(1, 5, n)]
        us[n] = {}
        for form, f in (("scalar", mapper._straw2_argmax_py),
                        ("numpy", mapper._straw2_argmax_np)):
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                for x in range(calls):
                    f(ids, ws, x, 1, n)
                best = min(best, time.perf_counter() - t0)
            us[n][form] = best / calls * 1e6
    cross = next((n for n in STRAW2_WIDTHS
                  if us[n]["numpy"] <= us[n]["scalar"]), None)
    log(f"host straw2 draw, us per draw (scalar, numpy) by width: "
        + ", ".join(f"{n}: ({v['scalar']:.1f}, {v['numpy']:.1f})"
                    for n, v in us.items())
        + f"; crossover width {cross}, STRAW2_NUMPY_MIN "
        f"{mapper.STRAW2_NUMPY_MIN}")
    return {"us_per_draw": us, "crossover_width": cross,
            "numpy_min": mapper.STRAW2_NUMPY_MIN}


def _draws_per_lane(fr, base_level, depth, wide_only=False):
    """Items one lane of a K7a path draws: the bucket sizes of its levels
    (each level's frontier buckets share one size in these maps; the
    widest is taken otherwise); with ``wide_only`` only the levels that
    draw on a 64-bit quotient (no i32 quotient table)."""
    m = fr.C.map
    ints = fr.integer_exact_levels
    return sum(max(m.bucket(b).size for b in fr.level_frontiers[base_level
                                                                 + d])
               for d in range(depth)
               if not (wide_only and ints[base_level + d]))


def k7a_draws(fr, n, spec, wide_only=False):
    """Items one K7a launch of ``spec`` over ``n`` parent lanes draws: per
    (lane, r, p) thread the candidate's levels, then L leaf attempts."""
    per = _draws_per_lane(fr, spec.base_level, spec.depth, wide_only)
    if spec.L and spec.leaf_depth:
        per += spec.L * _draws_per_lane(fr, spec.base_level + spec.depth,
                                        spec.leaf_depth, wide_only)
    return n * spec.R * spec.P * per


def record_descents(fr, xd):
    """The K7a calls of one candidate phase of ``fr`` over ``xd``: their
    arguments, to replay."""
    calls = []
    orig = fr._descend

    def record(*a):
        calls.append(a)
        return orig(*a)
    fr._descend = record
    try:
        fr._candidates(xd)
    finally:
        fr._descend = orig
    return calls


def k7a_alternative(fr, calls):
    """The draw form K7a does not take, on one configuration's launches,
    for the timing of step 3: where every level draws on an i32 quotient
    table ((u)), the same launches with every level on the multiply-high;
    where a level draws on per-item int64 quotient tables ((n)), the same
    launches with the multiply-high there.  Returns (what, a function
    running them), after holding their outputs equal to the path's."""
    import dataclasses
    from ceph_tpu_torch.ops import crush_fast as cf
    tabs = dataclasses.replace(fr.tables, qitem=None, q64=None)
    if all(fr.integer_exact_levels):
        tabs = dataclasses.replace(
            tabs, int_levels=(False,) * len(tabs.int_levels))
        what = "every_level_mulhi"
    elif fr.tables.q64 is not None:
        what = "mulhi"
    else:
        raise AssertionError("no alternative draw form to time")

    def run():
        return [cf.crush_descend(a[0], a[1], tabs, a[3]) for a in calls]
    for (c1, l1), (c2, l2) in zip(run(), [cf.crush_descend(*a)
                                          for a in calls]):
        if not (torch.equal(c1, c2) and (l1 is None) == (l2 is None)
                and (l1 is None or torch.equal(l1, l2))):
            raise AssertionError(f"K7a {what} != the path's tables")
    return what, run


def crush_times(drive_rules, dev, wide_ops=0):
    """5c: K7a over one full candidate phase per configuration (each of its
    launches replayed on the same lanes, in turns with the phase and with
    the draw form K7a does not take, ``k7a_alternative``), K7b per epoch,
    and their plain versions; CUDA events, 10 launches per sample, medians.
    K7a's bound counts OPS_PER_DRAW per item drawn plus ``wide_ops`` per
    draw on a 64-bit quotient (a level without an i32 table).  K7b's byte bound counts what this epoch's resolve
    reads: the cand (and leaf) entries of the (slot, round) pairs it
    evaluates, which the plain version counts, the per-lane inputs, the
    weights and the rows."""
    from ceph_tpu_torch.ops import crush_fast as cf, crush_kernels as ck
    times = {}
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    for name, (fr, _, _, w) in drive_rules.items():
        calls = record_descents(fr, xd)
        draws = sum(k7a_draws(fr, a[0].numel(), a[3]) for a in calls)
        wide_draws = sum(k7a_draws(fr, a[0].numel(), a[3], True)
                          for a in calls)
        alt, alt_run = k7a_alternative(fr, calls)
        cand_ms, k7a_ms, alt_ms = turns_ms([
            lambda: fr._candidates(xd),
            lambda: [cf.crush_descend(*a) for a in calls], alt_run],
            reps=REPS)
        k7a_plain = cuda_ms(lambda: [cf.crush_descend_plain(*a)
                                     for a in calls], runs=1, warmup=0)
        wd = torch.from_numpy(w.view(np.int32)).to(dev)
        cand, leaf, risk0, valid, xl = fr._cand
        k7b_host_ms = turns_ms([lambda: fr.resolve_packed(wd)], reps=REPS)[0]
        k7b_ms = graph_ms(lambda: fr.resolve_packed(wd))
        # K6: over the x K7b flags (the finishing launch, on a copy of its
        # rows) and over every x; the whole resolution of an epoch
        packed = fr.resolve_packed(wd)
        idx, n_live = fr.flagged_index(packed)
        n_flagged = int(n_live)
        work = packed.clone()

        def flagged():
            ck.crush_rule(fr.program, xd, wd, idx=idx, n_live=n_live,
                          packed=work)

        k6_flag_ms = graph_ms(flagged)
        k6_all_ms, k6_all_warp_ms = graph_turns_ms(
            [lambda: ck.crush_rule(fr.program, xd, wd),
             k6_warp_all(fr.program, xd, wd)], launches=3, samples=5)
        epoch_ms = graph_ms(lambda: fr.exact_packed(wd))
        # K7c over epoch 10's rows against epoch 9's
        w9 = np.full(CRUSH_OSDS, 0x10000, np.uint32)
        w9[(7 * (CRUSH_EPOCHS - 1) + 3) % CRUSH_OSDS] = 0
        prev = fr.exact_packed(torch.from_numpy(w9.view(np.int32)).to(dev))
        prev = prev.clone()
        rows10 = fr.exact_packed(wd).clone()
        n_fl = fr._n_flagged.clone()
        cap = min(fr.delta_cap, CRUSH_X)
        k7c_ms, k7c_plain_ms = graph_turns_ms([
            lambda: cf.crush_delta(rows10, prev, cap, n_fl),
            lambda: cf.crush_delta_plain(rows10, prev, cap, n_fl)])
        k7c_changed = int((rows10 != prev).any(1).sum())
        k7c_bytes = 2 * rows10.numel() * 4 + (2 + cap * (fr.result_max + 2)) * 4
        del prev, rows10
        k6_draws = torch.zeros(CRUSH_X, dtype=torch.int64, device=dev)
        t_plain = time.perf_counter()
        ck.crush_rule_plain(fr.program, xd, wd, draws=k6_draws)
        torch.cuda.synchronize()
        k6_plain_all_ms = (time.perf_counter() - t_plain) * 1e3
        fidx = idx[:n_flagged].long()
        k6_plain_flag_ms = cuda_ms(lambda: ck.crush_rule_plain(
            fr.program, xd[fidx], wd), runs=1, warmup=0)
        draws_all = int(k6_draws.sum())
        draws_flag = int(k6_draws[fidx].sum())
        max_items_flag = int(k6_draws[fidx].max()) if n_flagged else 0
        del work, packed
        k7b_plain = cuda_ms(lambda: cf.crush_resolve_plain(
            fr.spec, cand, leaf, xl, valid, risk0, wd, fr.parents,
            fr.result_max, 0), runs=1, warmup=0)
        ops = draws * OPS_PER_DRAW + wide_draws * wide_ops
        rows = CRUSH_X * (fr.result_max + 1) * 4
        lane_bytes = sum(t.numel() * t.element_size()
                         for t in (risk0, valid, xl, wd))
        k7b_bytes_all = (sum(t.numel() * t.element_size() for t in
                             (cand, leaf) if t is not None)
                         + lane_bytes + rows)
        reads = torch.zeros(cand.shape[2], dtype=torch.int64, device=dev)
        cf.crush_resolve_plain(fr.spec, cand, leaf, xl, valid, risk0, wd,
                               fr.parents, fr.result_max, 0, reads=reads)
        evaluated = int(reads.sum())
        k7b_bytes = (evaluated * 4 * (1 + (fr.spec.n_leaf if fr.spec.leafy
                                           else 0))
                     + lane_bytes + rows)
        times[name] = {
            "k7a_launches_per_phase": len(calls),
            "k7a_lanes": sum(a[0].numel() for a in calls),
            "k7a_draws": draws, "k7a_wide_draws": wide_draws,
            "k7a_wide_ops": wide_ops, "k7a_ops": ops,
            "candidate_phase_ms": cand_ms, "k7a_ms": k7a_ms,
            "k7a_alternative": alt, "k7a_alternative_ms": alt_ms,
            "k7a_plain_ms": k7a_plain,
            "k7a_bound_ms": ops / INSTR_PER_S * 1e3,
            "k7b_ms": k7b_ms, "k7b_host_launch_ms": k7b_host_ms,
            "k7b_plain_ms": k7b_plain,
            "k7b_evaluated": evaluated, "k7b_bytes": k7b_bytes,
            "k7b_bound_ms": k7b_bytes / HBM_BYTES_PER_S * 1e3,
            "k7b_bytes_all": k7b_bytes_all,
            "k7b_bound_ms_all": k7b_bytes_all / HBM_BYTES_PER_S * 1e3,
            "k6_flagged": n_flagged, "k6_flagged_ms": k6_flag_ms,
            "k6_flagged_plain_ms": k6_plain_flag_ms,
            "k6_flagged_draws": draws_flag,
            "k6_max_items_per_flagged_x": max_items_flag,
            "k6_flagged_bound_ms": (draws_flag * OPS_PER_DRAW / INSTR_PER_S
                                    * 1e3),
            "k6_all_ms": k6_all_ms, "k6_all_warp_ms": k6_all_warp_ms,
            "k6_all_plain_ms": k6_plain_all_ms,
            "k6_all_draws": draws_all,
            "k6_all_bound_ms": draws_all * OPS_PER_DRAW / INSTR_PER_S * 1e3,
            "resolve_epoch_ms": epoch_ms,
            "k7c_ms": k7c_ms, "k7c_plain_ms": k7c_plain_ms,
            "k7c_changed_rows": k7c_changed,
            "k7c_cap": cap, "k7c_bytes": k7c_bytes,
            "k7c_bound_ms": k7c_bytes / HBM_BYTES_PER_S * 1e3}
        log(f"time crush {name} " + json.dumps(times[name]))
        del calls
    return times


def tester_phase(cw, rules, dev) -> dict:
    """4t: crushtool --test --show-statistics over the (u) map.  Every rule
    and numrep of its mask at x 0..1023 (crushtool's default range) on the
    card equals the same sweep on the plain versions (CPU) byte for byte;
    then each rule at its pool size over 100000 x on the card, timed."""
    import io
    from ceph_tpu_torch.crush.tester import CrushTester
    texts = []
    for where in (dev, "cpu"):
        buf = io.StringIO()
        t = CrushTester(cw, buf, device=where)
        t.set_output_statistics(True)
        t.test()
        texts.append(buf.getvalue())
    if texts[0] != texts[1]:
        raise AssertionError("crushtool --test on the card != plain versions")
    out = {"x_0_1023_lines": texts[0].count("\n")}
    for mode, (rno, size) in rules.items():
        buf = io.StringIO()
        t = CrushTester(cw, buf, device=dev)
        t.set_output_statistics(True)
        t.set_rule(rno)
        t.set_num_rep(size)
        t.set_max_x(CRUSH_X - 1)
        t0 = time.perf_counter()
        t.test()
        out[mode] = {"wall_s": time.perf_counter() - t0,
                     "bad_mappings": t.bad_mappings,
                     "statistics": buf.getvalue().splitlines()[:3]}
        log(f"tester {mode}: crushtool --test --show-statistics --rule {rno} "
            f"--num-rep {size} --max-x {CRUSH_X - 1} on the card in "
            f"{out[mode]['wall_s']:.2f} s: {out[mode]['statistics']}")
    log(f"tester: every rule and numrep at x 0..1023, card == plain "
        f"versions ({out['x_0_1023_lines']} lines)")
    return out


def k7c_checks(drive_rules, plain_rules, dev):
    """K7c against its plain version, buffer for buffer, per configuration
    of the drive: epoch 10's rows against epoch 9's at the rule's cap, an
    all-equal epoch (epoch 10 against itself), and a cap of half the
    changed rows (an overflow: the count past the cap, the slots full).
    Then ``map_batch``'s refetch path: with a cap of 1, epoch 9 after
    epoch 10 overflows, must equal the plain versions' rows on every x and
    double the cap (restored afterwards).  Returns (max_abs_err, the
    cases' caps and counts)."""
    from ceph_tpu_torch.ops import crush_fast as cf
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    w9 = np.full(CRUSH_OSDS, 0x10000, np.uint32)
    w9[(7 * (CRUSH_EPOCHS - 1) + 3) % CRUSH_OSDS] = 0
    err, cases = 0, {}
    for name, (fr, _, _, w) in drive_rules.items():
        prev = fr.exact_packed(
            torch.from_numpy(w9.view(np.int32)).to(dev)).clone()
        rows = fr.exact_packed(
            torch.from_numpy(w.view(np.int32)).to(dev)).clone()
        n_fl = fr._n_flagged.clone()
        n_changed = int((rows != prev).any(1).sum())
        if not n_changed:
            raise AssertionError(f"K7c {name}: epochs 9 and 10 map alike")
        cap = min(fr.delta_cap, CRUSH_X)
        for case, (a, b, c) in {
                "epoch10_vs_9": (rows, prev, cap),
                "all_equal": (rows, rows, cap),
                "overflow": (rows, prev, max(1, n_changed // 2))}.items():
            got = cf.crush_delta(a, b, c, n_fl)
            want = cf.crush_delta_plain(a, b, c, n_fl)
            if got.shape != want.shape or not torch.equal(got, want):
                raise AssertionError(f"K7c {name} {case}: the buffer != "
                                     "the plain version's")
            err = max(err, int((got.long() - want.long()).abs().max()))
            cases[f"{name} {case}"] = {"cap": c, "n_changed": int(got[0])}
        cap0 = fr.delta_cap
        fr.delta_cap = 1
        res, cnt = fr.map_batch(xs, w9)
        rp, cp = plain_rules[name].map_batch(xs, w9)
        cols = np.arange(res.shape[1])[None, :]
        if not (np.array_equal(cnt, cp) and np.array_equal(
                np.where(cols < cnt[:, None], res, -1),
                np.where(cols < cp[:, None], rp, -1))):
            raise AssertionError(f"K7c {name}: the refetch epoch != plain")
        if fr.delta_cap != 2:
            raise AssertionError(f"K7c {name}: cap 1 did not overflow")
        cases[f"{name} refetch"] = {"cap": 1, "n_changed": n_changed}
        fr.delta_cap = cap0
        del prev, rows
    log(f"check K7c: every buffer equals the plain version's "
        f"(max_abs_err {err}): " + json.dumps(cases))
    return err, cases


def k7c_alone(dev) -> None:
    """``--k7c``: K7c alone after the build, against its plain version
    buffer for buffer on row tables made from the seed: 100000 rows of 4
    and of 13 words, 1000 rows and 1 row, with no row, 0.6%, half and
    every row changed, each at a cap of 1, of 8192 and of every row; then
    both timed by graph replay at 100000 x 4 with 0.6% changed."""
    from ceph_tpu_torch.ops import crush_fast as cf
    g = torch.Generator().manual_seed(SEED)
    n_flagged = torch.tensor([7], dtype=torch.int32, device=dev)
    cases = 0
    for X, W in ((100000, 4), (100000, 13), (1000, 4), (1, 2)):
        prev = torch.randint(0, 1 << 20, (X, W), generator=g,
                             dtype=torch.int32)
        for frac in (0.0, 0.006, 0.5, 1.0):
            rows = prev.clone()
            n = int(round(X * frac))
            pick = torch.randperm(X, generator=g)[:n]
            rows[pick, torch.randint(0, W, (n,), generator=g)] += 1
            a, b = rows.to(dev), prev.to(dev)
            for cap in sorted({1, min(8192, X), X}):
                got = cf.crush_delta(a, b, cap, n_flagged)
                want = cf.crush_delta_plain(a, b, cap, n_flagged)
                if got.shape != want.shape or not torch.equal(got, want):
                    raise AssertionError(f"K7c X={X} W={W} changed {n} "
                                         f"cap {cap}: != plain")
                cases += 1
    X, W, cap = 100000, 4, 8192
    prev = torch.randint(0, 1 << 20, (X, W), generator=g,
                         dtype=torch.int32)
    rows = prev.clone()
    rows[torch.randperm(X, generator=g)[:600], 0] += 1
    a, b = rows.to(dev), prev.to(dev)
    ms, plain_ms = graph_turns_ms([
        lambda: cf.crush_delta(a, b, cap, n_flagged),
        lambda: cf.crush_delta_plain(a, b, cap, n_flagged)])
    nbytes = 2 * X * W * 4 + (2 + cap * (W + 1)) * 4
    log("k7c " + json.dumps({
        "cases_equal": cases, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "x": X, "w": W,
        "cap": cap, "changed": 600}))


def crush_slice(dev, sass, sm_count) -> dict:
    """Phases 3h, 3c, 4c and 5c of the CRUSH slice on ``dev``; returns what
    they measured ("launches", "max_abs_err", "times", "hash_probe",
    ...).  ``sass``: ``sass_counts`` of every built source."""
    import multiprocessing
    from ceph_tpu_torch.ops import crush_fast, crush_kernels
    t_crush = time.perf_counter()
    # -- 3h. the hash alone, in its forms -----------------------------------
    probe = hash_probe(dev, sass, sm_count)
    # K7a's SASS: no subroutine (the s64 divide is gone), its class counts
    k7a_sass = {n: {k: c[k] for k in ("instructions", "alu", "fma",
                                      "subroutines")}
                for n, c in ((sass or {}).get("crush_fast") or {}).items()
                if n.startswith("crush_descend_kernel")}
    log(f"K7a SASS: {json.dumps(k7a_sass)}")
    if any(c["subroutines"] for c in k7a_sass.values()):
        raise AssertionError("K7a calls a subroutine (an s64 divide?)")
    # -- 3c. K7a / K7b against their plain versions ---------------------------
    maps = {"u": crush_remap_map(True), "n": crush_remap_map(False)}
    configs = [(f"{k}_{mode}", cw, rno, size)
               for k, (cw, rules) in maps.items()
               for mode, (rno, size) in rules.items()]
    crush_err, plain_rules, k6_jobs = crush_checks(configs, dev)

    # -- 4c. the CRUSH main path: crushtool-style epochs, then OSDMap ---------
    crush_fast.descend_launches.reset()
    crush_fast.resolve_launches.reset()
    crush_fast.delta_launches.reset()
    crush_kernels.rule_launches.reset()
    drive, jobs, drive_rules = crush_drive(configs, dev)
    osd_drive, osd_jobs, osd_lanes = osdmap_drive(*maps["u"], dev)
    crush_launches = {"crush_descend": crush_fast.descend_launches.n,
                      "crush_resolve": crush_fast.resolve_launches.n,
                      "crush_delta": crush_fast.delta_launches.n,
                      "crush_rule": crush_kernels.rule_launches.n}
    log(f"main crush: launches {crush_launches}")
    if 0 in crush_launches.values():
        raise AssertionError("CRUSH main path skipped a kernel: "
                             f"{crush_launches}")
    # epoch 10 against the plain versions on the whole 100000 x
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    for name, (fr, res, cnt, w) in drive_rules.items():
        rp, cp = plain_rules[name].map_batch(xs, w)
        cols = np.arange(res.shape[1])[None, :]
        if not (np.array_equal(cnt, cp) and np.array_equal(
                np.where(cols < cnt[:, None], res, -1),
                np.where(cols < cp[:, None], rp, -1))):
            raise AssertionError(f"{name}: epoch 10 != plain version")
    log(f"main crush: epoch 10 of {sorted(drive_rules)} equals the "
        f"plain versions on all {CRUSH_X} x")
    crush_err["crush_delta"], k7c_cases = k7c_checks(drive_rules,
                                                     plain_rules, dev)
    del plain_rules
    # the OSDMap drive's own lanes (hashed pps, many at or above 2^31):
    # its cached candidates and the last epoch's packed rows against the
    # plain versions, every PG of both pools
    for k, (fr, ruleno, size, pps, w) in osd_lanes.items():
        frp = crush_fast.compile_fast_rule(maps["u"][0].crush, ruleno, size,
                                           device=dev, plain=True)
        a, b, f, resid, _ = _rule_pair_err(fr, frp, pps, [w])
        log(f"check osdmap {k} pool lanes X={len(pps)} (x >= 2^31: "
            f"{int((pps >= 2 ** 31).sum())}): K7a max_abs_err={a} "
            f"K7b max_abs_err={b} K6-finished max_abs_err={f} residual "
            f"{resid[0]:.5f}")
        if a or b or f:
            raise AssertionError(f"osdmap {k}: kernels disagree with plain")
        crush_err["crush_descend"] = max(crush_err["crush_descend"], a)
        crush_err["crush_resolve"] = max(crush_err["crush_resolve"], b)
        crush_err["crush_rule"] = max(crush_err["crush_rule"], f)
        del frp
    del osd_lanes
    # the sampled rows against the host, in CHECK_PROCS workers started only
    # now: the walls above were taken with nothing else on the host
    ctx = multiprocessing.get_context("spawn")
    t_check = time.perf_counter()
    with ctx.Pool(CHECK_PROCS) as pool:
        pending = [(what, got, pool.map_async(fn, args))
                   for what, got, fn, args in jobs + osd_jobs + k6_jobs]
        n_rows = check_pending(pending)
        pool.close()
        pool.join()
    del jobs, osd_jobs, k6_jobs
    log(f"main crush: {n_rows} sampled rows equal crush_do_rule / "
        f"pg_to_up_acting_osds on the host "
        f"({time.perf_counter() - t_check:.1f} s in {CHECK_PROCS} workers)")
    crush = {"launches": crush_launches, "drive": drive,
             "osdmap": osd_drive, "checked_rows": n_rows,
             "max_abs_err": crush_err, "k7c_cases": k7c_cases,
             "straw2_host_us": straw2_host_times()}
    crush["tester"] = tester_phase(*maps["u"], dev)

    # -- 5c. CRUSH kernel times -------------------------------------------------
    ct = crush_times(drive_rules, dev, WIDE_DRAW_OPS)
    del drive_rules
    crush["times"] = ct
    crush["hash_probe"] = probe
    crush["k7a_sass"] = k7a_sass
    crush["seconds"] = time.perf_counter() - t_crush
    log(f"crush phases took {crush['seconds']:.1f} s")
    return crush


def load_parent_port(parent_dir, name):
    """The port's package of another checkout under ``parent_dir``, loaded
    under the module name ``name`` (its kernels build from its own sources
    into its own build directory)."""
    import importlib.util
    pkg = os.path.join(os.path.abspath(parent_dir), "ceph_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def k6_parent_turns(parent_dir, dev) -> dict:
    """``--k6-parent DIR``: K6 of this tree in turns with the K6 of another
    checkout of the port under ``DIR`` (its package loaded under another
    name, its kernel built from its own sources into its own build
    directory), on the main path's inputs: per configuration at epoch 10's
    weights, the flagged launch over the x K7b flags and the launch over
    all 100000 x (this tree's thread form, and its warp form over an index
    list of every x), replayed from CUDA graphs in turns (the other tree,
    this tree, the other tree again).  Every launch's rows must equal the
    others'."""
    import importlib
    from ceph_tpu_torch.ops import crush_fast as cf, crush_kernels as ck
    load_parent_port(parent_dir, "k6_parent")
    pk = importlib.import_module("k6_parent.ops.crush_kernels")
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    w = np.full(CRUSH_OSDS, 0x10000, np.uint32)
    w[(7 * CRUSH_EPOCHS + 3) % CRUSH_OSDS] = 0
    wd = torch.from_numpy(w.view(np.int32)).to(dev)
    out = {}
    for k, uniform in (("u", True), ("n", False)):
        cw, rules = crush_remap_map(uniform)
        for mode, (rno, size) in rules.items():
            name = f"{k}_{mode}"
            fr = cf.compile_fast_rule(cw.crush, rno, size, device=dev)
            fr.prepare_candidates(np.arange(CRUSH_X, dtype=np.uint32))
            packed = fr.resolve_packed(wd)
            idx, n_live = fr.flagged_index(packed)
            pprog = pk.compile_map(cw.crush, None, device=dev).compile_rule(
                rno, size)
            work = [packed.clone() for _ in range(2)]
            rows = [None] * 3

            def flag(i, mod_, prog):
                return lambda: mod_.crush_rule(prog, xd, wd, idx=idx,
                                               n_live=n_live, packed=work[i])

            def keep(i, fn):
                def run():
                    rows[i] = fn()
                return run
            fns = [flag(0, pk, pprog), flag(1, ck, fr.program)]
            for fn in fns:
                fn()
            if not torch.equal(work[0], work[1]):
                raise AssertionError(f"K6 {name} flagged: trees disagree")
            t = graph_turns_ms(fns + fns[:1])
            out[name] = {"flagged": {"other_tree_ms": [t[0], t[2]],
                                     "ms": t[1]}}
            fns = [keep(0, lambda: pk.crush_rule(pprog, xd, wd)),
                   keep(1, lambda: ck.crush_rule(fr.program, xd, wd)),
                   keep(2, k6_warp_all(fr.program, xd, wd))]
            for fn in fns:
                fn()
            for r in rows[1:]:
                if not (torch.equal(r[0], rows[0][0])
                        and torch.equal(r[1], rows[0][1])):
                    raise AssertionError(f"K6 {name} all x: trees disagree")
            t = graph_turns_ms(fns + fns[:1], 3, 5)
            out[name]["all"] = {"other_tree_ms": [t[0], t[3]], "ms": t[1],
                                "warp_ms": t[2]}
            out[name]["flagged_x"] = int(n_live)
            log(f"k6 against {parent_dir} {name}: " + json.dumps(out[name]))
            del fr, work, rows
    return out


def k7a_parent_turns(parent_dir, dev) -> dict:
    """``--k7a-parent DIR``: K7a and the candidate phase of this tree in
    turns with those of another checkout of the port under ``DIR`` (its
    package loaded under another name, its kernels built from its own
    sources into its own build directory), on the four configurations at
    100000 x: the phase (``FastRule._candidates``), then its K7a launches
    alone, replayed on the same lanes, each in the order other tree, this
    tree, this tree, other tree, 10 back to back per sample.  Both trees'
    cand and leaf tables must be equal."""
    import importlib
    from ceph_tpu_torch.ops import crush_fast as cf
    load_parent_port(parent_dir, "k7a_parent")
    pf = importlib.import_module("k7a_parent.ops.crush_fast")
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    out = {}
    for k, uniform in (("u", True), ("n", False)):
        cw, rules = crush_remap_map(uniform)
        for mode, (rno, size) in rules.items():
            name = f"{k}_{mode}"
            fr = cf.compile_fast_rule(cw.crush, rno, size, device=dev)
            pfr = pf.compile_fast_rule(cw.crush, rno, size, device=dev)
            got, want = fr._candidates(xd), pfr._candidates(xd)
            for a, b in zip(got[:2], want[:2]):
                if (a is None) != (b is None) or (
                        a is not None and not torch.equal(a, b)):
                    raise AssertionError(f"K7a {name}: trees disagree")
            del got, want
            calls, pcalls = record_descents(fr, xd), record_descents(pfr, xd)

            def launches(mod, cs):
                return lambda: [mod.crush_descend(*a) for a in cs]
            other, this = (lambda: pfr._candidates(xd),
                           lambda: fr._candidates(xd))
            phase = turns_ms([other, this, this, other], reps=REPS)
            other, this = launches(pf, pcalls), launches(cf, calls)
            k7a = turns_ms([other, this, this, other], reps=REPS)
            out[name] = {
                "phase": {"other_tree_ms": [phase[0], phase[3]],
                          "ms": [phase[1], phase[2]]},
                "k7a": {"other_tree_ms": [k7a[0], k7a[3]],
                        "ms": [k7a[1], k7a[2]],
                        "other_tree_launches": len(pcalls),
                        "launches": len(calls)}}
            log(f"k7a against {parent_dir} {name}: " + json.dumps(out[name]))
            del fr, pfr, calls, pcalls
    return out


# int64 quotient tables (distinct nonzero weights: the OSDs' and the hosts'
# one) of the (n) maps ``--k7a-forms`` times K7a's two draw forms on; K7a
# takes the tables up to Q64_MAX_TABLES of them
K7A_FORM_TABLES = (4, 16, 32, 48, 64, 128, 256, 1000)


def k7a_form_turns(dev) -> dict:
    """``--k7a-forms``: K7a's two draws for a level without an i32 quotient
    table, the per-item int64 quotient tables and the multiply-high, in
    turns (tables, multiply-high, multiply-high, tables; 10 launches of a
    candidate phase per sample) on the (n) map with its OSD weights taking
    distinct values so that the map has each count of ``K7A_FORM_TABLES``
    distinct weights, both rules at 100000 x.  Both forms' cand and leaf
    tables must be equal."""
    import dataclasses
    from ceph_tpu_torch.ops import crush_fast as cf
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    out = {}
    for d in K7A_FORM_TABLES:
        cw, rules = crush_remap_map(False, distinct=d - 1)
        for mode, (rno, size) in rules.items():
            fr = cf.compile_fast_rule(cw.crush, rno, size, device=dev)
            qitem, q64 = cf.item_quotient_tables(fr.C._weights_np, None)
            if q64.shape[0] != d:
                raise AssertionError(f"{q64.shape[0]} tables, not {d}")
            tables = dataclasses.replace(
                fr.tables, qitem=torch.from_numpy(qitem).to(dev),
                q64=torch.from_numpy(q64).to(dev))
            mulhi = dataclasses.replace(fr.tables, qitem=None, q64=None)
            calls = record_descents(fr, xd)

            def run(tabs):
                return lambda: [cf.crush_descend(a[0], a[1], tabs, a[3])
                                for a in calls]
            for (c1, l1), (c2, l2) in zip(run(tables)(), run(mulhi)()):
                if not (torch.equal(c1, c2) and (l1 is None or
                                                 torch.equal(l1, l2))):
                    raise AssertionError(f"K7a forms disagree, {d} tables")
            t = turns_ms([run(tables), run(mulhi), run(mulhi), run(tables)],
                         reps=REPS)
            name = f"{d}_{mode}"
            out[name] = {"tables": d,
                         "table_mib": q64.nbytes / 2**20,
                         "tables_ms": [t[0], t[3]], "mulhi_ms": [t[1], t[2]],
                         "taken": "tables" if fr.tables.q64 is not None
                         else "mulhi"}
            log(f"k7a forms {name}: " + json.dumps(out[name]))
            del fr, tables, mulhi, calls, qitem, q64
            torch.cuda.empty_cache()
    return out


def k8_parent_turns(parent_dir, dev) -> dict:
    """``--k8-parent DIR``: K8 of this tree in turns with the K8 of another
    checkout of the port under ``DIR`` (its package loaded under another
    name, its ``crush_legacy.cu`` built from its own sources into its own
    build directory), over (L)'s 100000 x for L1 and L2 at epochs 0, 10
    and H: CUDA graphs of 3 launches replayed in turns (the other tree,
    this tree, the other tree again).  The two trees' rows and counts must
    be equal."""
    import importlib
    from ceph_tpu_torch.crush.compiler import CrushCompiler
    from ceph_tpu_torch.ops import crush_legacy as cl
    load_parent_port(parent_dir, "k8_parent")
    pl = importlib.import_module("k8_parent.ops.crush_legacy")
    m = CrushCompiler().compile(legacy_map_text()).crush
    epochs = legacy_epochs(np.random.default_rng(SEED))
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    out = {}
    for rno, (key, (_, size)) in enumerate(LEGACY_RULES.items()):
        rule = cl.LegacyFastRule(m, rno, size, device=dev)
        prule = pl.LegacyFastRule(m, rno, size, device=dev)
        for e in ("0", str(LEGACY_EPOCHS), "H"):
            wd = torch.from_numpy(epochs[e].view(np.int32)).to(dev)
            a = pl.crush_legacy(prule, xd, wd)
            b = cl.crush_legacy(rule, xd, wd)
            if not (torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])):
                raise AssertionError(f"K8 {key} epoch {e}: trees disagree")
            t = graph_turns_ms([lambda: pl.crush_legacy(prule, xd, wd),
                                lambda: cl.crush_legacy(rule, xd, wd)]
                               * 2, launches=3, samples=5)
            name = f"{key} {e}"
            out[name] = {"other_tree_ms": [t[0], t[2]], "ms": t[1],
                         "ms_again": t[3]}
            log(f"k8 against {parent_dir} {name}: " + json.dumps(out[name]))
    return out


# ---- the legacy slice: 3l / 4l / 5l -------------------------------------------------

LEGACY_SHAPE = (5, 10, 20)        # (L): racks, hosts per rack, OSDs per host
LEGACY_CHECK_X = 4096             # x of each rule and epoch held against plain
LEGACY_SAMPLE = 1000              # x of each rule and epoch held against the host
                                  # (2000 until the cephfs slice: the time limit)
LEGACY_EPOCHS = 10                # epochs marking 2 more OSDs out each
# (L)'s rules: Ceph's default replicated rule (size 3), and a chained rule
# placing 2 copies in each of 2 racks (size 4)
LEGACY_RULES = {
    "L1": (["step take default", "step chooseleaf firstn 0 type host",
            "step emit"], 3),
    "L2": (["step take default", "step choose firstn 2 type rack",
            "step chooseleaf firstn 2 type host", "step emit"], 4),
}


def legacy_text_map(racks, hosts, per_host, rules, algs=("straw",) * 3,
                    tunables=()):
    """crushtool text of a rack-aware map: ``racks`` racks of ``hosts``
    hosts of ``per_host`` OSDs, every OSD weight 1.000, the root, rack and
    host buckets of ``algs``, rules ``rules`` (a list of step lines each, in
    rule ids 0..) and no tunable lines but ``tunables`` (name, value), so
    ``CrushCompiler.compile`` gives it the legacy tunables."""
    n = racks * hosts * per_host
    lines = ["# begin crush map"]
    lines += [f"tunable {k} {v}" for k, v in tunables]
    lines += [""] + [f"device {i} osd.{i}" for i in range(n)]
    lines += ["", "type 0 osd", "type 1 host", "type 2 rack", "type 3 root",
              "", "# buckets"]
    bid, osd, rack_names = -2, 0, []

    def bucket(kind, name, alg, items, weight):
        nonlocal bid
        lines.extend([f"{kind} {name} {{", f"\tid {bid}", f"\talg {alg}",
                      "\thash 0"]
                     + [f"\titem {i} weight {weight:.3f}" for i in items]
                     + ["}"])
        bid -= 1
    for r in range(racks):
        host_names = []
        for h in range(hosts):
            host_names.append(f"host{r * hosts + h}")
            bucket("host", host_names[-1], algs[2],
                   [f"osd.{osd + i}" for i in range(per_host)], 1.0)
            osd += per_host
        rack_names.append(f"rack{r}")
        bucket("rack", rack_names[-1], algs[1], host_names, per_host)
    lines.extend(["root default {", "\tid -1", f"\talg {algs[0]}", "\thash 0"]
                 + [f"\titem {r} weight {hosts * per_host:.3f}"
                    for r in rack_names] + ["}", "", "# rules"])
    for i, steps in enumerate(rules):
        lines.extend([f"rule rule{i} {{", f"\tid {i}", "\ttype replicated",
                      "\tmin_size 1", "\tmax_size 10"]
                     + [f"\t{s}" for s in steps] + ["}"])
    return "\n".join(lines + ["", "# end crush map", ""])


def legacy_small_maps():
    """The small legacy maps (36-80 OSDs) that tests/test_torch_crush_legacy.py
    and 3l run: name -> (text, [(rule id, result_max)])."""
    leaf = "step chooseleaf firstn 0 type host"
    chain = ["step choose firstn 2 type rack",
             "step chooseleaf firstn 2 type host"]
    take, emit = "step take default", "step emit"
    rack3 = [[take, leaf, emit], [take] + chain + [emit],
             ["step set_choose_tries 3", take, leaf, emit],
             ["step set_chooseleaf_tries 2", take, leaf, emit],
             ["step set_choose_local_tries 0", take, leaf, emit],
             ["step set_choose_local_fallback_tries 0", take, leaf, emit],
             [take, "step choose firstn 3 type osd", emit]]
    mixed = [[take, leaf, emit], [take] + chain + [emit]]
    return {
        "rack3x3x4": (legacy_text_map(3, 3, 4, rack3),
                      [(0, 3), (1, 4), (2, 3), (3, 3), (4, 3), (5, 3),
                       (6, 3)]),
        "mixed4x2x10": (legacy_text_map(4, 2, 10, mixed,
                                        ("straw2", "straw", "straw")),
                        [(0, 3), (1, 4)]),
        "stable3x3x4": (legacy_text_map(3, 3, 4, mixed,
                                        tunables=[("chooseleaf_stable", 1)]),
                        [(0, 3), (1, 4)]),
    }


def legacy_wide_maps():
    """A legacy map whose hosts are wider than a warp (3 racks x 2 hosts x
    40 OSDs), so a host draw takes several rounds of K8's group of lanes:
    name -> (text, [(rule id, result_max)]), as legacy_small_maps."""
    take, emit = "step take default", "step emit"
    rules = [[take, "step chooseleaf firstn 0 type host", emit],
             [take, "step choose firstn 2 type rack",
              "step chooseleaf firstn 2 type host", emit]]
    return {"wide3x2x40": (legacy_text_map(3, 2, 40, rules),
                           [(0, 3), (1, 4)])}


def legacy_heavy(w, per_host, rng, hosts=3, out=15, partial=20):
    """``w`` with ``hosts`` hosts losing ``out`` of their OSDs and
    ``partial`` other OSDs at 0x8000: local retries that run long enough
    to reach the permutation draw, and partial weights that reject."""
    w = w.copy()
    n_hosts = len(w) // per_host
    hs = rng.choice(n_hosts, min(hosts, n_hosts), replace=False)
    for h in hs:
        w[h * per_host + rng.choice(per_host, min(out, per_host - 1),
                                    replace=False)] = 0
    rest = np.nonzero(w == 0x10000)[0]
    w[rng.choice(rest, min(partial, len(rest)), replace=False)] = 0x8000
    return w


def legacy_weights(n, per_host, rng):
    """The small maps' weight vectors: all in, 10% out, 10% at a quarter
    weight, and heavy-out within hosts (``legacy_heavy``)."""
    all_in = np.full(n, 0x10000, np.uint32)
    out = all_in.copy()
    out[rng.choice(n, n // 10, replace=False)] = 0
    quarter = all_in.copy()
    quarter[rng.choice(n, n // 10, replace=False)] = 0x4000
    heavy = legacy_heavy(all_in, per_host, rng, hosts=2,
                         out=per_host - 1, partial=n // 10)
    return {"all_in": all_in, "out": out, "quarter": quarter,
            "heavy": heavy}


def legacy_epochs(rng):
    """(L)'s weight epochs: 0 all in, 1..10 each marking 2 more OSDs out,
    and H (``legacy_heavy``: 3 hosts with 15 of 20 OSDs out, 20 other OSDs
    at 0x8000)."""
    racks, hosts, per_host = LEGACY_SHAPE
    n = racks * hosts * per_host
    w = np.full(n, 0x10000, np.uint32)
    order = rng.permutation(n)
    epochs = {"0": w}
    for e in range(1, LEGACY_EPOCHS + 1):
        we = w.copy()
        we[order[:2 * e]] = 0
        epochs[str(e)] = we
    epochs["H"] = legacy_heavy(w, per_host, rng)
    return epochs


def legacy_map_text():
    """(L) as crushtool text: 1000 OSDs in 5 racks x 10 hosts x 20, every
    bucket straw (v1), weights 1.000, no tunable lines, rules L1 and L2."""
    return legacy_text_map(*LEGACY_SHAPE,
                           [steps for steps, _ in LEGACY_RULES.values()])


def _legacy_scheme_rows(args):
    """Check worker: K8's one-thread walk (``_Thread`` of
    tests/test_torch_crush_legacy_kernel.py) over a chunk of x: its rows and
    the items it hashes per x (what K8's instruction bound counts)."""
    m, ruleno, size, xs, weight = args
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tests"))
    from test_torch_crush_legacy_kernel import legacy_scheme
    from ceph_tpu_torch.ops.crush_legacy import LegacyFastRule
    rows, hashed, _, _ = legacy_scheme(
        LegacyFastRule(m, ruleno, size, device="cpu"), xs, weight)
    return [(row, int(h)) for row, h in zip(rows, hashed)]


def _legacy_pair(rule, x, w):
    """K8 and its plain version (on the card) over the same x: (max abs
    error, the plain version's wall in s, x taking a permutation draw, x
    taking a local retry)."""
    from ceph_tpu_torch.ops import crush_legacy as cl
    got, gcnt, _ = cl.crush_legacy(rule, x, w)
    stats = {}
    rule._tables = None           # the plain version's whole cost, tables too
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want, wcnt, res = cl.crush_legacy_plain(rule, x, w, stats)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if res.any():
        raise AssertionError("plain version left x past its window")
    err = max(int_err(got, want), int_err(gcnt, wcnt))
    return (err, wall, int(stats["perm"].sum()), int(stats["local"].sum()))


def legacy_checks(dev):
    """3l: K8 against its plain version on the card, byte-exact: every
    rule and weight vector of the small legacy maps and of the wide map at
    4096 x, and (L)'s first LEGACY_CHECK_X x of each rule and epoch.  The
    plain version marks the x that took a permutation draw or a local
    retry: on (L) both must be > 0."""
    from ceph_tpu_torch.crush.compiler import CrushCompiler
    from ceph_tpu_torch.ops import crush_legacy as cl
    out = {"max_abs_err": 0, "small": {}, "L": {}}
    xs = torch.from_numpy((np.arange(4096, dtype=np.uint64) * 2654435761
                           & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
                          ).to(dev)
    for name, (text, rules) in {**legacy_small_maps(),
                                **legacy_wide_maps()}.items():
        m = CrushCompiler().compile(text).crush
        per_host = m.max_devices // sum(1 for b in m.buckets
                                        if b is not None and b.type == 1)
        ws = legacy_weights(m.max_devices, per_host,
                            np.random.default_rng(SEED))
        for rno, size in rules:
            rule = cl.LegacyFastRule(m, rno, size, device=dev)
            for wn, w in ws.items():
                wd = torch.from_numpy(w.view(np.int32)).to(dev)
                err, _, perm, local = _legacy_pair(rule, xs, wd)
                out["small"][f"{name} rule {rno} {wn}"] = [err, perm, local]
                out["max_abs_err"] = max(out["max_abs_err"], err)
                if err:
                    raise AssertionError(f"K8 != plain: {name} rule {rno} "
                                         f"{wn}")
    log(f"check legacy: K8 == plain on {len(out['small'])} (map, rule, "
        f"weights) of the small and wide maps at 4096 x; x with a perm "
        f"draw / a local retry per case: "
        + json.dumps({k: v[1:] for k, v in out["small"].items()}))
    m = CrushCompiler().compile(legacy_map_text()).crush
    x = torch.arange(LEGACY_CHECK_X, dtype=torch.int32, device=dev)
    epochs = legacy_epochs(np.random.default_rng(SEED))
    perm_all = local_all = 0
    for rno, (key, (_, size)) in enumerate(LEGACY_RULES.items()):
        rule = cl.LegacyFastRule(m, rno, size, device=dev)
        for e, w in epochs.items():
            wd = torch.from_numpy(w.view(np.int32)).to(dev)
            err, wall, perm, local = _legacy_pair(rule, x, wd)
            out["L"][f"{key} {e}"] = {"max_abs_err": err, "plain_s": wall,
                                      "perm_x": perm, "local_x": local}
            out["max_abs_err"] = max(out["max_abs_err"], err)
            perm_all += perm
            local_all += local
            if err:
                raise AssertionError(f"K8 != plain: (L) {key} epoch {e}")
    out["L_perm_x"], out["L_local_x"] = perm_all, local_all
    log(f"check legacy (L): K8 == plain on the first {LEGACY_CHECK_X} x of "
        f"each rule and epoch; x with a perm draw {perm_all}, with a local "
        f"retry {local_all}: " + json.dumps(out["L"]))
    if not perm_all or not local_all:
        raise AssertionError("(L): no checked x took a permutation draw "
                             "or a local retry")
    return out


def legacy_drive(dev):
    """4l: the path.  ``crushtool -c`` of (L)'s text into a binary map,
    ``decode_crushmap``, then ``LegacyFastRule(...).map_batch`` over all
    100000 x for L1 and L2 in every epoch (the K8 count reset just before,
    read after; residual_fraction 0.0 every time).  Returns the rows of a
    1000-x sample per rule and epoch as host jobs (``crush_do_rule`` and
    K8's transcription), the walls, the rules and the map's path."""
    from ceph_tpu_torch.crush.binfmt import decode_crushmap
    from ceph_tpu_torch.ops import crush_legacy as cl
    from ceph_tpu_torch.tools import crushtool
    d = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build",
                     "legacy")
    os.makedirs(d, exist_ok=True)
    txt, binf = os.path.join(d, "L.txt"), os.path.join(d, "L.bin")
    with open(txt, "w") as f:
        f.write(legacy_map_text())
    if crushtool.main(["-c", txt, "-o", binf], device=dev) != 0:
        raise AssertionError("crushtool -c failed on (L)")
    with open(binf, "rb") as f:
        m = decode_crushmap(f.read()).crush
    if (m.choose_local_tries, m.choose_local_fallback_tries,
            m.choose_total_tries, m.chooseleaf_descend_once,
            m.chooseleaf_vary_r) != (2, 5, 19, 0, 0):
        raise AssertionError("(L) did not compile to the legacy tunables")
    xs = np.arange(CRUSH_X, dtype=np.uint32)
    sample = np.sort(np.random.default_rng(SEED).choice(
        CRUSH_X, LEGACY_SAMPLE, replace=False))
    epochs = legacy_epochs(np.random.default_rng(SEED))
    rules = {key: cl.LegacyFastRule(m, rno, size, device=dev)
             for rno, (key, (_, size)) in enumerate(LEGACY_RULES.items())}
    cl.launches.reset()
    walls, jobs, rows0 = {}, [], None
    for key, rule in rules.items():
        walls[key] = {}
        for e, w in epochs.items():
            n0 = cl.launches.n
            t0 = time.perf_counter()
            res, cnt = rule.map_batch(xs, w)
            walls[key][e] = time.perf_counter() - t0
            if cl.launches.n == n0:
                raise AssertionError(f"K8 did not launch: {key} epoch {e}")
            if rule.residual_fraction != 0.0:
                raise AssertionError(f"{key} epoch {e}: residual "
                                     f"{rule.residual_fraction}")
            got = [[int(v) for v in res[x, :cnt[x]]] for x in sample]
            wl = [int(v) for v in w]
            jobs.append((f"legacy {key} epoch {e}", got, _do_rule_rows,
                         [(m, rule.ruleno, c, rule.result_max, wl)
                          for c in _chunks(sample, CHECK_PROCS)]))
            jobs.append((f"legacy {key} epoch {e} transcription", got,
                         _legacy_scheme_rows,
                         [(m, rule.ruleno, rule.result_max, c, wl)
                          for c in _chunks(sample, CHECK_PROCS)]))
            if key == "L1" and e == "0":
                rows0 = (res, cnt)
    launches = cl.launches.n
    log(f"drive legacy: crushtool -c (L) -> decode_crushmap -> "
        f"LegacyFastRule.map_batch of {CRUSH_X} x, rules "
        f"{sorted(rules)} x epochs {sorted(epochs)}: K8 launches "
        f"{launches}, residual_fraction 0.0 every time; map_batch walls "
        + json.dumps(walls))
    return {"launches": launches, "walls": walls, "rules": rules,
            "epochs": epochs, "jobs": jobs, "rows0": rows0, "bin": binf,
            "map": m}


def legacy_tester(drive):
    """4l: ``crushtool -i L.bin --test --rule 0 --num-rep 3 --min-x 0
    --max-x 1023 --show-mappings`` (its own process, as a user runs it)
    prints the rows K8 gave for those x in epoch 0."""
    argv = ["-i", drive["bin"], "--test", "--rule", "0", "--num-rep", "3",
            "--min-x", "0", "--max-x", "1023", "--show-mappings"]
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "ceph_tpu_torch.tools.crushtool", *argv],
                          capture_output=True, text=True, timeout=600,
                          cwd=os.path.dirname(os.path.abspath(__file__)))
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"crushtool --test failed: {proc.stderr}")
    res, cnt = drive["rows0"]
    want = [f"CRUSH rule 0 x {x} ["
            + ",".join(str(int(v)) for v in res[x, :cnt[x]]) + "]"
            for x in range(1024)]
    if proc.stdout.splitlines() != want:
        raise AssertionError("crushtool --test --show-mappings != K8")
    log(f"tester legacy: crushtool --test --show-mappings over x 0..1023 "
        f"prints K8's rows ({wall:.2f} s, its own process)")
    return {"wall_s": wall, "lines": len(want)}


def legacy_times(drive, checks, items, dev):
    """5l: K8 per rule and epoch over 100000 x, replayed from a CUDA graph
    of 3 launches (the kernel's own time); its instruction bound: the items
    its transcription hashes per x over the 1000-x sample, scaled to
    100000 x, times OPS_PER_DRAW at the card's instruction rate; the
    plain version's wall on its 4096 x (3l) and the map_batch walls
    (4l)."""
    from ceph_tpu_torch.ops import crush_legacy as cl
    xd = torch.arange(CRUSH_X, dtype=torch.int32, device=dev)
    times = {}
    for key, rule in drive["rules"].items():
        for e, w in drive["epochs"].items():
            wd = torch.from_numpy(w.view(np.int32)).to(dev)
            ms = graph_ms(lambda: cl.crush_legacy(rule, xd, wd), launches=3,
                          samples=5)
            per_x = items[f"legacy {key} epoch {e} transcription"]
            ops = per_x * CRUSH_X * OPS_PER_DRAW
            times[f"{key} {e}"] = {
                "ms": ms, "items_per_x": per_x,
                "bound_ms": ops / INSTR_PER_S * 1e3,
                "plain_ms_4096_x": checks["L"][f"{key} {e}"]["plain_s"] * 1e3,
                "map_batch_wall_s": drive["walls"][key][e]}
    log("time legacy " + json.dumps(times))
    return times


def legacy_slice(dev) -> dict:
    """Phases 3l, 4l and 5l of the legacy slice on ``dev``."""
    import multiprocessing
    t_start = time.perf_counter()
    checks = legacy_checks(dev)
    drive = legacy_drive(dev)
    tester = legacy_tester(drive)
    ctx = multiprocessing.get_context("spawn")
    t_check = time.perf_counter()
    items = {}
    with ctx.Pool(CHECK_PROCS) as pool:
        pending = [(what, got, fn, pool.map_async(fn, args))
                   for what, got, fn, args in drive["jobs"]]
        host = [(what, got, res) for what, got, fn, res in pending
                if fn is _do_rule_rows]
        n_rows = check_pending(host)
        for what, got, fn, res in pending:
            if fn is not _legacy_scheme_rows:
                continue
            part = [r for chunk in res.get() for r in chunk]
            if [row for row, _ in part] != got:
                raise AssertionError(f"{what}: K8 != its transcription")
            items[what] = float(np.mean([h for _, h in part]))
        pool.close()
        pool.join()
    log(f"check legacy: {n_rows} sampled rows equal crush_do_rule and K8's "
        f"transcription on the host ({time.perf_counter() - t_check:.1f} s "
        f"in {CHECK_PROCS} workers)")
    times = legacy_times(drive, checks, items, dev)
    out = {"checks": checks, "launches": drive["launches"],
           "walls": drive["walls"], "tester": tester, "times": times,
           "checked_rows": n_rows,
           "seconds": time.perf_counter() - t_start}
    log(f"legacy phases took {out['seconds']:.1f} s")
    return out


BENCH_BATCH = (64, K, 1 << 17)    # the JAX bench's full mode (__main__.py:78-80)
BENCH_TARGET_S, BENCH_REPEATS, BENCH_WARMUP = 3.0, 3, 1
BENCH_SEED = 1234
BUILD_STAGE = "chip_smoke.build"  # devprof stage of phase 2's nvcc runs


def bench_slice(dev, batch_shape=BENCH_BATCH, target_s=BENCH_TARGET_S,
                remap=(CRUSH_OSDS, CRUSH_X, CRUSH_EPOCHS)) -> dict:
    """4b: the port's fenced bench on ``dev``, each step's kernel counts
    set to 0 just before it and read just after.  Returns the metrics, the
    counts per step and the dumps; raises on any failed gate."""
    from ceph_tpu_torch.bench import workloads as bw
    from ceph_tpu_torch.common.kernel_trace import g_kernel_timer
    from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
    from ceph_tpu_torch.ops import crush_fast, crush_kernels, gf_pallas
    from ceph_tpu_torch.trace import g_devprof, g_oplat
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crush_descend": crush_fast.descend_launches,
                "crush_resolve": crush_fast.resolve_launches,
                "crush_rule": crush_kernels.rule_launches}
    t_phase = time.perf_counter()
    matrix = gf_gen_rs_matrix(K + M, K)
    batch = np.random.default_rng(BENCH_SEED).integers(
        0, 256, size=batch_shape, dtype=np.uint8)
    stage0 = g_oplat.snapshot()
    n_fenced = 0
    launches, metrics, remap_keys = {}, [], {}
    g_kernel_timer.reset()
    g_kernel_timer.enable()

    def counted(step, fn):
        for c in counters.values():
            c.reset()
        out = fn()
        launches[step] = {n: c.n for n, c in counters.items()}
        return out

    # The timed step (salt XOR, then K1) at the batch the bench times,
    # held byte for byte against K1's plain version on the same salted
    # input, for the encode matrix and for the e=2 decode matrix.  These
    # launches are the check's, not the path's: the counts are reset
    # before each step below.
    data = torch.from_numpy(batch).to(dev)
    step_errs = {}
    for name, bits in (("encode", bw.encode_bitmatrix(matrix, dev)),
                       ("decode", bw.decode_bitmatrix(matrix, 2, dev))):
        for salt in (0x9E3779B9, 0x12345678):
            got = bw.salted_matmul_step()(data, bits, salt)
            s32 = salt - (1 << 32) if salt >> 31 else salt
            salted = (data.view(torch.int32) ^ s32).view(torch.uint8)
            want = gf_pallas.gf_bit_matmul_plain(salted, bits.bits)
            torch.cuda.synchronize()
            err = int((got.int() - want.int()).abs().max())
            step_errs[f"{name}@{salt:#x}"] = err
            if got.shape != want.shape or err:
                raise AssertionError(f"bench {name} step at {batch_shape} "
                                     f"disagrees with plain: {err}")
            del got, want, salted
    del data
    log("bench salted step == plain at " + json.dumps(
        list(batch_shape)) + " " + json.dumps(step_errs))
    compiles0 = g_devprof.snapshot()["compiles"]

    try:
        kw = dict(target_seconds=target_s, repeats=BENCH_REPEATS,
                  warmup=BENCH_WARMUP, device=dev)
        for step, fn in (("encode", bw.measure_encode),
                         ("decode", bw.measure_decode)):
            m = counted(step, lambda: fn(matrix, batch, **kw))
            metrics.append(m)
            n_fenced += m["n_steps"] * (BENCH_REPEATS + BENCH_WARMUP)
        parity = counted("parity_check",
                         lambda: bw.parity_check(matrix, device=dev))
        remaps = {}
        for uniform, infix in ((True, ""), (False, "_nonuniform")):
            keys = {}
            r = counted(f"remap{infix or '_uniform'}",
                        lambda: bw.measure_crush_remap(
                            *remap, uniform=uniform, infix=infix,
                            partial=keys.update, device=dev))
            remap_keys.update(keys)
            remaps[infix or "_uniform"] = {
                "wall_ms": r[0], "dev_ms": r[1], "host_ms": r[2],
                "residual_fraction": r[3], "rtt_ms": r[4]}
            metrics.extend(r[5])
    finally:
        g_kernel_timer.enable(False)
    wall_s = time.perf_counter() - t_phase
    for m in metrics:
        rl = m.get("roofline", {})
        hbm_share = (rl["implied_hbm_gibs"] / rl["peak_hbm_gibs"]
                     if rl.get("peak_hbm_gibs") else None)
        log(f"bench {m['name']} {m['value']} {m['unit']} fenced="
            f"{m['fenced']} suspect={m.get('suspect', False)} roofline="
            f"{rl.get('verdict', 'n/a')} model={rl.get('workload')} "
            f"implied_hbm_gibs={rl.get('implied_hbm_gibs')} "
            f"hbm_share={hbm_share} rtt_ms={m.get('rtt_ms')} "
            f"n_steps={m.get('n_steps')} stats=" + json.dumps(m["stats"]))
    log(f"bench parity_check {parity}; launches per step "
        + json.dumps(launches) + "; remap " + json.dumps(remaps)
        + "; remap keys " + json.dumps(remap_keys))
    bad = [m["name"] for m in metrics
           if not m["fenced"] or m.get("suspect", False)]
    if bad:
        raise AssertionError(f"bench metrics not fenced or suspect: {bad}")
    if not parity:
        raise AssertionError("bench parity_check failed on the card")
    for step in ("encode", "decode", "parity_check"):
        if not launches[step]["gf_bit_matmul"]:
            raise AssertionError(f"bench {step}: K1 did not launch")
    for infix in ("_uniform", "_nonuniform"):
        n = launches[f"remap{infix}"]
        flagged = remaps[infix]["residual_fraction"] > 0
        if not n["crush_resolve"] or (flagged and not n["crush_rule"]):
            raise AssertionError(f"bench remap{infix}: K7b or K6 did not "
                                 f"launch: {n}")
    replayed = {k: v for k, v in remap_keys.items()
                if k.endswith("host_replayed")}
    if len(replayed) != 2 or any(replayed.values()):
        raise AssertionError(f"bench remap recomputed x on the host: "
                             f"{replayed}")
    prof = g_devprof.dump()
    log("bench devprof " + json.dumps(prof))
    # Every nvcc run of this process happened in phase 2's build stage
    # and is attributed there (the build's worker threads carry the
    # stage), none later; the bench compiled nothing while it timed.
    from ceph_tpu_torch.ops import _build
    compiles = {site: v["compiles"] for site, v in prof["sites"].items()
                if v["compiles"]}
    bench_compiles = g_devprof.snapshot()["compiles"] - compiles0
    if (not prof["sites"] or compiles != (
            {BUILD_STAGE: len(_build.build_logs)} if _build.build_logs
            else {}) or bench_compiles):
        raise AssertionError(
            f"devprof: compiles by stage {compiles}, "
            f"{len(_build.build_logs)} nvcc builds, {bench_compiles} in "
            f"the bench, sites {sorted(prof['sites'])}")
    timer = g_kernel_timer.dump()
    log("bench kernel timer " + json.dumps(timer))
    stages = g_oplat.breakdown_since(stage0, wall_s, max(n_fenced, 1))
    log("bench oplat stage_breakdown " + json.dumps(stages))
    log(f"bench phase took {wall_s:.1f} s")
    return {"metrics": metrics, "parity_check": parity,
            "launches": launches, "remaps": remaps, "remap_keys": remap_keys,
            "devprof": prof, "kernel_timer": timer,
            "stage_breakdown": stages, "seconds": wall_s}


# 4d: the dispatch scheduler on the card
DISPATCH_THREADS = 8
DISPATCH_PER_THREAD = 8
# the threaded leg's flush size: each thread has 8 requests, so a flush of
# 16 holds requests of at least two threads
DISPATCH_THREAD_BATCH = 2 * DISPATCH_PER_THREAD
DISPATCH_TIMING_RUNS = 3
BENCH_CLI_TIMEOUT_S = 600


class InFlight:
    """Calls of the functions it wraps that are running at once, and the
    most seen since ``reset``."""

    def __init__(self):
        self.now = self.most = 0
        self._lock = threading.Lock()

    def reset(self) -> None:
        with self._lock:
            self.now = self.most = 0

    def wrap(self, fn):
        def inner(*args, **kwargs):
            with self._lock:
                self.now += 1
                self.most = max(self.most, self.now)
            try:
                return fn(*args, **kwargs)
            finally:
                with self._lock:
                    self.now -= 1
        return inner


def dispatch_slice(objs) -> dict:
    """4d: the dispatch scheduler's coalesced encode and degraded read of
    the 64 objects on the card, then 8 submitter threads with and without
    a window; K1's count set to 0 just before each leg and read just
    after.  Returns the counts, flushes, occupancy, the calls that ran at
    once and the host-clock times; raises on any failed check."""
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import dispatch_perf_counters, g_dispatcher
    from ceph_tpu_torch.dispatch import scheduler as ds
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.ops import gf_matmul, gf_pallas
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.common.kernel_trace import g_kernel_timer
    from ceph_tpu_torch.trace import (devflow_delta, g_devprof, g_oplat,
                                      g_perf_histograms, occupancy_axes)
    t_phase = time.perf_counter()
    profile = {"plugin": "cuda", "k": str(K), "m": str(M),
               "technique": "reed_sol_van"}
    codec = create_erasure_code(profile)
    sinfo = ecutil.stripe_info_t(K, K * CHUNK)
    all_shards = set(range(K + M))
    want = [ecutil.encode(sinfo, codec, o, all_shards) for o in objs]
    surv = [{i: b for i, b in sh.items() if i not in ERASED} for sh in want]
    pc = dispatch_perf_counters()
    hist = g_perf_histograms.get("dispatch",
                                 "dispatch_batch_occupancy_histogram",
                                 occupancy_axes)
    guarded = (ds.l_dispatch_fallbacks, ds.l_dispatch_fallback_reqs,
               ds.l_dispatch_errors)
    legs = {}

    def leg(name, drive):
        """One counted leg: K1's count and the dispatcher's counters read
        just before and just after ``drive``.  K1 must launch once per
        device call the dispatcher made: each flush and each request it
        ran inline (window 0)."""
        g0 = [pc.get(c) for c in guarded]
        b0 = pc.get(ds.l_dispatch_batches)
        p0 = pc.get(ds.l_dispatch_passthrough)
        h0 = (hist.axis0_sum, hist.total_count)
        gf_pallas.launches.reset()
        out = drive()
        k1 = gf_pallas.launches.n
        flushes = pc.get(ds.l_dispatch_batches) - b0
        inline = pc.get(ds.l_dispatch_passthrough) - p0
        moved = [pc.get(c) - v for c, v in zip(guarded, g0)]
        dn = hist.total_count - h0[1]
        occ = (hist.axis0_sum - h0[0]) / dn if dn else 0.0
        legs[name] = {"k1_launches": k1, "flushes": flushes,
                      "inline": inline, "mean_occupancy": occ,
                      "fallbacks_fallback_reqs_errors": moved}
        log(f"dispatch {name}: " + json.dumps(legs[name]))
        if any(moved):
            raise AssertionError(f"dispatch {name}: a batch failed and was "
                                 f"re-run or errored: {moved}")
        if k1 != flushes + inline or not k1:
            raise AssertionError(f"dispatch {name}: K1 launched {k1} times "
                                 f"for {flushes} flushes and {inline} "
                                 "inline calls")
        return out

    def check_encode(name, got, idx):
        for i, r in zip(idx, got):
            if sorted(r) != sorted(want[i]) or any(
                    not np.array_equal(r[j], want[i][j]) for j in r):
                raise AssertionError(f"dispatch {name}: object {i} differs "
                                     "from per-object ecutil.encode")

    try:
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        g_conf.set_val("ec_dispatch_batch_max", N_OBJ)
        got = leg("encode", lambda: [f.result() for f in [
            g_dispatcher.submit_encode(sinfo, codec, o, all_shards)
            for o in objs]])
        check_encode("encode", got, range(N_OBJ))
        del got
        got = leg("decode_concat", lambda: [f.result() for f in [
            g_dispatcher.submit_decode_concat(sinfo, codec, sv)
            for sv in surv]])
        for i, (g, o) in enumerate(zip(got, objs)):
            if not np.array_equal(g, o):
                raise AssertionError(f"dispatch decode_concat: object {i} "
                                     "differs from its payload")
        del got

        # 8 submitter threads on a codec whose device backend is not built
        # yet, so they race for it; the calls that run at once are
        # counted in the flush (_execute), the codec's device call and
        # K1's wrapper
        execs, calls, k1s = InFlight(), InFlight(), InFlight()
        built = []
        make_backend = gf_matmul.DeviceRSBackend

        def counted_backend(*args, **kwargs):
            built.append(1)
            return make_backend(*args, **kwargs)

        def threaded(th_codec, windowed):
            """Each thread encodes its 8 objects.  Windowed, all threads
            start together and every one has queued its requests before
            any demands a result, so each flush of
            ``DISPATCH_THREAD_BATCH`` holds requests of several threads
            and runs in the thread whose submit filled it, while the
            others go on queueing.  Window 0, every encode runs inline in
            its own thread, so the threads are in the device call and K1
            at once."""
            res = [None] * N_OBJ
            errs = []
            start = threading.Barrier(DISPATCH_THREADS)
            queued = threading.Barrier(DISPATCH_THREADS)

            def submitter(t):
                idx = range(t * DISPATCH_PER_THREAD,
                            (t + 1) * DISPATCH_PER_THREAD)
                try:
                    start.wait(timeout=60)
                    if not windowed:
                        for i in idx:
                            res[i] = g_dispatcher.encode(
                                sinfo, th_codec, objs[i], all_shards)
                        return
                    futs = [(i, g_dispatcher.submit_encode(
                        sinfo, th_codec, objs[i], all_shards)) for i in idx]
                    queued.wait(timeout=300)
                    for i, f in futs:
                        res[i] = f.result()
                except Exception as e:      # noqa: BLE001 — reported
                    errs.append(e)
                    start.abort()
                    queued.abort()

            for c in (execs, calls, k1s):
                c.reset()
            ths = [threading.Thread(target=submitter, args=(t,))
                   for t in range(DISPATCH_THREADS)]
            for th in ths:
                th.start()
            for th in ths:
                th.join(timeout=300)
            if errs or any(th.is_alive() for th in ths):
                raise AssertionError(f"dispatch threads failed: {errs}")
            return res

        for name, windowed in (("threads", True), ("threads_window0", False)):
            th_codec = create_erasure_code(profile)
            th_codec.encode_batch = calls.wrap(th_codec.encode_batch)
            g_dispatcher._execute = execs.wrap(g_dispatcher._execute)
            gf_matmul.gf_bit_matmul_kernel = k1s.wrap(
                gf_pallas.gf_bit_matmul_kernel)
            gf_matmul.DeviceRSBackend = counted_backend
            built.clear()
            g_conf.set_val("ec_dispatch_batch_window_us",
                           10**7 if windowed else 0)
            g_conf.set_val("ec_dispatch_batch_max", DISPATCH_THREAD_BATCH)
            try:
                got = leg(name, lambda: threaded(th_codec, windowed))
            finally:
                del g_dispatcher._execute
                gf_matmul.gf_bit_matmul_kernel = \
                    gf_pallas.gf_bit_matmul_kernel
                gf_matmul.DeviceRSBackend = make_backend
            check_encode(name, got, range(N_OBJ))
            del got
            legs[name].update({"most_at_once_execute": execs.most,
                               "most_at_once_encode_batch": calls.most,
                               "most_at_once_k1_wrapper": k1s.most,
                               "backends_built": len(built)})
            log(f"dispatch {name} calls at once: " + json.dumps(legs[name]))
            if len(built) != 1:
                raise AssertionError(f"dispatch {name}: the codec's device "
                                     f"backend was built {len(built)} times")
        if legs["threads"]["mean_occupancy"] <= DISPATCH_PER_THREAD:
            raise AssertionError(
                "dispatch threads: mean occupancy "
                f"{legs['threads']['mean_occupancy']} <= "
                f"{DISPATCH_PER_THREAD}: no flush held requests of two "
                "threads")
        if legs["threads_window0"]["most_at_once_encode_batch"] < 2:
            raise AssertionError("dispatch threads_window0: the threads "
                                 "never were in the device call at once")
        g_conf.set_val("ec_dispatch_batch_max", N_OBJ)

        # host-clock times at this width, outside the counted legs
        def coalesced_encode():
            g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
            for f in [g_dispatcher.submit_encode(sinfo, codec, o, all_shards)
                      for o in objs]:
                f.result()

        def serial_encode():
            g_conf.set_val("ec_dispatch_batch_window_us", 0)
            for o in objs:
                g_dispatcher.encode(sinfo, codec, o, all_shards)

        def coalesced_decode():
            g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
            for f in [g_dispatcher.submit_decode_concat(sinfo, codec, sv)
                      for sv in surv]:
                f.result()

        def serial_decode():
            g_conf.set_val("ec_dispatch_batch_window_us", 0)
            for sv in surv:
                g_dispatcher.decode_concat(sinfo, codec, sv)

        fns = {"encode_coalesced": coalesced_encode,
               "encode_serial": serial_encode,
               "decode_coalesced": coalesced_decode,
               "decode_serial": serial_decode}
        samples = {n: [] for n in fns}
        for fn in fns.values():
            fn()                                        # warm
        for r in range(DISPATCH_TIMING_RUNS):
            order = list(fns) if r % 2 == 0 else list(reversed(fns))
            for n in order:
                t0 = time.perf_counter()
                fns[n]()
                samples[n].append(time.perf_counter() - t0)
        total = N_OBJ * OBJ_BYTES
        times = {n: {"s": statistics.median(v), "samples_s": v,
                     "GiBps": total / statistics.median(v) / 2**30}
                 for n, v in samples.items()}
        log("dispatch host-clock times (64 x 4 MiB) " + json.dumps(times))
        # where each mode's time goes, from one more run of each outside
        # the timed samples: the stage ledger the dispatcher stamps per
        # request (a coalesced request accrues its flush's whole
        # device_call), the kernel timer (``ec_encode_batch``: upload, K1,
        # fetch, synchronised) and the host copies and transfers per object
        for n, fn in fns.items():
            stage0 = g_oplat.snapshot()
            flow0 = g_devprof.snapshot()
            g_kernel_timer.reset()
            g_kernel_timer.enable()
            t0 = time.perf_counter()
            try:
                fn()
            finally:
                g_kernel_timer.enable(False)
            wall = time.perf_counter() - t0
            times[n]["stage_breakdown"] = g_oplat.breakdown_since(
                stage0, wall, N_OBJ)
            times[n]["kernel_timer"] = g_kernel_timer.dump()
            times[n]["devflow"] = devflow_delta(flow0, g_devprof.snapshot(),
                                                N_OBJ)
            log(f"dispatch {n} breakdown (one run, {wall:.3f} s): stages "
                + json.dumps({k: v["usec_per_op"] for k, v in
                              times[n]["stage_breakdown"]["stages"].items()})
                + " kernel_timer " + json.dumps(times[n]["kernel_timer"])
                + " devflow " + json.dumps(times[n]["devflow"]))
    finally:
        for name in ("ec_dispatch_batch_window_us", "ec_dispatch_batch_max"):
            g_conf.rm_val(name)
        g_dispatcher.flush()
    dump = g_dispatcher.dump()
    log("dispatch counters " + json.dumps(dump["counters"]))
    wall = time.perf_counter() - t_phase
    log(f"dispatch phase took {wall:.1f} s")
    return {"legs": legs, "times": times, "counters": dump["counters"],
            "occupancy_histogram": dump["occupancy_histogram"],
            "k1_launches": sum(v["k1_launches"] for v in legs.values()),
            "seconds": wall}


# 4n, before the CLI: the stripe counts at which the CLI's dispatch and
# pipeline workloads give K1 their 64 KiB objects (k=8, one stripe of
# C=8192 each): serial and depth-1 calls 1, depth-8 flushes 8, the
# coalesced flush 32; 16 and 64 fill in the scan
SCAN_STRIPES = (1, 8, 16, 32, 64)
SCAN_OBJECT_BYTES = 65536
SCAN_RUNS = 21


def host_ms(fn, runs: int = SCAN_RUNS, warmup: int = 2) -> float:
    """Median host-clock time of ``fn`` followed by a device sync."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        t.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(t)


def encode_batch_scan() -> dict:
    """4n, before the CLI: the ``cuda`` codec's ``encode_batch`` at the
    shapes the CLI's dispatch workloads flush, each held byte for byte
    against K1's plain version on the same inputs (and K1 alone on the
    device tensor), then the pieces of its time at each shape: the
    upload, K1 (host clock and its own device time), the fetch into a new
    host tensor and into one kept from the last call, the first touch of
    a new host buffer of the flush's stack size against the rewrite of a
    kept one, and one coalesced dispatcher flush of that many objects with
    its stage ledger (``device_call``: stack, pad, encode_batch;
    ``d2h``: the per-request packs).  Raises on a disagreement."""
    from ceph_tpu_torch.bench import workloads as bw
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.ops.gf_pallas import (gf_bit_matmul_kernel,
                                              gf_bit_matmul_plain)
    from ceph_tpu_torch.trace import g_oplat
    codec, dev, sinfo, want = bw._dispatch_codec("cuda", SCAN_OBJECT_BYTES)
    bm = codec.device().enc_bits
    c = SCAN_OBJECT_BYTES // K
    rng = np.random.default_rng(SEED + 13)
    rows = {}
    saved = {n: g_conf.values.get(n) for n in
             ("ec_dispatch_batch_max", "ec_dispatch_batch_window_us")}
    try:
        for s in SCAN_STRIPES:
            data = rng.integers(0, 256, (s, K, c), dtype=np.uint8)
            t = torch.from_numpy(data).to(dev)
            ref = gf_bit_matmul_plain(t, bm.bits).cpu().numpy()
            got = codec.encode_batch(data)
            alone = gf_bit_matmul_kernel(t, bm).cpu().numpy()
            err = max(int(np.abs(g.astype(np.int16)
                                 - ref.astype(np.int16)).max())
                      if g.shape == ref.shape else 256
                      for g in (got, alone))
            if err:
                raise AssertionError(f"encode_batch at ({s}, {K}, {c}) "
                                     f"disagrees with plain: {err}")
            o = gf_bit_matmul_kernel(t, bm)
            kept = torch.empty(o.shape, dtype=o.dtype)
            buf = np.empty(data.nbytes, dtype=np.uint8)
            row = {"shape": [s, K, c], "max_abs_err": err,
                   "encode_batch_ms": host_ms(
                       lambda: codec.encode_batch(data)),
                   "upload_ms": host_ms(lambda: torch.from_numpy(data)
                                        .to(dev)),
                   "k1_ms": host_ms(lambda: gf_bit_matmul_kernel(t, bm)),
                   "k1_device_ms": turns_ms(
                       [lambda: gf_bit_matmul_kernel(t, bm)], SCAN_RUNS,
                       reps=10)[0],
                   "fetch_new_ms": host_ms(lambda: o.cpu().numpy()),
                   "fetch_kept_ms": host_ms(lambda: kept.copy_(o)),
                   "touch_new_ms": host_ms(
                       lambda: np.empty(data.nbytes, np.uint8).fill(1)),
                   "touch_kept_ms": host_ms(lambda: buf.fill(1))}
            objs = data.reshape(s, SCAN_OBJECT_BYTES)
            g_conf.set_val("ec_dispatch_batch_max", s)
            g_conf.set_val("ec_dispatch_batch_window_us", 10**7)

            def flush():
                for f in [g_dispatcher.submit_encode(sinfo, codec, objs[i],
                                                     want)
                          for i in range(s)]:
                    f.result()

            flush()
            stage0 = g_oplat.snapshot()
            row["flush_ms"] = host_ms(flush, runs=SCAN_RUNS, warmup=0)
            st = g_oplat.breakdown_since(stage0, 1.0, s * SCAN_RUNS)[
                "stages"]
            for name in ("device_call", "d2h"):
                row[f"flush_{name}_ms"] = (st[name]["usec_per_op"] / 1e3
                                           if name in st else None)
            rows[s] = row
            log(f"encode_batch scan S={s}: " + json.dumps(row))
            del t, o, kept, buf
    finally:
        for n, v in saved.items():
            if v is None:
                g_conf.rm_val(n)
            else:
                g_conf.set_val(n, v)
        g_dispatcher.flush()
    return rows


def bench_cli(env=None):
    """``python -m ceph_tpu_torch.bench --gate warn`` in its own process
    (``env`` added to this one's): its one JSON line and its seconds.
    Raises unless it exits 0 with one line."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.bench", "--gate", "warn"],
        cwd=here, capture_output=True, text=True,
        timeout=BENCH_CLI_TIMEOUT_S, env={**os.environ, **(env or {})})
    cli_s = time.perf_counter() - t0
    for line in proc.stderr.splitlines()[-40:]:
        log(f"  bench-cli: {line}")
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"bench CLI rc {proc.returncode}, "
                             f"{len(lines)} stdout lines")
    return json.loads(lines[0]), cli_s


# ``--dispatch-scan``: glibc's malloc, set so that the host buffers of a
# flush (up to 32 MiB) come from its heap and the heap's top is not given
# back after each flush; its defaults map each buffer over 128 KiB anew
# until a free raises the threshold, and trim the heap at 128 KiB
MALLOC_KEEP = {"GLIBC_TUNABLES": "glibc.malloc.mmap_threshold=33554432:"
               "glibc.malloc.trim_threshold=134217728"}
DISPATCH_METRICS = ("ec_dispatch_coalesce_fenced",
                    "ec_dispatch_serial_fenced", "ec_pipeline_fenced",
                    "ec_pipeline_depth1_fenced")


def dispatch_scan_turns(dev) -> dict:
    """``--dispatch-scan``: where the bench CLI's coalesced flush of 32 x
    64 KiB loses its time.  The first touch of a new 64 MiB host buffer
    against the rewrite of a kept one (us per 4 KiB page); 4n's
    ``encode_batch_scan``; the CLI's dispatch and pipeline workloads run
    in this process; then the CLI in its own process in turns, as it is
    and with ``MALLOC_KEEP``, each reading's ledger per flush logged."""
    from ceph_tpu_torch.bench import workloads as bw
    out = {}
    n = 64 << 20
    kept = np.empty(n, dtype=np.uint8)
    kept.fill(0)
    new_ms = host_ms(lambda: np.empty(n, np.uint8).fill(1), runs=5)
    kept_ms = host_ms(lambda: kept.fill(1), runs=5)
    out["touch_64MiB"] = {"new_ms": new_ms, "kept_ms": kept_ms,
                          "us_per_new_page": (new_ms - kept_ms) * 1e3
                          / (n >> 12)}
    log("first touch " + json.dumps(out["touch_64MiB"]))
    del kept
    out["scan"] = encode_batch_scan()

    def per_flush(m):
        """The metric's value and, per flush, its ledger's stages (each
        request of a flush accrues the flush's whole stage)."""
        st = m["stage_breakdown"]["stages"]
        return {"value": m["value"], **{
            f"{k}_ms": round(v["usec_per_op"] / 1e3, 4)
            for k, v in st.items()}}

    mc, ms = bw.measure_dispatch_coalesce(n_requests=32, target_seconds=2.0,
                                          repeats=3, device=dev)
    mp, mp1 = bw.measure_ec_pipeline(n_requests=64, target_seconds=2.0,
                                     repeats=3, device=dev)
    out["in_process"] = {m["name"]: per_flush(m) for m in (mc, ms, mp, mp1)}
    log("dispatch workloads in this process "
        + json.dumps(out["in_process"]))
    out["cli"] = []
    for env_name in ("default", "malloc_keep", "malloc_keep", "default"):
        line, cli_s = bench_cli(MALLOC_KEEP if env_name != "default"
                                else None)
        got = {m["name"]: per_flush(m) for m in line["metrics"]
               if m["name"] in DISPATCH_METRICS}
        out["cli"].append({"env": env_name, "seconds": cli_s, **got})
        log(f"bench CLI ({env_name}) " + json.dumps(got))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "dispatch_scan.json"), "w") as f:
        json.dump(out, f, indent=1)
    return out


def native_bench_slice() -> dict:
    """4n: the native host library's build and checks, then the bench CLI
    in its own process on the card.  Raises on any failed gate."""
    from ceph_tpu_torch import native
    from ceph_tpu_torch.bench.schema import validate_metric
    from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
    from ceph_tpu_torch.ops import _build_host
    from ceph_tpu_torch.utils.crc32c import crc32c, crc32c_sw
    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    lib = native.get_lib()
    load_s = time.perf_counter() - t0
    log(f"native library {lib._name}: g++ build seconds "
        + json.dumps(_build_host.build_seconds)
        + f" (this process; 0 entries: built before it), get_lib "
        f"{load_s:.3f} s")
    rng = np.random.default_rng(SEED)
    buf = rng.integers(0, 256, 1 << 16, dtype=np.uint8)
    if crc32c(buf) != crc32c_sw(buf) or crc32c(buf[::3]) != crc32c_sw(
            buf[::3]):
        raise AssertionError("native crc32c disagrees with crc32c_sw")
    matrix = gf_gen_rs_matrix(K + M, K)
    data = rng.integers(0, 256, (K, CHUNK), dtype=np.uint8)
    from ceph_tpu_torch.ec.rs_codec import MatrixRSCodec
    if not np.array_equal(native.native_rs_encode(matrix[K:], data),
                          MatrixRSCodec(matrix).encode(data)):
        raise AssertionError("native region coder disagrees with the host "
                             "codec")
    log("native crc32c == crc32c_sw, native_rs_encode == MatrixRSCodec")
    scan = encode_batch_scan()
    line, cli_s = bench_cli()
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "bench_line.json"), "w") as f:
        json.dump(line, f, indent=1)
    for m in line["metrics"]:
        validate_metric(m)
        rl = m.get("roofline", {})
        extra = {k: m[k] for k in ("speedup", "batch_occupancy",
                                   "mean_batch_occupancy", "identical",
                                   "serial_gibs", "depth1_gibs")
                 if k in m}
        log(f"bench-cli {m['name']} {m['value']} {m['unit']} fenced="
            f"{m['fenced']} suspect={m.get('suspect', False)} roofline="
            f"{rl.get('verdict', 'n/a')} " + json.dumps(extra)
            + " stats=" + json.dumps(m["stats"]))
    bad = [m["name"] for m in line["metrics"]
           if not m["fenced"] or m.get("suspect", False)]
    pipe = [m for m in line["metrics"] if m["name"] == "ec_pipeline_fenced"]
    if (bad or "error" in line or line.get("decode_parity") is not True
            or len(pipe) != 1 or pipe[0].get("identical") is not True
            or line.get("platform") != "gpu"):
        raise AssertionError(f"bench CLI line failed its gates: bad={bad} "
                             f"error={line.get('error')} parity="
                             f"{line.get('decode_parity')}")
    zc_launches = cluster_cli_gates(line)
    harness = harness_cli_gates(line)
    log("bench-cli crush_remap " + json.dumps(line.get("crush_remap")))
    log(f"bench-cli gate: {len(line['gate']['regressions'])} regressions, "
        f"compared {line['gate']['compared']}, not_ported "
        + json.dumps(line["not_ported"]))
    wall = time.perf_counter() - t_phase
    log(f"bench CLI process took {cli_s:.1f} s; native phase took "
        f"{wall:.1f} s")
    return {"build_seconds": dict(_build_host.build_seconds),
            "get_lib_s": load_s, "cli_s": cli_s, "seconds": wall,
            "encode_batch_scan": scan,
            "metrics": {m["name"]: m["value"] for m in line["metrics"]},
            "crush_remap": line.get("crush_remap"),
            "zero_copy_launches": zc_launches,
            "harness": harness,
            "mesh_metrics": {m["name"]: m for m in line["metrics"]
                             if m["name"] in MESH_METRICS},
            "elapsed_s": line.get("elapsed_s")}


CLUSTER_METRICS = ("traffic_harness", "ec_write_zero_copy",
                   "ec_recovery_storm")


def cluster_cli_gates(line: dict) -> dict:
    """4q (d): the bench CLI's three cluster workloads in ``line`` (the
    CLI's own process).  Raises unless each ran: the traffic run and the
    storm's traffic byte-exact, the storm's objects identical after the
    backfill, the ``zero_copy`` block clear of regress.py's ZERO-COPY
    gate, and the resident leg's writes launching K5, or K1 and K4 where
    the one-pass form does not fit the shape.  Returns the zero-copy
    legs' launches, summed."""
    from ceph_tpu_torch.bench.regress import _zero_copy_gate
    got = {m["name"]: m for m in line["metrics"]}
    missing = [n for n in CLUSTER_METRICS if n not in got]
    if missing or any(n in line["not_ported"] for n in (
            "measure_traffic", "measure_ec_write_zero_copy",
            "measure_recovery_storm")):
        raise AssertionError(f"bench CLI: cluster workloads missing "
                             f"{missing}")
    mt, mz, mr = (got[n] for n in CLUSTER_METRICS)
    zc = mz["zero_copy"]
    res_n = zc["launches"]["resident"]
    fails = _zero_copy_gate(mz["name"], zc)
    if not mt["byte_exact"] or not mr["identical"] or \
            not mr["byte_exact_traffic"] or fails or \
            not (res_n["fused_encode_crc"] > 0 or
                 (res_n["gf_bit_matmul"] > 0 and res_n["crc32c"] > 0)):
        raise AssertionError(
            f"bench CLI cluster gates: traffic byte_exact "
            f"{mt['byte_exact']}, storm identical {mr['identical']} / "
            f"{mr['byte_exact_traffic']}, zero-copy {fails}, resident "
            f"launches {res_n}")
    roll = mt["cluster_rollup"]
    log(f"bench-cli traffic_harness {mt['value']} ops/s, {mt['total_ops']} "
        f"ops, agg p99 {mt['aggregate'].get('p99')} us, cluster rollup "
        + json.dumps({"reply_p99_usec": roll["oplat_p99_usec"].get("reply"),
                      "rates": roll["rates"]}))
    log("bench-cli ec_write_zero_copy " + json.dumps(
        {k: zc[k] for k in ("resident_d2h_bytes_per_op",
                            "resident_copies_per_op", "twin_copies_per_op",
                            "resident_shards", "byte_exact", "launches")})
        + f" resident {mz['value']} ops/s, twin {mz['twin_ops_per_sec']}")
    log("bench-cli ec_recovery_storm " + json.dumps(mr["recovery"]))
    return {n: sum(leg[n] for leg in zc["launches"].values())
            for n in res_n}


HARNESS_METRICS = ("slo_autotune", "composed_chaos")


def harness_cli_gates(line: dict) -> dict:
    """4n: the bench CLI's harnesses on top of the mesh in ``line`` (the
    CLI's own process).  Raises unless the line runs every JAX workload
    (``not_ported`` empty), regress.py's CONTROL and CHAOS gates pass
    both (in the line's own gate and judged again here), every storyline
    is accepted, byte-exact and unwedged, and the autotune is byte-exact
    with no move from its disabled twin.  Returns each workload's wall
    and K1 / K9x launches."""
    from ceph_tpu_torch.bench.regress import _chaos_gate, _control_gate
    got = {m["name"]: m for m in line["metrics"]}
    missing = [n for n in HARNESS_METRICS if n not in got]
    if missing or line["not_ported"] != []:
        raise AssertionError(f"bench CLI: harnesses missing {missing}, "
                             f"not_ported {line['not_ported']}")
    ma, mx = (got[n] for n in HARNESS_METRICS)
    ctrl, chaos = ma["control"], mx["chaos"]
    fails = _control_gate(ma["name"], ctrl) + _chaos_gate(mx["name"], chaos)
    fails += [r for r in line["gate"]["regressions"]
              if r["name"].split(".")[0] in HARNESS_METRICS]
    bad = [r["seed"] for r in chaos["receipts"]
           if not (r["accepted"] and r["byte_exact"]) or r["wedged"]]
    if fails or bad or not chaos["accepted"] or not ctrl["byte_exact"] \
            or ctrl["disabled_moves"] != 0:
        raise AssertionError(
            f"bench CLI harness gates: {fails}, storylines failing {bad}, "
            f"autotune byte_exact {ctrl['byte_exact']}, disabled moves "
            f"{ctrl['disabled_moves']}")
    out = {}
    for m in (ma, mx):
        out[m["name"]] = {"wall_s": m["wall_s"], "value": m["value"],
                          "unit": m["unit"], "launches": m["launches"]}
    out["slo_autotune"]["scenarios"] = {
        n: {k: row[k] for k in ("converge_ticks", "moves", "raised",
                                "cleared", "in_bounds")}
        for n, row in ctrl["scenarios"].items()}
    out["composed_chaos"]["storylines"] = [
        {k: r[k] for k in ("seed", "legs", "accepted", "rounds",
                           "ops_completed", "settle_ticks",
                           "journal_events")}
        for r in chaos["receipts"]]
    for name, rec in out.items():
        log(f"bench-cli {name} " + json.dumps(rec))
    return out


# ---- 4o: osdmaptool on the card; 4m: MemStore with resident bodies -------

# 4o's map: the reference's ceph.conf.withracks layout at BASELINE's 1000-OSD
# straw2 map, 5 racks of 10 hosts of 20 OSDs; --create-from-conf gives jewel
# tunables and a replicated pool (size 3, chooseleaf host) of
# max_osd << pg_bits PGs
TOOL_RACKS, TOOL_HOSTS_PER_RACK, TOOL_PER_HOST = 5, 10, 20
TOOL_PG_BITS = 7                  # 1000 << 7 = 128000 PGs
TOOL_SAMPLE = 2048                # PGs held against the scalar pipeline
TOOL_MARK_OUT = 7
TOOL_UPMAP_MAX = 100
TOOL_DIR = os.path.join("build", "osdmaptool")


def withracks_conf() -> str:
    """``[osd.N]`` sections with ``host`` and ``rack``, as
    ceph.conf.withracks writes them."""
    lines, osd = [], 0
    for r in range(TOOL_RACKS):
        for h in range(TOOL_HOSTS_PER_RACK):
            for _ in range(TOOL_PER_HOST):
                lines += [f"[osd.{osd}]",
                          f"\thost = host{r * TOOL_HOSTS_PER_RACK + h}",
                          f"\track = rack{r}", ""]
                osd += 1
    return "\n".join(lines)


def osdmaptool_slice(dev) -> dict:
    """4o: ``osdmaptool`` (``tools/osdmaptool.main``, ``device`` the card)
    on the 1000-OSD conf map at 128000 PGs: ``--test-map-pgs`` through
    ``OSDMapMapping`` on K7a/K7b/K6 (the counts set to 0 just before each
    run and read just after; every pool on the card, no PG mapped on the
    host), a sample of its rows against the scalar pipeline; then
    ``--mark-out 7 --upmap --upmap-save`` and ``--test-map-pgs`` again,
    the upmapped PGs and a sample against the scalar pipeline on the
    saved map."""
    import contextlib
    import io
    from ceph_tpu_torch.ops import crush_fast as cf, crush_kernels as ck
    from ceph_tpu_torch.osdmap import OSDMapMapping, pg_t
    from ceph_tpu_torch.osdmap.simple_build import mark_up_in
    from ceph_tpu_torch.tools import osdmaptool

    os.makedirs(TOOL_DIR, exist_ok=True)
    conf = os.path.join(TOOL_DIR, "withracks.conf")
    om = os.path.join(TOOL_DIR, "om")
    upf = os.path.join(TOOL_DIR, "upmap.txt")
    with open(conf, "w") as f:
        f.write(withracks_conf())
    counters = {"crush_descend": cf.descend_launches,
                "crush_resolve": cf.resolve_launches,
                "crush_rule": ck.rule_launches}
    # the update's two halves: the raw batch (the card's mapper, rows
    # fetched) and the host post-pass (up/acting, primaries)
    split = {"_raw_batch": 0.0, "_postprocess": 0.0}
    orig = {n: getattr(OSDMapMapping, n) for n in split}

    def timed(name):
        def run(*a, **kw):
            t0 = time.perf_counter()
            try:
                return orig[name](*a, **kw)
            finally:
                split[name] += time.perf_counter() - t0
        return run

    mappings = []
    tool_map_pgs = osdmaptool.test_map_pgs

    def keep_mapping(*a, **kw):
        mappings.append(tool_map_pgs(*a, **kw))
        return mappings[-1]

    def tool(argv):
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = osdmaptool.main(argv, device=dev.type)
        wall = time.perf_counter() - t0
        if rc != 0:
            raise AssertionError(f"osdmaptool {argv}: exit {rc}")
        return buf.getvalue(), wall

    def map_pgs(argv, what):
        for c in counters.values():
            c.reset()
        for n in split:
            split[n] = 0.0
        out, wall = tool(argv)
        counts = {n: c.n for n, c in counters.items()}
        mm = mappings[-1]
        want = "device" if dev.type == "cuda" else "cpu"
        if mm.last_backend != {1: want} or mm.host_replayed != {1: 0}:
            raise AssertionError(f"{what}: last_backend {mm.last_backend}, "
                                 f"host_replayed {mm.host_replayed}")
        if not all(counts.values()):
            raise AssertionError(f"{what}: a CRUSH kernel did not launch: "
                                 f"{counts}")
        lines = out.splitlines()
        pg_num = TOOL_RACKS * TOOL_HOSTS_PER_RACK * TOOL_PER_HOST \
            << TOOL_PG_BITS
        if f"pool 1 pg_num {pg_num}" not in lines or \
                f"size 3\t{pg_num}" not in lines:
            raise AssertionError(f"{what}: not every PG mapped to 3 OSDs")
        with open(os.path.join("chiprun_out", f"osdmaptool_{what}.txt"),
                  "w") as f:
            f.write(out)
        r = {"wall_s": wall, "device_update_s": split["_raw_batch"],
             "host_postpass_s": split["_postprocess"],
             "launches": counts, "last_backend": mm.last_backend,
             "host_replayed": mm.host_replayed,
             "stats": [ln for ln in lines if ln.startswith((" ", "mapped"))]}
        log(f"4o {what}: " + json.dumps(r))
        return r, mm

    def scalar_check(mm, m, pss, what):
        for ps in pss:
            pg = pg_t(1, int(ps))
            if mm.get(pg) != tuple(m.pg_to_up_acting_osds(pg)):
                raise AssertionError(f"{what}: pg {pg} {mm.get(pg)} != "
                                     f"scalar {m.pg_to_up_acting_osds(pg)}")
        return len(pss)

    os.makedirs("chiprun_out", exist_ok=True)
    res = {}
    for n in split:
        setattr(OSDMapMapping, n, timed(n))
    osdmaptool.test_map_pgs = keep_mapping
    try:
        _, res["create_s"] = tool(
            ["--create-from-conf", om, "-c", conf, "--with-default-pool",
             "--pg_bits", str(TOOL_PG_BITS), "--pgp_bits", str(TOOL_PG_BITS),
             "--clobber"])
        res["test_map_pgs"], mm = map_pgs([om, "--mark-up-in",
                                           "--test-map-pgs"], "map_pgs")
        with open(om, "rb") as f:
            m = osdmaptool.load_map(f.read())
        mark_up_in(m)                 # the tool's --mark-up-in, unsaved
        pg_num = m.pools[1].pg_num
        rng = np.random.default_rng(SEED + 4)
        sample = np.sort(rng.choice(pg_num, TOOL_SAMPLE, replace=False))
        t0 = time.perf_counter()
        res["sample_checked"] = scalar_check(mm, m, sample, "map_pgs")
        res["sample_check_s"] = time.perf_counter() - t0
        out, res["upmap_s"] = tool(
            [om, "--mark-up-in", "--mark-out", str(TOOL_MARK_OUT), "--upmap",
             upf, "--upmap-max", str(TOOL_UPMAP_MAX), "--upmap-deviation",
             ".01", "--upmap-save"])
        with open(upf) as f:
            cmds = f.read().splitlines()
        res["upmap_changes"] = len(cmds)
        res["upmap_pgs"] = pg_num
        log(f"4o upmap: {len(cmds)} changes over {pg_num} PGs in "
            f"{res['upmap_s']:.2f} s (tool wall, the map's load and save "
            f"included)")
        if not cmds:
            raise AssertionError("4o: the upmap step proposed nothing")
        res["test_map_pgs_upmap"], mm = map_pgs([om, "--test-map-pgs"],
                                                "map_pgs_upmap")
        with open(om, "rb") as f:
            m = osdmaptool.load_map(f.read())
        if len(m.pg_upmap_items) != len(
                [c for c in cmds if "pg-upmap-items" in c]) or \
                m.osd_weight[TOOL_MARK_OUT] != 0:
            raise AssertionError("4o: the saved map lacks the upmap items "
                                 "or the mark-out")
        upmapped = sorted(pg.ps for pg in m.pg_upmap_items)
        t0 = time.perf_counter()
        res["upmap_sample_checked"] = scalar_check(
            mm, m, sorted(set(upmapped) | set(sample.tolist())),
            "map_pgs_upmap")
        res["upmap_sample_check_s"] = time.perf_counter() - t0
    finally:
        for n, fn in orig.items():
            setattr(OSDMapMapping, n, fn)
        osdmaptool.test_map_pgs = tool_map_pgs
    res["launches"] = {n: res["test_map_pgs"]["launches"][n]
                       + res["test_map_pgs_upmap"]["launches"][n]
                       for n in counters}
    log(f"4o: rows of {res['sample_checked']} sampled PGs and of "
        f"{res['upmap_sample_checked']} PGs (every upmapped one) after "
        "--upmap-save equal the scalar pg_to_up_acting_osds")
    return res


class Daemons:
    """The daemons of one in-process cluster, assembled from ``pkg`` (a
    package name: ``ceph_tpu_torch``, or the JAX package for the CPU
    twin tests) as the JAX package's ``MiniCluster`` assembles them
    without its ``Manager``: one ``Network``; the monitors (one, or a
    quorum whose rank 0 wins the first election), with
    ``bootstrap(n_osds, 1)`` (one OSD per host); the OSDs, each subscribed; the
    idle hook that flushes the dispatch scheduler, drains threaded op
    queues and sweeps unacked sub-writes; ``tick`` without the mgr's
    tick, then recovery; ``scrub``; ``run_recovery``; and the thrasher
    controls.  A client is ``client()``, the user's ``RadosClient``;
    ``burst_write_full`` keeps many of its writes in flight at once, as
    the JAX traffic harness's clients do.  ``stores`` mounts a given
    object store (osd id -> store) in place of a fresh ``MemStore``."""

    def __init__(self, pkg: str, n_osds: int, n_mons: int = 1,
                 stores=None):
        import importlib
        self.pkg = pkg
        msg = importlib.import_module(pkg + ".msg")
        mon_mod = importlib.import_module(pkg + ".mon.monitor")
        osd_mod = importlib.import_module(pkg + ".osd.osd")
        self._rados = importlib.import_module(pkg + ".client.rados")
        self._msgs = importlib.import_module(pkg + ".msg.messages")
        self._oplat = importlib.import_module(pkg + ".trace.oplat")
        self._dispatch = importlib.import_module(pkg + ".dispatch")
        self.network = msg.Network()
        if n_mons == 1:
            self.mons = [mon_mod.Monitor(self.network)]
        else:
            names = [f"mon.{r}" for r in range(n_mons)]
            self.mons = [mon_mod.Monitor(
                self.network, name=names[r], rank=r,
                peers=[n for n in names if n != names[r]])
                for r in range(n_mons)]
        self.mons[0].bootstrap(n_osds, 1)
        if n_mons > 1:
            self.mons[0].start_election()
            self.network.pump()
            self.mons[0].publish()
            self.network.pump()
        mon_names = [m.name for m in self.mons]
        self._osd_mod = osd_mod
        self.osds = {}
        for i in range(n_osds):
            osd = osd_mod.OSD(self.network, i,
                              store=(stores or {}).get(i),
                              mon_name=mon_names[0], mon_names=mon_names)
            self.osds[i] = osd
            for m in self.mons:
                m.subscribe(osd.name)
        if n_mons > 1:
            for osd in self.osds.values():
                self.mons[0].send_full_map(osd.name)
            self.network.pump()
        self.clock = 0.0
        self.network.add_idle_hook(self._idle_kick)

    def _live_osds(self):
        return [o for o in self.osds.values()
                if o.name not in self.network.down]

    def _idle_kick(self) -> bool:
        g = self._dispatch.g_dispatcher
        did = bool(g.pending_count() and g.flush())
        for osd in self._live_osds():
            if len(osd.op_wq):
                if osd.op_tp is not None:
                    osd.drain_ops()
                    did = True
                else:
                    did = bool(osd.drain_ops()) or did
        if did:
            return True
        for osd in self._live_osds():
            for pg in osd.pgs.values():
                be = pg.backend
                if be is not None and be.inflight_writes:
                    did = bool(be.sweep_inflight(idle=True)) or did
        return did

    @property
    def mon(self):
        """The live leader (the only monitor of a one-mon cluster)."""
        live = [m for m in self.mons if m.name not in self.network.down]
        for m in live:
            if m.is_leader():
                return m
        return live[0] if live else self.mons[0]

    def shutdown(self) -> None:
        for osd in self.osds.values():
            osd.shutdown()

    def client(self, name: str = "client.0"):
        return self._rados.RadosClient(self.network, self.mon, name)

    def burst_write_full(self, cl, pool: str, items: dict,
                         deadline_s: float = 120.0) -> dict:
        """Send a ``writefull`` of every (oid, body) of ``items`` from
        client ``cl`` before pumping any, then pump until each has its
        reply or ``deadline_s`` passes; returns oid -> result (None for
        an op that got no reply)."""
        pool_id = cl.lookup_pool(pool)
        tids = {}
        for oid, body in items.items():
            pgid, primary = cl._calc_target(pool_id, oid)
            cl._tid += 1
            msg = self._msgs.MOSDOp(
                tid=cl._tid, pool=pgid[0], oid=oid, pgid=pgid,
                op=self._msgs.CEPH_OSD_OP_WRITEFULL, data=body,
                epoch=cl.osdmap.epoch)
            self._oplat.stamp_client(msg, cl.name)
            cl.messenger.send_message(msg, f"osd.{primary}")
            tids[cl._tid] = oid
        t_end = time.monotonic() + deadline_s
        while True:
            moved = self.network.pump()
            if all(t in cl._replies for t in tids) or \
                    time.monotonic() > t_end:
                break
            if not moved:
                time.sleep(0.001)
        return {oid: (cl._replies.pop(t).result if t in cl._replies
                      else None) for t, oid in tids.items()}

    def publish(self) -> None:
        self.mon.publish()
        self.network.pump()
        self.run_recovery()

    def create_ec_pool(self, name: str, profile: dict, pg_num: int,
                       ec_overwrites: bool = True) -> int:
        pname = f"{name}_profile"
        self.mon.create_ec_profile(pname, profile)
        pid = self.mon.create_ec_pool(name, pname, pg_num,
                                      ec_overwrites=ec_overwrites)
        self.publish()
        return pid

    def create_replicated_pool(self, name: str, size: int,
                               pg_num: int) -> int:
        pid = self.mon.create_replicated_pool(name, size, pg_num)
        self.publish()
        return pid

    def tick(self, dt: float = 1.0, rounds: int = 1) -> None:
        for _ in range(rounds):
            self.clock += dt
            for m in self.mons:
                if m.name not in self.network.down:
                    m.tick(self.clock)
            for osd in self._live_osds():
                osd.tick(self.clock)
            self.network.pump()
        self.run_recovery()

    def scrub(self, deep: bool = True) -> None:
        for osd in self._live_osds():
            for pg in osd.pgs.values():
                if pg.is_primary():
                    pg.start_scrub(deep=deep)
        self.network.pump()
        self.run_recovery()

    def run_recovery(self, max_rounds: int = 4) -> int:
        total = 0
        for _ in range(max_rounds):
            pushed = sum(osd.run_recovery() for osd in self._live_osds())
            self.network.pump()
            total += pushed
            if not pushed:
                break
        return total

    def kill_osd(self, osd_id: int) -> None:
        self.network.set_down(f"osd.{osd_id}", True)

    def revive_osd(self, osd_id: int) -> None:
        self.network.set_down(f"osd.{osd_id}", False)
        self.mon.mark_osd_up(osd_id)
        self.mon.send_full_map(f"osd.{osd_id}")
        self.network.pump()
        self.run_recovery()

    def replace_osd(self, osd_id: int) -> None:
        """A replaced disk: a fresh daemon with an empty ``MemStore``
        under the same id, marked up and in; recovery backfills it.  The
        daemon starts at the cluster's clock, as a process reads the
        wall clock its peers read: at 0 it would take every peer for
        silent since then and report each one failed on its first
        tick."""
        old = self.osds[osd_id]
        old.shutdown()
        self.network.set_down(old.name, False)
        osd = self._osd_mod.OSD(self.network, osd_id,
                                mon_name=old.mon_name,
                                mon_names=old.mon_names)
        osd.now = self.clock
        self.osds[osd_id] = osd
        for m in self.mons:
            m.subscribe(osd.name)
        self.mon.mark_osd_up(osd_id)
        self.mon.mark_osd_in(osd_id)
        self.mon.send_full_map(osd.name)
        self.network.pump()
        self.run_recovery()

    def kill_mon(self, rank: int) -> None:
        self.network.set_down(self.mons[rank].name, True)

    def mark_osd_down(self, osd_id: int) -> None:
        self.mon.mark_osd_down(osd_id)
        self.network.pump()
        self.run_recovery()

    def mark_osd_out(self, osd_id: int) -> None:
        self.mon.mark_osd_out(osd_id)
        self.network.pump()
        self.run_recovery()

    def mark_osd_in(self, osd_id: int) -> None:
        self.mon.mark_osd_in(osd_id)
        self.network.pump()
        self.run_recovery()


def memstore_slice(objs, dev) -> dict:
    """4m: the resident write (K5) of the 64 objects of 4 MiB, k=8 m=4
    reed_sol_van, into 12 ``MemStore``s (one per shard) through
    ``write_shard`` transactions; ``read_shard`` returns every handle with
    no device-to-host bytes; the device verify (K4) of every stored body
    passes; ``store.shard_corrupt`` on one shard, and the verify flags that
    shard and no other; ``read`` of every shard equals the host encode
    (the corrupted one differs in its first byte alone)."""
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.fault import g_faults
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    from ceph_tpu_torch.os_store import (DeviceShard, MemStore, Transaction,
                                         hobject_t)
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.trace import g_devprof
    import gc
    gc.collect()                  # earlier phases' bodies leave the budget
    n = K + M
    sinfo = ecutil.stripe_info_t(K, K * CHUNK)
    spo = OBJ_BYTES // sinfo.get_stripe_width()
    g_conf.set_val("os_memstore_device_bytes_max", RESIDENT_BUDGET)
    prof = {"plugin": "cuda", "k": str(K), "m": str(M),
            "technique": "reed_sol_van"}
    codec = create_erasure_code(prof)
    stores = [MemStore() for _ in range(n)]
    cids = [f"1.0s{i}" for i in range(n)]
    for st, cid in zip(stores, cids):
        t = Transaction()
        t.create_collection(cid)
        st.queue_transaction(t)

    def ho(o, i):
        return hobject_t(f"obj{o}", i)

    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crc32c": crc32c_device.launches,
                "fused_encode_crc": fused_encode_crc.launches}
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    for o, obj in enumerate(objs):
        shards = resident.encode_resident_shards(
            codec, obj.reshape(spo, K, CHUNK))
        for i in range(n):
            t = Transaction()
            t.write_shard(cids[i], ho(o, i), shards[i])
            stores[i].queue_transaction(t)
    torch.cuda.synchronize()
    write_s = time.perf_counter() - t0
    counts = {name: c.n for name, c in counters.items()}
    if counts != {"gf_bit_matmul": 0, "crc32c": 0,
                  "fused_encode_crc": len(objs)}:
        raise AssertionError(f"4m: the resident write is not one K5 launch "
                             f"per object: {counts}")
    del shards

    # read_shard: the handles themselves, nothing copied to the host
    d2h0 = g_devprof.totals()["d2h_bytes"]
    t0 = time.perf_counter()
    handles = [[stores[i].read_shard(cids[i], ho(o, i)) for i in range(n)]
               for o in range(len(objs))]
    read_shard_s = time.perf_counter() - t0
    d2h = g_devprof.totals()["d2h_bytes"] - d2h0
    if d2h or not all(isinstance(h, DeviceShard) and h.is_resident
                      for row in handles for h in row):
        raise AssertionError(f"4m: read_shard moved {d2h} B to the host "
                             "or returned a body that is not resident")

    def verify():
        crc32c_device.launches.reset()
        bad = [(o, i) for o, row in enumerate(handles)
               for i, h in enumerate(row)
               if crc32c_device.crc32c_of_device_array(h.device_array())
               != h.crc]
        return bad, crc32c_device.launches.n

    t0 = time.perf_counter()
    bad, k4 = verify()
    verify_s = time.perf_counter() - t0
    if bad or not k4:
        raise AssertionError(f"4m: verify flagged {bad}, K4 launches {k4}")
    victim = (5, 3)
    g_faults.inject("store.shard_corrupt", mode="once",
                    match=f"{cids[victim[1]]}/{ho(*victim)}")
    try:
        stores[victim[1]].read_shard(cids[victim[1]], ho(*victim))
    finally:
        g_faults.clear()
    bad, k4_after = verify()
    if bad != [victim] or not k4_after:
        raise AssertionError(f"4m: after store.shard_corrupt on {victim} "
                             f"the verify flagged {bad}")

    # read: every body on the host, against the host encode
    host = create_erasure_code(dict(prof, backend="host"))
    t0 = time.perf_counter()
    got = [[stores[i].read(cids[i], ho(o, i)) for i in range(n)]
           for o in range(len(objs))]
    read_s = time.perf_counter() - t0
    for o, obj in enumerate(objs):
        want = ecutil.encode(sinfo, host, obj, set(range(n)))
        for i in range(n):
            w = want[i].tobytes()
            if (o, i) == victim:
                w = bytes([w[0] ^ 1]) + w[1:]
            if got[o][i] != w:
                raise AssertionError(f"4m: read of object {o} shard {i} "
                                     "differs from the host encode")
    res = {"write_s": write_s, "read_shard_s": read_shard_s,
           "verify_s": verify_s, "read_s": read_s,
           "write_GiBps": len(objs) * OBJ_BYTES / write_s / 2**30,
           "read_shard_d2h_bytes": d2h,
           "launches": {"fused_encode_crc": counts["fused_encode_crc"],
                        "crc32c": k4 + k4_after},
           "flagged": [list(victim)], "bodies": len(objs) * n}
    log("4m: " + json.dumps(res))
    return res


# -- 4p. the OSD data path ---------------------------------------------------
OSD_PATH_OSDS = 12                # one per host, crush-failure-domain=host
OSD_PATH_PG_NUM = 128             # Ceph's ~100 PGs per OSD
SMOKE_PG_NUM = 32                 # 4p's, 4q's and 4x's in the whole smoke
OSD_PATH_SMALL = 64 << 10         # (e)'s writes
OSD_PATH_DEADLINE_S = 60.0        # the most any one op may take
REGEN_PROFILE = {"plugin": "regenerating", "k": "8", "m": "4", "d": "10"}
REGEN_OBJ_BYTES = 1 << 20


class OpGate:
    """Every client op of 4p goes through ``call``: it must return
    within ``OSD_PATH_DEADLINE_S`` and, for a write, with result 0."""

    def __init__(self):
        self.ops = 0
        self.slowest_s = 0.0

    def call(self, what, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        dt = time.perf_counter() - t0
        self.ops += 1
        self.slowest_s = max(self.slowest_s, dt)
        if dt > OSD_PATH_DEADLINE_S:
            raise AssertionError(f"4p: {what} took {dt:.1f} s")
        if isinstance(out, int) and out != 0:
            raise AssertionError(f"4p: {what} answered {out}")
        return out


def stored_bodies(d, pool_id: int, keys_only: bool = False,
                  only=None) -> dict:
    """(oid, shard) -> stored body bytes of every object of ``pool_id``
    (of the oids in ``only`` where given), read straight from the live
    OSDs' stores (resident bodies are fetched; with ``keys_only`` nothing
    is read and the values are None)."""
    out = {}
    for osd in d.osds.values():
        if osd.name in d.network.down:
            continue
        st = osd.store
        for cid in st.list_collections():
            if not cid.startswith(f"{pool_id}.") or cid.endswith("_meta"):
                continue
            for ho in st.list_objects(cid):
                if only is not None and ho.oid not in only:
                    continue
                if ho.shard >= 0:
                    out[(ho.oid, ho.shard)] = None if keys_only \
                        else st.read(cid, ho)
    return out


def native_shards(matrix: np.ndarray, k: int, chunk: int,
                  body: bytes) -> list:
    """Every shard body of ``body`` (zero-padded to whole stripes) by the
    native host coder: the data rows, then ``matrix``'s coding rows."""
    from ceph_tpu_torch.native import native_rs_encode
    w = k * chunk
    buf = np.frombuffer(body + b"\0" * (-len(body) % w), dtype=np.uint8)
    rows = np.ascontiguousarray(
        buf.reshape(-1, k, chunk).transpose(1, 0, 2)).reshape(k, -1)
    coding = native_rs_encode(matrix[k:], rows)
    return [rows[i].tobytes() for i in range(k)] + \
        [coding[j].tobytes() for j in range(coding.shape[0])]


def check_bodies(d, pool_id, expect: dict, what: str,
                 skip_shards=None) -> int:
    """Every stored body of ``expect``'s objects equals its expected
    shard; each object has every shard but those in ``skip_shards``
    (oid -> shards held by OSDs still down).  Returns the bodies held."""
    got = stored_bodies(d, pool_id, only=set(expect))
    n = 0
    for oid, shards in expect.items():
        held = {s for (o, s) in got if o == oid}
        missing = set(range(len(shards))) - held - \
            set((skip_shards or {}).get(oid, ()))
        if missing:
            raise AssertionError(f"4p {what}: {oid} lacks shards "
                                 f"{sorted(missing)}")
        for s in held:
            if got[(oid, s)] != shards[s]:
                raise AssertionError(f"4p {what}: {oid} shard {s} differs "
                                     "from the reference coder")
            n += 1
    return n


def acting_of(d, cl, pool: str, oid: str) -> list:
    """The acting set of ``oid``'s PG on ``d`` (``Daemons`` or a
    ``MiniCluster``), by the monitor's map."""
    import importlib
    pkg = getattr(d, "pkg", None) or type(d).__module__.split(".")[0]
    pg_t = importlib.import_module(pkg + ".osdmap").pg_t
    pgid, _ = cl._calc_target(cl.lookup_pool(pool), oid)
    return [int(o) for o in d.mon.osdmap.pg_to_up_acting_osds(
        pg_t(*pgid))[2]]


class LegTrace:
    """The separate traced run of a leg: ``g_kernel_timer`` on (each
    timed device call ends in a synchronise) and, on the card, a
    ``torch.profiler`` trace of every thread (the op queue's workers
    launch too), whose CUDA kernel time by name is summed.  Gives the
    share of the leg's wall spent in the port's kernels and in all
    device work (kernels and copies).  ``counters`` are the kernels'
    launch counters: where they moved but the trace holds none of the
    kernels, the kernel time is null (unseen), not zero."""

    # the port's kernels on this path by their CUDA names: K1 (and its
    # first design), K4 (both paths) and K5
    KERNELS = ("gf_nibble_kernel", "gf_popc_kernel", "crc32c",
               "fused_encode_crc")

    def __init__(self, dev, counters):
        self.dev = dev
        self.counters = counters

    def __enter__(self):
        from ceph_tpu_torch.common.kernel_trace import g_kernel_timer
        self.timer = g_kernel_timer
        self.timer.reset()
        self.timer.enable(True)
        self.prof = None
        self.n0 = sum(c.n for c in self.counters)
        if self.dev.type == "cuda":
            acts = [torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]
            try:
                from torch._C._profiler import _ExperimentalConfig
                cfg = {"experimental_config":
                       _ExperimentalConfig(profile_all_threads=True)}
            except (ImportError, TypeError):
                cfg = {}
            self.all_threads = bool(cfg)
            self.prof = torch.profiler.profile(activities=acts, **cfg)
            self.prof.start()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.dev.type == "cuda":
            torch.cuda.synchronize()
        self.wall = time.perf_counter() - self.t0
        self.launched = sum(c.n for c in self.counters) - self.n0
        self.timer.enable(False)
        calls = self.timer.dump()
        self.device_call_s = sum(c["total_s"] for c in calls.values())
        self.kernel_ms = self.device_ms = None
        if self.prof is not None:
            self.prof.stop()
            kern = dev_all = 0.0
            for e in self.prof.key_averages():
                t = getattr(e, "self_device_time_total", None)
                if t is None:
                    t = getattr(e, "self_cuda_time_total", 0.0)
                if not t:
                    continue
                dev_all += t
                if any(k in e.key for k in self.KERNELS):
                    kern += t
            if kern or not self.launched:
                self.kernel_ms = kern / 1e3
            if dev_all:
                self.device_ms = dev_all / 1e3
        return False

    def reading(self) -> dict:
        w = self.wall
        return {
            "traced_wall_s": w, "traced_launches": self.launched,
            "profiled_all_threads": getattr(self, "all_threads", None),
            "kernel_ms": self.kernel_ms, "device_busy_ms": self.device_ms,
            "kernel_share": (self.kernel_ms / 1e3 / w
                             if self.kernel_ms is not None else None),
            "device_busy_share": (self.device_ms / 1e3 / w
                                  if self.device_ms is not None else None),
            "timed_device_calls_s": self.device_call_s,
            "timed_device_call_share": self.device_call_s / w}


def osd_path_slice(dev, obj_bytes: int = OBJ_BYTES, n_obj: int = N_OBJ,
                   pg_num: int = OSD_PATH_PG_NUM,
                   small_bytes: int = OSD_PATH_SMALL,
                   regen_bytes: int = REGEN_OBJ_BYTES,
                   trace_rebuilds: bool = False) -> dict:
    """4p: a client's writes and reads through the port's daemons (the
    monitor, 12 OSDs with their PGs and ``ECBackend``s, the RADOS client),
    built by ``Daemons``, on a k=8 m=4 ``plugin=cuda`` pool:

    (a) ``write_full`` of the 64 objects of 4 MiB: K1 once per write;
        every stored body equals the native host coder's; reads, a
        ranged read, a partial overwrite and an append (rmw), after which
        the bodies equal a fresh encode of the final content;
    (b) the OSDs holding shards 1 and 9 of obj0's PG go down: every
        object reads back byte-exact, K1 decoding the lost data shards;
    (c) one of them has its disk replaced (an empty store under the
        same id, marked up; 12 shards fill the 12 hosts, so an out OSD's
        shards would have no other home): recovery rebuilds its shards
        there, equal to the native coder's;
    (d) residency on (4 GiB), on a fresh cluster: the writes launch K5
        once each and K1 never; reading them back launches K4 once per
        resident data body; one body rotted at ``store.shard_corrupt``
        fails its sub-read alone and the primary decodes (K1); deep
        scrub hashes on the host, launching no K4;
    (e) 4 op threads, pipeline depth 8 and a collection window: a burst
        of 64 writes of 64 KiB from many PGs, K1 once per dispatcher
        flush, at least one flush of more than one request, no re-run;
    (f) a regenerating pool (pm_mbr k=8 m=4 d=10): writes, one OSD
        down and its disk replaced, recovery by sub-chunk repair rounds
        with no fallback; the bytes equal the port's ``backend=host``
        codec.

    Each leg's counts are reset just before it and read just after;
    writes and reads get a reply within ``OSD_PATH_DEADLINE_S`` and
    answer 0.  Walls are host clocks around work whose replies carry
    host bytes (each op's device work is complete); each leg but the two
    rebuilds is run once more under ``LegTrace`` for its kernel share;
    with ``trace_rebuilds`` (``--osd-path``) so are (c) and (f), each on a
    second OSD whose disk is replaced (~35 s each on the card, left out
    of the whole smoke to keep it inside its time limit).  On the CPU (a
    rehearsal at small sizes) the codecs take ``backend=host`` and the
    launch counts are not checked."""
    import gc
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import dispatch_perf_counters, g_dispatcher
    from ceph_tpu_torch.dispatch import scheduler as dsched
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.fault import g_faults
    from ceph_tpu_torch.ops import (crc32c_device, fused_encode_crc,
                                    gf_pallas, resident)
    from ceph_tpu_torch.os_store.device_shard import (
        l_msd_crc_device, l_msd_crc_host, memstore_device_perf_counters)
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.osd.ec_backend import (l_pipeline_errors,
                                               pipeline_perf_counters)
    from ceph_tpu_torch.recovery import (l_recovery_fallbacks,
                                         l_recovery_repair_rounds,
                                         recovery_perf_counters)
    on_card = dev.type == "cuda"
    backend = {} if on_card else {"backend": "host"}
    prof = {"plugin": "cuda", "k": str(K), "m": str(M),
            "crush-failure-domain": "host", **backend}
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crc32c": crc32c_device.launches,
                "fused_encode_crc": fused_encode_crc.launches,
                "resident_calls": resident.launches}
    total = {n: 0 for n in counters}
    kernel_counters = [counters[n] for n in ("gf_bit_matmul", "crc32c",
                                             "fused_encode_crc")]
    gate = OpGate()
    out = {"legs": {}, "config": {
        "osds": OSD_PATH_OSDS, "pg_num": pg_num, "profile": prof,
        "objects": n_obj, "object_bytes": obj_bytes,
        "small_bytes": small_bytes, "regen_profile": REGEN_PROFILE,
        "regen_object_bytes": regen_bytes,
        "deadline_s": OSD_PATH_DEADLINE_S}}
    t_slice = time.perf_counter()

    def reset():
        for c in counters.values():
            c.reset()

    def read_counts():
        got = {n: c.n for n, c in counters.items()}
        for n, v in got.items():
            total[n] += v
        return got

    def leg(name, wall, nbytes, launches, **extra):
        rec = {"wall_s": wall, "bytes": nbytes,
               "GiBps": nbytes / wall / 2**30 if wall else None,
               "launches": launches, **extra}
        out["legs"][name] = rec
        log(f"4p {name}: " + json.dumps(rec))
        return rec

    def traced(rec, tr):
        rec["trace"] = tr.reading()
        log("4p traced run: " + json.dumps(rec["trace"]))

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4p: {what}")

    def rebuild(d, pid, osd_id, want):
        """Replace ``osd_id``'s disk (an empty store under the same id,
        marked up) and tick until every (oid, shard) of ``want`` is
        stored again; ``check_bodies`` then finds any that is not."""
        t1 = time.perf_counter()
        d.replace_osd(osd_id)
        log(f"4p: osd.{osd_id}'s disk replaced in "
            f"{time.perf_counter() - t1:.1f} s")
        for i in range(10):
            t1 = time.perf_counter()
            d.tick(1.0)
            log(f"4p: recovery tick {i} {time.perf_counter() - t1:.1f} s")
            if want <= set(stored_bodies(d, pid, keys_only=True)):
                return

    # earlier phases leave residency and the dispatch options set: every
    # leg starts from the defaults, and sets what it states itself
    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "osd_op_num_threads", "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    # a device error caught on the way (the dispatcher's per-request
    # re-run of a failed flush, an encode future resolved with an error)
    # fails 4p even where the op still got its reply
    dpc, ppc = dispatch_perf_counters(), pipeline_perf_counters()
    caught0 = (dpc.get(dsched.l_dispatch_fallbacks),
               dpc.get(dsched.l_dispatch_errors),
               ppc.get(l_pipeline_errors))
    rng = np.random.default_rng(SEED + 4)
    objs = {f"obj{i}": rng.integers(0, 256, obj_bytes,
                                    dtype=np.uint8).tobytes()
            for i in range(n_obj)}
    matrix = create_erasure_code({**prof, "backend": "host"}).codec.matrix

    # -- (a) write -------------------------------------------------------------
    t0 = time.perf_counter()
    d = Daemons("ceph_tpu_torch", OSD_PATH_OSDS)
    pid = d.create_ec_pool("ec", prof, pg_num)
    cl = d.client()
    out["boot_s"] = time.perf_counter() - t0
    log(f"4p: 12 OSDs and a pool of {pg_num} PGs up in "
        f"{out['boot_s']:.1f} s")
    reset()
    t0 = time.perf_counter()
    for oid, body in objs.items():
        gate.call(f"write_full {oid}", cl.write_full, "ec", oid, body)
    wall = time.perf_counter() - t0
    n = read_counts()
    need(n["gf_bit_matmul"] == n_obj, f"(a) K1 launches {n} for {n_obj} "
         "encodes")
    expect = {oid: native_shards(matrix, K, CHUNK, b)
              for oid, b in objs.items()}
    held = check_bodies(d, pid, expect, "(a)")
    if held != n_obj * (K + M):
        raise AssertionError(f"4p (a): {held} bodies stored")
    rec = leg("a_write", wall, n_obj * obj_bytes, n, bodies_checked=held)
    reset()
    t0 = time.perf_counter()
    for oid, body in objs.items():
        if gate.call(f"read {oid}", cl.read, "ec", oid) != body:
            raise AssertionError(f"4p (a): read of {oid} differs")
    rec["read_wall_s"] = time.perf_counter() - t0
    rec["read_GiBps"] = n_obj * obj_bytes / rec["read_wall_s"] / 2**30
    off, ln = obj_bytes // 4 + 123, obj_bytes // 3
    if gate.call("ranged read", cl.read, "ec", "obj5", off, ln) != \
            objs["obj5"][off:off + ln]:
        raise AssertionError("4p (a): ranged read differs")
    final = dict(objs)
    patch = rng.integers(0, 256, obj_bytes // 40, dtype=np.uint8).tobytes()
    at = obj_bytes * 3 // 8 + 77
    gate.call("overwrite", cl.write, "ec", "obj1", patch, at)
    final["obj1"] = objs["obj1"][:at] + patch + objs["obj1"][at + len(patch):]
    tail = rng.integers(0, 256, obj_bytes // 13, dtype=np.uint8).tobytes()
    gate.call("append", cl.append, "ec", "obj2", tail)
    final["obj2"] = objs["obj2"] + tail
    for oid in ("obj1", "obj2"):
        expect[oid] = native_shards(matrix, K, CHUNK, final[oid])
        if gate.call(f"read {oid}", cl.read, "ec", oid) != final[oid]:
            raise AssertionError(f"4p (a): {oid} after rmw differs")
    check_bodies(d, pid, {o: expect[o] for o in ("obj1", "obj2")},
                 "(a) rmw")
    rec["rmw_launches"] = read_counts()
    with LegTrace(dev, kernel_counters) as tr:
        for i, body in enumerate(objs.values()):
            gate.call("traced write", cl.write_full, "ec", f"t{i}", body)
    traced(rec, tr)
    reset()

    # -- (b) degraded read -----------------------------------------------------
    acting = acting_of(d, cl, "ec", "obj0")
    victims = [acting[1], acting[9]]
    placed = {oid: acting_of(d, cl, "ec", oid) for oid in final}
    lost = {oid: [s for s, o in enumerate(a) if o in victims]
            for oid, a in placed.items()}
    for o in victims:
        d.kill_osd(o)
    t0 = time.perf_counter()
    for i in range(10):
        t1 = time.perf_counter()
        d.tick(6.0)
        log(f"4p (b): tick {i} {time.perf_counter() - t1:.1f} s")
        if all(not d.mon.osdmap.is_up(o) for o in victims):
            break
    if any(d.mon.osdmap.is_up(o) for o in victims):
        raise AssertionError(f"4p (b): osds {victims} never marked down")
    mark_s = time.perf_counter() - t0
    decodes = sum(1 for s in lost.values() if any(x < K for x in s))
    reset()
    t0 = time.perf_counter()
    for oid, body in final.items():
        if gate.call(f"degraded read {oid}", cl.read, "ec", oid) != body:
            raise AssertionError(f"4p (b): degraded read of {oid} differs")
    wall = time.perf_counter() - t0
    n = read_counts()
    need(n["gf_bit_matmul"] >= decodes > 0,
         f"(b) K1 launches {n} for {decodes} objects with a lost data shard")
    rec = leg("b_degraded_read", wall,
              sum(len(b) for b in final.values()), n,
              mark_down_s=mark_s, victims=victims,
              objects_missing_a_data_shard=decodes)
    with LegTrace(dev, kernel_counters) as tr:
        for oid in final:
            gate.call("traced read", cl.read, "ec", oid)
    traced(rec, tr)
    reset()

    # -- (c) recovery ----------------------------------------------------------
    # 12 shards fill the 12 hosts, so an out OSD's shards have no other
    # home (and every epoch that leaves one out sends each PG's mapping
    # through CRUSH's full retry budget on the host): the downed OSD's
    # disk is replaced instead, an empty store under the same id marked
    # up, and recovery rebuilds its shards there by decode
    still = {oid: [s for s, o in enumerate(a) if o == victims[1]]
             for oid, a in placed.items()}
    want = {(oid, s) for oid in final for s in range(K + M)
            if s not in still[oid]}
    t0 = time.perf_counter()
    rebuild(d, pid, victims[0], want)
    wall = time.perf_counter() - t0
    n = read_counts()
    held = check_bodies(d, pid, expect, "(c)", skip_shards=still)
    rebuilt = sum(1 for oid in final
                  for s in lost[oid] if s not in still[oid])
    need(n["gf_bit_matmul"] > 0, f"(c) K1 launches {n}")
    rec = leg("c_recovery", wall, rebuilt * obj_bytes // K, n,
              shards_rebuilt=rebuilt, bodies_checked=held)
    if trace_rebuilds:
        # the traced run: the other downed OSD's disk, replaced and rebuilt
        with LegTrace(dev, kernel_counters) as tr:
            rebuild(d, pid, victims[1],
                    {(oid, s) for oid in final for s in range(K + M)})
        traced(rec, tr)
        rec["traced_bodies_checked"] = check_bodies(d, pid, expect,
                                                    "(c) traced")
    reset()
    d.shutdown()
    del d, cl, expect
    gc.collect()

    # -- (d) resident write ----------------------------------------------------
    g_conf.set_val("os_memstore_device_bytes_max", RESIDENT_BUDGET)
    pc = memstore_device_perf_counters()
    try:
        d = Daemons("ceph_tpu_torch", OSD_PATH_OSDS)
        pid = d.create_ec_pool("resident", prof, pg_num)
        cl = d.client()
        reset()
        t0 = time.perf_counter()
        for oid, body in objs.items():
            gate.call(f"resident write {oid}", cl.write_full, "resident",
                      oid, body)
        wall = time.perf_counter() - t0
        n = read_counts()
        need(n["resident_calls"] == n["fused_encode_crc"] == n_obj
             and n["gf_bit_matmul"] == 0,
             f"(d) write launches {n}: K5 {n_obj} times, K1 never")
        rec = leg("d_resident_write", wall, n_obj * obj_bytes, n)
        dev0, host0 = pc.get(l_msd_crc_device), pc.get(l_msd_crc_host)
        reset()
        t0 = time.perf_counter()
        for oid, body in objs.items():
            if gate.call(f"resident read {oid}", cl.read, "resident",
                         oid) != body:
                raise AssertionError(f"4p (d): read of {oid} differs")
        rwall = time.perf_counter() - t0
        n = read_counts()
        crc_dev = pc.get(l_msd_crc_device) - dev0
        crc_host = pc.get(l_msd_crc_host) - host0
        if crc_dev != n_obj * K or crc_host:
            raise AssertionError(f"4p (d): device crcs {crc_dev}, host "
                                 f"crcs {crc_host} for {n_obj * K} bodies")
        need(n["crc32c"] == n_obj * K and n["gf_bit_matmul"] == 0,
             f"(d) read launches {n}: K4 once per resident body")
        rec.update(read_wall_s=rwall,
                   read_GiBps=n_obj * obj_bytes / rwall / 2**30,
                   read_launches=n, crc_device=crc_dev, crc_host=crc_host)
        # rot one data body of obj0: its sub-read fails, the primary
        # decodes
        acting = acting_of(d, cl, "resident", "obj0")
        st = d.osds[acting[0]].store
        cid = next(c for c in st.list_collections()
                   if any(h.oid == "obj0" and h.shard == 0
                          for h in st.list_objects(c)))
        ho = next(h for h in st.list_objects(cid)
                  if h.oid == "obj0" and h.shard == 0)
        reset()
        g_faults.inject("store.shard_corrupt", mode="once",
                        match=f"{cid}/{ho}")
        try:
            if gate.call("rotted read", cl.read, "resident", "obj0") != \
                    objs["obj0"]:
                raise AssertionError("4p (d): read past the rot differs")
        finally:
            g_faults.clear()
        n = read_counts()
        need(n["gf_bit_matmul"] >= 1, f"(d) rot: K1 launches {n}")
        rec["rot_launches"] = n
        reset()
        t0 = time.perf_counter()
        d.scrub(deep=True)
        n = read_counts()
        need(n["crc32c"] == 0, f"(d) deep scrub launched K4: {n}")
        rec.update(deep_scrub_s=time.perf_counter() - t0,
                   deep_scrub_launches=n)
        for oid, body in objs.items():
            if gate.call(f"read {oid}", cl.read, "resident", oid) != body:
                raise AssertionError(f"4p (d): {oid} after scrub differs")
        reset()
        with LegTrace(dev, kernel_counters) as tr:
            for i, body in enumerate(objs.values()):
                gate.call("traced resident write", cl.write_full,
                          "resident", f"t{i}", body)
            for i in range(n_obj):
                gate.call("traced resident read", cl.read, "resident",
                          f"t{i}")
        traced(rec, tr)
        reset()
        d.shutdown()
        del d, cl
    finally:
        g_conf.rm_val("os_memstore_device_bytes_max")
    gc.collect()

    # -- (e) coalesced and threaded --------------------------------------------
    opts = {"osd_op_num_threads": 4, "ec_pipeline_depth": 8,
            "ec_dispatch_batch_window_us": 20000}
    for k, v in opts.items():
        g_conf.set_val(k, v)
    small = {f"s{i}": rng.integers(0, 256, small_bytes,
                                   dtype=np.uint8).tobytes()
             for i in range(n_obj)}
    try:
        d = Daemons("ceph_tpu_torch", OSD_PATH_OSDS)
        pid = d.create_ec_pool("small", prof, pg_num)
        cl = d.client()
        g_dispatcher.flush()

        def dsnap():
            return {name: dpc.get(getattr(dsched, f"l_dispatch_{name}"))
                    for name in ("batches", "batched_reqs", "coalesced",
                                 "fallbacks", "errors")} | {
                "encode_errors": ppc.get(l_pipeline_errors)}
        before = dsnap()
        reset()
        t0 = time.perf_counter()
        res = d.burst_write_full(cl, "small", small,
                                 deadline_s=OSD_PATH_DEADLINE_S)
        wall = time.perf_counter() - t0
        n = read_counts()
        delta = {k: v - before[k] for k, v in dsnap().items()}
        if res != {oid: 0 for oid in small}:
            bad = {o: r for o, r in res.items() if r != 0}
            raise AssertionError(f"4p (e): replies {bad}")
        if delta["fallbacks"] or delta["errors"] or delta["encode_errors"]:
            raise AssertionError(f"4p (e): re-runs or errors {delta}")
        if delta["coalesced"] < 2:
            raise AssertionError(f"4p (e): no flush held two requests "
                                 f"{delta}")
        need(n["gf_bit_matmul"] == delta["batches"],
             f"(e) K1 launches {n} for {delta['batches']} flushes")
        sexp = {oid: native_shards(matrix, K, CHUNK, b)
                for oid, b in small.items()}
        held = check_bodies(d, pid, sexp, "(e)")
        for oid, body in small.items():
            if gate.call(f"read {oid}", cl.read, "small", oid) != body:
                raise AssertionError(f"4p (e): read of {oid} differs")
        rec = leg("e_coalesced_threaded", wall, n_obj * small_bytes, n,
                  dispatch=delta, bodies_checked=held,
                  mean_requests_per_flush=delta["batched_reqs"]
                  / max(delta["batches"], 1))
        with LegTrace(dev, kernel_counters) as tr:
            res = d.burst_write_full(
                cl, "small", {f"t{o}": b for o, b in small.items()},
                deadline_s=OSD_PATH_DEADLINE_S)
        if set(res.values()) != {0}:
            raise AssertionError(f"4p (e): traced burst replies {res}")
        traced(rec, tr)
        reset()
        d.shutdown()
        del d, cl
    finally:
        for k in opts:
            g_conf.rm_val(k)
    gc.collect()

    # -- (f) regenerating ------------------------------------------------------
    rprof = {**REGEN_PROFILE, "crush-failure-domain": "host", **backend}
    regen = {f"r{i}": rng.integers(0, 256, regen_bytes,
                                   dtype=np.uint8).tobytes()
             for i in range(n_obj)}
    d = Daemons("ceph_tpu_torch", OSD_PATH_OSDS)
    pid = d.create_ec_pool("regen", rprof, pg_num)
    cl = d.client()
    host = create_erasure_code({**REGEN_PROFILE, "backend": "host"})
    sinfo = host.make_stripe_info(d.mon.osdmap.pools[pid].stripe_width)
    w = sinfo.get_stripe_width()
    n_all = host.get_chunk_count()
    rexp = {}
    for oid, body in regen.items():
        sh = ecutil.encode(sinfo, host, body + b"\0" * (-len(body) % w),
                           set(range(n_all)))
        rexp[oid] = [sh[i].tobytes() for i in range(n_all)]
    reset()
    t0 = time.perf_counter()
    for oid, body in regen.items():
        gate.call(f"regen write {oid}", cl.write_full, "regen", oid, body)
    wall = time.perf_counter() - t0
    n = read_counts()
    need(n["gf_bit_matmul"] == n_obj, f"(f) write K1 launches {n}")
    held = check_bodies(d, pid, rexp, "(f) write")
    rec = leg("f_regen_write", wall, n_obj * regen_bytes, n,
              bodies_checked=held)
    with LegTrace(dev, kernel_counters) as tr:
        for i, body in enumerate(regen.values()):
            gate.call("traced regen write", cl.write_full, "regen",
                      f"t{i}", body)
    traced(rec, tr)
    for i, body in enumerate(regen.values()):
        rexp[f"t{i}"] = rexp[f"r{i}"]
    rpc = recovery_perf_counters()
    r0, f0 = rpc.get(l_recovery_repair_rounds), rpc.get(l_recovery_fallbacks)
    acting = acting_of(d, cl, "regen", "r0")
    victim = acting[-1]
    d.kill_osd(victim)
    d.mark_osd_down(victim)
    want = {(oid, s) for oid in rexp for s in range(n_all)}
    reset()
    t0 = time.perf_counter()
    rebuild(d, pid, victim, want)
    wall = time.perf_counter() - t0
    n = read_counts()
    rounds = rpc.get(l_recovery_repair_rounds) - r0
    fallbacks = rpc.get(l_recovery_fallbacks) - f0
    if rounds <= 0 or fallbacks:
        raise AssertionError(f"4p (f): repair rounds {rounds}, fallbacks "
                             f"{fallbacks}")
    need(n["gf_bit_matmul"] >= rounds, f"(f) repair K1 launches {n}")
    held = check_bodies(d, pid, rexp, "(f) recovery")
    for oid, body in regen.items():
        if gate.call(f"regen read {oid}", cl.read, "regen", oid) != body:
            raise AssertionError(f"4p (f): read of {oid} differs")
    rec = leg("f_regen_recovery", wall, rounds * len(rexp["r0"][0]), n,
              repair_rounds=rounds, repair_fallbacks=fallbacks,
              bodies_checked=held)
    if trace_rebuilds:
        # the traced run: a second OSD down, its disk replaced and rebuilt
        d.kill_osd(acting[0])
        d.mark_osd_down(acting[0])
        r0 = rpc.get(l_recovery_repair_rounds)
        f0 = rpc.get(l_recovery_fallbacks)
        with LegTrace(dev, kernel_counters) as tr:
            rebuild(d, pid, acting[0], want)
        traced(rec, tr)
        rec["traced_repair_rounds"] = \
            rpc.get(l_recovery_repair_rounds) - r0
        if rec["traced_repair_rounds"] <= 0 or \
                rpc.get(l_recovery_fallbacks) != f0:
            raise AssertionError(f"4p (f): traced recovery {rec}")
        rec["traced_bodies_checked"] = check_bodies(d, pid, rexp,
                                                    "(f) traced")
    reset()
    d.shutdown()
    del d, cl
    gc.collect()

    caught = (dpc.get(dsched.l_dispatch_fallbacks),
              dpc.get(dsched.l_dispatch_errors), ppc.get(l_pipeline_errors))
    if caught != caught0:
        raise AssertionError(f"4p: device errors caught on the path: "
                             f"(re-runs, errors, encode errors) {caught0} "
                             f"-> {caught}")
    for name, rec in out["legs"].items():
        log(f"4p {name} record: " + json.dumps(rec))
    out["launches"] = total
    out["ops"] = gate.ops
    out["slowest_op_s"] = gate.slowest_s
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4p: {gate.ops} ops, slowest {gate.slowest_s:.2f} s, launches "
        f"{total}, {out['seconds']:.1f} s")
    return out


def osd_path_alone(dev) -> None:
    """``--osd-path``: 4p alone after phases 1-2, its record written to
    ``chiprun_out/osd_path.json``; the two rebuilds are traced too."""
    out = osd_path_slice(dev, trace_rebuilds=True)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "osd_path.json"), "w") as f:
        json.dump(out, f, indent=1)


# ---- 4q: MiniCluster, the traffic harness and psim ------------------------

CLUSTER_CLIENTS = 16              # rados bench's default -t 16
CLUSTER_OPS_PER_CLIENT = 8
CLUSTER_PSIM_SAMPLE = 2048        # PGs of psim's mapping held against the host


def cluster_slice(dev, obj_bytes: int = OBJ_BYTES, n_obj: int = N_OBJ,
                  pg_num: int = OSD_PATH_PG_NUM,
                  n_clients: int = CLUSTER_CLIENTS,
                  ops_per_client: int = CLUSTER_OPS_PER_CLIENT,
                  psim_map: str = os.path.join(TOOL_DIR, "om"),
                  psim_sample: int = CLUSTER_PSIM_SAMPLE) -> dict:
    """4q: the port's ``MiniCluster`` (the monitor, 12 OSDs and the mgr
    with its telemetry, controller and incident manager) with an EC pool
    of k=8, m=4 and ``pg_num`` PGs on the ``cuda`` plugin, 4p's
    deployment, as a user drives it:

    (a) a client's ``write_full`` of the 64 objects of 4 MiB: K1 once per
        write, every stored body equal to the native host coder's; the
        objects read back;
    (b) ``load.run_traffic``, closed loop, ``n_clients`` clients of
        ``ops_per_client`` ops of 4 MiB, half reads: byte-exact, every op
        answered, K1 launched at least once and at most once per write
        the OSDs served; its ops/s, p99 and the mgr's cluster rollup;
    (c) one acting OSD killed and marked down, ticks, then degraded reads
        of the 64 objects: K1 launches, the bytes equal, ``health()``
        reports ``1 osds down``, ``tpu status`` answers and one Prometheus
        scrape over ``mgr/http.py``'s HTTP server holds the cluster's
        gauges;
    (e) ``tools/psim`` on ``psim_map`` (4o's saved map): every PG mapped by
        ``OSDMapMapping`` through K7a, K7b and K6 (the counts set to 0
        just before, read just after), ``psim_sample`` of its rows equal
        to the host ``pg_to_up_acting_osds``.

    (d), the bench CLI's three cluster workloads, runs in 4n.  Counts are
    reset just before each leg and read just after.  On the CPU (a
    rehearsal at small sizes) the codecs take ``backend=host`` and the
    launch counts are not checked."""
    import contextlib
    import io
    import urllib.request
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.load import TrafficSpec, run_traffic
    from ceph_tpu_torch.mgr.http import MgrHttp, serve
    from ceph_tpu_torch.ops import (crc32c_device, crush_fast as cf,
                                    crush_kernels as ck, fused_encode_crc,
                                    gf_pallas)
    from ceph_tpu_torch.osd.osd import L_OSD_OP_W
    from ceph_tpu_torch.osdmap import OSDMapMapping, pg_t
    from ceph_tpu_torch.tools import osdmaptool, psim
    on_card = dev.type == "cuda"
    extra = {} if on_card else {"backend": "host"}
    counters = {"gf_bit_matmul": gf_pallas.launches,
                "crc32c": crc32c_device.launches,
                "fused_encode_crc": fused_encode_crc.launches,
                "crush_descend": cf.descend_launches,
                "crush_resolve": cf.resolve_launches,
                "crush_rule": ck.rule_launches}
    total = {n: 0 for n in counters}
    gate = OpGate()
    out = {"legs": {}, "config": {
        "osds": OSD_PATH_OSDS, "pg_num": pg_num, "k": K, "m": M,
        "plugin": "cuda", "extra_profile": extra, "objects": n_obj,
        "object_bytes": obj_bytes, "clients": n_clients,
        "ops_per_client": ops_per_client, "psim_map": psim_map}}
    t_slice = time.perf_counter()

    def reset():
        for c in counters.values():
            c.reset()

    def read_counts():
        got = {n: c.n for n, c in counters.items()}
        for n, v in got.items():
            total[n] += v
        return got

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4q: {what}")

    def leg(name, **rec):
        out["legs"][name] = rec
        log(f"4q {name}: " + json.dumps(rec, default=str))
        return rec

    # earlier phases leave residency and the dispatch options set: the
    # cluster starts from the defaults
    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "osd_op_num_threads", "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    rng = np.random.default_rng(SEED + 5)
    objs = {f"obj{i}": rng.integers(0, 256, obj_bytes,
                                    dtype=np.uint8).tobytes()
            for i in range(n_obj)}
    matrix = create_erasure_code({"plugin": "cuda", "k": str(K),
                                  "m": str(M), "backend": "host"}
                                 ).codec.matrix

    # -- (a) writes and reads --------------------------------------------------
    t0 = time.perf_counter()
    c = MiniCluster(n_osds=OSD_PATH_OSDS)
    pid = c.create_ec_pool("ec", k=K, m=M, pg_num=pg_num, plugin="cuda",
                           extra_profile=extra)
    cl = c.client()
    out["boot_s"] = time.perf_counter() - t0
    log(f"4q: MiniCluster of {OSD_PATH_OSDS} OSDs and a pool of {pg_num} "
        f"PGs up in {out['boot_s']:.1f} s")
    reset()
    t0 = time.perf_counter()
    for oid, body in objs.items():
        gate.call(f"write_full {oid}", cl.write_full, "ec", oid, body)
    wall = time.perf_counter() - t0
    n = read_counts()
    need(n["gf_bit_matmul"] == n_obj,
         f"(a) K1 launches {n} for {n_obj} writes")
    expect = {oid: native_shards(matrix, K, CHUNK, b)
              for oid, b in objs.items()}
    held = check_bodies(c, pid, expect, "4q (a)")
    if held != n_obj * (K + M):
        raise AssertionError(f"4q (a): {held} bodies stored")
    reset()
    t1 = time.perf_counter()
    for oid, body in objs.items():
        if gate.call(f"read {oid}", cl.read, "ec", oid) != body:
            raise AssertionError(f"4q (a): read of {oid} differs")
    read_wall = time.perf_counter() - t1
    leg("a_write_read", wall_s=wall, GiBps=n_obj * obj_bytes / wall / 2**30,
        launches=n, bodies_checked=held, read_wall_s=read_wall,
        read_GiBps=n_obj * obj_bytes / read_wall / 2**30,
        read_launches=read_counts())

    # -- (b) the traffic harness ------------------------------------------------
    def served_writes():
        return sum(o.perf_counters.get(L_OSD_OP_W) for o in c.osds.values())

    w0 = served_writes()
    reset()
    res = run_traffic(c, TrafficSpec(
        pool="ec", n_clients=n_clients, ops_per_client=ops_per_client,
        read_fraction=0.5, object_sizes=((obj_bytes, 1.0),),
        mode="closed", seed=SEED, keep_completions=False))
    n = read_counts()
    writes = served_writes() - w0
    if not res.byte_exact or res.completed != res.total_ops or \
            res.total_ops != n_clients * ops_per_client:
        raise AssertionError(
            f"4q (b): byte_exact {res.byte_exact}, {res.completed} of "
            f"{res.total_ops} ops answered, errors {res.errors[:4]}")
    need(0 < n["gf_bit_matmul"] <= writes,
         f"(b) K1 launches {n} for {writes} writes served")
    wall_run_s = max(res.elapsed_s, 1e-3)
    c.clock += wall_run_s
    c.mgr.telemetry.tick(c.mgr, c.clock)
    roll = c.mgr.telemetry.rollup(window_s=c.clock + 1.0)
    leg("b_traffic", ops_per_s=res.ops_per_sec, elapsed_s=res.elapsed_s,
        total_ops=res.total_ops, completed=res.completed,
        writes_served=writes, bytes_moved=res.bytes_moved,
        rounds=res.rounds, byte_exact=res.byte_exact,
        p99_usec=res.aggregate.get("p99"), aggregate=res.aggregate,
        launches=n, cluster_rollup={
            "oplat_p99_usec": roll["oplat_p99_usec"],
            "rates": roll["rates"], "span_s": roll["span_s"],
            "copies_per_op": roll["copies_per_op"],
            "slo": {k: st["state"] for k, st in roll["slo"].items()}})

    # -- (c) an OSD down: degraded reads, health, status, a scrape -----------
    victim = acting_of(c, cl, "ec", "obj0")[1]
    placed = {oid: acting_of(c, cl, "ec", oid) for oid in objs}
    decodes = sum(1 for a in placed.values() if victim in a[:K])
    t0 = time.perf_counter()
    c.kill_osd(victim)
    c.mark_osd_down(victim)
    c.tick(dt=1.0, rounds=2)
    mark_s = time.perf_counter() - t0
    health = c.health()
    if "1 osds down" not in health:
        raise AssertionError(f"4q (c): health {health!r}")
    reset()
    t0 = time.perf_counter()
    for oid, body in objs.items():
        if gate.call(f"degraded read {oid}", cl.read, "ec", oid) != body:
            raise AssertionError(f"4q (c): degraded read of {oid} differs")
    wall = time.perf_counter() - t0
    n = read_counts()
    need(n["gf_bit_matmul"] >= decodes > 0,
         f"(c) K1 launches {n} for {decodes} objects with a lost data "
         "shard")
    status = c.admin_socket.execute("tpu status")
    if status["health"] != c.health() or "cluster_p99_usec" not in status:
        raise AssertionError(f"4q (c): tpu status {status}")
    srv, port = serve(MgrHttp(c.mgr, c, c.perf_collection))
    try:
        with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics",
                                    timeout=60) as r:
            scrape = r.read().decode()
    finally:
        srv.shutdown()
        srv.server_close()
    want_lines = (f"ceph_osd_up {OSD_PATH_OSDS - 1}",
                  f"ceph_osd_in {OSD_PATH_OSDS}")
    if not all(ln in scrape.splitlines() for ln in want_lines) or \
            "ceph_daemon_" not in scrape or "ceph_tpu_codec" in scrape:
        raise AssertionError("4q (c): the scrape lacks the cluster gauges")
    leg("c_degraded", victim=victim, mark_down_s=mark_s, health=health,
        wall_s=wall, GiBps=n_obj * obj_bytes / wall / 2**30, launches=n,
        objects_missing_a_data_shard=decodes,
        tpu_status_keys=sorted(status),
        scrape_lines=len(scrape.splitlines()))
    for osd in c.osds.values():
        osd.shutdown()
    del c, cl, objs, expect

    # -- (e) psim on 4o's map ---------------------------------------------------
    kept = []

    class KeptMapping(OSDMapMapping):
        def update(self, m, *a, **kw):
            r = super().update(m, *a, **kw)
            kept.append(self)
            return r

    with open(psim_map, "rb") as f:
        m = osdmaptool.load_map(f.read())
    pg_count = sum(p.pg_num for p in m.pools.values())
    buf = io.StringIO()
    reset()
    psim.OSDMapMapping, orig = KeptMapping, psim.OSDMapMapping
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = psim.main([psim_map, "--objects", str(pg_count)],
                           device=dev.type)
    finally:
        psim.OSDMapMapping = orig
    wall = time.perf_counter() - t0
    n = read_counts()
    if rc != 0 or len(kept) != 1:
        raise AssertionError(f"4q (e): psim exit {rc}")
    need(n["crush_descend"] and n["crush_resolve"] and n["crush_rule"],
         f"(e) a CRUSH kernel did not launch: {n}")
    mm = kept[0]
    want = "device" if on_card else "cpu"
    if set(mm.last_backend.values()) != {want} or \
            any(mm.host_replayed.values()):
        raise AssertionError(f"4q (e): last_backend {mm.last_backend}, "
                             f"host_replayed {mm.host_replayed}")
    lines = buf.getvalue().splitlines()
    if len([ln for ln in lines if ln.startswith("osd.")]) != m.max_osd:
        raise AssertionError("4q (e): psim printed no row per OSD")
    t0 = time.perf_counter()
    checked = 0
    for pid_, pool in sorted(m.pools.items()):
        pss = rng.choice(pool.pg_num, min(psim_sample, pool.pg_num),
                         replace=False)
        for ps in sorted(int(p) for p in pss):
            pg = pg_t(pid_, ps)
            if mm.get(pg) != tuple(m.pg_to_up_acting_osds(pg)):
                raise AssertionError(f"4q (e): pg {pg} {mm.get(pg)} != "
                                     f"host {m.pg_to_up_acting_osds(pg)}")
            checked += 1
    leg("e_psim", wall_s=wall, pgs=pg_count, launches=n,
        sample_checked=checked,
        sample_check_s=time.perf_counter() - t0,
        summary=[ln for ln in lines if ln.startswith("avg")])
    out["launches"] = total
    out["slowest_op_s"] = gate.slowest_s
    out["ops"] = gate.ops
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4q: {gate.ops} ops, slowest {gate.slowest_s:.2f} s; launches "
        + json.dumps(total) + f"; {out['seconds']:.1f} s")
    return out


def cluster_alone(dev) -> None:
    """``--cluster``: 4o (whose saved map psim reads) and 4q alone after
    phases 1-2, 4q's record written to ``chiprun_out/cluster.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    osdmaptool_slice(dev)
    out = cluster_slice(dev)
    with open(os.path.join("chiprun_out", "cluster.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


VSTART_OSDS = 12                  # one per host, crush-failure-domain=host
VSTART_PG_NUM = 32
VSTART_OBJ = 32                   # objects of OBJ_BYTES written in (a)
VSTART_LATE = 8                   # objects written while two OSDs are down
VSTART_MONS = 3                   # (d) SIGKILLs the leader, rank 0
VSTART_MON_GRACE = 8.0            # the JAX multi-mon case's mon_grace
VSTART_FAILOVER_OBJ = 8           # objects written under the new quorum
VSTART_COUNT_EVERY_S = 0.5        # the OSD launcher's count-file period
VSTART_ATTEMPT_S = 10.0           # an op's reply wait before a map refresh
VSTART_SETTLE_S = 10.0            # recovery pushes still this long: done
VSTART_DIR = os.path.join("build", "vstart")


class _ReadyStamp:
    """The launcher's stdout: stamps the wall time the daemon prints
    READY, and passes everything on."""

    def __init__(self, out, state):
        self.out, self.state = out, state

    def write(self, text):
        if "READY" in text and self.state["ready_t"] is None:
            self.state["ready_t"] = time.time()
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def osd_launcher(count_dir: str, argv: list) -> None:
    """``python3 chip_smoke.py --vstart-osd DIR <osd argv>``: one OSD of
    4v.  Runs ``ceph_tpu_torch.vstart.main(argv)`` and, every
    ``VSTART_COUNT_EVERY_S``, rewrites ``DIR/osd-<pid>.json`` with its
    pid, K1's launch count in this process, whether the process holds a
    CUDA context and K1's library, and the wall time it printed READY.  The daemon is
    SIGKILLed, so the file is its last word; nothing waits for an exit
    hook."""
    from ceph_tpu_torch import vstart
    from ceph_tpu_torch.ops import _build, gf_pallas
    pid = os.getpid()
    state = {"pid": pid, "osd": int(argv[argv.index("--id") + 1]),
             "ready_t": None}
    path = os.path.join(count_dir, f"osd-{pid}.json")

    def dump():
        while True:
            rec = dict(state, launches=gf_pallas.launches.n,
                       cuda=torch.cuda.is_initialized(),
                       k1_loaded="gf_bit_matmul" in _build._libs,
                       t=time.time())
            with open(path + ".tmp", "w") as f:
                json.dump(rec, f)
            os.replace(path + ".tmp", path)
            time.sleep(VSTART_COUNT_EVERY_S)

    sys.stdout = _ReadyStamp(sys.stdout, state)
    threading.Thread(target=dump, daemon=True).start()
    vstart.main(argv)


def counted_cluster(count_dir: str, **kw):
    """The port's ``ProcessCluster`` whose OSDs start through
    ``osd_launcher`` (so their K1 counts reach ``count_dir``), with each
    daemon's spawn time and the mon's READY time kept."""
    from ceph_tpu_torch.vstart import ProcessCluster

    class CountedCluster(ProcessCluster):
        def __init__(self):
            self.spawned, self.ready = {}, {}
            super().__init__(**kw)

        def _spawn_mon(self, rank, with_pool, rejoin=False):
            self.spawned[self.mon_names[rank]] = time.time()
            super()._spawn_mon(rank, with_pool, rejoin)

        def _await_ready(self, name, timeout=120.0):
            super()._await_ready(name, timeout)
            self.ready.setdefault(name, time.time())

        def _spawn_osd(self, i):
            self.spawned[f"osd.{i}"] = time.time()
            self.procs[f"osd.{i}"] = subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--vstart-osd",
                 count_dir, *self.osd_argv(i)],
                stdout=subprocess.PIPE, text=True,
                cwd=os.path.dirname(os.path.abspath(__file__)),
                env=self._osd_args["env"])

    return CountedCluster()


def osd_counts(count_dir: str, live_pids, since: float,
               timeout: float = 10.0) -> list:
    """Every OSD process's last count record, once each live one has
    written after ``since`` (a killed one's last record stands)."""
    end = time.monotonic() + timeout
    while True:
        recs = []
        for name in os.listdir(count_dir):
            if name.endswith(".json"):
                with open(os.path.join(count_dir, name)) as f:
                    recs.append(json.load(f))
        fresh = {r["pid"] for r in recs if r["t"] >= since}
        if set(live_pids) <= fresh:
            return recs
        if time.monotonic() > end:
            raise AssertionError(f"4v: no fresh count from pids "
                                 f"{sorted(set(live_pids) - fresh)}")
        time.sleep(0.1)


def compute_apps() -> str:
    """The card's compute processes as ``nvidia-smi`` lists them.  In a
    container whose pids nvidia-smi cannot see it lists every process
    as pid 1, so the OSD processes report their own contexts."""
    return subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()


class WireOps:
    """4v's client ops: each goes to its PG's primary by the client's map
    and waits for its own reply, up to ``VSTART_ATTEMPT_S`` before a map
    refresh and a resend, and ``OSD_PATH_DEADLINE_S`` in all; an EAGAIN
    (peering, a stale map) refreshes the map and resends, as the
    Objecter does.  The client's ``write_full``/``read`` give up after
    eight 50 ms windows of silence on the socket, shorter than a 4 MiB
    op takes across processes (ROADMAP Queue 3).  Every op must answer
    0; latencies are kept per kind."""

    def __init__(self, cluster, cl, pool: str):
        from ceph_tpu_torch.msg import messages
        self.c, self.cl, self.msgs = cluster, cl, messages
        self.pool_id = cl.lookup_pool(pool)
        self.lat = {}
        # kind -> (s, oid, its last attempts) of the slowest op so far
        self.slowest = {}

    def refresh(self):
        self.cl.mon.send_full_map(self.cl.name)
        self.c.network.pump(quiesce=0.05, deadline=1.0)

    def op(self, kind: str, oid: str, data: bytes = b""):
        cl, m = self.cl, self.msgs
        code = {"write": m.CEPH_OSD_OP_WRITEFULL,
                "read": m.CEPH_OSD_OP_READ}[kind]
        t0 = time.perf_counter()
        seen = []
        while time.perf_counter() - t0 < OSD_PATH_DEADLINE_S:
            pgid, primary = cl._calc_target(self.pool_id, oid)
            if primary < 0:
                seen.append(("no primary", cl.osdmap.epoch))
                self.refresh()
                continue
            cl._tid += 1
            tid = cl._tid
            cl.messenger.send_message(m.MOSDOp(
                tid=tid, pool=pgid[0], oid=oid, pgid=pgid, op=code,
                data=data, epoch=cl.osdmap.epoch), f"osd.{primary}")
            t_try = time.perf_counter()
            while tid not in cl._replies and \
                    time.perf_counter() - t_try < VSTART_ATTEMPT_S:
                self.c.network.pump(quiesce=0.002, deadline=0.05)
            reply = cl._replies.pop(tid, None)
            seen.append((primary, cl.osdmap.epoch,
                         None if reply is None else reply.result))
            if reply is not None and reply.result != -11:
                dt = time.perf_counter() - t0
                self.lat.setdefault(kind, []).append(dt)
                if dt > self.slowest.get(kind, (0.0,))[0]:
                    self.slowest[kind] = (dt, oid, seen[-12:])
                if reply.result != 0:
                    raise AssertionError(f"4v: {kind} {oid} answered "
                                         f"{reply.result}")
                return reply
            self.refresh()
        raise AssertionError(f"4v: {kind} {oid} unanswered after "
                             f"{OSD_PATH_DEADLINE_S} s: (primary, epoch, "
                             f"result) {seen[-12:]}")

    def stats(self, kind: str, n_bytes: int) -> dict:
        """The ops of ``kind`` since the last call: count, wall, GiB/s,
        p50, p99, and the slowest op's attempts as (primary, epoch,
        result) (None: no reply within ``VSTART_ATTEMPT_S``)."""
        lat = sorted(self.lat.pop(kind, []))
        wall = sum(lat)
        slowest = self.slowest.pop(kind, None)
        return {"ops": len(lat), "wall_s": wall, "slowest": slowest,
                "GiBps": n_bytes / wall / 2**30 if wall else None,
                "p50_s": lat[len(lat) // 2] if lat else None,
                "p99_s": lat[min(len(lat) - 1, int(len(lat) * 0.99))]
                if lat else None}


def vstart_slice(dev, n_osds: int = VSTART_OSDS, k: int = K, m: int = M,
                 obj_bytes: int = OBJ_BYTES, n_obj: int = VSTART_OBJ,
                 n_late: int = VSTART_LATE,
                 n_failover: int = VSTART_FAILOVER_OBJ,
                 pg_num: int = VSTART_PG_NUM, proof: bool = True) -> dict:
    """4v: the port's process cluster (``ceph_tpu_torch.vstart``), three
    mon processes (``mon_grace`` 8 s) and ``n_osds`` OSD processes over
    the TCP messenger with cephx on, each OSD on its own ``WALStore`` in a
    temporary ``data_root``, an isa k=8 m=4 pool of ``pg_num`` PGs
    (``crush-failure-domain=host``; the codec on the card, ``backend`` by
    default) and a client in this process bound to the peon ``mon.1``:

    (a) ``n_obj`` objects of ``obj_bytes`` made from the seed written,
        then read back;
    (b) two OSDs that hold data shards of the first object SIGKILLed;
        once the client's map shows them down, every object read
        degraded, then ``n_late`` more objects written with the two down;
    (c) one of them restarted on its data directory, then the other, then
        ``wait_healthy``; once recovery's pushes stop moving, every object
        read;
    (d) three self-managed snapshot ids allocated through the peon; a
        relayed ``selfmanaged_snap_create`` sent and the leader ``mon.0``
        SIGKILLed at once; ``quorum_status`` polled until rank 1 leads a
        quorum of two without rank 0; a snapshot id strictly above every
        one from before the kill; ``n_failover`` objects of ``obj_bytes``
        written (K1's sum in the OSD processes must move by at least
        ``n_failover``); every object of (a)-(d) read back; a second
        client bound to ``mon.2`` reaches the first one's epoch and
        snapshot sequence.  The election's seconds (kill to the first
        ``quorum_status`` that shows it, polled every 0.5 s) and the leg's
        wall are logged;
    then, with ``proof``, ``m`` OSDs other than (b)'s SIGKILLed, so that
    each late object's read needs the restarted disks' recovered shards,
    and the late objects read again (the whole smoke leaves this proof to
    ``--vstart``, for its time limit).

    Every op answers 0 within ``OSD_PATH_DEADLINE_S`` and every read is
    byte-exact.  Each OSD process opens the card and loads K1 before it
    reports READY, and counts its own K1 launches into
    ``VSTART_DIR/counts`` (``osd_launcher``); the sum over the OSD
    processes must move in (a), in (b) and in (c), every OSD process must
    report its CUDA context and K1's library, and the device memory the
    boot took must come to at least 64 MiB per OSD process.  On the CPU (a rehearsal at small
    sizes) the profile takes ``backend=host``, the OSDs ``--device cpu``,
    and the card's checks are skipped."""
    import shutil
    import tempfile
    on_card = dev.type == "cuda"
    profile = {"plugin": "isa", "k": str(k), "m": str(m),
               "crush-failure-domain": "host"}
    if not on_card:
        profile["backend"] = "host"
    count_dir = os.path.abspath(os.path.join(VSTART_DIR, "counts"))
    shutil.rmtree(count_dir, ignore_errors=True)
    os.makedirs(count_dir)
    data_root = tempfile.mkdtemp(prefix="vstart_")
    rng = np.random.default_rng(SEED + 7)
    objs = {f"obj{i}": rng.integers(0, 256, obj_bytes,
                                    dtype=np.uint8).tobytes()
            for i in range(n_obj)}
    late = {f"late{i}": rng.integers(0, 256, obj_bytes,
                                     dtype=np.uint8).tobytes()
            for i in range(n_late)}
    after = {f"failover{i}": rng.integers(0, 256, obj_bytes,
                                          dtype=np.uint8).tobytes()
             for i in range(n_failover)}
    out = {"legs": {}, "config": {
        "osds": n_osds, "mons": VSTART_MONS, "mon_grace": VSTART_MON_GRACE,
        "pg_num": pg_num, "profile": profile,
        "objects": n_obj, "late_objects": n_late,
        "failover_objects": n_failover, "object_bytes": obj_bytes,
        "auth": True, "device": dev.type}}
    t_slice = time.perf_counter()

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4v: {what}")

    def leg(name, **rec):
        out["legs"][name] = rec
        log(f"4v {name}: " + json.dumps(rec, default=str))
        return rec

    def live_osd_pids():
        return [p.pid for n, p in c.procs.items()
                if n.startswith("osd.") and p.poll() is None]

    def k1_sum():
        since = time.time()
        recs = osd_counts(count_dir, live_osd_pids(), since)
        return sum(r["launches"] for r in recs), recs

    def wait_down_up(osd_id, up, timeout=90.0):
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            c.pump_for(0.5)
            cl.mon.send_full_map(cl.name)
            c.network.pump()
            if cl.osdmap.is_up(osd_id) == up:
                return
        raise AssertionError(f"4v: osd.{osd_id} never marked "
                             f"{'up' if up else 'down'}")

    def perf_dump(i):
        """``perf dump`` of osd.i; the client's command gives up after
        eight 50 ms windows, shorter than a recovering OSD may take."""
        end = time.monotonic() + OSD_PATH_DEADLINE_S
        while True:
            try:
                return cl.osd_command(i, "perf dump")
            except IOError:
                if time.monotonic() > end:
                    raise
                c.pump_for(0.2)

    def snap_create(timeout=120.0):
        """A self-managed snapshot id through the client's mon, retried
        across an election window."""
        end = time.monotonic() + timeout
        while True:
            try:
                return cl.selfmanaged_snap_create("ec")
            except (IOError, ValueError) as e:
                if time.monotonic() > end:
                    raise AssertionError(f"4v (d): snapshot create never "
                                         f"answered: {e!r}")
                c.pump_for(0.5)

    def new_leader(dead_rank, timeout=150.0):
        """``quorum_status`` polled until a decided election seats a
        leader other than ``dead_rank`` with a quorum of two or more
        without it."""
        end = time.monotonic() + timeout
        last = None
        while time.monotonic() < end:
            try:
                last = cl.mon_command("quorum_status")
            except (IOError, ValueError) as e:
                last = e
                c.pump_for(0.5)
                continue
            if (last["leader_rank"] >= 0 and last["leader_rank"] != dead_rank
                    and last["election_epoch"] % 2 == 0
                    and dead_rank not in last["quorum"]
                    and len(last["quorum"]) >= 2):
                return last
            c.pump_for(0.5)
        raise AssertionError(f"4v (d): no leader after the kill: {last!r}")

    def recovery_pushes():
        total = 0
        for i in range(n_osds):
            if c.procs[f"osd.{i}"].poll() is not None:
                continue
            dump = perf_dump(i)
            stack = [dump]
            while stack:
                d = stack.pop()
                for key, v in d.items():
                    if isinstance(v, dict):
                        stack.append(v)
                    elif key == "recovery_push":
                        total += int(v)
        return total

    free0 = torch.cuda.mem_get_info()[0] if on_card else 0
    t0 = time.perf_counter()
    c = counted_cluster(
        count_dir, n_osds=n_osds,
        pool={"name": "ec", "pg_num": pg_num, "profile": profile},
        auth=True, data_root=data_root,
        # Ceph's osd_heartbeat_grace: 13 processes that take ~20 s each
        # to start on the card's 8 host cores miss the test settings' 4 s;
        # a 2 s interval settles the first tick's reports (every peer
        # not heard from yet) sooner than Ceph's 6 s
        heartbeat_interval=2.0, heartbeat_grace=20.0,
        down_out_interval=3600.0,       # the downed disks come back
        n_mons=VSTART_MONS, mon_grace=VSTART_MON_GRACE,
        client_names=("client.x", "client.y"),
        device="cuda" if on_card else "cpu")
    try:
        # bound to a peon, as the JAX multi-mon case's client: its
        # commands cross the relay, and its map feed outlives the leader
        cl = c.client("client.x", mon_name="mon.1")
        c.wait_healthy(cl, timeout=120.0)
        ops = WireOps(c, cl, "ec")
        # the first op waits out the PGs' first peering: part of the boot
        ops.op("write", "warmup", b"warmup")
        ops.lat.clear()
        ops.slowest.clear()
        out["boot_s"] = time.perf_counter() - t0
        k1_total, recs = k1_sum()
        first = {f"osd.{r_['osd']}": r_ for r_ in recs}
        boot = {n: c.ready[n] - c.spawned[n] for n in c.mon_names}
        for n in (f"osd.{i}" for i in range(n_osds)):
            boot[n] = first[n]["ready_t"] - c.spawned[n]
            need(first[n]["cuda"] and first[n]["k1_loaded"],
                 f"{n} holds no CUDA context or K1 library at READY")
        out["process_boot_s"] = boot
        if on_card:
            # what the device lost to the cluster: the 12 OSD contexts
            # (this process does no device work while they boot)
            ctx = (free0 - torch.cuda.mem_get_info()[0]) / n_osds / 2**20
            need(ctx >= 64, f"{ctx:.0f} MiB of device memory per OSD "
                            "process: not a CUDA context each")
            out["context_mib_per_osd"] = ctx
            log(f"4v: device memory per OSD process {ctx:.1f} MiB "
                f"(free before the spawn minus after the boot, over "
                f"{n_osds})")
        log(f"4v: {1 + n_osds} processes up in {out['boot_s']:.1f} s; "
            f"boot seconds " + json.dumps(
                {n: round(v, 2) for n, v in boot.items()}))

        # -- (a) writes and reads ---------------------------------------------
        n0 = k1_total
        for oid, body in objs.items():
            ops.op("write", oid, body)
        w = ops.stats("write", n_obj * obj_bytes)
        n1, _ = k1_sum()
        for oid, body in objs.items():
            if ops.op("read", oid).data != body:
                raise AssertionError(f"4v (a): read of {oid} differs")
        r = ops.stats("read", n_obj * obj_bytes)
        n2, recs = k1_sum()
        need(n1 - n0 > 0, f"(a) the OSD processes launched K1 {n1 - n0} "
                          "times in the writes")
        apps = compute_apps() if on_card else ""
        need(all(r_["cuda"] and r_["k1_loaded"] for r_ in recs
                 if r_["pid"] in live_osd_pids()),
             "an OSD process lost its CUDA context or K1 library")
        out["nvidia_smi_compute_apps"] = apps
        leg("a_write_read", write=w, read=r, k1_writes=n1 - n0,
            k1_reads=n2 - n1, osd_pids=sorted(live_osd_pids()),
            nvidia_smi_compute_apps=apps)
        k1_leg = {"a": n2 - n0}

        # -- (b) two OSDs down: degraded reads and writes ---------------------
        from ceph_tpu_torch.osdmap import pg_t
        pgid, primary = cl._calc_target(ops.pool_id, "obj0")
        acting = cl.osdmap.pg_to_up_acting_osds(pg_t(*pgid))[2]
        victims = [o for o in acting[:k]
                   if o != primary and 0 <= o < n_osds][:2]
        if len(victims) < 2:
            raise AssertionError(f"4v (b): obj0's data shards sit on "
                                 f"{acting[:k]}")
        for v in victims:
            c.kill_osd(v)
        t_kill = time.perf_counter()
        for v in victims:
            wait_down_up(v, up=False)
        detect_s = time.perf_counter() - t_kill
        n0, _ = k1_sum()
        for oid, body in objs.items():
            if ops.op("read", oid).data != body:
                raise AssertionError(f"4v (b): degraded read of {oid} "
                                     "differs")
        r = ops.stats("read", n_obj * obj_bytes)
        n1, _ = k1_sum()
        for oid, body in late.items():
            ops.op("write", oid, body)
        w = ops.stats("write", n_late * obj_bytes)
        n2, _ = k1_sum()
        need(n1 - n0 > 0, f"(b) degraded reads launched K1 {n1 - n0} "
                          "times")
        leg("b_degraded", victims=victims, detect_s=detect_s, read=r,
            k1_reads=n1 - n0, late_write=w, k1_late_writes=n2 - n1)
        k1_leg["b"] = n2 - n0

        # -- (c) the disks come back: recovery, a healthy cluster --------------
        n0, _ = k1_sum()
        p0 = recovery_pushes()
        t0 = time.perf_counter()
        c.restart_osd(victims[0])
        wait_down_up(victims[0], up=True)
        first_up_s = time.perf_counter() - t0
        c.restart_osd(victims[1])
        c.wait_healthy(cl, timeout=120.0)
        healthy_s = time.perf_counter() - t0
        # recovery has settled once its pushes stop moving
        pushes, still_since = 0, time.monotonic()
        end = time.monotonic() + 2 * OSD_PATH_DEADLINE_S
        while time.monotonic() < end:
            now = recovery_pushes() - p0
            if now != pushes:
                pushes, still_since = now, time.monotonic()
            elif pushes and time.monotonic() - still_since >= \
                    VSTART_SETTLE_S:
                break
            c.pump_for(1.0)
        recovered_s = time.perf_counter() - t0
        if not pushes:
            raise AssertionError("4v (c): recovery pushed nothing")
        for oid, body in {**objs, **late}.items():
            if ops.op("read", oid).data != body:
                raise AssertionError(f"4v (c): read of {oid} differs")
        r = ops.stats("read", (n_obj + n_late) * obj_bytes)
        n1, _ = k1_sum()
        need(n1 - n0 > 0, f"(c) recovery launched K1 {n1 - n0} times")
        leg("c_restart_recover", first_up_s=first_up_s,
            healthy_s=healthy_s, recovered_s=recovered_s,
            recovery_pushes=pushes, read=r, k1=n1 - n0)
        k1_leg["c"] = n1 - n0

        # -- (d) the leader mon SIGKILLed mid-command: an election, then
        # snapshot ids, writes and reads under the new quorum ----------------
        from ceph_tpu_torch.msg.messages import MMonCommand
        t_d = time.perf_counter()
        n0, _ = k1_sum()
        pre_ids = [snap_create() for _ in range(3)]
        if pre_ids != sorted(pre_ids) or len(set(pre_ids)) != 3:
            raise AssertionError(f"4v (d): snapshot ids {pre_ids}")
        c.network.send(cl.name, "mon.1", MMonCommand(
            tid=990001, cmd="selfmanaged_snap_create",
            args={"pool_name": "ec"}))
        c.kill_mon(0)
        t_kill = time.perf_counter()
        st = new_leader(dead_rank=0)
        election_s = time.perf_counter() - t_kill
        if st["leader_rank"] != 1:
            raise AssertionError(f"4v (d): rank {st['leader_rank']} leads, "
                                 "not rank 1")
        post_id = snap_create(timeout=150.0)
        if post_id <= max(pre_ids):
            raise AssertionError(f"4v (d): snapshot id {post_id} after the "
                                 f"kill, not above {pre_ids}")
        for oid, body in after.items():
            ops.op("write", oid, body)
        w = ops.stats("write", n_failover * obj_bytes)
        n1, _ = k1_sum()
        need(n1 - n0 >= n_failover, f"(d) the OSD processes launched K1 "
                                    f"{n1 - n0} times in {n_failover} "
                                    "writes")
        for oid, body in {**objs, **late, **after}.items():
            if ops.op("read", oid).data != body:
                raise AssertionError(f"4v (d): read of {oid} differs")
        r = ops.stats("read", (n_obj + n_late + n_failover) * obj_bytes)
        cl2 = c.client("client.y", mon_name="mon.2")
        end = time.monotonic() + 90.0
        while True:
            for x in (cl, cl2):
                x.mon.send_full_map(x.name)
            c.pump_for(0.3)
            p1 = cl.osdmap.pools.get(cl.osdmap.lookup_pg_pool_name("ec"))
            p2 = cl2.osdmap.pools.get(cl2.osdmap.lookup_pg_pool_name("ec"))
            if (p1 is not None and p2 is not None
                    and cl.osdmap.epoch == cl2.osdmap.epoch
                    and p1.snap_seq == p2.snap_seq >= post_id):
                break
            if time.monotonic() > end:
                raise AssertionError(
                    f"4v (d): the survivors' clients diverge: epochs "
                    f"{cl.osdmap.epoch}/{cl2.osdmap.epoch}, snap_seq "
                    f"{getattr(p1, 'snap_seq', None)}/"
                    f"{getattr(p2, 'snap_seq', None)}, want >= {post_id}")
        n2, _ = k1_sum()
        wall_d = time.perf_counter() - t_d
        leg("d_mon_failover", pre_kill_snap_ids=pre_ids,
            post_kill_snap_id=post_id, quorum=st, election_s=election_s,
            write=w, k1_writes=n1 - n0, read=r, k1_reads=n2 - n1,
            epoch=cl.osdmap.epoch, snap_seq=p1.snap_seq, wall_s=wall_d)
        k1_leg["d"] = n2 - n0
        log(f"4v (d): rank 1 leads {election_s:.3f} s after mon.0's "
            f"SIGKILL; the leg took {wall_d:.3f} s")

        n0, _ = k1_sum()
        others, proof_read = [], None
        if proof:
            # the proof: with m other OSDs gone, every late object's read
            # needs the k survivors' shards, the two restarted disks' ones
            # (which only recovery gave them) among them
            others = [o for o in range(n_osds) if o not in victims][-m:]
            for o in others:
                c.kill_osd(o)
            for o in others:
                wait_down_up(o, up=False)
            for oid, body in late.items():
                if ops.op("read", oid).data != body:
                    raise AssertionError(f"4v (c): {oid} read through the "
                                         "restarted disks differs")
            proof_read = ops.stats("read", n_late * obj_bytes)
            n1, _ = k1_sum()
            need(n1 - n0 > 0, f"(c) the proof's reads launched K1 "
                              f"{n1 - n0} times")
            leg("c_proof", killed_for_proof=others, proof_read=proof_read,
                k1=n1 - n0)
            k1_leg["c"] += n1 - n0
    finally:
        c.close()
        shutil.rmtree(data_root, ignore_errors=True)
    out["k1_by_leg"] = k1_leg
    out["launches"] = {"gf_bit_matmul": sum(k1_leg.values())}
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4v: K1 in the OSD processes {out['launches']}; "
        f"{out['seconds']:.1f} s")
    return out


def vstart_alone(dev) -> None:
    """``--vstart``: 4v alone after phases 1-2, its record written to
    ``chiprun_out/vstart.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    out = vstart_slice(dev)
    with open(os.path.join("chiprun_out", "vstart.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


# ---- 4w: the mesh, with K9x -----------------------------------------------------
MESH_MEMBERS = 8                  # the JAX bench's mesh_chips=8, slow_chip=5
MESH_SURV = (8192, K, CHUNK)      # (a) K9x's survivors: S, k, C
MESH_LOST = (1, 2)                # (a) two lost data shards
MESH_SHARD_AXES = (2, 4, 8)       # (a) partials XOR-reduced by one K9x
MESH_RS_S = 1024                  # (b) stripes of the ShardedRS legs
MESH_CRUSH_X = 100_000            # (b) x of the sharded CRUSH map
MESH_METRICS = ("ec_mesh_fenced", "ec_mesh_skew", "ec_mesh_straggler",
                "ec_degraded_read")


def xor_bound_ms(n: int, nbytes: int):
    """Least time of an n-way XOR reduction of ``nbytes`` each: every
    partial read once and the output written once over HBM."""
    return (n + 1) * nbytes / HBM_BYTES_PER_S * 1e3, "bytes"


def mesh_counters() -> dict:
    from ceph_tpu_torch.ops import crush_fast as cf, crush_kernels as ck
    from ceph_tpu_torch.ops import gf_pallas, mesh_xor
    return {"gf_bit_matmul": gf_pallas.launches,
            "mesh_xor": mesh_xor.launches,
            "crush_descend": cf.descend_launches,
            "crush_resolve": cf.resolve_launches,
            "crush_rule": ck.rule_launches}


def mesh_leg(name, drive) -> tuple:
    """Every count set to 0 just before ``drive`` and read just after."""
    counters = mesh_counters()
    for c in counters.values():
        c.reset()
    t0 = time.perf_counter()
    out = drive()
    wall = time.perf_counter() - t0
    counts = {n: c.n for n, c in counters.items()}
    log(f"4w {name}: {wall:.2f} s, launches " + json.dumps(counts))
    return out, counts, wall


def mesh_k9x(dev, rs) -> dict:
    """4w (a): K9x against its plain version on the partial products of
    the survivor-sharded decode at MESH_SURV, for each shard axis: each
    partial is K1 on a k-slice of the survivors with the matching rows of
    the decode bit-matrix, and their XOR must equal K1's whole decode."""
    from ceph_tpu_torch.ops import gf_pallas, mesh_xor
    s, k, c = MESH_SURV
    srcs = tuple(i for i in range(K + M) if i not in MESH_LOST)[:k]
    full = rs._decode_bits_for(srcs, MESH_LOST)
    bits = full.bits.cpu().numpy()
    r = len(MESH_LOST)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 17)
    surv = torch.randint(0, 256, (s, k, c), generator=gen, device=dev,
                         dtype=torch.uint8)
    whole = gf_pallas.gf_bit_matmul_kernel(surv, full)
    out = {}
    for n in MESH_SHARD_AXES:
        kk = k // n
        parts = torch.empty((n, s, r, c), dtype=torch.uint8, device=dev)
        for b in range(n):
            bm = gf_pallas.BitMatrix(bits[8 * kk * b:8 * kk * (b + 1)], dev)
            gf_pallas.gf_bit_matmul_kernel(
                surv[:, kk * b:kk * (b + 1)].contiguous(), bm,
                out=parts[b])
        got = mesh_xor.xor_reduce(parts)
        want = mesh_xor.xor_reduce_plain(parts)
        torch.cuda.synchronize()
        err = int_err(got, want)
        if err or not torch.equal(got, whole):
            raise AssertionError(f"4w (a) n={n}: K9x max_abs_err {err}, "
                                 f"equal to K1's decode "
                                 f"{torch.equal(got, whole)}")
        nbytes = s * r * c
        half = (n + 1) * nbytes // 2
        src = torch.empty(half, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        dst_out = torch.empty_like(got)
        ms, copy = turns_ms([lambda: mesh_xor.xor_reduce(parts, out=dst_out),
                             lambda: dst.copy_(src)], reps=REPS)
        plain = cuda_ms(lambda: mesh_xor.xor_reduce_plain(parts))
        b_ms, b_by = xor_bound_ms(n, nbytes)
        out[n] = {"max_abs_err": err, "ms": ms, "copy_ms": copy,
                  "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                  "share_of_bound": b_ms / ms,
                  "GBps": (n + 1) * nbytes / ms / 1e6}
        log(f"4w (a) K9x n={n} (S,r,C)=({s},{r},{c}) " + json.dumps(out[n]))
        del parts, got, want, src, dst, dst_out
    return out


def mesh_crush_map(dev):
    """4o's 1000-OSD map (osdmaptool --create-from-conf of the withracks
    conf, pool 1 of size 3), built into ``build/mesh``."""
    import contextlib
    import io
    from ceph_tpu_torch.osdmap.simple_build import mark_up_in
    from ceph_tpu_torch.tools import osdmaptool
    d = os.path.join("build", "mesh")
    os.makedirs(d, exist_ok=True)
    conf, om = os.path.join(d, "withracks.conf"), os.path.join(d, "om")
    with open(conf, "w") as f:
        f.write(withracks_conf())
    with contextlib.redirect_stdout(io.StringIO()):
        rc = osdmaptool.main(["--create-from-conf", om, "-c", conf,
                              "--with-default-pool", "--pg_bits",
                              str(TOOL_PG_BITS), "--pgp_bits",
                              str(TOOL_PG_BITS), "--clobber"],
                             device=dev.type)
    if rc != 0:
        raise AssertionError(f"4w: osdmaptool --create-from-conf exit {rc}")
    with open(om, "rb") as f:
        m = osdmaptool.load_map(f.read())
    mark_up_in(m)
    pool = m.pools[1]
    ruleno = m.crush.find_rule(pool.crush_rule, pool.type, pool.size)
    return m, ruleno, pool.size


def mesh_sharded(dev, rs_matrix) -> dict:
    """4w (b): ShardedRS's encode, decode, survivor-sharded decode and
    reshard on 8 members of the card, each byte-equal to one-device K1 and
    to the native host coder; ShardedFastRule on 4o's map over
    MESH_CRUSH_X x, rows equal to FastRule's."""
    from ceph_tpu_torch.ops.crush_fast import compile_fast_rule
    from ceph_tpu_torch.ops.gf_matmul import DeviceRSBackend
    from ceph_tpu_torch.native import native_rs_encode
    from ceph_tpu_torch.parallel import ShardedRS, make_mesh
    from ceph_tpu_torch.parallel.crush import ShardedFastRule
    mesh = make_mesh(MESH_MEMBERS, platform=dev.type)
    one = DeviceRSBackend(rs_matrix, dev)
    rng = np.random.default_rng(SEED + 18)
    data = rng.integers(0, 256, (MESH_RS_S, K, CHUNK), dtype=np.uint8)
    res = {"mesh": dict(mesh.shape), "members": mesh.size,
           "devices": [str(d) for d in mesh.distinct_devices]}
    sh, counts, wall = mesh_leg("(b) ShardedRS build",
                                lambda: ShardedRS(rs_matrix, mesh))
    coding, counts, wall = mesh_leg("(b) encode", lambda: sh.encode(data))
    rows = np.ascontiguousarray(data.transpose(1, 0, 2)).reshape(K, -1)
    host = native_rs_encode(rs_matrix[K:], rows).reshape(
        M, MESH_RS_S, CHUNK).transpose(1, 0, 2)
    if not np.array_equal(coding, one.encode(data)) or \
            not np.array_equal(coding, host):
        raise AssertionError("4w (b): sharded encode != one-device K1 or "
                             "the native host coder")
    if counts["gf_bit_matmul"] != mesh.size:
        raise AssertionError(f"4w (b) encode: K1 launched "
                             f"{counts['gf_bit_matmul']} times for "
                             f"{mesh.size} members")
    res["encode"] = {"launches": counts, "wall_s": wall}
    allc = np.concatenate([data, coding], axis=1)
    srcs = [i for i in range(K + M) if i not in MESH_LOST][:K]
    surv = np.ascontiguousarray(allc[:, srcs])
    want = np.ascontiguousarray(data[:, list(MESH_LOST)])
    for name, fn in (("decode", sh.decode_data),
                     ("decode_survivor_sharded",
                      sh.decode_data_survivor_sharded)):
        got, counts, wall = mesh_leg(f"(b) {name}",
                                     lambda: fn(surv, srcs, MESH_LOST))
        ref = one.decode_data(surv, srcs, MESH_LOST)
        if not np.array_equal(got, want) or not np.array_equal(got, ref):
            raise AssertionError(f"4w (b) {name}: != the lost data or "
                                 "one-device K1")
        k9x = 1 if name == "decode_survivor_sharded" else 0
        if counts["gf_bit_matmul"] != mesh.size or \
                counts["mesh_xor"] != k9x:
            raise AssertionError(f"4w (b) {name}: launches {counts}")
        res[name] = {"launches": counts, "wall_s": wall}
    out, counts, wall = mesh_leg("(b) reshard",
                                 lambda: sh.reshard_stripes_to_chunks(allc))
    if not np.array_equal(out.numpy(), allc) or \
            len(out.addressable_shards) != mesh.size:
        raise AssertionError("4w (b) reshard: values or pieces differ")
    res["reshard"] = {"launches": counts, "wall_s": wall,
                      "piece_shape": list(out.addressable_shards[0]
                                          .data.shape)}
    del out
    m, ruleno, size = mesh_crush_map(dev)
    xs = np.arange(MESH_CRUSH_X, dtype=np.uint32)
    weight = np.asarray(m.osd_weight, dtype=np.uint32)
    fr = compile_fast_rule(m.crush.crush, ruleno, size, device=dev)
    sf = ShardedFastRule(m.crush.crush, ruleno, size, mesh)
    (srows, scnt), counts, wall = mesh_leg(
        "(b) ShardedFastRule", lambda: sf.map_batch(xs, weight))
    frows, fcnt = fr.map_batch(xs, weight)
    if not (np.array_equal(scnt, fcnt) and np.array_equal(srows, frows)):
        raise AssertionError("4w (b) ShardedFastRule rows != FastRule's")
    if not (counts["crush_descend"] and counts["crush_resolve"]
            and counts["crush_rule"] == mesh.size):
        raise AssertionError(f"4w (b) ShardedFastRule launches {counts}")
    res["crush"] = {"x": MESH_CRUSH_X, "osds": len(m.osd_weight),
                    "rule": ruleno, "size": size, "launches": counts,
                    "wall_s": wall,
                    "residual_fraction": sf.residual_fraction}
    return res


def mesh_dispatch(dev) -> dict:
    """4w (c): a coalesced flush of 4d's 64 objects of 4 MiB with
    ec_mesh_chips=8 against the same flush with the mesh off: byte-equal,
    every member occupied, K1 launched members x flushes; then the
    discovery path, batch_mesh(-1) with one member per device: a mesh of
    one, the single-device path."""
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import dispatch_perf_counters, g_dispatcher
    from ceph_tpu_torch.dispatch import scheduler as ds
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.mesh import (batch_mesh, g_mesh,
                                     set_members_per_device)
    from ceph_tpu_torch.osd import ecutil
    codec = create_erasure_code({
        "plugin": "cuda", "k": str(K), "m": str(M),
        "technique": "reed_sol_van",
        "backend": "cuda" if dev.type == "cuda" else "host"})
    sinfo = ecutil.stripe_info_t(K, K * CHUNK)
    every = set(range(K + M))
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 19)
    objs = torch.randint(0, 256, (N_OBJ, OBJ_BYTES), generator=gen,
                         device=dev, dtype=torch.uint8).cpu().numpy()
    pc = dispatch_perf_counters()

    def flush():
        b0 = pc.get(ds.l_dispatch_batches)
        futs = [g_dispatcher.submit_encode(sinfo, codec, o, every)
                for o in objs]
        g_dispatcher.flush()
        return [f.result() for f in futs], pc.get(ds.l_dispatch_batches) - b0

    res = {}
    try:
        g_conf.set_val("ec_dispatch_batch_window_us", 10**7)
        g_conf.set_val("ec_dispatch_batch_max", N_OBJ)
        (off, n_off), c_off, w_off = mesh_leg("(c) mesh off", flush)
        g_conf.set_val("ec_mesh_chips", MESH_MEMBERS)
        chips0 = {i: v["stripes"] for i, v in g_mesh.per_chip().items()}
        (on, n_on), c_on, w_on = mesh_leg("(c) ec_mesh_chips=8", flush)
        occ = {i: v["stripes"] - chips0.get(i, 0)
               for i, v in g_mesh.per_chip().items()}
        same = all(sorted(a) == sorted(b) and all(
            np.array_equal(a[i], b[i]) for i in a) for a, b in zip(on, off))
        if not same or len(occ) != MESH_MEMBERS or \
                not all(v > 0 for v in occ.values()) or \
                c_on["gf_bit_matmul"] != MESH_MEMBERS * n_on or \
                c_off["gf_bit_matmul"] != n_off:
            raise AssertionError(
                f"4w (c): identical {same}, occupancy {occ}, K1 "
                f"{c_on['gf_bit_matmul']} for {n_on} meshed flushes, "
                f"{c_off['gf_bit_matmul']} for {n_off} without")
        res.update(identical=same, occupancy=occ, flushes=n_on,
                   launches_mesh=c_on, launches_off=c_off,
                   wall_s_mesh=w_on, wall_s_off=w_off,
                   plans=len(g_mesh.dump()["plans"]),
                   pool=g_mesh.dump()["pool"])
        del on, off
        set_members_per_device(1)
        disc = batch_mesh(-1)
        g_conf.set_val("ec_mesh_chips", -1)
        (one, n_one), c_one, w_one = mesh_leg(
            "(c) batch_mesh(-1), one member per device", flush)
        if disc.size != 1 or g_mesh.active() or \
                c_one["gf_bit_matmul"] != n_one:
            raise AssertionError(f"4w (c) discovery: {disc}, active "
                                 f"{g_mesh.active()}, K1 {c_one}")
        res["discovery"] = {"batch_mesh_-1_members": disc.size,
                            "active": g_mesh.active(), "launches": c_one,
                            "flushes": n_one}
    finally:
        for name in ("ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                     "ec_mesh_chips"):
            g_conf.rm_val(name)
        set_members_per_device(MESH_MEMBERS)
        g_mesh.topology()
    return res


def mesh_workload_metrics(dev) -> dict:
    """The CLI's four mesh workloads at its full-mode shapes, in this
    process (``--mesh``; the whole smoke reads them from 4n's CLI line)."""
    from ceph_tpu_torch.bench import workloads as w
    from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
    mm, _single = w.measure_ec_mesh(gf_gen_rs_matrix(K + M, K),
                                    mesh_chips=-1, target_seconds=2.0,
                                    device=dev)
    return {m["name"]: m for m in (
        mm, w.measure_mesh_skew(device=dev),
        w.measure_mesh_straggler(n_flushes=48, device=dev),
        w.measure_degraded_read(n_batches=32, ops_per_client=32,
                                device=dev))}


def mesh_cli_gates(metrics: dict, smi: str) -> dict:
    """4w (d): the mesh workloads' gates: the mesh encode's dispatch
    receipt identical with every member occupied, regress.py's SKEW GATE
    and STRAGGLER GATE (the injected slow member detected; the protected
    p999 ratios; zero fallbacks; every read byte-exact).  Returns each
    leg's readings and K1 / K9x launches (counted in the process that ran
    it)."""
    from ceph_tpu_torch.bench.regress import _skew_gate, _straggler_gate
    missing = [n for n in MESH_METRICS if n not in metrics]
    if missing:
        raise AssertionError(f"4w (d): mesh workloads missing {missing}")
    mm, sk, st, dr = (metrics[n] for n in MESH_METRICS)
    fails = _skew_gate(sk["name"], sk["skew"]) + \
        _straggler_gate(st["name"], st["straggler"]) + \
        _straggler_gate(dr["name"], dr["straggler"])
    occupied = [v > 0 for v in mm["per_chip_stripes"].values()]
    if (fails or not mm["identical"] or len(occupied) != MESH_MEMBERS
            or not all(occupied) or not sk["identical"]
            or not st["identical"] or not dr["identical"]
            or st["straggler"]["single_device_fallbacks"]
            or dr["straggler"]["single_device_fallbacks"]
            or not dr["straggler"]["byte_identical"]
            or not all(m["launches"]["gf_bit_matmul"]
                       for m in (mm, sk, st, dr))):
        raise AssertionError(f"4w (d) gates: {fails}, identical "
                             f"{[m.get('identical') for m in (mm, sk, st, dr)]}"
                             f", occupied {occupied}")
    out = {
        "ec_mesh": {k: mm[k] for k in ("value", "single_gibs", "speedup",
                                       "mesh_chips", "per_chip_stripes",
                                       "identical", "launches", "n_devices",
                                       "roofline")},
        "skew": {**sk["skew"], "launches": sk["launches"]},
        "straggler": {**st["straggler"], "launches": st["launches"]},
        "degraded_read": {**dr["straggler"], "launches": dr["launches"]},
        "card": smi,
        "note": f"{MESH_MEMBERS} members share one card: parity and "
                "per-member launches, not scaling"}
    for name in ("ec_mesh", "skew", "straggler", "degraded_read"):
        log(f"4w (d) {name} [{smi}; {MESH_MEMBERS} members share one card] "
            + json.dumps(out[name], default=str))
    return out


def mesh_slice(dev, smi: str, cli_metrics: dict = None) -> dict:
    """4w: the mesh on 8 members of the card.  (a) K9x against its plain
    version; (b) ShardedRS and ShardedFastRule; (c) the dispatcher's flush
    with ec_mesh_chips=8 and the discovery path; (d) the CLI's mesh
    workloads' gates (from 4n's CLI line, or run here with ``--mesh``)."""
    from ceph_tpu_torch.gf.matrices import gf_gen_rs_matrix
    from ceph_tpu_torch.mesh import set_members_per_device
    from ceph_tpu_torch.ops.gf_matmul import DeviceRSBackend
    t_phase = time.perf_counter()
    set_members_per_device(MESH_MEMBERS)
    matrix = gf_gen_rs_matrix(K + M, K)
    res = {"members": MESH_MEMBERS, "card": smi}
    t0 = time.perf_counter()
    res["k9x"] = mesh_k9x(dev, DeviceRSBackend(matrix, dev))
    res["a_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["sharded"] = mesh_sharded(dev, matrix)
    res["b_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res["dispatch"] = mesh_dispatch(dev)
    res["c_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if cli_metrics is None:
        cli_metrics = mesh_workload_metrics(dev)
        res["d_source"] = "this process"
    else:
        res["d_source"] = "4n's bench CLI process"
    res["workloads"] = mesh_cli_gates(cli_metrics, smi)
    res["d_s"] = time.perf_counter() - t0
    sharded = res["sharded"]
    legs = [sharded[n]["launches"] for n in (
        "encode", "decode", "decode_survivor_sharded", "reshard", "crush")]
    legs += [res["dispatch"]["launches_mesh"],
             res["dispatch"]["launches_off"],
             res["dispatch"]["discovery"]["launches"]]
    res["launches"] = {n: sum(leg[n] for leg in legs)
                       for n in mesh_counters()}
    res["cli_launches"] = {
        n: sum(res["workloads"][w]["launches"][n] for w in (
            "ec_mesh", "skew", "straggler", "degraded_read"))
        for n in ("gf_bit_matmul", "mesh_xor")}
    res["seconds"] = time.perf_counter() - t_phase
    log(f"4w took {res['seconds']:.1f} s ((a) {res['a_s']:.1f}, (b) "
        f"{res['b_s']:.1f}, (c) {res['c_s']:.1f}, (d) {res['d_s']:.1f}); "
        "launches " + json.dumps(res["launches"]) + ", CLI legs "
        + json.dumps(res["cli_launches"]))
    return res


def mesh_alone(dev) -> None:
    """``--mesh``: 4w alone after phases 1-2, its four workloads run in
    this process, its record written to ``chiprun_out/mesh.json``."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    os.makedirs("chiprun_out", exist_ok=True)
    out = mesh_slice(dev, smi.splitlines()[0])
    with open(os.path.join("chiprun_out", "mesh.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)



# ---- 4x: a block device on an erasure-coded data pool -------------------------
RBD_ORDER = 22                    # rbd's default object size, 4 MiB
RBD_OBJECTS = 64                  # a 256 MiB image
RBD_REP_PG_NUM = 32               # the replicated pool of headers, journals
RBD_RAND_WRITES = 128             # rbd bench --io-type write --io-size 4K
RBD_SMOKE_RAND_WRITES = 64        #   (the whole smoke's, for its time limit)
RBD_RAND_IO = 4096                #   --io-pattern rand
RBD_CLONE_WRITES = 16             # writes into the clone (copyups)
RBD_MIRROR_OSDS = 6               # the mirror's destination cluster
RBD_MIRROR_K, RBD_MIRROR_M = 4, 2
RBD_MIRROR_PG_NUM = 32
RBD_CHECK_OBJECTS = 8             # objects whose stored shards are checked
RBD_TRACE_WRITES = 16             # the traced sample: 4 KiB writes
RBD_TRACE_OBJECTS = 4             #   and whole-object rewrites


def k1_legs(phase: str, dev, out: dict, total: dict):
    """``counted(name, drive, traced=False, **rec)`` of a phase: runs
    ``drive`` with K1's count set to 0 just before and read just after,
    adds the count to ``total`` and records the leg (its wall, K1
    launches, ``rec`` and what ``drive`` returns) in ``out["legs"]``.  A
    ``traced`` leg runs under ``LegTrace`` and adds its busy shares; the
    profiler's cost is in its wall, so the timed legs run untraced."""
    from ceph_tpu_torch.ops import gf_pallas

    def counted(name, drive, traced=False, **rec):
        gf_pallas.launches.reset()
        t0 = time.perf_counter()
        if traced:
            with LegTrace(dev, [gf_pallas.launches]) as tr:
                extra_rec = drive() or {}
            rec.update({k: v for k, v in tr.reading().items() if k in (
                "device_busy_share", "kernel_share", "device_busy_ms",
                "kernel_ms", "timed_device_call_share")})
        else:
            extra_rec = drive() or {}
        wall = time.perf_counter() - t0
        n = gf_pallas.launches.n
        total["gf_bit_matmul"] += n
        leg = {"wall_s": wall, "k1_launches": n, **rec, **extra_rec}
        out["legs"][name] = leg
        log(f"{phase} {name}: " + json.dumps(leg, default=str))
        return leg
    return counted


def shard_pair(shard_sets, replica_sets) -> list:
    """Two OSDs holding data shards of one object, from the first of
    ``shard_sets`` (each an object's data-shard OSDs, the leg's first
    object first) that has such a pair, whose loss leaves every PG in
    ``replica_sets`` (a replicated pool's acting sets) two of its three
    copies.  An image's or bucket's id is random, so the first object's
    PG can have no such pair."""
    for data in shard_sets:
        for i, a in enumerate(data):
            for b in data[i + 1:]:
                if not any({a, b} <= set(held) for held in replica_sets):
                    return [a, b]
    raise AssertionError("no two data-shard OSDs spare the replicated pool")


def rbd_slice(dev, order: int = RBD_ORDER, n_obj: int = RBD_OBJECTS,
              pg_num: int = OSD_PATH_PG_NUM,
              rep_pg_num: int = RBD_REP_PG_NUM,
              rand_writes: int = RBD_RAND_WRITES,
              rand_io: int = RBD_RAND_IO,
              clone_writes: int = RBD_CLONE_WRITES,
              mirror_pg_num: int = RBD_MIRROR_PG_NUM,
              check_objects: int = RBD_CHECK_OBJECTS,
              trace_writes: int = RBD_TRACE_WRITES,
              trace_objects: int = RBD_TRACE_OBJECTS) -> dict:
    """4x: a block device whose data lives on an erasure-coded pool, as a
    user makes one with ``rbd create --size 256M --data-pool ecdata
    --journaling``: a ``MiniCluster`` of 12 OSDs, one per host; a
    replicated pool ``rbd`` (size 3) for the headers and the journal; an
    ``ecdata`` pool, ``cuda`` plugin k=8 m=4, ``pg_num`` PGs; an image of
    ``n_obj`` objects of ``2**order`` bytes.  Legs, the counts set to 0
    just before each and read just after:

    (a) fill the image, one write per object: K1 once per write;
    (b) ``rand_writes`` writes of ``rand_io`` bytes at seeded random
        offsets (``rbd bench --io-type write --io-pattern rand``); each
        rewrites its object through ECBackend's read-modify-write, so K1
        once per write; p50 and p99 per op;
    (c) ``snap create`` and ``protect``, a clone whose data also lives on
        ``ecdata``, then ``clone_writes`` writes into the clone (each a
        copyup of its parent object into the EC pool): K1 per write;
    (d) two OSDs holding data shards of the first object (and no two
        copies of one object of the replicated pool) killed and marked
        down, then the image, its snapshot and the clone exported:
        K1 decodes each object that lost a data shard; every export
        equal to a numpy model of the image;
    (e) an ``ImageMirror`` replays the source journal onto a second
        ``MiniCluster`` (6 OSDs, a k=4 m=2 ``cuda`` data pool of
        ``mirror_pg_num`` PGs): the destination's export equals the
        source; K1 once per replayed write.

    After (b) a traced sample (``trace_writes`` more 4 KiB writes and
    ``trace_objects`` whole-object rewrites under ``LegTrace``) gives the
    device's busy share, if the profiler sees it; the timed legs run
    untraced.  After (c) the stored shards of ``check_objects`` objects
    equal the native host coder's.  Each leg records its wall and K1
    launches.  On the
    CPU (a rehearsal at small sizes) the codecs take ``backend=host`` and
    the launch counts are not checked."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.rbd import Image, ImageMirror, RBD
    on_card = dev.type == "cuda"
    extra = {} if on_card else {"backend": "host"}
    obj = 1 << order
    size = n_obj * obj
    out = {"legs": {}, "config": {
        "osds": OSD_PATH_OSDS, "pg_num": pg_num, "rep_pg_num": rep_pg_num,
        "k": K, "m": M, "plugin": "cuda", "extra_profile": extra,
        "order": order, "objects": n_obj, "image_bytes": size,
        "rand_writes": rand_writes, "rand_io": rand_io,
        "clone_writes": clone_writes, "mirror_osds": RBD_MIRROR_OSDS,
        "mirror_k": RBD_MIRROR_K, "mirror_m": RBD_MIRROR_M,
        "mirror_pg_num": mirror_pg_num}}
    total = {"gf_bit_matmul": 0}
    t_slice = time.perf_counter()

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4x: {what}")

    counted = k1_legs("4x", dev, out, total)

    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "ec_mesh_chips", "osd_op_num_threads",
                 "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    rng = np.random.default_rng(SEED + 7)
    model = bytearray(size)
    matrix = create_erasure_code({"plugin": "cuda", "k": str(K),
                                  "m": str(M), "backend": "host"}
                                 ).codec.matrix

    t0 = time.perf_counter()
    c = MiniCluster(n_osds=OSD_PATH_OSDS)
    c.create_replicated_pool("rbd", size=3, pg_num=rep_pg_num)
    data_pid = c.create_ec_pool("ecdata", k=K, m=M, pg_num=pg_num,
                                plugin="cuda", extra_profile=extra)
    cl = c.client("client.rbd")
    rbd = RBD(cl)
    rbd.create("rbd", "vm", size, order, data_pool="ecdata",
               journaling=True)
    img = Image(cl, "rbd", "vm")
    out["boot_s"] = time.perf_counter() - t0
    log(f"4x: MiniCluster of {OSD_PATH_OSDS} OSDs, pools rbd "
        f"({rep_pg_num} PGs) and ecdata ({pg_num} PGs), image of "
        f"{size >> 20} MiB up in {out['boot_s']:.1f} s")

    def write(image, off, data, mirror_model=True):
        if image.write(off, data) != len(data):
            raise AssertionError(f"4x: short write at {off}")
        if mirror_model:
            model[off:off + len(data)] = data

    # -- (a) fill ----------------------------------------------------------------
    def fill():
        for i in range(n_obj):
            write(img, i * obj, rng.integers(0, 256, obj,
                                             dtype=np.uint8).tobytes())
    leg = counted("a_fill", fill, writes=n_obj)
    leg["GiBps"] = size / leg["wall_s"] / 2**30
    need(leg["k1_launches"] == n_obj,
         f"(a) K1 launches {leg['k1_launches']} for {n_obj} writes")

    # -- (b) random small writes ---------------------------------------------------
    offs = rng.integers(0, size // rand_io, rand_writes) * rand_io
    lat = []

    def rand():
        for off in offs:
            t = time.perf_counter()
            write(img, int(off), rng.integers(0, 256, rand_io,
                                              dtype=np.uint8).tobytes())
            lat.append(time.perf_counter() - t)
        return {"p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "ops_per_s": len(lat) / sum(lat)}
    leg = counted("b_rand_4k", rand, writes=rand_writes)
    need(leg["k1_launches"] == rand_writes,
         f"(b) K1 launches {leg['k1_launches']} for {rand_writes} writes")
    # the device's share of such writes, from a traced sample of them and
    # of whole-object rewrites
    sample_offs = rng.integers(0, size // rand_io, trace_writes) * rand_io

    def sample():
        for off in sample_offs:
            write(img, int(off), rng.integers(0, 256, rand_io,
                                              dtype=np.uint8).tobytes())
        for i in range(trace_objects):
            write(img, i * obj, rng.integers(0, 256, obj,
                                             dtype=np.uint8).tobytes())
    leg = counted("t_traced_sample", sample, traced=True,
                  writes=trace_writes + trace_objects)
    need(leg["k1_launches"] == trace_writes + trace_objects,
         f"(t) K1 launches {leg['k1_launches']} for "
         f"{trace_writes + trace_objects} writes")

    # -- (c) snapshot, clone, copyups into the EC pool --------------------------
    snap_model = bytes(model)
    child_model = bytearray(model)

    def clone():
        img.snap_create("s1")
        img.snap_protect("s1")
        rbd.clone("rbd", "vm", "s1", "rbd", "child", data_pool="ecdata")
        child = Image(cl, "rbd", "child")
        for objno in rng.choice(n_obj, clone_writes, replace=False):
            off = int(objno) * obj + int(rng.integers(0, obj // rand_io)) \
                * rand_io
            data = rng.integers(0, 256, rand_io, dtype=np.uint8).tobytes()
            write(child, off, data, mirror_model=False)
            child_model[off:off + len(data)] = data
        return {"parent": "vm@s1"}
    leg = counted("c_snap_clone", clone, writes=clone_writes)
    need(leg["k1_launches"] == clone_writes,
         f"(c) K1 launches {leg['k1_launches']} for {clone_writes} "
         "copyup writes")
    # the stored shards of a sample of objects, against the native coder
    sample = sorted(int(i) for i in rng.choice(n_obj, min(check_objects,
                                                          n_obj),
                                               replace=False))
    expect = {img._obj(i): native_shards(
        matrix, K, CHUNK, bytes(model[i * obj:(i + 1) * obj]))
        for i in sample}
    t0 = time.perf_counter()
    held = check_bodies(c, data_pid, expect, "4x (c)")
    if held != len(sample) * (K + M):
        raise AssertionError(f"4x (c): {held} bodies of {len(sample)} "
                             "objects")
    out["shards_checked"] = held
    out["shard_check_s"] = time.perf_counter() - t0

    # -- (d) two OSDs down: degraded exports -----------------------------------
    # two OSDs that hold data shards of one object (the first that has
    # such a pair, ``shard_pair``), picked so that
    # every object of the replicated pool (headers, the directory, the
    # journal) keeps two of its three copies, its min_size: the journal
    # stays writable for (e)'s mirror, as the reference requires of a
    # PG that takes writes
    rep_pid = c.mon.osdmap.lookup_pg_pool_name("rbd")
    rep_sets = [set(acting_of(c, cl, "rbd", oid)) for oid in sorted({
        ho.oid for osd in c.osds.values()
        for cid in osd.store.list_collections()
        if cid.startswith(f"{rep_pid}.") and not cid.endswith("_meta")
        for ho in osd.store.list_objects(cid)})]
    victims = shard_pair((acting_of(c, cl, "ecdata", img._obj(i))[1:K]
                          for i in range(n_obj)), rep_sets)
    lost = {i for i in range(n_obj)
            if set(acting_of(c, cl, "ecdata", img._obj(i))[:K])
            & set(victims)}
    t0 = time.perf_counter()
    for v in victims:
        c.kill_osd(v)
        c.mark_osd_down(v)
    out["mark_down_s"] = time.perf_counter() - t0
    exports = {}

    def export():
        views = {"vm": Image(cl, "rbd", "vm"),
                 "vm@s1": Image(cl, "rbd", "vm", snapshot="s1"),
                 "child": Image(cl, "rbd", "child")}
        for name, view in views.items():
            exports[name] = view.read(0, size)
        want = {"vm": bytes(model), "vm@s1": snap_model,
                "child": bytes(child_model)}
        for name in views:
            if exports[name] != want[name]:
                raise AssertionError(f"4x (d): export of {name} differs "
                                     "from the model")
        return {"exports": sorted(views)}
    leg = counted("d_degraded_export", export, victims=victims,
                  objects_missing_a_data_shard=len(lost),
                  mark_down_s=out["mark_down_s"])
    leg["GiBps"] = 3 * size / leg["wall_s"] / 2**30
    need(leg["k1_launches"] >= len(lost) > 0,
         f"(d) K1 launches {leg['k1_launches']} for {len(lost)} objects "
         "with a lost data shard per export")

    # -- (e) the mirror: replay the journal onto a second cluster ---------------
    t0 = time.perf_counter()
    dst = MiniCluster(n_osds=RBD_MIRROR_OSDS)
    dst.create_replicated_pool("rbd", size=3, pg_num=8)
    dst.create_ec_pool("ecdata", k=RBD_MIRROR_K, m=RBD_MIRROR_M,
                       pg_num=mirror_pg_num, plugin="cuda",
                       extra_profile=extra)
    dcl = dst.client("client.mirror")
    out["mirror_boot_s"] = time.perf_counter() - t0
    replayed = []

    def mirror():
        mi = ImageMirror(cl, "rbd", "vm", dcl, "rbd",
                         dst_data_pool="ecdata")
        replayed.append(mi.run_once())
        got = Image(dcl, "rbd", "vm").read(0, size)
        if got != bytes(model):
            raise AssertionError("4x (e): the mirror's export differs "
                                 "from the source")
        return {"events_replayed": replayed[0]}
    leg = counted("e_mirror", mirror)
    journaled = n_obj + rand_writes + trace_writes + trace_objects
    need(leg["k1_launches"] == journaled,
         f"(e) K1 launches {leg['k1_launches']} for {journaled} replayed "
         "writes")
    for cluster in (c, dst):
        for osd in cluster.osds.values():
            osd.shutdown()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4x: launches " + json.dumps(total) + f"; {out['seconds']:.1f} s")
    return out


def rbd_alone(dev) -> None:
    """``--rbd``: 4x alone after phases 1-2, its record written to
    ``chiprun_out/rbd.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    out = rbd_slice(dev)
    with open(os.path.join("chiprun_out", "rbd.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


CEPHFS_META_PG_NUM = 32           # the metadata pool (replicated, size 3)
CEPHFS_DATA_PG_NUM = 64           # the data pool (cuda k=8 m=4)
CEPHFS_BIG_FILES = 32             # (a) files of one 4 MiB object each
CEPHFS_BIG_BYTES = 4 << 20        #   (cephfs's default layout, order 22)
CEPHFS_SMALL_FILES = 256          # (b) small files
CEPHFS_SMALL_BYTES = 4096
CEPHFS_DIRS = 16                  #   spread over these directories
CEPHFS_TRACE_BIG = 2              # the traced sample: 4 MiB files
CEPHFS_TRACE_SMALL = 16           #   and 4 KiB files


def fs_walk(fs, path: str = "/") -> dict:
    """The namespace under ``path`` as ``RemoteCephFS`` lists it:
    path -> inode."""
    out = {}
    for name, inode in sorted(fs.listdir(path).items()):
        sub = path.rstrip("/") + "/" + name
        out[sub] = inode
        if inode.get("type") == "dir":
            out.update(fs_walk(fs, sub))
    return out


def fs_names(inodes: dict) -> dict:
    """path -> (type, ino, size): what a replay must give back."""
    return {p: (i.get("type"), i.get("ino"), i.get("size", 0))
            for p, i in inodes.items()}


def cephfs_slice(dev, big_files: int = CEPHFS_BIG_FILES,
                 big_bytes: int = CEPHFS_BIG_BYTES,
                 small_files: int = CEPHFS_SMALL_FILES,
                 small_bytes: int = CEPHFS_SMALL_BYTES,
                 dirs: int = CEPHFS_DIRS,
                 meta_pg_num: int = CEPHFS_META_PG_NUM,
                 data_pg_num: int = CEPHFS_DATA_PG_NUM,
                 trace_big: int = CEPHFS_TRACE_BIG,
                 trace_small: int = CEPHFS_TRACE_SMALL) -> dict:
    """4y: a filesystem whose file data lives on an erasure-coded pool,
    as a user makes one with ``ceph osd pool create fsdata erasure`` and
    ``ceph fs new``: a ``MiniCluster`` of 12 OSDs, one per host; a
    replicated ``fsmeta`` pool (size 3, ``meta_pg_num`` PGs) for the
    directories, the InoTable and the MDS journal; an ``fsdata`` pool,
    ``cuda`` plugin k=8 m=4, stripe unit 4096, ``data_pg_num`` PGs; an
    ``MDSDaemon`` that makes the filesystem, and two ``RemoteCephFS``
    clients A and B, each driving the MDS and its peer from its blocked
    requests.  Legs, K1's count set to 0 just before each and read just
    after:

    (a) A opens ``big_files`` files for writing under the BUFFER cap and
        buffers ``big_bytes`` into each; B opens and reads each, which
        makes the MDS revoke A's caps, and A's flush writes the object
        (K1 once per object) before B's read is granted; byte-exact;
    (b) ``small_files`` files of ``small_bytes`` in ``dirs`` directories:
        create, write and stat each, p50 / p99 per file; K1 once per
        file;
    (c) ``snap_create`` on one directory, a file in it overwritten, and
        the snapshot's view reads the old bytes, the head the new;
    (d) two OSDs holding data shards of the first file (and no two
        copies of any PG of ``fsmeta``) killed and marked down; every
        file read back equal to a numpy model: K1 decodes each object
        that lost a data shard;
    (e) the MDS dropped and a fresh ``MDSDaemon(mkfs=False)`` replays the
        journal; a new client's walk of the namespace equals what it was,
        and every file's bytes, read from the data pool through the
        replayed inodes, equal the model.

    After (b) a traced sample (``trace_big`` buffered 4 MiB files read by
    B and ``trace_small`` small files, under ``LegTrace``) gives the
    device's busy share, if the profiler sees it; the timed legs run
    untraced.  The phase fails if K1's count stays 0 in (a), (b) or (d),
    if no object lost a data shard in (d), or if any read differs.  On
    the CPU (a rehearsal at small sizes) the codec takes
    ``backend=host`` and the launch counts are not checked."""
    from ceph_tpu_torch.cephfs.cls_fs import file_oid
    from ceph_tpu_torch.cephfs.mds_client import RemoteCephFS
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.mds import MDSDaemon
    from ceph_tpu_torch.msg.messages import CEPH_CAP_FILE_BUFFER
    from ceph_tpu_torch.osdmap import ceph_stable_mod, pg_t
    on_card = dev.type == "cuda"
    extra = {} if on_card else {"backend": "host"}
    out = {"legs": {}, "config": {
        "osds": OSD_PATH_OSDS, "meta_pg_num": meta_pg_num,
        "data_pg_num": data_pg_num, "k": K, "m": M, "plugin": "cuda",
        "stripe_unit": CHUNK, "extra_profile": extra,
        "big_files": big_files, "big_bytes": big_bytes,
        "small_files": small_files, "small_bytes": small_bytes,
        "dirs": dirs}}
    total = {"gf_bit_matmul": 0}
    t_slice = time.perf_counter()

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4y: {what}")

    def same(got, want, what):
        if got != want:
            raise AssertionError(f"4y: {what} differs from the model")

    counted = k1_legs("4y", dev, out, total)

    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "ec_mesh_chips", "osd_op_num_threads",
                 "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    rng = np.random.default_rng(SEED + 8)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    t0 = time.perf_counter()
    c = MiniCluster(n_osds=OSD_PATH_OSDS)
    meta_pid = c.create_replicated_pool("fsmeta", size=3,
                                        pg_num=meta_pg_num)
    data_pid = c.create_ec_pool("fsdata", k=K, m=M, pg_num=data_pg_num,
                                plugin="cuda", extra_profile=extra)
    srv = {"mds": MDSDaemon(c.network, c.client("client.mds"), "mds.0",
                            mkfs=True)}
    fa = RemoteCephFS(c.client("client.a"))
    fb = RemoteCephFS(c.client("client.b"))
    # cooperative scheduling, as the MDS's own tests run it: a blocked
    # client drives the MDS and its peer
    fa._drive = lambda: (srv["mds"].process(), fb.process())
    fb._drive = lambda: (srv["mds"].process(), fa.process())
    fa.mkdir("/big")
    fa.mkdir("/small")
    for j in range(dirs):
        fa.mkdir(f"/small/d{j:02d}")
    out["boot_s"] = time.perf_counter() - t0
    log(f"4y: MiniCluster of {OSD_PATH_OSDS} OSDs, pools fsmeta "
        f"({meta_pg_num} PGs) and fsdata ({data_pg_num} PGs), the MDS and "
        f"{dirs + 2} directories up in {out['boot_s']:.1f} s")
    model = {}

    def buffered(paths):
        """A buffers each file under the BUFFER cap; B reads each, which
        revokes A's caps and makes A flush first."""
        handles = []
        for path in paths:
            fh = fa.open(path, "w")
            if not fh.caps & CEPH_CAP_FILE_BUFFER:
                raise AssertionError(f"4y: {path} opened without BUFFER")
            model[path] = body(big_bytes)
            fh.write(model[path], 0)
            handles.append(fh)
        for path in paths:
            same(fb.read(path), model[path], f"B's read of {path}")
        revoked = sum(fh.caps == 0 for fh in handles)
        if revoked != len(handles):
            raise AssertionError(f"4y: {revoked} of {len(handles)} "
                                 "buffered handles revoked")
        for fh in handles:
            fh.close()
        return {"revoked": revoked}

    def small(paths):
        lat = []
        for path in paths:
            model[path] = body(small_bytes)
            t = time.perf_counter()
            fa.create(path)
            fa.write(path, model[path], 0)
            size = fa.stat(path)["size"]
            lat.append(time.perf_counter() - t)
            if size != small_bytes:
                raise AssertionError(f"4y: {path} stat size {size}")
        return lat

    # -- (a) buffered 4 MiB files, B's reads revoke A's caps ---------------------
    big = [f"/big/f{i:03d}" for i in range(big_files)]
    leg = counted("a_buffered_revoke", lambda: buffered(big),
                  files=big_files)
    leg["GiBps"] = big_files * big_bytes / leg["wall_s"] / 2**30
    need(leg["k1_launches"] >= big_files,
         f"(a) K1 launches {leg['k1_launches']} for {big_files} files")

    # -- (b) small files: create, write, stat ------------------------------------
    smalls = [f"/small/d{i % dirs:02d}/f{i:04d}" for i in range(small_files)]

    def leg_b():
        lat = small(smalls)
        return {"p50_ms": 1e3 * float(np.percentile(lat, 50)),
                "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                "files_per_s": len(lat) / sum(lat)}
    leg = counted("b_small_files", leg_b, files=small_files)
    need(leg["k1_launches"] >= small_files,
         f"(b) K1 launches {leg['k1_launches']} for {small_files} files")
    # the device's share of such work, from a traced sample of both kinds
    t_big = [f"/big/t{i:03d}" for i in range(trace_big)]
    t_small = [f"/small/d00/t{i:04d}" for i in range(trace_small)]

    def sample():
        buffered(t_big)
        small(t_small)
    leg = counted("t_traced_sample", sample, traced=True,
                  files=trace_big + trace_small)
    need(leg["k1_launches"] >= trace_big + trace_small,
         f"(t) K1 launches {leg['k1_launches']} for "
         f"{trace_big + trace_small} files")

    # -- (c) a subtree's snapshot, then an overwrite -----------------------------
    snap_dir, snap_file = "/small/d01", smalls[1]

    def leg_c():
        old = model[snap_file]
        snap = fa.snap_create(snap_dir, "s1")
        model[snap_file] = body(small_bytes)
        fa.write(snap_file, model[snap_file], 0)
        view = fa.snapshot(snap_dir, "s1")
        same(view.read(snap_file.rsplit("/", 1)[1]), old,
             f"the snapshot's view of {snap_file}")
        same(fb.read(snap_file), model[snap_file], f"the head {snap_file}")
        return {"snap": snap}
    counted("c_snapshot", leg_c)

    # -- (d) two OSDs down: every file read back ---------------------------------
    # the acting sets of every PG of both pools, by the monitor's map
    m = c.mon.osdmap
    meta_sets, data_sets = ([[int(o) for o in m.pg_to_up_acting_osds(
        pg_t(pid, ps))[2]] for ps in range(n)] for pid, n in (
            (meta_pid, meta_pg_num), (data_pid, data_pg_num)))

    def data_acting(oid):
        pool = m.get_pg_pool(data_pid)
        ps = ceph_stable_mod(m.map_to_pg(data_pid, oid).ps, pool.pg_num,
                             pool.pg_num_mask)
        return data_sets[ps]

    namespace = fs_names(fs_walk(fb))
    objects = [file_oid(namespace[p][1], 0) for p in sorted(model)]
    victims = shard_pair((data_acting(file_oid(namespace[p][1], 0))[1:K]
                          for p in big), meta_sets)
    lost = sum(1 for oid in objects
               if set(data_acting(oid)[:K]) & set(victims))
    if not lost:
        raise AssertionError("4y (d): no object lost a data shard")
    t0 = time.perf_counter()
    for v in victims:
        c.kill_osd(v)
        c.mark_osd_down(v)
    out["mark_down_s"] = time.perf_counter() - t0

    def leg_d():
        for path in sorted(model):
            same(fb.read(path), model[path], f"degraded read of {path}")
    leg = counted("d_degraded_reads", leg_d, victims=victims,
                  files=len(model), objects_missing_a_data_shard=lost,
                  mark_down_s=out["mark_down_s"])
    leg["GiBps"] = sum(map(len, model.values())) / leg["wall_s"] / 2**30
    need(leg["k1_launches"] >= lost,
         f"(d) K1 launches {leg['k1_launches']} for {lost} objects with "
         "a lost data shard")

    # -- (e) a fresh MDS replays the journal ---------------------------------------
    def leg_e():
        srv["mds"] = MDSDaemon(c.network, c.client("client.mds2"), "mds.0")
        fe = RemoteCephFS(c.client("client.e"))
        fe._drive = lambda: srv["mds"].process()
        inodes = fs_walk(fe)
        if fs_names(inodes) != namespace:
            raise AssertionError("4y (e): the replayed namespace differs")
        for path in sorted(model):
            inode = inodes[path]
            same(fe._read_data(inode, 0, None, inode["size"]), model[path],
                 f"the replayed inode's bytes of {path}")
        return {"entries": len(namespace)}
    counted("e_mds_replay", leg_e)
    for osd in c.osds.values():
        osd.shutdown()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4y: launches " + json.dumps(total) + f"; {out['seconds']:.1f} s")
    return out


def cephfs_alone(dev) -> None:
    """``--cephfs``: 4y alone after phases 1-2, its record written to
    ``chiprun_out/cephfs.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    out = cephfs_slice(dev)
    with open(os.path.join("chiprun_out", "cephfs.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


RGW_META_PG_NUM = 32              # the gateway's metadata pool (size 3)
RGW_DATA_PG_NUM = 32              # the data pool (cuda k=8 m=4), 4x's cut
RGW_BIG_OBJECTS = 16              # (a) PUTs of 16 MiB, 4 chunks each
RGW_BIG_BYTES = 16 << 20
RGW_SMALL_OBJECTS = 128           # (b) PUTs of 4 KiB
RGW_SMALL_BYTES = 4096
RGW_PARTS = 3                     # (c) a multipart upload of 8 MiB parts
RGW_PART_BYTES = 8 << 20
RGW_OVERWRITES = 8                # (d) keys overwritten once versioned
RGW_TRACE_BIG = 2                 # the traced sample: 16 MiB PUTs
RGW_TRACE_SMALL = 16              #   and 4 KiB PUTs


class S3Client:
    """A storage user's S3 client: path-style requests over HTTP to
    ``127.0.0.1:port``, each signed with AWS signature v4 by the user's
    keys.  ``req`` raises on any reply outside 2xx unless ``ok`` is
    false."""

    def __init__(self, port: int, access_key: str, secret_key: str):
        self.port = port
        self.keys = (access_key, secret_key)

    def req(self, method, path, body=b"", query=None, ok=True):
        import http.client
        from urllib.parse import urlencode

        from ceph_tpu_torch.rgw.http import sign_v4
        query = dict(query or {})
        hdrs = {"Host": f"127.0.0.1:{self.port}"}
        hdrs["Authorization"] = sign_v4(*self.keys, method, path, hdrs,
                                        query, body)
        url = path + ("?" + urlencode(query) if query else "")
        conn = http.client.HTTPConnection("127.0.0.1", self.port,
                                          timeout=300)
        try:
            conn.request(method, url, body, hdrs)
            r = conn.getresponse()
            out = r.read()
        finally:
            conn.close()
        if ok and not 200 <= r.status < 300:
            raise AssertionError(f"4z: {method} {url} answered {r.status}: "
                                 f"{out[:300]!r}")
        return r.status, dict(r.getheaders()), out


def rgw_slice(dev, big_objects: int = RGW_BIG_OBJECTS,
              big_bytes: int = RGW_BIG_BYTES,
              small_objects: int = RGW_SMALL_OBJECTS,
              small_bytes: int = RGW_SMALL_BYTES,
              parts: int = RGW_PARTS, part_bytes: int = RGW_PART_BYTES,
              overwrites: int = RGW_OVERWRITES,
              meta_pg_num: int = RGW_META_PG_NUM,
              data_pg_num: int = RGW_DATA_PG_NUM,
              trace_big: int = RGW_TRACE_BIG,
              trace_small: int = RGW_TRACE_SMALL) -> dict:
    """4z: an S3 object store whose data lives on an erasure-coded pool,
    as a user deploys radosgw with an EC data pool: a ``MiniCluster`` of
    12 OSDs, one per host; a replicated ``rgwmeta`` pool (size 3,
    ``meta_pg_num`` PGs) for users, buckets and bucket indexes; an
    ``rgwdata`` pool, ``cuda`` plugin k=8 m=4, stripe unit 4096,
    ``data_pg_num`` PGs; ``RGWLite`` behind ``S3Frontend`` under
    ``serve()`` on localhost, and a user made by ``radosgw-admin user
    create`` whose keys sign every request (AWS v4).  Legs, K1's count
    set to 0 just before each and read just after:

    (a) ``big_objects`` PUTs of ``big_bytes`` (4 MiB chunks, K1 once per
        chunk), each GET back byte-exact with its ETag the md5;
    (b) ``small_objects`` PUTs of ``small_bytes``, p50 / p99 per PUT;
    (c) a multipart upload of ``parts`` parts of ``part_bytes`` (one
        object each), completed (the stitched object re-written in
        chunks); its GET equals the concatenation;
    (d) versioning enabled on (b)'s bucket and ``overwrites`` keys
        overwritten; a lifecycle rule (noncurrent after 3 days),
        ``lc_process`` four days on and ``gc``: the data pool then holds
        exactly the model's live chunks;
    (e) two OSDs holding data shards killed and marked down; every live
        object's GET equals a numpy model: K1 decodes each chunk that
        lost a data shard.

    After (b) a traced sample (``trace_big`` big and ``trace_small``
    small PUTs, under ``LegTrace``) gives the device's busy share, if the
    profiler sees it; the timed legs run untraced.  The phase fails if
    K1's count stays 0 in (a), (b), (c) or (e), if no chunk lost a data
    shard in (e), if any GET differs, or if any request that should
    succeed gets a reply outside 2xx (a failed K1 build or launch under
    a PUT reaches the client as a 500).  On the CPU (a rehearsal at small
    sizes) the codec takes ``backend=host`` and the launch counts are
    not checked."""
    import contextlib
    import hashlib
    import io

    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.osdmap import ceph_stable_mod, pg_t
    from ceph_tpu_torch.rgw import RGWLite, S3Frontend, serve
    from ceph_tpu_torch.rgw.gateway import CHUNK as RGW_CHUNK
    from ceph_tpu_torch.tools import rgw_admin
    on_card = dev.type == "cuda"
    extra = {} if on_card else {"backend": "host"}
    out = {"legs": {}, "config": {
        "osds": OSD_PATH_OSDS, "meta_pg_num": meta_pg_num,
        "data_pg_num": data_pg_num, "k": K, "m": M, "plugin": "cuda",
        "stripe_unit": CHUNK, "extra_profile": extra,
        "big_objects": big_objects, "big_bytes": big_bytes,
        "small_objects": small_objects, "small_bytes": small_bytes,
        "parts": parts, "part_bytes": part_bytes,
        "overwrites": overwrites}}
    total = {"gf_bit_matmul": 0}
    t_slice = time.perf_counter()

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4z: {what}")

    def same(got, want, what):
        if got != want:
            raise AssertionError(f"4z: {what} differs from the model")

    counted = k1_legs("4z", dev, out, total)

    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "ec_mesh_chips", "osd_op_num_threads",
                 "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    rng = np.random.default_rng(SEED + 9)

    def body(n):
        return rng.integers(0, 256, n, dtype=np.uint8).tobytes()

    t0 = time.perf_counter()
    c = MiniCluster(n_osds=OSD_PATH_OSDS)
    meta_pid = c.create_replicated_pool("rgwmeta", size=3,
                                        pg_num=meta_pg_num)
    data_pid = c.create_ec_pool("rgwdata", k=K, m=M, pg_num=data_pg_num,
                                plugin="cuda", extra_profile=extra)
    cl = c.client("client.rgw")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = rgw_admin.run(c, cl, ["user", "create", "--uid", "s3user",
                                   "--display-name", "S3 User"])
    if rc != 0:
        raise AssertionError(f"4z: radosgw-admin user create exited {rc}")
    user = json.loads(buf.getvalue())
    g = RGWLite(cl, "rgwmeta", "rgwdata")
    srv, port = serve(S3Frontend(g))
    s3 = S3Client(port, user["access_key"], user["secret_key"])
    for b in ("big", "small", "mp", "trace"):
        s3.req("PUT", f"/{b}")
    out["boot_s"] = time.perf_counter() - t0
    log(f"4z: MiniCluster of {OSD_PATH_OSDS} OSDs, pools rgwmeta "
        f"({meta_pg_num} PGs) and rgwdata ({data_pg_num} PGs), the S3 "
        f"frontend on port {port}, a user and 4 buckets up in "
        f"{out['boot_s']:.1f} s")
    # bucket/key -> the object's bytes; (bucket, key) -> its version id
    model, vids = {}, {}
    try:
        def put(bucket, key, data):
            model[(bucket, key)] = data
            _st, hdrs, _ = s3.req("PUT", f"/{bucket}/{key}", data)
            vids[(bucket, key)] = hdrs.get("x-amz-version-id")
            return hdrs

        def get(bucket, key, what):
            _st, hdrs, got = s3.req("GET", f"/{bucket}/{key}")
            want = model[(bucket, key)]
            same(got, want, what)
            if hdrs.get("ETag") != f'"{hashlib.md5(want).hexdigest()}"':
                raise AssertionError(f"4z: {what}'s ETag {hdrs.get('ETag')}")

        # -- (a) big objects, 4 chunks each ---------------------------------
        bigs = [f"obj{i:03d}" for i in range(big_objects)]

        def leg_a():
            for key in bigs:
                hdrs = put("big", key, body(big_bytes))
                etag = hashlib.md5(model[("big", key)]).hexdigest()
                if hdrs.get("ETag") != f'"{etag}"':
                    raise AssertionError(f"4z: PUT big/{key}'s ETag")
            for key in bigs:
                get("big", key, f"GET big/{key}")
        chunks_a = big_objects * -(-big_bytes // RGW_CHUNK)
        leg = counted("a_big_puts", leg_a, objects=big_objects,
                      chunks=chunks_a)
        leg["GiBps"] = 2 * big_objects * big_bytes / leg["wall_s"] / 2**30
        need(leg["k1_launches"] >= chunks_a,
             f"(a) K1 launches {leg['k1_launches']} for {chunks_a} chunks")

        # -- (b) small objects ------------------------------------------------
        smalls = [f"d{i % 16:02d}/o{i:04d}" for i in range(small_objects)]

        def leg_b():
            lat = []
            for key in smalls:
                t = time.perf_counter()
                put("small", key, body(small_bytes))
                lat.append(time.perf_counter() - t)
            return {"p50_ms": 1e3 * float(np.percentile(lat, 50)),
                    "p99_ms": 1e3 * float(np.percentile(lat, 99)),
                    "puts_per_s": len(lat) / sum(lat)}
        leg = counted("b_small_puts", leg_b, objects=small_objects)
        need(leg["k1_launches"] >= small_objects,
             f"(b) K1 launches {leg['k1_launches']} for {small_objects} "
             "PUTs")
        # the device's share of such work, from a traced sample of both
        # kinds
        t_keys = ([(f"t{i:03d}", big_bytes) for i in range(trace_big)]
                  + [(f"s{i:03d}", small_bytes) for i in range(trace_small)])

        def sample():
            for key, n in t_keys:
                put("trace", key, body(n))
        t_chunks = (trace_big * -(-big_bytes // RGW_CHUNK) + trace_small)
        leg = counted("t_traced_sample", sample, traced=True,
                      objects=len(t_keys))
        need(leg["k1_launches"] >= t_chunks,
             f"(t) K1 launches {leg['k1_launches']} for {t_chunks} chunks")

        # -- (c) a multipart upload ------------------------------------------
        def leg_c():
            root = s3.req("POST", "/mp/joined", query={"uploads": ""})[2]
            upload_id = re.search(rb"<UploadId>([^<]+)</UploadId>",
                                  root).group(1).decode()
            datas, etags = [], []
            for n in range(1, parts + 1):
                datas.append(body(part_bytes))
                hdrs = s3.req("PUT", "/mp/joined", datas[-1], query={
                    "uploadId": upload_id, "partNumber": str(n)})[1]
                etags.append(hdrs["ETag"])
            manifest = "<CompleteMultipartUpload>" + "".join(
                f"<Part><PartNumber>{n}</PartNumber><ETag>{e}</ETag>"
                "</Part>" for n, e in enumerate(etags, 1)) + \
                "</CompleteMultipartUpload>"
            s3.req("POST", "/mp/joined", manifest.encode(),
                   query={"uploadId": upload_id})
            model[("mp", "joined")] = b"".join(datas)
            vids[("mp", "joined")] = None
            get("mp", "joined", "GET of the completed upload")
            return {"upload_id": upload_id}
        chunks_c = parts + -(-parts * part_bytes // RGW_CHUNK)
        leg = counted("c_multipart", leg_c, parts=parts,
                      part_bytes=part_bytes, chunks=chunks_c)
        need(leg["k1_launches"] >= chunks_c,
             f"(c) K1 launches {leg['k1_launches']} for {chunks_c} "
             "objects")

        # -- (d) versioning, overwrites, lifecycle and gc --------------------
        def live_chunks():
            """The data pool's objects the model's live versions hold."""
            oids = set()
            for (bucket, key), data in model.items():
                base = f"{g.get_bucket(bucket)['id']}_o_{key}"
                if vids[(bucket, key)]:
                    base += f"#v#{vids[(bucket, key)]}"
                n = max(1, -(-len(data) // RGW_CHUNK))
                oids.update([base] + [base.replace("_o_", "_c_", 1)
                                      + f".{i}" for i in range(1, n)])
            return oids

        def leg_d():
            s3.req("PUT", "/small", b"<VersioningConfiguration><Status>"
                   b"Enabled</Status></VersioningConfiguration>",
                   query={"versioning": ""})
            for key in smalls[:overwrites]:
                put("small", key, body(small_bytes))
                if not vids[("small", key)]:
                    raise AssertionError(f"4z: small/{key} has no version")
            g.put_bucket_lifecycle("small", [{
                "id": "noncurrent", "prefix": "", "status": "Enabled",
                "noncurrent_days": 3}])
            lc = g.lc_process(now=time.time() + 4 * 86400)
            if lc["small"]["noncurrent_removed"] != overwrites:
                raise AssertionError(f"4z: lifecycle removed {lc['small']}")
            report = g.gc(repair=True)
            stored = set(cl.list_objects("rgwdata"))
            want = live_chunks()
            if stored != want:
                raise AssertionError(
                    f"4z: rgwdata holds {len(stored)} objects, the model "
                    f"{len(want)}: {sorted(stored ^ want)[:8]}")
            for key in smalls[:overwrites]:
                get("small", key, f"GET small/{key} after the lifecycle")
            return {"lifecycle": lc["small"], "gc": {
                k: len(v) for k, v in report.items()},
                "data_objects": len(stored)}
        counted("d_versioning_lifecycle_gc", leg_d, overwrites=overwrites)

        # -- (e) two OSDs down: every live object read back ------------------
        m = c.mon.osdmap
        meta_sets, data_sets = ([[int(o) for o in m.pg_to_up_acting_osds(
            pg_t(pid, ps))[2]] for ps in range(n)] for pid, n in (
                (meta_pid, meta_pg_num), (data_pid, data_pg_num)))

        def data_acting(oid):
            pool = m.get_pg_pool(data_pid)
            ps = ceph_stable_mod(m.map_to_pg(data_pid, oid).ps,
                                 pool.pg_num, pool.pg_num_mask)
            return data_sets[ps]

        chunks = sorted(live_chunks())
        first = f"{g.get_bucket('big')['id']}_o_{bigs[0]}"
        victims = shard_pair((data_acting(oid)[1:K]
                              for oid in [first, *chunks]), meta_sets)
        lost = sum(1 for oid in chunks
                   if set(data_acting(oid)[:K]) & set(victims))
        if not lost:
            raise AssertionError("4z (e): no chunk lost a data shard")
        t0 = time.perf_counter()
        for v in victims:
            c.kill_osd(v)
            c.mark_osd_down(v)
        out["mark_down_s"] = time.perf_counter() - t0

        def leg_e():
            for bucket, key in sorted(model):
                get(bucket, key, f"degraded GET {bucket}/{key}")
        leg = counted("e_degraded_gets", leg_e, victims=victims,
                      objects=len(model), chunks=len(chunks),
                      chunks_missing_a_data_shard=lost,
                      mark_down_s=out["mark_down_s"])
        leg["GiBps"] = sum(map(len, model.values())) / leg["wall_s"] / 2**30
        need(leg["k1_launches"] >= lost,
             f"(e) K1 launches {leg['k1_launches']} for {lost} chunks with "
             "a lost data shard")
    finally:
        srv.shutdown()
        srv.server_close()
        for osd in c.osds.values():
            osd.shutdown()
    out["launches"] = total
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4z: launches " + json.dumps(total) + f"; {out['seconds']:.1f} s")
    return out


def rgw_alone(dev) -> None:
    """``--rgw``: 4z alone after phases 1-2, its record written to
    ``chiprun_out/rgw.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    out = rgw_slice(dev)
    with open(os.path.join("chiprun_out", "rgw.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


RF_MONS = 3                       # a quorum that survives its leader
RF_FILL = 32                      # (a) objects written before the failover
RF_LATE = 16                      #     and after it
RF_PATCHES = 16                   # (b) unaligned partial overwrites
RF_PATCH_BYTES = 65536 + 4321     #     crossing stripe boundaries
RF_SPLIT_PG_NUM = 64              # (c) pg_num and pgp_num 32 -> 64
RF_SNAP_WRITES = 8                # (d) overwrites that clone


def rados_features_slice(dev, obj_bytes: int = OBJ_BYTES,
                         pg_num: int = SMOKE_PG_NUM,
                         split_pg_num: int = RF_SPLIT_PG_NUM,
                         n_fill: int = RF_FILL, n_late: int = RF_LATE,
                         n_patch: int = RF_PATCHES,
                         patch_bytes: int = RF_PATCH_BYTES,
                         n_snap: int = RF_SNAP_WRITES) -> dict:
    """4r: the RADOS features of an erasure-coded pool that the case
    twins hold to the JAX package's own cases, at full width: a
    ``MiniCluster`` of ``RF_MONS`` monitors and 12 OSDs, one per host, and
    a ``cuda`` k=8 m=4 pool of ``pg_num`` PGs with objects of
    ``obj_bytes``.  Legs, K1's count set to 0 just before each and read
    just after:

    (a) ``n_fill`` writes; the leader killed (after
        ``tests/test_multimon.py:34``) and the cluster ticked until
        ``mon.1`` leads; ``n_late`` writes and a replicated pool created
        under it; the old leader revived.  K1 once per write.
    (b) a non-primary OSD killed and marked down; ``n_late`` writes and
        ``n_patch`` unaligned overwrites of ``patch_bytes`` while it is
        away; revived and recovered (after ``tests/test_pg_log.py:71``
        and ``tests/test_rmw.py:151``): the recovery pushes exactly one
        shard per object changed meanwhile, and decodes on K1.
    (c) ``pg_num``, then ``pgp_num``, to ``split_pg_num`` (after
        ``tests/test_pg_split.py:83`` and ``:202``), every object read
        back; an OSD holding a data shard of objects in child PGs killed
        and marked down, those objects read degraded: K1 decodes.
    (d) the OSD revived; a self-managed snapshot, ``n_snap`` overwrites
        under its write context (after
        ``tests/test_selfmanaged_snaps.py:50``): K1 twice per write, once
        for the clone (``PG.with_clone`` writes the old bytes as an
        object of its own, a full EC write) and once for the head; each
        read at the snap equals the old bytes, at head the new.

    Every read must equal a numpy model, and every op must answer 0
    within ``OSD_PATH_DEADLINE_S``.  On the CPU (a rehearsal at small
    sizes) the codec takes ``backend=host`` and the launch counts are
    not checked."""
    from ceph_tpu_torch.cluster import MiniCluster
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.dispatch import g_dispatcher
    from ceph_tpu_torch.osdmap import pg_t
    on_card = dev.type == "cuda"
    extra = {} if on_card else {"backend": "host"}
    gate = OpGate()
    total = {"gf_bit_matmul": 0}
    out = {"legs": {}, "config": {
        "mons": RF_MONS, "osds": OSD_PATH_OSDS, "pg_num": pg_num,
        "split_pg_num": split_pg_num, "k": K, "m": M, "plugin": "cuda",
        "extra_profile": extra, "object_bytes": obj_bytes,
        "fill": n_fill, "late": n_late, "patches": n_patch,
        "patch_bytes": patch_bytes, "snap_writes": n_snap}}
    t_slice = time.perf_counter()

    def need(cond, what):
        if on_card and not cond:
            raise AssertionError(f"4r: {what}")

    g_dispatcher.flush()
    for name in ("os_memstore_device_bytes_max", "ec_pipeline_depth",
                 "ec_dispatch_batch_window_us", "ec_dispatch_batch_max",
                 "osd_op_num_threads", "osd_op_queue_batch_intake"):
        g_conf.rm_val(name)
    rng = np.random.default_rng(SEED + 18)
    model = {}

    def body():
        return rng.integers(0, 256, obj_bytes, dtype=np.uint8).tobytes()

    def write(oid, data):
        gate.call(f"write_full {oid}", cl.write_full, "ec", oid, data)
        model[oid] = data

    def check(oids, what, snap=None, want=None):
        for oid in oids:
            expect = (want or model)[oid]
            got = gate.call(f"{what} read {oid}",
                            lambda: cl.read("ec", oid, snap=snap))
            if got != expect:
                raise AssertionError(f"4r {what}: read of {oid} differs")

    counted = k1_legs("4r", dev, out, total)
    t0 = time.perf_counter()
    c = MiniCluster(n_osds=OSD_PATH_OSDS, n_mons=RF_MONS)
    c.create_ec_pool("ec", k=K, m=M, pg_num=pg_num, plugin="cuda",
                     extra_profile=extra)
    cl = c.client("client.rf")
    out["boot_s"] = time.perf_counter() - t0
    log(f"4r: MiniCluster of {RF_MONS} mons, {OSD_PATH_OSDS} OSDs and a "
        f"pool of {pg_num} PGs up in {out['boot_s']:.1f} s")
    try:
        # -- (a) a monitor failover under writes ------------------------------
        fill = [f"a{i}" for i in range(n_fill)]
        late = [f"f{i}" for i in range(n_late)]

        def failover():
            nonlocal cl
            for oid in fill:
                write(oid, body())
            epoch = c.mon.osdmap.epoch
            c.kill_mon(0)
            ticks = 0
            while c.mon.name != "mon.1" or not c.mon.is_leader():
                if ticks == 12:
                    raise AssertionError("4r (a): no election after the "
                                         "leader died")
                c.tick(dt=6.0)
                ticks += 1
            leader = c.mon
            if 0 in leader.quorum or leader.osdmap.epoch < epoch:
                raise AssertionError(f"4r (a): quorum {leader.quorum}, "
                                     f"epoch {leader.osdmap.epoch}")
            cl = c.client("client.rf2")      # a session with the new leader
            for oid in late:
                write(oid, body())
            c.create_replicated_pool("after_failover", 3, 8)
            gate.call("write_full after_failover", cl.write_full,
                      "after_failover", "marker", b"new leader")
            c.revive_mon(0)
            cl = c.client("client.rf3")  # and with the quorum it rejoined
            return {"election_ticks": ticks, "leader": leader.name,
                    "leader_after_revive": c.mon.name,
                    "writes": len(fill) + len(late)}

        leg = counted("a_failover", failover)
        need(leg["k1_launches"] == n_fill + n_late,
             f"(a) K1 launches {leg['k1_launches']} for "
             f"{n_fill + n_late} writes")
        if gate.call("read after_failover", cl.read, "after_failover",
                     "marker") != b"new leader":
            raise AssertionError("4r (a): the new pool's object differs")
        counted("a_read", lambda: check(fill + late, "(a)"))

        # -- (b) an OSD flap: writes and partial overwrites meanwhile --------
        victim = acting_of(c, cl, "ec", fill[0])[1]    # not the primary
        patched = fill[:n_patch]
        flap_new = [f"b{i}" for i in range(n_late)]

        def pushes():
            return sum(o.perf["recovery_push"] for o in c.osds.values())

        placed = {oid: acting_of(c, cl, "ec", oid)
                  for oid in flap_new + patched}

        def flap_writes():
            c.kill_osd(victim)
            c.mark_osd_down(victim)
            for oid in flap_new:
                write(oid, body())
            for i, oid in enumerate(patched):
                off = 4097 + 7919 * i
                patch = rng.integers(0, 256, patch_bytes,
                                     dtype=np.uint8).tobytes()
                gate.call(f"write {oid} at {off}", cl.write, "ec", oid,
                          patch, off)
                new = bytearray(model[oid])
                new[off:off + patch_bytes] = patch
                model[oid] = bytes(new)
            return {"victim": victim, "writes": len(flap_new),
                    "overwrites": len(patched)}

        counted("b_flap_writes", flap_writes)
        changed = {oid for oid, acting in placed.items() if victim in acting}
        data_lost = sum(1 for oid in changed
                        if victim in placed[oid][:K])
        p0 = pushes()

        def flap_recover():
            c.revive_osd(victim)
            c.run_recovery()
            return {"pushes": pushes() - p0,
                    "changed_objects": len(changed),
                    "data_shards_pushed": data_lost,
                    "objects": len(model)}

        leg = counted("b_flap_recovery", flap_recover)
        if leg["pushes"] != len(changed):
            raise AssertionError(
                f"4r (b): recovery pushed {leg['pushes']} shards for "
                f"{len(changed)} objects changed during the flap")
        need(leg["k1_launches"] >= 1 and data_lost >= 1,
             f"(b) K1 launches {leg['k1_launches']} for {data_lost} data "
             "shards pushed")
        counted("b_read", lambda: check(list(model), "(b)"))

        # -- (c) a PG split with pgp migration -------------------------------
        pid = c.mon.osdmap.lookup_pg_pool_name("ec")

        def split():
            c.mon.set_pool_pg_num("ec", split_pg_num)
            c.publish()
            c.mon.set_pool_pgp_num("ec", split_pg_num)
            c.publish()
            ticks = 0
            while c.mon.osdmap.pg_temp:
                if ticks == 12:
                    raise AssertionError(
                        f"4r (c): pg_temp pins never cleared: "
                        f"{dict(c.mon.osdmap.pg_temp)}")
                c.tick(dt=1.0)
                for _ in range(3):
                    c.network.pump()
                    c.run_recovery()
                ticks += 1
            pool = c.mon.osdmap.pools[pid]
            if pool.pg_num != split_pg_num or \
                    pool.pgp_num != split_pg_num:
                raise AssertionError(f"4r (c): pg_num {pool.pg_num}, "
                                     f"pgp_num {pool.pgp_num}")
            check(list(model), "(c)")
            return {"pg_num": pool.pg_num, "pgp_num": pool.pgp_num,
                    "migration_ticks": ticks}

        counted("c_split", split)
        pool = c.mon.osdmap.pools[pid]
        children = [oid for oid in model if pool.raw_pg_to_pg(
            c.mon.osdmap.map_to_pg(pid, oid)).ps >= pg_num]
        if not children:
            raise AssertionError("4r (c): no object landed in a child PG")
        child0 = pool.raw_pg_to_pg(c.mon.osdmap.map_to_pg(pid, children[0]))
        acting = [int(o) for o in c.mon.osdmap.pg_to_up_acting_osds(
            pg_t(pid, child0.ps))[2]]
        split_victim = acting[1]
        degraded = [oid for oid in children
                    if split_victim in acting_of(c, cl, "ec", oid)[:K]]

        def child_degraded():
            c.kill_osd(split_victim)
            c.mark_osd_down(split_victim)
            check(degraded, "(c) degraded")
            return {"victim": split_victim, "child_objects": len(children),
                    "objects_missing_a_data_shard": len(degraded)}

        leg = counted("c_degraded", child_degraded)
        need(leg["k1_launches"] >= 1,
             f"(c) K1 launches {leg['k1_launches']} for {len(degraded)} "
             "degraded child-PG objects")
        c.revive_osd(split_victim)
        c.run_recovery()

        # -- (d) self-managed snapshot clones ----------------------------------
        snapped = list(model)[:n_snap]
        old = {oid: model[oid] for oid in snapped}

        def snapshot():
            sid = cl.selfmanaged_snap_create("ec")
            cl.set_write_ctx("ec", sid, [sid])
            for oid in snapped:
                write(oid, body())
            return {"snap": sid, "writes": len(snapped)}

        leg = counted("d_snapshot", snapshot)
        need(leg["k1_launches"] == 2 * n_snap,
             f"(d) K1 launches {leg['k1_launches']} for {n_snap} writes "
             "and their clones")
        sid = leg["snap"]

        def snap_reads():
            check(snapped, "(d) snap", snap=sid, want=old)
            check(snapped, "(d) head")

        counted("d_read", snap_reads)
    finally:
        for osd in c.osds.values():
            osd.shutdown()
    out["launches"] = total
    out["slowest_op_s"] = gate.slowest_s
    out["ops"] = gate.ops
    out["seconds"] = time.perf_counter() - t_slice
    log(f"4r: {gate.ops} ops, slowest {gate.slowest_s:.2f} s; launches "
        + json.dumps(total) + f"; {out['seconds']:.1f} s")
    return out


def rados_features_alone(dev) -> None:
    """``--rados-features``: 4r alone after phases 1-2, its record written
    to ``chiprun_out/rados_features.json``."""
    os.makedirs("chiprun_out", exist_ok=True)
    out = rados_features_slice(dev)
    with open(os.path.join("chiprun_out", "rados_features.json"), "w") as f:
        json.dump(out, f, indent=1, default=str)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    # every line logged, stamped with the seconds since here, also goes to
    # chiprun_out/chip_smoke.log: the output's end alone is cut short
    os.makedirs("chiprun_out", exist_ok=True)
    log_path = os.path.join("chiprun_out", "chip_smoke.log")
    open(log_path, "w").close()
    LOG_FILE.append((log_path, time.perf_counter()))
    from ceph_tpu_torch import arch
    from ceph_tpu_torch.ec import create_erasure_code
    from ceph_tpu_torch.gf.matrices import (gf_gen_cauchy1_matrix,
                                            gf_gen_rs_matrix)
    from ceph_tpu_torch.gf.tables import expand_to_bitmatrix
    from ceph_tpu_torch.common.config import g_conf
    from ceph_tpu_torch.ops import _build, gf_pallas
    from ceph_tpu_torch.ops.gf_matmul import DeviceRSBackend
    from ceph_tpu_torch.osd import ecutil
    from ceph_tpu_torch.trace import g_devprof

    dev = torch.device("cuda")
    results: dict = {"phase_seconds": {}}
    t_mark = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        results["phase_seconds"][name] = now - t_mark[0]
        log(f"phase {name} took {now - t_mark[0]:.1f} s")
        t_mark[0] = now

    # -- 1. device ------------------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    smi = smi.splitlines()[0]
    log(smi)
    probe = arch.probe()
    log("arch " + json.dumps(probe))
    results.update(nvidia_smi=smi, arch=probe)

    phase_done("1 device")

    # -- 2. build -------------------------------------------------------------
    t0 = time.perf_counter()
    with g_devprof.stage(BUILD_STAGE):
        built = _build.build_all()
    build_s = time.perf_counter() - t0
    log(f"build {sorted(built)} in {build_s:.2f} s")
    ptxas = {}
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            entry = re.search(r"Compiling entry function '(\S+)'", line)
            if entry:
                ptxas.setdefault(name, []).append(kernel_name(entry.group(1)))
            elif "registers" in line or "spill" in line:
                ptxas.setdefault(name, []).append(line.strip())
    for name, lines in ptxas.items():
        for line in lines:
            log(f"  ptxas[{name}] {line}")
    results["ptxas"] = ptxas
    results["build_s"] = build_s
    sass = {n: sass_counts(so, probe["nvcc"]) for n, so in built.items()}
    for name, per_fn in sass.items():
        for fn, c in (per_fn or {}).items():
            log(f"  sass[{name}] {fn} " + json.dumps(
                {k: v for k, v in c.items() if k != "opcodes"}))
    results["sass"] = sass
    for flag, turns in (("--k6-parent", k6_parent_turns),
                        ("--k7a-parent", k7a_parent_turns),
                        ("--k7a-forms", k7a_form_turns),
                        ("--dispatch-scan", dispatch_scan_turns),
                        ("--k8-parent", k8_parent_turns),
                        ("--osd-path", osd_path_alone),
                        ("--cluster", cluster_alone),
                        ("--vstart", vstart_alone),
                        ("--k7c", k7c_alone),
                        ("--mesh", mesh_alone),
                        ("--rbd", rbd_alone),
                        ("--cephfs", cephfs_alone),
                        ("--rgw", rgw_alone),
                        ("--rados-features", rados_features_alone)):
        if flag not in sys.argv:
            continue
        if flag in ("--k7a-forms", "--dispatch-scan", "--osd-path",
                    "--cluster", "--vstart", "--k7c", "--mesh", "--rbd",
                    "--cephfs", "--rgw", "--rados-features"):
            turns(dev)
        else:
            turns(sys.argv[sys.argv.index(flag) + 1], dev)
        log(smi)
        log(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}))
        return 0

    phase_done("2 build")

    # -- 4n. the native host library and the bench CLI in its own process,
    # first after the build: its mesh workloads' wall-clock gates (4w (d))
    # read the host's jitter, which the host-bound checks below raise -------
    results["native_bench"] = native_bench_slice()
    phase_done("4n native + bench CLI")

    # -- 3. kernel against its plain version ----------------------------------
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    rs = DeviceRSBackend(gf_gen_rs_matrix(K + M, K), dev)
    enc_bm = rs.enc_bits
    srcs = [i for i in range(K + M) if i not in ERASED][:K]
    dec1 = rs._decode_bits_for(tuple(srcs), (1,))
    dec2 = rs._decode_bits_for(tuple(srcs), (1, 2))
    odd = [((3, 21, 4, 96), gf_gen_rs_matrix),
           ((5, 32, 4, 32), gf_gen_rs_matrix),
           ((2, 2, 1, 33), gf_gen_rs_matrix),
           ((1, 40, 3, 4128), gf_gen_cauchy1_matrix)]
    cases = [("encode", (8192, K, M, CHUNK), enc_bm),
             ("decode_r1", (8192, K, 1, CHUNK), dec1),
             ("decode_r2", (8192, K, 2, CHUNK), dec2)]
    for (s, k, r, c), genm in odd:
        bits = expand_to_bitmatrix(genm(k + r, k)[k:])
        cases.append((f"odd_{s}x{k}x{r}x{c}", (s, k, r, c),
                      gf_pallas.BitMatrix(bits, dev)))
    rng = np.random.default_rng(SEED)
    for k in (1, 9, 32, 256):
        for r in (1, 5, 8):
            bm = gf_pallas.BitMatrix(
                rng.integers(0, 2, (8 * k, 8 * r), dtype=np.uint8), dev)
            for c in (1, 15, 4097):
                cases.append((f"grid_{k}x{r}x{c}", (3, k, r, c), bm))
    cases.append(("misaligned", (64, K, M, CHUNK), enc_bm))
    max_err = 0
    inputs = {}
    for name, (s, k, r, c), bm in cases:
        if name == "misaligned":      # contiguous, one byte off 16-B alignment
            buf = torch.randint(0, 256, (s * k * c + 1,), generator=gen,
                                device=dev, dtype=torch.uint8)
            data = buf[1:].view(s, k, c)
            if data.data_ptr() % 16 != 1 or not data.is_contiguous():
                raise AssertionError("misaligned case is not one byte off")
        else:
            data = torch.randint(0, 256, (s, k, c), generator=gen,
                                 device=dev, dtype=torch.uint8)
        got = gf_pallas.gf_bit_matmul_kernel(data, bm)
        want = gf_pallas.gf_bit_matmul_plain(data, bm.bits)
        torch.cuda.synchronize()
        err = int((got.int() - want.int()).abs().max())
        if not name.startswith("grid_") or err:
            log(f"check {name} (S,k,r,C)={(s, k, r, c)} max_abs_err={err}")
        if got.shape != (s, r, c) or err:
            raise AssertionError(f"kernel disagrees with plain at {name}")
        max_err = max(max_err, err)
        if name in ("encode", "decode_r1", "decode_r2"):
            prior = gf_pallas.gf_bit_matmul_popc(data, bm)
            torch.cuda.synchronize()
            if not torch.equal(prior, want):
                raise AssertionError(f"first design disagrees at {name}")
            inputs[name] = (data, bm)
        del got, want
    n_grid = sum(1 for n, _, _ in cases if n.startswith("grid_"))
    log(f"check grid: {n_grid} shapes of random 0/1 matrices, max_abs_err 0")
    log("check first design (popc) at encode, decode_r1, decode_r2: equal")
    results["max_abs_err"] = max_err
    results["checked_shapes"] = len(cases)

    phase_done("3 K1 checks")

    # -- 4. main path ---------------------------------------------------------
    sinfo = ecutil.stripe_info_t(K, K * CHUNK)
    spo = OBJ_BYTES // sinfo.get_stripe_width()          # 128 stripes
    all_shards = set(range(K + M))
    objs_dev = torch.randint(0, 256, (N_OBJ * spo, K, CHUNK), generator=gen,
                             device=dev, dtype=torch.uint8)
    objs = objs_dev.cpu().numpy().reshape(N_OBJ, OBJ_BYTES)
    launches = 0
    e2e = {}
    for tech in ("reed_sol_van", "cauchy"):
        codec = create_erasure_code({"plugin": "cuda", "k": str(K),
                                     "m": str(M), "technique": tech})
        gf_pallas.launches.reset()
        # (a) one object at a time, as the OSD calls it
        shards = [ecutil.encode(sinfo, codec, o, all_shards) for o in objs]
        # (b) the whole batch on the card
        parity = codec.encode_batch_device(objs_dev)
        torch.cuda.synchronize()
        want = torch.from_numpy(np.stack(
            [np.stack([sh[K + j].reshape(spo, CHUNK) for j in range(M)],
                      axis=1) for sh in shards])).to(dev)
        if not torch.equal(parity, want.reshape(N_OBJ * spo, M, CHUNK)):
            raise AssertionError(f"{tech}: batched parity != per-object")
        # ... and its reconstruction twin, survivors already on the card
        del want
        surv_dev = torch.cat([objs_dev[:, [0, 2, 3, 4, 5, 6, 7]],
                              parity[:, :1]], dim=1)
        rec = codec.decode_batch_device(surv_dev, srcs, [1])
        if not torch.equal(rec, objs_dev[:, 1:2]):
            raise AssertionError(f"{tech}: decode_batch_device mismatch")
        del surv_dev, rec, parity
        # (c) degraded read of every object, (d) rebuild of shard 9
        for o, sh in zip(objs, shards):
            surv = {i: b for i, b in sh.items() if i not in ERASED}
            if not np.array_equal(ecutil.decode_concat(sinfo, codec, surv), o):
                raise AssertionError(f"{tech}: decode_concat mismatch")
            if not np.array_equal(
                    ecutil.decode(sinfo, codec, surv, [9])[9], sh[9]):
                raise AssertionError(f"{tech}: rebuilt shard 9 mismatch")
        n = gf_pallas.launches.n
        log(f"main {tech}: (a)-(d) byte-exact, kernel launches {n}")
        if n == 0:
            raise AssertionError(f"{tech}: main path never ran the kernel")
        launches += n
        # (e) one object against the host codec
        flat = objs[0].reshape(spo, K, CHUNK).transpose(1, 0, 2).reshape(
            K, spo * CHUNK)
        host = codec.codec.encode(np.ascontiguousarray(flat))
        for j in range(M):
            if not np.array_equal(
                    host[j].reshape(spo, CHUNK),
                    shards[0][K + j].reshape(spo, CHUNK)):
                raise AssertionError(f"{tech}: host codec mismatch")
        log(f"main {tech}: (e) host MatrixRSCodec agrees")

        # -- 5. end-to-end times (outside the counted run) --------------------
        surv_all = [{i: b for i, b in sh.items() if i not in ERASED}
                    for sh in shards]
        total = N_OBJ * OBJ_BYTES
        ta = wall_s(lambda: [ecutil.encode(sinfo, codec, o, all_shards)
                             for o in objs], runs=RUNS)
        tb = cuda_ms(lambda: codec.encode_batch_device(objs_dev)) / 1e3
        tc = wall_s(lambda: [ecutil.decode_concat(sinfo, codec, sv)
                             for sv in surv_all], runs=RUNS)
        e2e[tech] = {
            "a_encode_per_object_GiBps": total / ta / 2**30,
            "b_encode_batch_device_GiBps": total / tb / 2**30,
            "c_decode_concat_GiBps": total / tc / 2**30,
        }
        log(f"e2e {tech} " + json.dumps(e2e[tech]))
    del shards, surv_all
    results["main_path_launches"] = launches

    phase_done("4/5 main path")

    # -- 3b. crc32c kernel against its plain version (after slice 1's phases,
    # which run as they did before this slice) -------------------------------
    crc_err = crc_checks(gen, rng, dev)
    results["crc32c_checks_max_abs_err"] = crc_err
    fused_err = fused_checks(gen, dev)
    results["fused_checks_max_abs_err"] = fused_err

    phase_done("3b/3f crc and fused checks")

    # -- 4r. the device-resident write path -----------------------------------
    g_conf.set_val("os_memstore_device_bytes_max", RESIDENT_BUDGET)
    res_launches = {"gf_bit_matmul": 0, "crc32c": 0, "fused_encode_crc": 0,
                    "resident_calls": 0}
    res_err = 0
    res_batch = None
    for tech in ("reed_sol_van", "cauchy"):
        codec = create_erasure_code({"plugin": "cuda", "k": str(K),
                                     "m": str(M), "technique": tech})
        shards = [ecutil.encode(sinfo, codec, o, all_shards) for o in objs]
        res = resident_phase(tech, codec, objs, objs_dev, shards, sinfo, spo,
                             dev)
        for name, v in res["launches"].items():
            res_launches[name] += v
        res_err = max(res_err, res["max_abs_err"])
        e2e[tech].update(res["e2e"])
        if res_batch is None:
            res_batch = (res["batch"], codec)
        del res, shards
    results["e2e"] = e2e
    results["resident_path_launches"] = res_launches

    phase_done("4r resident write")

    # -- 5. kernel times ------------------------------------------------------
    times = {}
    for name in ("encode", "decode_r1", "decode_r2"):
        data, bm = inputs[name]
        s, k, c = data.shape
        half = s * (k + bm.r) * c // 2      # the kernel's bytes, half each way
        src = torch.empty(half, dtype=torch.uint8, device=dev)
        dst = torch.empty_like(src)
        ms, prior, copy = turns_ms([
            lambda: gf_pallas.gf_bit_matmul_kernel(data, bm),
            lambda: gf_pallas.gf_bit_matmul_popc(data, bm),
            lambda: dst.copy_(src)], reps=REPS)
        del src, dst
        plain = cuda_ms(lambda: gf_pallas.gf_bit_matmul_plain(data, bm.bits))
        b_ms, b_by = bound_ms(s, k, bm.r, c)
        times[name] = {"ms": ms, "prior_ms": prior, "copy_ms": copy,
                       "plain_ms": plain, "bound_ms": b_ms, "bound_by": b_by,
                       "share_of_bound": b_ms / ms,
                       "GBps": (s * k * c + s * bm.r * c) / ms / 1e6}
        log(f"time {name} " + json.dumps(times[name]))
    results["kernel_times"] = times

    phase_done("5 K1 times")

    # -- 5r. crc32c and fused-encode times -----------------------------------
    times.update(resident_times(*res_batch, objs_dev, dev))
    del res_batch

    phase_done("5r crc and fused times")

    # -- 3w. K3 against its plain version (after the earlier slices' phases,
    # which run as they did before this slice) -------------------------------
    word_err, word_inputs = word_checks(gen, rng, dev)
    results["gfw_checks_max_abs_err"] = word_err

    phase_done("3w K3 checks")

    # -- 4j. the codec families at full width ---------------------------------
    del objs_dev
    families = {name: family_phase(name, prof, objs)
                for name, prof in FAMILY_PROFILES}
    results["families"] = families
    word_launches = sum(f["launches"]["gfw_bit_matmul"]
                        for f in families.values())
    family_k1 = sum(f["launches"]["gf_bit_matmul"] for f in families.values())

    phase_done("4j families")

    # -- 5w. K3 times ---------------------------------------------------------
    wt = word_times(word_inputs, dev)
    del word_inputs
    results["word_kernel_times"] = wt
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"after timing: clocks.sm, clocks.max.sm, power.draw, temp: {clocks}")
    results["clocks_after_timing"] = clocks

    phase_done("5w K3 times")

    # -- 3c / 4c / 5c: the CRUSH slice, after the earlier slices' phases, which
    # run as they did before it ----------------------------------------------------
    crush = crush_slice(dev, sass, probe["sm_count"])
    results["crush"] = crush
    # the OSDMap drive's updates, as the osdmap logger's histogram saw them
    from ceph_tpu_torch.trace import g_perf_histograms, latency_axes
    from ceph_tpu_torch.trace.histogram import hist_percentiles
    upd = g_perf_histograms.get("osdmap", "crush_map_latency_histogram",
                                latency_axes)
    crush["crush_map_update_histogram"] = {
        "count": upd.total_count, "sum_usec": upd.axis0_sum,
        **hist_percentiles(upd)}
    log("crush_map_update histogram (usec) "
        + json.dumps(crush["crush_map_update_histogram"]))
    crush_launches, crush_err, ct = (crush["launches"], crush["max_abs_err"],
                                     crush["times"])
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"after crush timing: clocks.sm, clocks.max.sm, power.draw, temp: "
        f"{clocks}")

    phase_done("3c/4c/5c CRUSH")

    # -- 3l / 4l / 5l: the legacy slice, after the earlier slices' phases,
    # which run as they did before it ---------------------------------------------
    legacy = legacy_slice(dev)
    results["legacy"] = legacy
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    log(f"after legacy timing: clocks.sm, clocks.max.sm, power.draw, temp: "
        f"{clocks}")
    k8 = legacy["times"]["L1 0"]

    phase_done("3l/4l/5l legacy")

    # -- 4b. the port's fenced bench, after the earlier slices' phases, which
    # run as they did before it ------------------------------------------------
    bench = bench_slice(dev)
    results["bench"] = bench
    bench_n = {n: sum(step[n] for step in bench["launches"].values())
               for n in ("gf_bit_matmul", "crush_descend", "crush_resolve",
                         "crush_rule")}
    phase_done("4b bench")

    # -- 4d. the dispatch scheduler on the card, after the earlier slices'
    # phases, which run as they did before it --------------------------------
    dispatch = dispatch_slice(objs)
    results["dispatch"] = dispatch
    phase_done("4d dispatch")

    # -- 4o. osdmaptool on the card, 4m. MemStore with resident bodies, after
    # the earlier slices' phases, which run as they did before them ---------
    tool = osdmaptool_slice(dev)
    results["osdmaptool"] = tool
    phase_done("4o osdmaptool")
    store = memstore_slice(objs, dev)
    results["memstore"] = store
    phase_done("4m memstore")

    # -- 4p. the OSD data path: a client's writes and reads through the
    # monitor, the OSDs, their PGs and ECBackend, after the earlier
    # slices' phases, which run as they did before it --------------------
    del objs
    osd_path = osd_path_slice(dev, pg_num=SMOKE_PG_NUM)
    results["osd_path"] = osd_path
    path_n = osd_path["launches"]
    phase_done("4p OSD data path")

    # -- 4q. MiniCluster: a user's writes, a traffic run and degraded reads
    # through the monitor, the OSDs and the mgr, then psim on 4o's map,
    # after the earlier slices' phases, which run as they did before it --
    cluster = cluster_slice(dev, pg_num=SMOKE_PG_NUM)
    results["cluster"] = cluster
    cl_n = cluster["launches"]
    cli_zc = results["native_bench"]["zero_copy_launches"]
    phase_done("4q MiniCluster")

    # -- 4v. the process cluster: a client's writes, degraded reads and a
    # recovery through daemons that each run K1 in their own process,
    # after the earlier slices' phases, which run as they did before it --
    vs = vstart_slice(dev, proof=False)
    results["vstart"] = vs
    phase_done("4v process cluster")

    # -- 4w. the mesh on 8 members of the card: K9x, ShardedRS and
    # ShardedFastRule, the dispatcher's meshed flush, and the gates of the
    # CLI's mesh workloads (4n's CLI line), after the earlier slices'
    # phases, which run as they did before it -------------------------------
    mesh = mesh_slice(dev, smi, results["native_bench"].pop("mesh_metrics"))
    results["mesh"] = mesh
    mesh_n, mesh_cli = mesh["launches"], mesh["cli_launches"]
    k9x = mesh["k9x"][2]         # the (4, 2) mesh's shard axis
    phase_done("4w mesh")

    # -- 4x. a block device on an erasure-coded data pool: fill, random
    # small writes, a clone's copyups, degraded exports and a mirror's
    # replay, after the earlier slices' phases, which run as they did -----
    rbd_rec = rbd_slice(dev, pg_num=SMOKE_PG_NUM,
                        rand_writes=RBD_SMOKE_RAND_WRITES)
    results["rbd"] = rbd_rec
    # the bench CLI's harnesses on the mesh (4n's line)
    harness = results["native_bench"]["harness"]
    harness_n = {n: sum(w["launches"][n] for w in harness.values())
                 for n in ("gf_bit_matmul", "mesh_xor")}
    phase_done("4x rbd")

    # -- 4y. a filesystem on an erasure-coded data pool: buffered writes
    # flushed by a caps revoke, small files, a subtree snapshot, degraded
    # reads and an MDS journal replay, after the earlier slices' phases,
    # which run as they did ------------------------------------------------------
    fs_rec = cephfs_slice(dev)
    results["cephfs"] = fs_rec
    phase_done("4y cephfs")

    # -- 4z. an S3 object store on an erasure-coded data pool: big and small
    # PUTs over HTTP, a multipart upload, versioning with a lifecycle pass
    # and gc, and degraded GETs, after the earlier slices' phases, which
    # run as they did -------------------------------------------------------
    rgw_rec = rgw_slice(dev)
    results["rgw"] = rgw_rec
    phase_done("4z rgw")

    # -- 4r. an erasure-coded pool through a monitor failover, an OSD flap,
    # a PG split and self-managed snapshot clones, after the earlier slices'
    # phases, which run as they did --------------------------------------------
    rf_rec = rados_features_slice(dev)
    results["rados_features"] = rf_rec
    phase_done("4r rados features")

    enc = times["encode"]
    k4, k5 = times["crc32c"], times["fused_encode_crc"]
    k7 = ct["u_firstn"]
    k6 = ct["u_ec"]          # the rule whose x K7b flags every epoch
    k3, k3w32 = wt["w16"], wt["w32"]
    # the hash probe's reading, beside each kernel that draws hashes: the
    # time of hash32_3 and of K7a's split, and their issue rates
    hp = crush["hash_probe"]["forms"]
    hash_reading = {
        "hash32_3_ms": hp["hash32_3"]["ms"],
        "split_ms": hp["hash32_3_split"]["ms"],
        "hash32_3_alu_per_sm_clk": hp["hash32_3"].get("alu_per_sm_clk"),
        "split_instructions_per_sm_clk": hp["hash32_3_split"].get(
            "instructions_per_sm_clk"),
        "hashes": crush["hash_probe"]["hashes"]}
    kernels = {"kernels": [{
        "name": "gf_bit_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bit_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_pallas.py:37",
        "launches": (launches + res_launches["gf_bit_matmul"] + family_k1
                     + bench_n["gf_bit_matmul"] + dispatch["k1_launches"]
                     + path_n["gf_bit_matmul"] + cl_n["gf_bit_matmul"]
                     + cli_zc["gf_bit_matmul"]
                     + vs["launches"]["gf_bit_matmul"]
                     + mesh_n["gf_bit_matmul"] + mesh_cli["gf_bit_matmul"]
                     + rbd_rec["launches"]["gf_bit_matmul"]
                     + harness_n["gf_bit_matmul"]
                     + fs_rec["launches"]["gf_bit_matmul"]
                     + rgw_rec["launches"]["gf_bit_matmul"]
                     + rf_rec["launches"]["gf_bit_matmul"]),
        "max_abs_err": max_err,
        "ms": enc["ms"], "plain_ms": enc["plain_ms"],
        "bound_ms": enc["bound_ms"], "bound_by": enc["bound_by"],
        "library_ms": None, "prior_ms": enc["prior_ms"],
        "copy_ms": enc["copy_ms"]}, {
        "name": "crc32c", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crc32c.cu",
        "replaces": "ceph_tpu/ops/crc32c_device.py:73",
        "launches": res_launches["crc32c"] + store["launches"]["crc32c"]
        + path_n["crc32c"] + cl_n["crc32c"] + cli_zc["crc32c"],
        "max_abs_err": max(crc_err, res_err),
        "ms": k4["ms"], "plain_ms": k4["plain_ms"],
        "bound_ms": k4["bound_ms"], "bound_by": k4["bound_by"],
        "library_ms": None, "prior_ms": k4["prior_ms"],
        "copy_ms": k4["copy_ms"]}, {
        "name": "fused_encode_crc", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/fused_encode_crc.cu",
        "replaces": "ceph_tpu/ops/resident.py:31",
        "launches": res_launches["fused_encode_crc"]
        + store["launches"]["fused_encode_crc"]
        + path_n["fused_encode_crc"] + cl_n["fused_encode_crc"]
        + cli_zc["fused_encode_crc"],
        "max_abs_err": max(res_err, fused_err),
        "ms": k5["ms"], "plain_ms": k5["plain_ms"],
        "bound_ms": k5["bound_ms"], "bound_by": k5["bound_by"],
        "library_ms": None, "prior_ms": k5["prior_ms"],
        "copy_ms": k5["copy_ms"]}, {
        "name": "gfw_bit_matmul", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/gf_bit_matmul.cu",
        "replaces": "ceph_tpu/ops/gf_matmul.py:84",
        "launches": word_launches, "max_abs_err": word_err,
        "ms": k3["ms"], "plain_ms": k3["plain_ms"],
        "bound_ms": k3["bound_ms"], "bound_by": k3["bound_by"],
        "library_ms": None, "prior_ms": k3["prior_ms"],
        "copy_ms": k3["copy_ms"], "ms_w32": k3w32["ms"],
        "plain_ms_w32": k3w32["plain_ms"],
        "bound_ms_w32": k3w32["bound_ms"],
        "bound_by_w32": k3w32["bound_by"],
        "prior_ms_w32": k3w32["prior_ms"],
        "copy_ms_w32": k3w32["copy_ms"]}, {
        "name": "crush_descend", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_fast.cu",
        "replaces": "ceph_tpu/ops/crush_fast.py:592",
        "launches": crush_launches["crush_descend"]
        + bench_n["crush_descend"] + tool["launches"]["crush_descend"]
        + cl_n["crush_descend"] + mesh_n["crush_descend"],
        "max_abs_err": crush_err["crush_descend"],
        "ms": k7["k7a_ms"], "plain_ms": k7["k7a_plain_ms"],
        "bound_ms": k7["k7a_bound_ms"], "bound_by": "operations",
        "library_ms": None,
        "ms_by_config": {n: t["k7a_ms"] for n, t in ct.items()},
        "bound_ms_by_config": {n: t["k7a_bound_ms"] for n, t in ct.items()},
        "plain_ms_by_config": {n: t["k7a_plain_ms"] for n, t in ct.items()},
        "candidate_phase_ms_by_config": {n: t["candidate_phase_ms"]
                                         for n, t in ct.items()},
        "launches_per_phase_by_config": {n: t["k7a_launches_per_phase"]
                                         for n, t in ct.items()},
        "alternative_ms_by_config": {
            n: {t["k7a_alternative"]: t["k7a_alternative_ms"]}
            for n, t in ct.items()},
        "sass": crush["k7a_sass"],
        "ptxas": {n: u for n, u in ptxas_usage(ptxas.get("crush_fast", [])).items()
                  if n.startswith("crush_descend")},
        "hash_probe": hash_reading}, {
        "name": "crush_resolve", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_fast.cu",
        "replaces": "ceph_tpu/ops/crush_fast.py:882",
        "launches": crush_launches["crush_resolve"]
        + bench_n["crush_resolve"] + tool["launches"]["crush_resolve"]
        + cl_n["crush_resolve"] + mesh_n["crush_resolve"],
        "max_abs_err": crush_err["crush_resolve"],
        "ms": k7["k7b_ms"], "plain_ms": k7["k7b_plain_ms"],
        "bound_ms": k7["k7b_bound_ms"], "bound_by": "bytes",
        "library_ms": None,
        "ms_by_config": {n: t["k7b_ms"] for n, t in ct.items()},
        "bound_ms_by_config": {n: t["k7b_bound_ms"] for n, t in ct.items()},
        "bound_ms_all_bytes_by_config": {n: t["k7b_bound_ms_all"]
                                         for n, t in ct.items()},
        "host_launch_ms_by_config": {n: t["k7b_host_launch_ms"]
                                     for n, t in ct.items()}}, {
        "name": "crush_delta", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_fast.cu",
        "replaces": "ceph_tpu/ops/crush_fast.py:931",
        "launches": crush_launches["crush_delta"],
        "max_abs_err": crush_err["crush_delta"],
        "ms": k7["k7c_ms"], "plain_ms": k7["k7c_plain_ms"],
        "bound_ms": k7["k7c_bound_ms"], "bound_by": "bytes",
        "library_ms": None, "changed_rows": k7["k7c_changed_rows"],
        "cap": k7["k7c_cap"],
        "ms_by_config": {n: t["k7c_ms"] for n, t in ct.items()},
        "plain_ms_by_config": {n: t["k7c_plain_ms"] for n, t in ct.items()},
        "bound_ms_by_config": {n: t["k7c_bound_ms"] for n, t in ct.items()},
        "changed_rows_by_config": {n: t["k7c_changed_rows"]
                                   for n, t in ct.items()},
        "checks": crush["k7c_cases"]}, {
        "name": "crush_rule", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_fast.cu",
        "replaces": "ceph_tpu/ops/crush_kernels.py:436",
        "launches": crush_launches["crush_rule"] + bench_n["crush_rule"]
        + tool["launches"]["crush_rule"] + cl_n["crush_rule"]
        + mesh_n["crush_rule"],
        "max_abs_err": crush_err["crush_rule"],
        "ms": k6["k6_flagged_ms"], "plain_ms": k6["k6_flagged_plain_ms"],
        "bound_ms": k6["k6_flagged_bound_ms"], "bound_by": "operations",
        "library_ms": None, "flagged_x": k6["k6_flagged"],
        "max_items_per_flagged_x": k6["k6_max_items_per_flagged_x"],
        "ptxas": {n: u for n, u in ptxas_usage(ptxas.get("crush_fast", [])).items()
                  if n.startswith("crush_rule")},
        "ms_all_by_config": {n: t["k6_all_ms"] for n, t in ct.items()},
        "ms_all_warp_by_config": {n: t["k6_all_warp_ms"]
                                  for n, t in ct.items()},
        "max_items_per_flagged_x_by_config": {
            n: t["k6_max_items_per_flagged_x"] for n, t in ct.items()},
        "resolve_epoch_ms_by_config": {n: t["resolve_epoch_ms"]
                                       for n, t in ct.items()},
        "bound_ms_all_by_config": {n: t["k6_all_bound_ms"]
                                     for n, t in ct.items()},
        "plain_ms_all_by_config": {n: t["k6_all_plain_ms"]
                                     for n, t in ct.items()},
        "ms_flagged_by_config": {n: t["k6_flagged_ms"]
                                 for n, t in ct.items()},
        "bound_ms_flagged_by_config": {n: t["k6_flagged_bound_ms"]
                                       for n, t in ct.items()},
        "hash_probe": hash_reading}, {
        "name": "crush_legacy", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/crush_legacy.cu",
        "replaces": "ceph_tpu/ops/crush_legacy.py:387",
        "launches": legacy["launches"],
        "max_abs_err": legacy["checks"]["max_abs_err"],
        "ms": k8["ms"], "plain_ms": k8["plain_ms_4096_x"], "plain_x": 4096,
        "bound_ms": k8["bound_ms"], "bound_by": "operations",
        "library_ms": None, "items_per_x": k8["items_per_x"],
        "ptxas": ptxas_usage(ptxas.get("crush_legacy", [])),
        "ms_by_rule_epoch": {n: t["ms"] for n, t in legacy["times"].items()},
        "bound_ms_by_rule_epoch": {n: t["bound_ms"]
                                   for n, t in legacy["times"].items()},
        "plain_ms_4096_x_by_rule_epoch": {
            n: t["plain_ms_4096_x"] for n, t in legacy["times"].items()},
        "perm_x": legacy["checks"]["L_perm_x"],
        "local_x": legacy["checks"]["L_local_x"],
        "hash_probe": hash_reading}, {
        "name": "mesh_xor", "route": "cuda",
        "source": "ceph_tpu_torch/csrc/mesh_xor.cu",
        "replaces": "ceph_tpu/parallel/ec.py:255",
        "launches": mesh_n["mesh_xor"] + mesh_cli["mesh_xor"]
        + harness_n["mesh_xor"],
        "max_abs_err": max(t["max_abs_err"] for t in mesh["k9x"].values()),
        "ms": k9x["ms"], "plain_ms": k9x["plain_ms"],
        "bound_ms": k9x["bound_ms"], "bound_by": k9x["bound_by"],
        "library_ms": None, "copy_ms": k9x["copy_ms"],
        "partials": 2,
        "ms_by_partials": {n: t["ms"] for n, t in mesh["k9x"].items()},
        "bound_ms_by_partials": {n: t["bound_ms"]
                                 for n, t in mesh["k9x"].items()},
        "plain_ms_by_partials": {n: t["plain_ms"]
                                 for n, t in mesh["k9x"].items()},
        "copy_ms_by_partials": {n: t["copy_ms"]
                                for n, t in mesh["k9x"].items()}}]}
    results.update(kernels)
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump(results, f, indent=1)
    log("rados_features " + json.dumps(
        {"seconds": rf_rec["seconds"], "ops": rf_rec["ops"],
         "slowest_op_s": rf_rec["slowest_op_s"],
         "legs": {n: {k: v for k, v in leg.items() if k in (
             "wall_s", "k1_launches", "pushes", "changed_objects",
             "data_shards_pushed", "objects_missing_a_data_shard",
             "election_ticks", "migration_ticks")}
             for n, leg in rf_rec["legs"].items()}}))
    log(smi)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--vstart-osd"]:
        osd_launcher(sys.argv[2], sys.argv[3:])
    else:
        sys.exit(main())
